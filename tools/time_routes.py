"""Time the traversal routes and row fetches on one GPU.

    python tools/time_routes.py [--repeats N]

Prints the card's name and power limit, then one JSON line per measurement:

  * sweep_*: the dense Möller-Trumbore sweep at 512^2 rays x the
    36-triangle Cornell box, XLA (intersect_brute / occluded_brute) and
    Pallas-Triton (sweep_triton), each with its ALU bound beside it;
  * render_*: end-to-end offline render (512^2, depth 8, 16 spp) of the
    Cornell box and of the 262k-triangle sphere box, each through its GPU
    route (Triton sweep, CUDA kernel) and through the plain XLA route
    (XLA sweep, LBVH walk), run in the order GPU, XLA, XLA, GPU;
  * fetch_*: one row fetch of 262,144 lanes from a [N, 32] table, N in
    {36, 256, 512}, by plain gather and by one-hot matmul.

Times are medians of `repeats` runs after a warm-up, host clock around
block_until_ready.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# float32 peak of one H100 SXM outside the tensor cores (NVIDIA data sheet)
PEAK_F32 = {"NVIDIA H100 80GB HBM3": 67e12}
# flops per (ray, triangle) test of accel/intersect.py `_mt_batch` plus the
# running min: 2 crosses (2 x 9), 4 dots (4 x 5), 3 subs, 1 div, 4 muls by
# inv_det, 9 compares/selects, 2 for the reduction
MT_FLOPS = 18 + 20 + 3 + 1 + 4 + 9 + 2


def median_time(fn, *args, repeats=5):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts)), float(np.max(ts))


def emit(name, t, **kw):
    print(json.dumps(dict(name=name, median_s=t[0], min_s=t[1], max_s=t[2],
                          **kw)), flush=True)


# each GPU route and the plain XLA route it is compared with
_XLA_ROUTE = {"triton": "brute", "cuda": "bvh", "brute": "brute",
              "bvh": "bvh"}


def time_sweep(repeats):
    import jax
    import jax.numpy as jnp
    from tests.fixtures import CBOX_JSON
    from vision_tpu.accel import intersect as isect
    from vision_tpu.accel.sweep_triton import sweep_triton
    from vision_tpu.scene.scene import Scene
    sc = Scene(CBOX_JSON)
    W, H = sc.camera.resolution
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    p_film = jnp.stack([(pix % W).astype(jnp.float32) + 0.5,
                        (pix // W).astype(jnp.float32) + 0.5], -1)
    ray = sc.camera.generate_ray(p_film, jnp.zeros((W * H, 2)))
    ray = ray.replace(t_max=jnp.full((W * H,), 6.0))
    d = sc.data
    tris = (d.tri_p0, d.tri_e1, d.tri_e2)
    kind = jax.devices()[0].device_kind
    n_tri = d.tri_p0.shape[0]
    padded = -(-n_tri // 128) * 128
    fns = {
        "sweep_xla_closest": jax.jit(
            lambda r: isect.intersect_brute(r, *tris).prim_id),
        "sweep_xla_anyhit": jax.jit(lambda r: isect.occluded_brute(r, *tris)),
        "sweep_triton_closest": jax.jit(lambda r: sweep_triton(r, *tris)[1]),
        "sweep_triton_anyhit": jax.jit(
            lambda r: sweep_triton(r, *tris, any_hit=True)[1]),
    }
    for name in ("sweep_xla_closest", "sweep_triton_closest",
                 "sweep_triton_closest", "sweep_xla_closest",
                 "sweep_xla_anyhit", "sweep_triton_anyhit",
                 "sweep_triton_anyhit", "sweep_xla_anyhit"):
        n = padded if "xla" in name else n_tri
        emit(name, median_time(fns[name], ray, repeats=repeats), rays=W * H,
             triangles=n_tri, tested_triangles=n,
             alu_bound_s=W * H * n * MT_FLOPS / PEAK_F32[kind])


def time_render(repeats):
    """End to end, GPU route vs its XLA route, in the order A B B A."""
    import jax
    import vision_tpu
    from tests.fixtures import CBOX_JSON, make_sphere_cbox
    from vision_tpu.accel import intersect as isect
    from vision_tpu.scene.scene import Scene
    choose = isect.choose_route

    def xla_route(*a, **k):
        return _XLA_ROUTE[choose(*a, **k)]

    def run(sc, xla):
        # the route is fixed when the wavefront is traced: recompile
        jax.clear_caches()
        isect.choose_route = xla_route if xla else choose
        try:
            return median_time(lambda: vision_tpu.render(sc, spp=16),
                               repeats=repeats)
        finally:
            isect.choose_route = choose

    for name, desc in (("cbox", CBOX_JSON),
                       ("sphere_cbox", make_sphere_cbox(256, 512))):
        sc = Scene(desc)
        gpu_route = choose(sc.data.bvh is not None, "gpu")
        for xla in (False, True, True, False):
            route = _XLA_ROUTE[gpu_route] if xla else gpu_route
            emit(f"render_{name}_{route}", run(sc, xla), scene=name,
                 triangles=int(sc.data.tri_p0.shape[0]), res=512, depth=8,
                 spp=16)


def time_fetch(repeats):
    import jax
    import jax.numpy as jnp
    R = 512 * 512
    rs = np.random.RandomState(0)
    for n in (36, 256, 512):
        table = jnp.asarray(rs.rand(n, 32).astype(np.float32))
        idx = jnp.asarray(rs.randint(0, n, R).astype(np.int32))
        gather = jax.jit(lambda t, i: t[i])
        onehot = jax.jit(lambda t, i: jax.lax.dot_general(
            (i[:, None] == jnp.arange(t.shape[0])).astype(jnp.bfloat16), t,
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32))
        ok = bool(jnp.array_equal(gather(table, idx), onehot(table, idx)))
        for name, fn in (("fetch_gather", gather), ("fetch_onehot", onehot),
                         ("fetch_onehot", onehot), ("fetch_gather", gather)):
            emit(name, median_time(fn, table, idx, repeats=repeats),
                 lanes=R, rows=n, cols=32, results_equal=ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=("sweep", "fetch", "render"))
    args = ap.parse_args(argv)
    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("time_routes: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"device_kind: {jax.devices()[0].device_kind}")
    for part in args.only:
        {"sweep": time_sweep, "fetch": time_fetch,
         "render": time_render}[part](args.repeats)


if __name__ == "__main__":
    main()
