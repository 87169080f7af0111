"""End-to-end smoke test of the renderer on NVIDIA GPUs.

    python chip_smoke.py                 # phases 1-6 on one GPU
    python chip_smoke.py --four-cards    # sharded render + training step,
                                         # 1 GPU vs 4 GPUs, nothing else
    python chip_smoke.py --out DIR       # also keep the rendered PNGs in DIR

Drives the main path through the entry points a user calls (the CLI
in-process, `vision_tpu.render`, `pt.radiance` under `jax.grad`,
`realtime.render_realtime`) on generated scenes at the widths users render,
and checks every output: against the numpy referee (tests/ref_renderer.py),
against the same jitted code on the CPU backend, and the BVH traversal
against the dense sweep. Any failed check raises, so the script exits
non-zero; without a GPU it exits non-zero before printing anything. The
last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Everything runs in this one process (a JAX process reserves most of a
card's memory).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def expect(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def _require_gpus(count):
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        sys.stderr.write(f"chip_smoke: needs {count} GPU(s); JAX found "
                         f"{[d.platform for d in devices]}\n")
        raise SystemExit(2)
    return devices


def _timed(label, fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    print(f"  {label}: {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def _film_rays(camera, seed=0):
    """One primary ray per pixel through a seeded jittered film point."""
    import jax.numpy as jnp
    W, H = camera.resolution
    pix = np.arange(W * H)
    off = np.random.RandomState(seed).rand(W * H, 2)
    p_film = jnp.asarray(np.stack([pix % W, pix // W], -1) + off, jnp.float32)
    return camera.generate_ray(p_film, jnp.zeros((W * H, 2)))


def _compare_images(a, b, what):
    """Lane-wise agreement: < 2% of pixels beyond 1e-3 + 1e-3 |ref|, image
    means within 1%. Float differences between backends flip a few
    discrete events (edge hits, roulette), which moves whole paths."""
    a = np.asarray(a).reshape(-1, 3)
    b = np.asarray(b).reshape(-1, 3)
    expect(np.isfinite(a).all() and np.isfinite(b).all(), f"{what}: finite")
    bad = (np.abs(a - b) > 1e-3 + 1e-3 * np.abs(b)).any(-1).mean()
    rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    print(f"  {what}: {bad * 100:.3f}% pixels differ, means "
          f"{a.mean():.6f} vs {b.mean():.6f} (rel {rel:.2e})")
    expect(bad < 0.02, f"{what}: < 2% of pixels differ")
    expect(rel < 0.01, f"{what}: image means within 1%")


def _wave(scene, spp, frame0=0):
    from vision_tpu.render import _wave_pass
    import jax.numpy as jnp
    return _wave_pass(scene.data, scene.camera, scene.filter,
                      jnp.uint32(frame0), spp, scene.max_depth,
                      scene.min_depth, jnp.float32(scene.rr_threshold))[0]


def _on_cpu(tree):
    import jax
    return jax.device_put(tree, jax.devices("cpu")[0])


def _scene(desc, res=None, scene_dir="."):
    from vision_tpu.scene.scene import Scene
    desc = copy.deepcopy(desc)
    if res is not None:
        desc["camera"]["param"]["radiance_collector"]["param"][
            "resolution"] = [res, res]
    t0 = time.perf_counter()
    sc = Scene(desc, scene_dir=scene_dir)
    print(f"  scene build ({sc.data.tri_p0.shape[0]} triangles, "
          f"{sc.camera.resolution[0]}x{sc.camera.resolution[1]}): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return sc


# ----------------------------------------------------------------- phases
def phase_device():
    import jax
    from vision_tpu.accel import cuda_trace
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    d = jax.devices()[0]
    print(f"jax {jax.__version__}: {len(jax.devices())} x {d.device_kind}")
    t0 = time.perf_counter()
    err = cuda_trace.load()
    print(f"  set-up: traversal kernel build + load "
          f"{time.perf_counter() - t0:.3f} s")
    expect(err is None, f"traversal kernel loaded ({err})")


def phase_small(out_dir, res=512, spp=64, ref_res=32, ref_spp=24,
                cmp_res=128, cmp_spp=8):
    from tests.fixtures import CBOX_JSON
    from tests.ref_renderer import RefTracer
    from vision_tpu import cli
    from vision_tpu.core.imageio import read_png
    from vision_tpu.integrator import pt
    import jax
    import jax.numpy as jnp

    desc = copy.deepcopy(CBOX_JSON)
    desc["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [res, res]
    desc["integrator"]["param"]["max_depth"] = 8
    path = os.path.join(out_dir, "cbox.json")
    png = os.path.join(out_dir, "cbox_cli.png")
    with open(path, "w") as f:
        json.dump(desc, f)
    t0 = time.perf_counter()
    rc = cli.main(["-s", path, "-o", png, "--spp", str(spp), "-d", "gpu",
                   "-q"])
    print(f"  cli render {res}^2 d8 {spp}spp (compile included): "
          f"{time.perf_counter() - t0:.3f} s")
    img = read_png(png)
    expect(rc == 0 and img.shape == (res, res, 3), "CLI wrote the PNG")
    expect(img.mean() > 10, f"CLI image is lit (mean {img.mean():.1f}/255)")

    # absolute energy against the independent numpy referee
    ref = RefTracer(CBOX_JSON, seed=3)
    sc = _scene(CBOX_JSON, ref_res)
    fn = jax.jit(lambda sd, c, f, i, depth: pt.render_sample(
        sd, c, f, i, max_depth=depth, min_depth=99)[0],
        static_argnums=4)
    for depth in (1, 2, 4):
        ours = sum(np.asarray(fn(sc.data, sc.camera, sc.filter,
                                 jnp.uint32(700 + i), depth))
                   for i in range(ref_spp)) / ref_spp
        theirs = ref.render(ref_res, ref_spp, depth)
        rel = abs(ours.mean() - theirs.mean()) / theirs.mean()
        expect(rel < 0.06, f"referee depth {depth}: means {ours.mean():.5f} "
               f"vs {theirs.mean():.5f} within 6% ({rel * 100:.2f}%)")

    # same jitted code on the CPU backend
    sc = _scene(CBOX_JSON, cmp_res)
    gpu = _timed("wave GPU", _wave, sc, cmp_spp)
    sc_cpu = copy.copy(sc)
    sc_cpu.data, sc_cpu.camera, sc_cpu.filter = _on_cpu(
        (sc.data, sc.camera, sc.filter))
    cpu = _timed("wave CPU", _wave, sc_cpu, cmp_spp)
    _compare_images(gpu, cpu, f"cbox {cmp_res}^2 {cmp_spp}spp GPU vs CPU")


def traversal_check(data, camera, n_rays=65536, seed=0):
    """Route in use vs the dense sweep on camera primaries plus seeded
    random rays from inside the box."""
    import jax
    import jax.numpy as jnp
    from vision_tpu.accel import intersect as isect
    from vision_tpu.core.types import Ray

    prim = _film_rays(camera.replace(resolution=(128, 128)), seed=seed)
    n_rand = n_rays - prim.origin.shape[0]
    rs = np.random.RandomState(seed)
    o = rs.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n_rand, 3))
    d = rs.randn(n_rand, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    o = jnp.concatenate([prim.origin, f32(o)])
    d = jnp.concatenate([prim.direction, f32(d)])
    ray = Ray.make(o, d)
    shadow = Ray(origin=o, direction=d,
                 t_max=f32(rs.uniform(0.05, 2.0, n_rays)))

    closest = jax.jit(lambda sd, r: isect.trace(sd, r))
    occluded = jax.jit(lambda sd, r: isect.trace(sd, r, any_hit=True))
    brute = jax.jit(lambda sd, r: isect.intersect_brute(
        r, sd.tri_p0, sd.tri_e1, sd.tri_e2))
    brute_occ = jax.jit(lambda sd, r: isect.occluded_brute(
        r, sd.tri_p0, sd.tri_e1, sd.tri_e2))
    xla = jax.jit(lambda sd, r, any_hit: isect.intersect_bvh(
        r, sd.bvh, any_hit=any_hit), static_argnums=2)

    ref = brute(data, ray)
    ref_occ = np.asarray(brute_occ(data, shadow))
    id_r, t_r = np.asarray(ref.prim_id), np.asarray(ref.t)
    routes = [("route in use", lambda: closest(data, ray),
               lambda: occluded(data, shadow))]
    if data.bvh is not None:
        routes.append(("XLA LBVH walk", lambda: xla(data, ray, False),
                       lambda: xla(data, shadow, True)))
    for name, run, run_occ in routes:
        hit, trunc = run()
        hit_o, trunc_o = run_occ()
        occ = np.asarray(getattr(hit_o, "prim_id", hit_o))
        occ = occ if occ.dtype == bool else occ >= 0
        ids = np.asarray(hit.prim_id)
        same = ids == id_r
        both = same & (id_r >= 0)
        t_err = (np.abs(np.asarray(hit.t) - t_r) / np.maximum(t_r, 1e-30))[both]
        print(f"  {name}: prim agree {same.mean() * 100:.4f}%, hits "
              f"{(id_r >= 0).mean() * 100:.1f}%, max rel t err "
              f"{t_err.max() if both.any() else 0:.2e}, occlusion agree "
              f"{(occ == ref_occ).mean() * 100:.4f}% "
              f"(occluded {ref_occ.mean() * 100:.1f}%)")
        expect(same.mean() >= 0.999, f"{name}: prim_id agrees on >= 99.9%")
        expect(both.any() and t_err.max() <= 1e-5,
               f"{name}: t agrees to 1e-5 where prim_id agrees")
        expect((occ == ref_occ).mean() >= 0.999,
               f"{name}: occlusion agrees on >= 99.9%")
        expect(int(trunc) == 0 and int(trunc_o) == 0,
               f"{name}: 0 truncated lanes")


def phase_large(out_dir, sub_div=256, res=512, spp=16, n_rays=65536):
    import jax.numpy as jnp
    import vision_tpu
    from tests.fixtures import make_sphere_cbox
    from vision_tpu.render import _wave_pass
    from vision_tpu.sensor import film

    sc = _scene(make_sphere_cbox(sub_div, res))
    expect(sc.data.bvh is not None and sc.data.sah is not None,
           f"{sc.data.tri_p0.shape[0]} triangles take the BVH route")
    traversal_check(sc.data, sc.camera, n_rays)
    t0 = time.perf_counter()
    _wave_pass.lower(sc.data, sc.camera, sc.filter, jnp.uint32(0), 8,
                     sc.max_depth, sc.min_depth,
                     jnp.float32(sc.rr_threshold)).compile()
    print(f"  compile: render wave pass, 8-spp chunk: "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    vision_tpu.render(sc, spp=8)
    print(f"  render warm-up 8spp (compile included): "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    hdr = vision_tpu.render(sc, spp=spp)
    print(f"  render {res}^2 d{sc.max_depth} {spp}spp: "
          f"{time.perf_counter() - t0:.3f} s")
    expect(hdr.shape == (res, res, 3) and np.isfinite(hdr).all(),
           "large render finite")
    expect(hdr.mean() > 0.01, f"large render lit (mean {hdr.mean():.4f})")
    film.to_png(vision_tpu.postprocess(sc, hdr),
                os.path.join(out_dir, "sphere_cbox.png"))
    return sc


def phase_repeated(out_dir, n=4, sub_div=128, res=128, spp=8):
    from tests.fixtures import flatten_by_hand, make_repeated_cbox
    desc = make_repeated_cbox(n, sub_div, res)
    inst = _scene(desc)
    by_hand = _scene(flatten_by_hand(desc, out_dir), scene_dir=out_dir)
    expect(inst.data.bvh is not None
           and inst.data.tri_p0.shape == by_hand.data.tri_p0.shape,
           f"{n} repeated meshes flattened into one soup")
    _compare_images(_wave(inst, spp), _wave(by_hand, spp),
                    "repeated meshes vs placed by hand")


def grad_step(scene, res=256, depth=4):
    """value_and_grad of an L2 image loss over materials + camera pose
    through the remat'd wavefront (the inverse-rendering step)."""
    import jax
    import jax.numpy as jnp
    from vision_tpu.core import rng
    from vision_tpu.diff.optimize import apply_params, param_surface
    from vision_tpu.integrator import pt

    camera = scene.camera.replace(resolution=(res, res))
    pix = jnp.arange(res * res, dtype=jnp.uint32)
    p_film = jnp.stack([(pix % res).astype(jnp.float32) + 0.5,
                        (pix // res).astype(jnp.float32) + 0.5], -1)

    def loss(params, data, cam):
        data, cam = apply_params(data, cam, params)
        L, aovs = pt.radiance(data, cam.generate_ray(p_film),
                              rng.seed(pix, jnp.uint32(1)),
                              max_depth=depth, remat=True)
        return jnp.mean(L * L), aovs["truncated"]

    params = param_surface(scene.data, camera, ("materials", "camera"))
    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return step, (params, scene.data, camera)


def phase_grad(name, scene, res=256, depth=4):
    import jax
    step, args = grad_step(scene, res, depth)
    (l_g, tr), g_g = _timed(f"{name} grad step GPU (compile included)",
                            step, *args)
    _timed(f"{name} grad step GPU", step, *args)
    leaves = jax.tree.leaves(g_g)
    expect(np.isfinite(float(l_g)) and all(np.isfinite(np.asarray(x)).all()
                                           for x in leaves),
           f"{name}: loss {float(l_g):.6f} and gradients finite")
    expect(int(tr) == 0, f"{name}: 0 truncated lanes")
    (l_c, _), g_c = _timed(f"{name} grad step CPU", step, *_on_cpu(args))
    a = np.concatenate([np.ravel(x) for x in
                        jax.tree.leaves(g_g["materials"])])
    b = np.concatenate([np.ravel(x) for x in
                        jax.tree.leaves(g_c["materials"])])
    norm = abs(np.linalg.norm(a) - np.linalg.norm(b)) / np.linalg.norm(b)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    print(f"  {name}: loss GPU {float(l_g):.6f} CPU {float(l_c):.6f}, "
          f"material grad norm rel diff {norm:.2e}, cosine {cos:.6f}")
    expect(norm < 0.02 and cos >= 0.99,
           f"{name}: material gradient matches CPU (2% norm, cos 0.99)")


def phase_realtime(scene, res=512, frames=3):
    import jax
    from vision_tpu.integrator import realtime as rt
    camera = scene.camera.replace(resolution=(res, res))
    frame = jax.jit(rt.render_realtime)
    state = rt.RealTimeState.initial((res, res))
    for i in range(frames):
        img, state = _timed(f"real-time frame {i}", frame, scene.data,
                            camera, state)
    img = np.asarray(img)
    expect(img.shape == (res, res, 3) and np.isfinite(img).all(),
           "real-time frames finite")
    expect(img.mean() > 0.01, f"real-time frame lit (mean {img.mean():.4f})")


def phase_four_cards(devices, res=512):
    """render_sharded and training_step over a 1-card mesh and a 4-card
    (dp=4, sp=1) mesh: same seed, same result."""
    import jax
    from tests.fixtures import CBOX_JSON, make_sphere_cbox
    from vision_tpu.parallel import dist
    one = dist.make_mesh(devices[:1])
    four = dist.make_mesh(devices[:4])
    for name, desc in (("cbox", CBOX_JSON),
                       ("sphere cbox", make_sphere_cbox(256, res))):
        sc = _scene(desc, res)
        img1, img4 = (_timed(f"{name} render_sharded dp={m.shape['dp']} "
                             "(compile included)", dist.render_sharded,
                             sc.data, sc.camera, sc.filter, 0, m)
                      for m in (one, four))
        _compare_images(img4, img1, f"{name} 4 cards vs 1")
        target = np.zeros((res, res, 3), np.float32)
        (l1, g1), (l4, g4) = (
            _timed(f"{name} training_step dp={m.shape['dp']} "
                   "(compile included)", dist.training_step, sc.data,
                   sc.camera, sc.filter, 0, m, target) for m in (one, four))
        rel = abs(float(l4) - float(l1)) / abs(float(l1))
        a = np.concatenate([np.ravel(x) for x in jax.tree.leaves(g4)])
        b = np.concatenate([np.ravel(x) for x in jax.tree.leaves(g1)])
        norm = abs(np.linalg.norm(a) - np.linalg.norm(b)) / np.linalg.norm(b)
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        print(f"  {name}: loss {float(l4):.6f} vs {float(l1):.6f}, grad "
              f"norm rel diff {norm:.2e}, cosine {cos:.6f}")
        expect(rel < 1e-3, f"{name}: training loss within 1e-3")
        expect(norm < 0.02 and cos >= 0.99,
               f"{name}: gradients within 2% norm, cosine >= 0.99")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 1-vs-4-GPU sharded render and "
                         "training step")
    ap.add_argument("--out", default=None,
                    help="directory for the rendered images "
                         "(default: a temporary directory)")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    devices = _require_gpus(count)
    import jax
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        print("phase 1: device", flush=True)
        phase_device()
        if args.four_cards:
            print("phase D: four cards", flush=True)
            phase_four_cards(devices)
        else:
            print("phase 2: small scene, offline", flush=True)
            phase_small(out_dir)
            print("phase 3: large scene, offline", flush=True)
            large = phase_large(out_dir)
            print("phase 4: repeated meshes", flush=True)
            phase_repeated(out_dir)
            print("phase 5: inverse rendering", flush=True)
            from tests.fixtures import CBOX_JSON
            phase_grad("cbox", _scene(CBOX_JSON, 256))
            phase_grad("sphere cbox", large)
            print("phase 6: real-time", flush=True)
            phase_realtime(large)
    print(f"total: {time.perf_counter() - t_start:.3f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
