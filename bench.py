"""Benchmark ladder (BASELINE.md configs) on the accelerator.

Prints ONE JSON line. `metric`/`value`/`unit` track the headline number
(cbox 512^2 d8 path-tracing throughput); `device` names the device and the
card's power limit; `extra` carries the other rungs:

  - staircase_512_d4_mrays: 262k-tri mesh through the BVH route
  - prism_hero_256_mrays:   hero-wavelength dispersion scene
  - cbox_256_d4_grad_mrays: forward+backward (inverse-rendering grad step);
    rays counted are forward-traced rays, time includes the backward sweep
  - staircase_grad_mrays:   the same fwd+bwd metric on a BVH scene
  - kitchen_1M_mrays:       million-triangle scene
  - classroom_rt_ms:        one real-time frame (ReSTIR DI+GI + SHARC +
    SVGF) on classroom 512^2 (BASELINE config 5)

Rays counted are actual traced rays (closest + shadow, active lanes only)
from the integrator's on-device counter.
"""
import json
import os
import subprocess
import time

import jax
import jax.numpy as jnp

RES = 512
DEPTH = 8
WARMUP = 2
ITERS = 16
REF = "/root/reference/res/render_scene"


def _wave_metric(sc, spp, depth, warmup, iters, frame_stride=None):
    from vision_tpu.integrator import pt

    @jax.jit
    def pass_fn(scene, camera, filt, frame0):
        img, aovs = pt.render_wave(scene, camera, filt, frame0,
                                   spp=spp, max_depth=depth)
        return img, aovs["nrays"]

    stride = frame_stride if frame_stride is not None else spp
    nrays_total = 0.0
    for i in range(warmup):
        img, nr = pass_fn(sc.data, sc.camera, sc.filter, jnp.uint32(i))
    img.block_until_ready()
    t0 = time.perf_counter()
    for i in range(iters):
        img, nr = pass_fn(sc.data, sc.camera, sc.filter,
                          jnp.uint32(100 + i * stride))
        nrays_total += float(nr)
    img.block_until_ready()
    dt = time.perf_counter() - t0
    return nrays_total / dt / 1e6


def bench_cbox():
    import copy
    from tests.fixtures import CBOX_JSON
    from vision_tpu.scene.scene import Scene

    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [RES, RES]
    sc = Scene(s)
    return _wave_metric(sc, spp=16, depth=DEPTH, warmup=WARMUP, iters=ITERS)


def bench_staircase():
    from vision_tpu.scene.scene import Scene
    path = os.path.join(REF, "staircase/vision_scene.json")
    if not os.path.exists(path):
        return None
    sc = Scene(path)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [RES, RES]
    sc = Scene(sc.raw, scene_dir=sc.scene_dir)
    return _wave_metric(sc, spp=2, depth=4, warmup=1, iters=2)


def bench_prism():
    from vision_tpu.scene.scene import Scene
    path = os.path.join(REF, "cbox/cbox-prism.json")
    if not os.path.exists(path):
        return None
    sc = Scene(path)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [256, 256]
    sc = Scene(sc.raw, scene_dir=sc.scene_dir)
    return _wave_metric(sc, spp=16, depth=6, warmup=1, iters=4)


def bench_grad():
    """Forward+backward Mrays/s: grad of an L2 image loss w.r.t. material
    floats through the remat'd wavefront (BASELINE 'forward + backward')."""
    import copy
    from tests.fixtures import CBOX_JSON
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt
    from vision_tpu.core import rng

    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [256, 256]
    sc = Scene(s)
    W, H = sc.camera.resolution
    R = W * H
    pix = jnp.arange(R, dtype=jnp.uint32)
    px = (pix % W).astype(jnp.float32)
    py = (pix // W).astype(jnp.float32)
    p_film = jnp.stack([px + 0.5, py + 0.5], -1)
    ray = sc.camera.generate_ray(p_film, jnp.zeros((R, 2)))
    target = jnp.zeros((R, 3))

    mt = sc.data.materials
    mat_floats = {k: v for k, v in vars(mt).items()
                  if hasattr(v, "dtype")
                  and jnp.issubdtype(v.dtype, jnp.floating)}

    def loss_fn(mf, scene, frame):
        scene = scene.replace(materials=scene.materials.replace(**mf))
        st = rng.seed(pix, frame)
        L, aovs = pt.radiance(scene, ray, st, max_depth=4, remat=True)
        return jnp.mean((L - target) ** 2), aovs["nrays"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    (l, nr), g = step(mat_floats, sc.data, jnp.uint32(0))
    jax.block_until_ready(g)
    t0 = time.perf_counter()
    iters = 6
    nrays = 0.0
    for i in range(iters):
        (l, nr), g = step(mat_floats, sc.data, jnp.uint32(i + 1))
        nrays += float(nr)
    jax.block_until_ready(g)
    dt = time.perf_counter() - t0
    return nrays / dt / 1e6


def bench_staircase_grad():
    """Forward+backward on a BVH scene: grad of an L2 loss w.r.t. material
    floats through the remat'd wavefront on staircase 256^2 depth 2."""
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt
    from vision_tpu.core import rng
    path = os.path.join(REF, "staircase/vision_scene.json")
    if not os.path.exists(path):
        return None
    sc = Scene(path)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [256, 256]
    sc = Scene(sc.raw, scene_dir=sc.scene_dir)
    W, H = sc.camera.resolution
    R = W * H
    pix = jnp.arange(R, dtype=jnp.uint32)
    p_film = jnp.stack([(pix % W).astype(jnp.float32) + 0.5,
                        (pix // W).astype(jnp.float32) + 0.5], -1)
    ray = sc.camera.generate_ray(p_film, jnp.zeros((R, 2)))
    target = jnp.zeros((R, 3))
    mt = sc.data.materials
    mat_floats = {k: v for k, v in vars(mt).items()
                  if hasattr(v, "dtype")
                  and jnp.issubdtype(v.dtype, jnp.floating)}

    def loss_fn(mf, scene, frame):
        scene = scene.replace(materials=scene.materials.replace(**mf))
        st = rng.seed(pix, frame)
        L, aovs = pt.radiance(scene, ray, st, max_depth=2, remat=True)
        return jnp.mean((L - target) ** 2), aovs["nrays"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (l, nr), g = step(mat_floats, sc.data, jnp.uint32(0))
    jax.block_until_ready(g)
    t0 = time.perf_counter()
    nrays = 0.0
    for i in range(2):
        (l, nr), g = step(mat_floats, sc.data, jnp.uint32(i + 1))
        nrays += float(nr)
    jax.block_until_ready(g)
    return nrays / (time.perf_counter() - t0) / 1e6


def bench_kitchen():
    """Million-triangle scene (kitchen, 1.05M tris): full PT through the
    BVH route."""
    from vision_tpu.scene.scene import Scene
    path = os.path.join(REF, "kitchen/vision_scene.json")
    if not os.path.exists(path):
        return None
    sc = Scene(path)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [RES, RES]
    sc = Scene(sc.raw, scene_dir=sc.scene_dir)
    return _wave_metric(sc, spp=1, depth=3, warmup=1, iters=2)


def bench_classroom_rt():
    """Real-time integrator frame time on classroom 512^2 (BASELINE config
    5: ReSTIR DI + GI + SHARC + SVGF)."""
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import realtime as rt
    path = os.path.join(REF, "classroom/vision_scene.json")
    if not os.path.exists(path):
        return None
    sc = Scene(path)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [RES, RES]
    sc = Scene(sc.raw, scene_dir=sc.scene_dir)

    frame = jax.jit(lambda scene, cam, state: rt.render_realtime(
        scene, cam, state))
    state = rt.RealTimeState.initial((RES, RES))
    img, state = frame(sc.data, sc.camera, state)
    img.block_until_ready()
    # steady state (temporal reuse warm)
    for _ in range(2):
        img, state = frame(sc.data, sc.camera, state)
    img.block_until_ready()
    t0 = time.perf_counter()
    n = 4
    for _ in range(n):
        img, state = frame(sc.data, sc.camera, state)
    img.block_until_ready()
    return (time.perf_counter() - t0) / n * 1e3


def _device():
    d = jax.devices()[0]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "name_power_limit": smi}


def main():
    out = {}
    mrays = bench_cbox()
    out["metric"] = "cbox_512_d8_pt_throughput"
    out["value"] = round(mrays, 3)
    out["unit"] = "Mrays/s"
    out["device"] = _device()
    extra = {}
    for name, fn in [("staircase_512_d4_mrays", bench_staircase),
                     ("prism_hero_256_mrays", bench_prism),
                     ("cbox_256_d4_grad_mrays", bench_grad),
                     ("staircase_grad_mrays", bench_staircase_grad),
                     ("kitchen_1M_mrays", bench_kitchen),
                     ("classroom_rt_ms", bench_classroom_rt)]:
        try:
            v = fn()
            if v is not None:
                extra[name] = round(v, 3)
        except Exception as e:  # a rung must never sink the headline metric
            extra[name] = f"error: {type(e).__name__}: {e}"
    out["extra"] = extra
    print(json.dumps(out))


if __name__ == "__main__":
    main()
