"""Classroom rung (BASELINE config 5): real-time integrator accumulation
to the 1024spp target + differentiable texture/light recovery on the real
scene.

Artifacts:
  gallery/classroom_rt_accum.png  — ReSTIR DI+GI+SHARC+SVGF frames
                                    accumulated to N samples/pixel
  CLASSROOM_DEMO.json             — frame time, accumulation stats, and
                                    the recovery loss curve

Usage: python tools/classroom_demo.py [res] [frames] [opt_steps]
"""
import json
import os
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import jax
import jax.numpy as jnp

SCENE = "/root/reference/res/render_scene/classroom/vision_scene.json"


def log(m):
    print(f"[{time.strftime('%H:%M:%S')}] {m}", flush=True)


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    opt_steps = int(sys.argv[3]) if len(sys.argv) > 3 else 24
    section = sys.argv[4] if len(sys.argv) > 4 else "all"

    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import realtime as rt
    from vision_tpu.sensor import film
    from vision_tpu.render import postprocess

    out = {}
    if os.path.exists("CLASSROOM_DEMO.json"):
        out = json.load(open("CLASSROOM_DEMO.json"))
    sc = Scene(SCENE)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [res, res]
    sc = Scene(sc.raw, scene_dir=sc.scene_dir)
    log(f"classroom: {sc.data.tri_p0.shape[0]} tris res={res}")

    # ---- real-time accumulation to the spp target ----
    if section in ("all", "accum"):
        _accum(sc, res, frames, out)
    if section in ("all", "opt"):
        _optimize(sc, res, opt_steps, out)
    json.dump(out, open("CLASSROOM_DEMO.json", "w"), indent=1)
    log("wrote CLASSROOM_DEMO.json")


def _accum(sc, res, frames, out):
    import jax
    from vision_tpu.integrator import realtime as rt
    from vision_tpu.sensor import film
    from vision_tpu.render import postprocess
    import jax.numpy as jnp
    import numpy as np
    frame = jax.jit(lambda scene, cam, state: rt.render_realtime(
        scene, cam, state))
    state = rt.RealTimeState.initial((res, res))
    # two warmup calls: the state pytree changes shape after frame 1
    # (gbuffer None -> arrays), which forces a second trace/compile
    img, state = frame(sc.data, sc.camera, state)
    img.block_until_ready()
    img, state = frame(sc.data, sc.camera, state)
    img.block_until_ready()
    t0 = time.perf_counter()
    img, state = frame(sc.data, sc.camera, state)
    img.block_until_ready()
    ms = (time.perf_counter() - t0) * 1e3
    out["rt_ms_per_frame"] = round(ms, 1)
    out["resolution"] = res
    log(f"rt frame: {ms:.0f} ms  -> accumulating {frames} frames "
        f"(~{ms * frames / 1e3:.0f}s)")
    accum = jnp.asarray(img)
    t0 = time.perf_counter()
    for i in range(1, frames):
        img, state = frame(sc.data, sc.camera, state)
        w = 1.0 / (i + 1)
        accum = accum * (1.0 - w) + img * w
        # block every few frames: bound the async chain of dependent
        # launches in flight
        if i % 16 == 0:
            accum.block_until_ready()
        if i % 128 == 0:
            log(f"  frame {i}/{frames} "
                f"({(time.perf_counter()-t0)/i*1e3:.0f} ms/frame avg)")
    accum.block_until_ready()
    out["accum_frames"] = frames
    out["accum_seconds"] = round(time.perf_counter() - t0, 1)
    # steady-state frame time from the accumulation loop itself (immune
    # to warmup retraces)
    out["rt_ms_steady"] = round(out["accum_seconds"] / max(frames - 1, 1)
                                * 1e3, 1)
    ldr = postprocess(sc, np.asarray(accum))
    film.to_png(ldr, "gallery/classroom_rt_accum.png")
    log(f"wrote gallery/classroom_rt_accum.png "
        f"({out['accum_seconds']}s for {frames} frames)")


def _optimize(sc, res, opt_steps, out):
    # ---- differentiable texture/light recovery on the real scene ----
    import time
    import jax.numpy as jnp
    from vision_tpu.scene.scene import Scene
    from vision_tpu.diff import optimize as opt
    res_o = min(res, 128)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [res_o, res_o]
    sco = Scene(sc.raw, scene_dir=sc.scene_dir)

    # target through the SAME render path + RNG stream the loss uses
    target = opt.render_with_params(sco.data, sco.camera, {}, 7,
                                    max_depth=3)
    target.block_until_ready()
    log("target rendered; perturbing materials+lights and recovering")

    # perturb: scale all material albedos and the light color
    mt = sco.data.materials
    lt_ = sco.data.lights
    pert = sco.data.replace(
        materials=mt.replace(kd=jnp.clip(mt.kd * 0.4 + 0.3, 0, 1)),
        lights=lt_.replace(color=lt_.color * 2.5))
    sco.data = pert
    t0 = time.perf_counter()
    params, losses = opt.optimize_scene(
        sco.data, sco.camera, target, groups=("materials", "lights"),
        steps=opt_steps, lr=5e-2, max_depth=3, verbose=True,
        fixed_frame=7)
    out["opt_steps"] = opt_steps
    out["opt_seconds"] = round(time.perf_counter() - t0, 1)
    out["opt_loss_first"] = round(losses[0], 6)
    out["opt_loss_last"] = round(losses[-1], 6)
    log(f"recovery: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"in {out['opt_seconds']}s")


if __name__ == "__main__":
    main()
