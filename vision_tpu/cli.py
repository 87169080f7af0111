"""Command-line renderer.

Replaces the reference CLI (`/root/reference/src/base/cli_parser.cpp:18-46`):
  -s scene  -o output  -d device  -p pipeline  -m mode  --denoise
  --clear-cache  -t threads  (+ --spp, --adaptive, --distributed here)
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser("vision-tpu",
                                 description="differentiable path tracer")
    ap.add_argument("-s", "--scene", required=True, help="scene JSON(C) file")
    ap.add_argument("-o", "--output", default=None, help="output image path")
    ap.add_argument("--spp", type=int, default=None, help="samples per pixel")
    ap.add_argument("-d", "--device", default=None, choices=["cpu", "gpu"],
                    help="cpu: run on the CPU; gpu: require a GPU and fail "
                         "without one (default: best available)")
    ap.add_argument("--denoise", action="store_true",
                    help="apply the post denoiser before tonemap")
    ap.add_argument("-p", "--pipeline", default=None,
                    choices=["fixed", "graph", "bake", "realtime"],
                    help="render pipeline plugin (default: scene's choice; "
                         "bake = lightmap bake + display, realtime = "
                         "ReSTIR DI/GI frame loop)")
    ap.add_argument("-m", "--mode", default="cli", choices=["cli"],
                    help="run mode (the reference's gui mode is headless "
                         "by design)")
    ap.add_argument("--clear-cache", action="store_true",
                    help="drop jax's persistent compilation cache before "
                         "rendering (RHIContext::clear_cache analog)")
    ap.add_argument("-t", "--threads", type=int, default=None,
                    help="host CPU device/thread count "
                         "(xla_force_host_platform_device_count)")
    ap.add_argument("--adaptive", action="store_true",
                    help="variance-based adaptive sampling "
                         "(ConvergenceInspector)")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize the JAX multi-process runtime "
                         "(multi-host; run one process per host)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    import os
    if args.threads:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.threads}")
    import jax
    if args.clear_cache:
        try:
            cc_dir = jax.config.jax_compilation_cache_dir
            if cc_dir:
                import shutil
                shutil.rmtree(cc_dir, ignore_errors=True)
        except Exception:
            pass
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif args.device == "gpu" and jax.devices()[0].platform != "gpu":
        raise SystemExit(f"-d gpu: no GPU found (JAX devices: "
                         f"{[d.platform for d in jax.devices()]})")
    if args.distributed:
        from .parallel import launch
        if not launch.init_distributed():
            # the user explicitly asked for multi-host: a silent single-host
            # fallback would render N duplicate images
            raise SystemExit(
                "--distributed: jax.distributed.initialize() failed "
                "(check coordinator address / process env)")

    from .scene.scene import load_scene
    from .render import render, postprocess
    from .sensor import film

    t0 = time.time()
    scene = load_scene(args.scene)
    if not args.quiet:
        print(f"scene loaded: {scene.data.tri_p0.shape[0]} tris, "
              f"{scene.data.materials.kd.shape[0]} materials, "
              f"{scene.data.lights.n_lights} lights "
              f"({time.time() - t0:.2f}s)")

    pipeline = args.pipeline
    if pipeline is None:
        # scene files may declare their pipeline plugin (reference
        # PipelineDesc); 'customized' is the render-graph pipeline
        pt_ = getattr(scene, "pipeline_type", "fixed")
        pipeline = {"bake": "bake", "customized": "graph"}.get(pt_)
    if pipeline == "bake":
        from .pipelines.bake import bake_scene, render_baked
        baked = bake_scene(scene.data, lightmap_res=256,
                           spp=args.spp or 16)
        hdr = render_baked(scene.data, scene.camera, baked)
        import numpy as _np
        hdr = _np.asarray(hdr)
    elif pipeline == "realtime":
        from .integrator import realtime as rt
        import numpy as _np
        state = rt.RealTimeState.initial(scene.camera.resolution)
        frames = max(1, (args.spp or 16))
        acc = None
        for i in range(frames):
            img, state = rt.render_realtime(scene.data, scene.camera, state)
            w = 1.0 / (i + 1)
            acc = img if acc is None else acc * (1 - w) + img * w
        hdr = _np.asarray(acc)
    elif pipeline == "graph":
        from .pipelines.graph import default_graph
        import jax.numpy as jnp
        import numpy as _np
        g = default_graph(scene.data, scene.camera, scene.filter)
        out_g = g.execute(ctx={"frame_index": jnp.uint32(0),
                               "max_depth": scene.max_depth,
                               "tone_mapper": scene.tone_mapper,
                               "exposure": scene.exposure})
        # the graph's accum output is linear HDR pre-tonemap
        hdr = _np.asarray(out_g["accum"])
    else:
        hdr = render(scene, spp=args.spp, verbose=not args.quiet,
                     adaptive=args.adaptive)
    if args.denoise:
        from .post.denoise import denoise_simple
        hdr = denoise_simple(hdr)
    img = postprocess(scene, hdr)
    out = args.output or scene.output_fn
    if out.endswith(".exr"):
        film.to_exr(hdr, out)
    else:
        film.to_png(img, out)
    if not args.quiet:
        print(f"wrote {out} ({time.time() - t0:.2f}s total)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
