"""Render the gallery + parity artifacts on the GPU.

Produces gallery/*.png, a CPU-vs-GPU consistency check (BASELINE.md
'match CPU reference' criterion), and a PSNR comparison against the
reference's own 20000spp golden render of the cornell box.
"""
import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
warnings.simplefilter("ignore")

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "gallery")
os.makedirs(OUT, exist_ok=True)

REF = "/root/reference/res/render_scene"


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def main():
    import jax
    import jax.numpy as jnp
    from vision_tpu.scene.scene import Scene
    from vision_tpu.render import render, postprocess
    from vision_tpu.sensor import film

    report = {}

    def do(name, scene_path_or_dict, spp, res=None, scene_dir=None):
        t0 = time.time()
        sc = Scene(scene_path_or_dict, scene_dir=scene_dir)
        if res:
            sc.resolution = (res, res)
            sc.camera = sc.camera.replace(resolution=(res, res))
        hdr = render(sc, spp=spp)
        img = postprocess(sc, hdr)
        film.to_png(img, os.path.join(OUT, f"{name}.png"))
        dt = time.time() - t0
        report[name] = {"spp": spp, "res": sc.resolution, "sec": round(dt, 1)}
        print(f"[gallery] {name}: {dt:.1f}s", flush=True)
        return sc, hdr, img

    # 1. canonical cornell box (our fixture scene) — ladder config 1
    from tests.fixtures import CBOX_JSON, make_glass_cbox
    import copy
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [512, 512]
    sc, _, _ = do("cbox_512_256spp", s, 256)

    # CPU-vs-GPU consistency (few-spp, identical RNG)
    from vision_tpu.render import _render_pass
    img_t, _ = _render_pass(sc.data, sc.camera, sc.filter, jnp.uint32(0),
                            sc.max_depth, sc.min_depth, jnp.float32(1.0))
    img_t = np.asarray(img_t)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        sc_cpu = Scene(s)
        img_c, _ = _render_pass(sc_cpu.data, sc_cpu.camera,
                                sc_cpu.filter, jnp.uint32(0),
                                sc_cpu.max_depth, sc_cpu.min_depth,
                                jnp.float32(1.0))
        img_c = np.asarray(img_c)
    diff = np.abs(img_t - img_c)
    frac_close = float((diff < 1e-3).mean())
    report["cpu_gpu_consistency"] = {
        "frac_within_1e-3": round(frac_close, 4),
        "frac_within_1e-2": round(float((diff < 1e-2).mean()), 4),
        "median_absdiff": float(np.median(diff)),
    }
    print(f"[parity] CPU-vs-GPU 1spp: {frac_close:.3f} of values within 1e-3",
          flush=True)

    # 2. glass + mirror cornell (ladder config 2: BVH-free dielectrics)
    g = make_glass_cbox()
    g["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [512, 512]
    do("cbox_glass_mirror_256spp", g, 256)

    # 3. hero-wavelength dispersion (ladder config 3)
    h = make_glass_cbox()
    h["camera"]["param"]["radiance_collector"]["param"]["resolution"] = [384, 384]
    h["spectrum"] = {"type": "hero", "param": {"dimension": 4}}
    do("cbox_glass_hero_dispersion_256spp", h, 256)

    # 4. the reference's own scene file (checker texture, ACES, spot+point+
    #    projector lights) vs its 20000spp golden
    sc_ref, hdr_ref, img_ref = do(
        "ref_vision_scene_512_384spp",
        f"{REF}/cbox/vision_scene.json", 384, res=512)
    golden_path = f"{REF}/cbox/20000spp.png"
    if os.path.exists(golden_path):
        from PIL import Image
        golden = np.asarray(Image.open(golden_path).convert("RGB"),
                            np.float32) / 255.0
        golden = np.asarray(Image.fromarray(
            (golden * 255).astype(np.uint8)).resize((512, 512)),
            np.float32) / 255.0
        p = psnr(img_ref, golden)
        report["psnr_vs_reference_golden"] = round(p, 2)
        print(f"[parity] PSNR vs reference 20000spp golden: {p:.2f} dB",
              flush=True)

    # 5. mesh-heavy scene through the BVH (cbox.json, 14k tris)
    do("cbox_meshes_128spp", f"{REF}/cbox/cbox.json", 128, res=384)

    # 6. large scenes through the SAH packet BVH (ladder configs 4/5)
    do("staircase_512_64spp", f"{REF}/staircase/vision_scene.json", 64,
       res=512)
    do("classroom_512_64spp", f"{REF}/classroom/vision_scene.json", 64,
       res=512)
    do("prism_hero_256_128spp", f"{REF}/cbox/cbox-prism.json", 128, res=256)

    # 7. light_field framebuffer: 3x3 sub-aperture grid over a wide-open
    #    thin lens + shift-sum refocus to near/far planes
    t0 = time.time()
    from vision_tpu.render import render_light_field
    from vision_tpu.sensor import light_field as lfm
    lf_s = copy.deepcopy(CBOX_JSON)
    lf_s["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [192, 192]
    lf_s["camera"]["param"]["lens_radius"] = 0.22
    lf_s["camera"]["param"]["focal_distance"] = 5.5
    sc_lf = Scene(lf_s)
    tiles = render_light_field(sc_lf, spp=64, grid=3)
    film.to_png(postprocess(sc_lf, np.asarray(lfm.mosaic(tiles))),
                os.path.join(OUT, "lightfield_grid_3x3.png"))
    near = np.asarray(lfm.refocus(tiles, 10.0))
    far = np.asarray(lfm.refocus(tiles, -10.0))
    film.to_png(postprocess(sc_lf, np.concatenate([near, far], axis=1)),
                os.path.join(OUT, "lightfield_refocus_near_far.png"))
    report["lightfield"] = {"grid": 3, "spp": 64,
                            "sec": round(time.time() - t0, 1)}
    print(f"[gallery] lightfield: {report['lightfield']['sec']}s",
          flush=True)

    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
