"""Golden-image parity vs the reference's shipped ground truth.

The reference keeps external ground-truth renders next to its cbox scene
(`/root/reference/res/render_scene/cbox/TungstenRender.png` — the classic
cornell box rendered by Tungsten; `20000spp.png` is a different, newer scene
variant whose HDRI asset is absent from the snapshot). BASELINE.md demands
PSNR-vs-golden verification; this is it. Calibration: 128px/16spp/d8 on CPU
scores ~26 dB (MC noise dominated).
Threshold set at 24 dB — structural breakage (wrong MIS weight, flipped
walls, energy bug) drops this below 15 dB immediately.
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

GOLD = "/root/reference/res/render_scene/cbox/TungstenRender.png"


def _srgb(x):
    x = np.clip(x, 0, 1)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)


def _psnr(a, b):
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.skipif(not os.path.exists(GOLD), reason="golden asset missing")
def test_cbox_psnr_vs_tungsten_golden():
    from PIL import Image
    from tests.fixtures import CBOX_JSON
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt

    RES, SPP = 128, 16
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [RES, RES]
    sc = Scene(s)
    fn = jax.jit(lambda sd, c, f, i: pt.render_sample(sd, c, f, i,
                                                      max_depth=8)[0])
    acc = 0.0
    for i in range(SPP):
        acc = acc + fn(sc.data, sc.camera, sc.filter, jnp.uint32(i))
    out = _srgb(np.asarray(acc / SPP))

    g = np.asarray(Image.open(GOLD))[..., :3].astype(np.float32) / 255.0
    k = 1024 // RES
    g = g.reshape(RES, k, RES, k, 3).mean((1, 3))
    p = _psnr(out, g)
    assert p > 24.0, f"PSNR vs Tungsten golden dropped to {p:.2f} dB"
    # brightness parity (catches double-counted MIS / missing NEE)
    assert abs(out.mean() - g.mean()) < 0.03


@pytest.mark.skipif(not os.path.exists(GOLD), reason="golden asset missing")
def test_cbox_linear_error_vs_tungsten():
    """Linear-radiance parity vs the EXTERNAL golden — a COARSE anchor.
    What bounds its tightness (all verified, see also test_referee.py for
    the exact-energy verification):
      * the Tungsten scene declares tonemap "gamma" (tungsten_scene.json),
        so the PNG decodes with gamma 2.2, but any exposure step in the
        chain is unknown (the EXR is PIZ-compressed; no decoder here);
      * the fixture follows vision's cbox.json recreation, whose box
        rotations differ slightly from the Tungsten originals (visible as
        localized silhouette/face-shading differences);
      * Tungsten's light quad is a WHITE (albedo 1) reflector; vision's
        is black.
    Measured calibration: bias ~ -5%, block-weighted error ~0.20. A wrong
    filter curve, gamma, or MIS weight jumps far past the thresholds."""
    from PIL import Image
    from tests.fixtures import CBOX_JSON
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt

    RES, SPP = 128, 24
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [RES, RES]
    sc = Scene(s)
    fn = jax.jit(lambda sd, c, f, i: pt.render_sample(sd, c, f, i,
                                                      max_depth=16)[0])
    acc = 0.0
    for i in range(SPP):
        acc = acc + fn(sc.data, sc.camera, sc.filter, jnp.uint32(i))
    ours = np.asarray(acc / SPP)  # linear radiance

    g8 = np.asarray(Image.open(GOLD))[..., :3].astype(np.float32) / 255.0
    glin = np.power(g8, 2.2)
    k = 1024 // RES
    gldr = g8.reshape(RES, k, RES, k, 3).mean((1, 3))
    glin = glin.reshape(RES, k, RES, k, 3).mean((1, 3))
    # exclude clipped golden pixels (the light) where 8-bit LDR saturates
    mask = (gldr < 0.95).all(-1)

    # block-average (8x8) so CI spp noise doesn't dominate, then
    # luminance-weighted absolute error
    B = 8
    ob = ours.reshape(RES // B, B, RES // B, B, 3).mean((1, 3))
    gb = glin.reshape(RES // B, B, RES // B, B, 3).mean((1, 3))
    mb = mask.reshape(RES // B, B, RES // B, B).mean((1, 3)) > 0.99
    werr = np.abs(ob - gb)[mb].sum() / gb[mb].sum()
    assert werr < 0.25, f"luminance-weighted linear error {werr:.4f}"
    bias = (ours - glin)[mask].mean() / max(glin[mask].mean(), 1e-6)
    assert abs(bias) < 0.08, f"linear brightness bias {bias:+.4f}"


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.skipif(
    not os.path.exists(os.path.join(GOLDEN_DIR, "cbox_hdr.npz")),
    reason="repo golden not generated (tools/gen_golden.py)")
def test_cbox_hdr_self_golden():
    """Tight linear-HDR regression net: CI render vs the repo-internal
    1024spp golden (tools/gen_golden.py, rendered on chip). Block
    averaging pushes CI noise to ~2%, so a >2.5% energy shift or >6%
    weighted error is a real regression."""
    from tests.fixtures import CBOX_JSON
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt

    gold = np.load(os.path.join(GOLDEN_DIR, "cbox_hdr.npz"))["img"]
    RES, SPP = 128, 24
    s = copy.deepcopy(CBOX_JSON)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [RES, RES]
    sc = Scene(s)
    fn = jax.jit(lambda sd, c, f, i: pt.render_sample(sd, c, f, i,
                                                      max_depth=8)[0])
    acc = 0.0
    for i in range(SPP):
        acc = acc + fn(sc.data, sc.camera, sc.filter, jnp.uint32(100 + i))
    ours = np.asarray(acc / SPP)

    B = 8
    ob = ours.reshape(RES // B, B, RES // B, B, 3).mean((1, 3))
    gb = gold.reshape(RES // B, B, RES // B, B, 3).mean((1, 3))
    werr = np.abs(ob - gb).sum() / gb.sum()
    bias = (ob - gb).mean() / gb.mean()
    assert werr < 0.06, f"weighted HDR error vs self-golden {werr:.4f}"
    assert abs(bias) < 0.025, f"HDR energy bias {bias:+.4f}"


PRISM = "/root/reference/res/render_scene/cbox/cbox-prism.json"


@pytest.mark.skipif(not os.path.exists(PRISM), reason="prism scene missing")
def test_prism_dispersion_golden():
    """Hero-wavelength dispersion golden (BASELINE rung 3): the prism
    scene rendered with the hero spectrum must produce spectrally-split
    (saturated) bright caustics that the 3-channel srgb spectrum cannot,
    while total energy stays comparable."""
    from vision_tpu.scene.scene import Scene
    from vision_tpu.render import render

    sc = Scene(PRISM)
    sc.raw["camera"]["param"]["radiance_collector"]["param"][
        "resolution"] = [48, 48]
    sc_hero = Scene(sc.raw, scene_dir=sc.scene_dir)
    assert sc_hero.spectrum_type == "hero"
    img_h = render(sc_hero, spp=4)

    raw2 = copy.deepcopy(sc.raw)
    raw2["spectrum"] = {"type": "srgb"}
    sc_srgb = Scene(raw2, scene_dir=sc.scene_dir)
    img_s = render(sc_srgb, spp=4)

    assert np.isfinite(img_h).all() and np.isfinite(img_s).all()
    # comparable energy (dispersion must not create/lose power)
    ratio = img_h.mean() / max(img_s.mean(), 1e-9)
    assert 0.6 < ratio < 1.6, ratio

    def bright_sat(img):
        lum = img.mean(-1)
        thr = np.quantile(lum, 0.9)
        sel = lum >= max(thr, 1e-6)
        mx = img.max(-1)[sel]
        mn = img.min(-1)[sel]
        return float(np.mean((mx - mn) / np.maximum(mx, 1e-6)))

    s_h, s_s = bright_sat(img_h), bright_sat(img_s)
    # the rainbow: hero's bright pixels are more saturated
    assert s_h > s_s + 0.02, (s_h, s_s)


def test_bigscene_product_path_thumbnails():
    """Large reference scenes rendered through the BVH route against
    committed thumbnail goldens: a traversal regression fails CI, not just
    the gallery. Golden: tests/goldens/bigscene_thumbs.npz, 48^2 1spp
    depth-2, fixed seed."""
    import os
    import jax.numpy as jnp
    from vision_tpu.scene.scene import Scene
    from vision_tpu.integrator import pt
    from vision_tpu.core import rng

    gold_path = os.path.join(os.path.dirname(__file__), "goldens",
                             "bigscene_thumbs.npz")
    if not os.path.exists(gold_path):
        import pytest
        pytest.skip("golden not generated")
    gold = np.load(gold_path)
    scenes = {
        "staircase": "/root/reference/res/render_scene/staircase/"
                     "vision_scene.json",
        "classroom": "/root/reference/res/render_scene/classroom/"
                     "vision_scene.json",
    }
    for name, path in scenes.items():
        if not os.path.exists(path):
            continue
        sc = Scene(path)
        sc.raw["camera"]["param"]["radiance_collector"]["param"][
            "resolution"] = [48, 48]
        sc = Scene(sc.raw, scene_dir=sc.scene_dir)
        assert sc.data.bvh is not None, name
        R = 48 * 48
        pix = jnp.arange(R, dtype=jnp.uint32)
        p_film = jnp.stack([(pix % 48).astype(jnp.float32) + 0.5,
                            (pix // 48).astype(jnp.float32) + 0.5], -1)
        ray = sc.camera.generate_ray(p_film, jnp.zeros((R, 2)))
        st = rng.seed(pix, jnp.uint32(11))
        L, _ = pt.radiance(sc.data, ray, st, max_depth=2)
        img = np.asarray(L).reshape(48, 48, 3)
        ref = gold[name]
        # tie-break tolerance: coincident-surface pixels may pick a
        # different prim under a different traversal order
        bad = (np.abs(img - ref) > 1e-3 + 1e-3 * np.abs(ref)).any(-1)
        assert bad.mean() < 0.01, (name, bad.sum())
        assert np.allclose(img.mean(), ref.mean(), rtol=0.01), name
