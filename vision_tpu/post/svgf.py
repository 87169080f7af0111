"""SVGF: spatiotemporal variance-guided filtering.

Equivalent of `/root/reference/src/render_core/denoiser/SVGF/` (reproject ->
filter_moments -> N x atrous -> modulate): temporal accumulation with
motion-vector reprojection and surface-similarity validation, luminance
moment tracking for variance, variance-guided edge-stopping a-trous passes.
Operates on demodulated illumination (color / albedo) like the reference.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.math import luminance, safe_div


@struct.dataclass
class SVGFState:
    illum: jnp.ndarray     # [H, W, 3] accumulated illumination
    moments: jnp.ndarray   # [H, W, 2] luminance first/second moments
    history: jnp.ndarray   # [H, W] frame count


def init_state(h, w):
    return SVGFState(illum=jnp.zeros((h, w, 3)),
                     moments=jnp.zeros((h, w, 2)),
                     history=jnp.zeros((h, w)))


def _bilinear_reproject(img, motion):
    """Sample img at pixel + motion (backward reprojection)."""
    H, W = img.shape[:2]
    yy, xx = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    sx = xx.astype(jnp.float32) + motion[..., 0]
    sy = yy.astype(jnp.float32) + motion[..., 1]
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    fx = (sx - x0)[..., None] if img.ndim == 3 else (sx - x0)
    fy = (sy - y0)[..., None] if img.ndim == 3 else (sy - y0)

    def tap(xi, yi):
        xi = jnp.clip(xi, 0, W - 1)
        yi = jnp.clip(yi, 0, H - 1)
        return img[yi, xi]

    out = (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)
    in_b = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    return out, in_b


def _shift2d(img, dy, dx):
    return jnp.roll(img, (dy, dx), axis=(0, 1))


def _spatial_moments(illum, normal, var_boost=1.0):
    """7x7 edge-aware luminance moment estimate (reference filter_moments
    pass): while temporal history is short the per-pixel moments are too
    noisy to trust, so variance is estimated from the neighborhood with
    normal/luminance edge-stopping weights."""
    lum = luminance(illum)
    m1 = jnp.zeros_like(lum)
    m2 = jnp.zeros_like(lum)
    wsum = jnp.zeros_like(lum)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            ls = _shift2d(lum, dy, dx)
            ns = _shift2d(normal, dy, dx)
            w_n = jnp.clip(jnp.sum(ns * normal, -1), 0.0, 1.0) ** 32
            w_l = jnp.exp(-jnp.abs(ls - lum) * 4.0)
            w = w_n * w_l
            m1 = m1 + ls * w
            m2 = m2 + ls * ls * w
            wsum = wsum + w
    m1 = safe_div(m1, wsum)
    m2 = safe_div(m2, wsum)
    return jnp.maximum(m2 - m1 * m1, 0.0) * var_boost


def _atrous_var_pass(color, var, normal, albedo, step, sigma_rt=4.0,
                     sigma_normal=128.0, sigma_albedo=8.0):
    """One variance-guided a-trous iteration that ALSO filters the variance
    (reference SVGF/svgf.h: var' = sum w^2 var / (sum w)^2, and the
    luminance sigma uses a 3x3-prefiltered sqrt(var) per ITERATION rather
    than a fixed initial estimate)."""
    k5 = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]
    # 3x3 gaussian prefilter of the variance for the luminance sigma
    g = jnp.zeros_like(var)
    k3 = [0.25, 0.5, 0.25]
    for j in range(3):
        for i in range(3):
            g = g + k3[j] * k3[i] * _shift2d(var, j - 1, i - 1)
    denom = sigma_rt * jnp.sqrt(jnp.maximum(g, 0.0)) + 1e-4
    lum_c = luminance(color)
    acc = jnp.zeros_like(color)
    vacc = jnp.zeros_like(var)
    wsum = jnp.zeros_like(var)
    for j in range(5):
        for i in range(5):
            dy = (j - 2) * step
            dx = (i - 2) * step
            k = k5[j] * k5[i]
            c = _shift2d(color, dy, dx)
            v = _shift2d(var, dy, dx)
            n = _shift2d(normal, dy, dx)
            a = _shift2d(albedo, dy, dx)
            w_n = jnp.power(jnp.clip(jnp.sum(n * normal, -1), 0.0, 1.0),
                            sigma_normal)
            w_l = jnp.exp(-safe_div(jnp.abs(luminance(c) - lum_c), denom))
            w_a = jnp.exp(-jnp.sum(jnp.abs(a - albedo), -1) * sigma_albedo)
            w = k * w_n * w_l * w_a
            acc = acc + c * w[..., None]
            vacc = vacc + v * w * w
            wsum = wsum + w
    out = safe_div(acc, wsum[..., None])
    out_var = safe_div(vacc, jnp.maximum(wsum * wsum, 1e-12))
    return out, out_var


def svgf_filter(color, albedo, normal, depth, motion, prev_state,
                prev_normal=None, prev_depth=None,
                n_passes=3, alpha=0.05, moments_alpha=0.2,
                history_limit=32.0, sigma_rt=10.0, sigma_normal=128.0):
    """One SVGF frame. All inputs [H, W, ...]. Returns (filtered, new_state).

    Parameters mirror the scene-config knobs (vision_scene.json svgf block:
    N, alpha, moments_alpha, history_limit, sigma_rt, sigma_normal)."""
    H, W = color.shape[:2]
    # demodulate albedo (reference modulator pass)
    illum = safe_div(color, jnp.maximum(albedo, 1e-3))

    # ---- reproject ----
    prev_illum, ok_i = _bilinear_reproject(prev_state.illum, motion)
    prev_mom, _ = _bilinear_reproject(prev_state.moments, motion)
    prev_hist, _ = _bilinear_reproject(prev_state.history[..., None], motion)
    prev_hist = prev_hist[..., 0]
    valid = ok_i
    if prev_normal is not None:
        pn, _ = _bilinear_reproject(prev_normal, motion)
        valid = valid & (jnp.sum(pn * normal, -1) > 0.8)
    if prev_depth is not None:
        pd, _ = _bilinear_reproject(prev_depth[..., None], motion)
        rel = jnp.abs(pd[..., 0] - depth) / jnp.maximum(depth, 1e-3)
        valid = valid & (rel < 0.1)

    hist = jnp.where(valid, jnp.minimum(prev_hist + 1.0, history_limit), 1.0)
    a = jnp.maximum(alpha, 1.0 / hist)[..., None]
    am = jnp.maximum(moments_alpha, 1.0 / hist)[..., None]

    illum_acc = jnp.where(valid[..., None],
                          prev_illum + (illum - prev_illum) * a, illum)
    lum = luminance(illum)
    mom = jnp.stack([lum, lum * lum], -1)
    mom_acc = jnp.where(valid[..., None], prev_mom + (mom - prev_mom) * am, mom)

    # ---- variance: temporal moments when history suffices, spatial
    # moment estimation while it is short (reference filter_moments) ----
    var_t = jnp.maximum(mom_acc[..., 1] - mom_acc[..., 0] ** 2, 0.0)
    var_s = _spatial_moments(illum_acc, normal,
                             var_boost=jnp.maximum(1.0, 4.0 / hist))
    var = jnp.where(hist >= 4.0, var_t, var_s)

    # ---- a-trous passes: variance rides the filter chain (w^2 update),
    # and each pass re-derives its luminance sigma from the current
    # 3x3-prefiltered variance (SVGF/svgf.h atrous loop) ----
    out = illum_acc
    for p in range(n_passes):
        out, var = _atrous_var_pass(out, var, normal, albedo, 1 << p,
                                    sigma_rt=4.0,
                                    sigma_normal=sigma_normal)

    filtered = out * jnp.maximum(albedo, 1e-3)  # re-modulate
    new_state = SVGFState(illum=illum_acc, moments=mom_acc, history=hist)
    return filtered, new_state
