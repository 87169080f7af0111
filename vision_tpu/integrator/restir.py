"""ReSTIR DI: reservoir-based spatiotemporal importance resampling.

TPU-native equivalent of the reference real-time integrator's direct stage
(`/root/reference/src/render_core/integrator/ReSTIR/direct.{h,cpp}`):

  shader0: per-pixel RIS over M light candidates (streaming reservoir,
           p_hat = luminance of the unshadowed contribution,
           direct.cpp:161-210) + temporal reuse validated by surface
           similarity (direct.h:93);
  shader1: spatial reuse over K ring neighbors + final visibility + shading.

Reservoirs are plain SoA pytrees over the pixel wavefront — sharded over
chips like any other buffer (SURVEY.md: "ReSTIR DI reservoirs as sharded
device arrays"). Weights use the unbiased 1/M RIS estimator with
`safe_weight` clamping like reservoir.h:64-118.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import rng
from ..core.math import (coordinate_system, dot, luminance, normalize,
                         safe_div, to_local)
from ..core.types import Ray
from ..lights import lights as lt
from ..shading import bsdf as ub
from ..shading.materials import gather_params
from . import pt


@struct.dataclass
class Reservoir:
    p_light: jnp.ndarray   # [N, 3] winning sample position
    Le: jnp.ndarray        # [N, 3] its (unshadowed) emitted radiance
    dist: jnp.ndarray      # [N] distance (occlusion t_max)
    delta: jnp.ndarray     # [N] bool: delta light (visibility-only shading)
    wsum: jnp.ndarray      # [N]
    M: jnp.ndarray         # [N] candidate count
    W: jnp.ndarray         # [N] final RIS weight
    p_hat: jnp.ndarray     # [N] target value of winner at this surface

    @classmethod
    def empty(cls, n):
        z = jnp.zeros((n,))
        return cls(p_light=jnp.zeros((n, 3)), Le=jnp.zeros((n, 3)),
                   dist=jnp.full((n,), 1e30), delta=jnp.zeros((n,), bool),
                   wsum=z, M=z, W=z, p_hat=z)


def _target_phat(gb, params, wo_l, frame, p_light, Le, delta):
    """p_hat = luminance of unshadowed contribution f * |cos| * Le
    (solid-angle measure folded into Le for delta lights)."""
    t, b, ns = frame
    wi = normalize(p_light - gb.pos)
    wi_l = to_local(t, b, ns, wi)
    ev = ub.evaluate(params, wo_l, wi_l)
    f_cos = ev.f * jnp.abs(wi_l[..., 2])[..., None]
    contrib = f_cos * Le
    return jnp.maximum(luminance(contrib), 0.0)


def _update(res, u, w, p_light, Le, dist, delta, p_hat):
    """Streaming reservoir update (reservoir.h update)."""
    wsum = res.wsum + w
    take = (u * wsum < w) & (w > 0.0)
    sel = lambda a, b_: jnp.where(take[..., None] if a.ndim > 1 else take, a, b_)
    return res.replace(
        p_light=sel(p_light, res.p_light), Le=sel(Le, res.Le),
        dist=jnp.where(take, dist, res.dist),
        delta=jnp.where(take, delta, res.delta),
        p_hat=jnp.where(take, p_hat, res.p_hat),
        wsum=wsum, M=res.M + 1.0)


def _finalize(res):
    """W = wsum / (M * p_hat) with safe clamping (reservoir.h safe_weight)."""
    W = safe_div(res.wsum, res.M * res.p_hat)
    W = jnp.where(jnp.isfinite(W), W, 0.0)
    return res.replace(W=jnp.clip(W, 0.0, 1e6))


def initial_candidates(scene, gb, state, m_light=8):
    """shader0 part 1: RIS over m_light light candidates per pixel."""
    n = gb.pos.shape[0]
    spectrum = scene.spectrum
    state, swl = spectrum.sample_wavelengths(state)
    params, _ = gather_params(scene.materials, scene.atlas, gb.mat_id, gb.uv)
    t, b = coordinate_system(gb.normal)
    wo_l = to_local(t, b, gb.normal, gb.wo)
    frame = (t, b, gb.normal)

    res = Reservoir.empty(n)
    for _ in range(m_light):
        state, u_sel = rng.next_1d(state)
        state, u2 = rng.next_2d(state)
        ls = lt.sample_wi(scene.lights, scene.atlas, scene.tri_pack,
                          gb.pos, gb.normal, u_sel, u2, scene.world_radius)
        is_delta = ls.pdf < 0.0
        pdf = jnp.where(is_delta, -ls.pdf, ls.pdf)
        p_hat = _target_phat(gb, params, wo_l, frame, ls.p_light, ls.L,
                             is_delta)
        w = safe_div(p_hat, pdf)
        state, u_r = rng.next_1d(state)
        res = _update(res, u_r, w, ls.p_light, ls.L, ls.dist, is_delta, p_hat)
    res = _finalize(res)
    return state, res, (params, wo_l, frame)


def surface_similar(gb_a, idx_a, gb_b, idx_b, depth_tol=0.1, normal_tol=0.9):
    """Surface similarity test for reuse validation (direct.h:93)."""
    dz = jnp.abs(gb_a.depth[idx_a] - gb_b.depth[idx_b])
    rel = dz / jnp.maximum(gb_a.depth[idx_a], 1e-3)
    nd = jnp.sum(gb_a.normal[idx_a] * gb_b.normal[idx_b], -1)
    return (rel < depth_tol) & (nd > normal_tol) & gb_b.valid[idx_b]


def _merge(res, other, gb, params, wo_l, frame, u, m_clamp=None):
    """Merge another reservoir as a weighted candidate (combine step)."""
    p_hat_here = _target_phat(gb, params, wo_l, frame, other.p_light,
                              other.Le, other.delta)
    M_o = other.M if m_clamp is None else jnp.minimum(other.M, m_clamp)
    w = p_hat_here * other.W * M_o
    new = _update(res, u, w, other.p_light, other.Le,
                  jnp.linalg.norm(other.p_light - gb.pos, axis=-1),
                  other.delta, p_hat_here)
    return new.replace(M=res.M + M_o)


def restir_di(scene, gb, state, prev=None, frame_index=0, m_light=8,
              spatial_taps=4, spatial_radius=16.0, resolution=None,
              history_limit=20.0):
    """Full DI pass: candidates -> temporal -> spatial -> shade.

    prev: (prev_reservoir, prev_gbuffer) or None (first frame).
    Returns (state, L_direct [N, 3], reservoir for next frame)."""
    n = gb.pos.shape[0]
    W, H = resolution
    state, res, (params, wo_l, frame) = initial_candidates(
        scene, gb, state, m_light)

    # visibility for the initial winner (direct.cpp checks before reuse);
    # lanes with no surface or no winner skip the trace (packet-path
    # dead-lane compaction)
    wi = normalize(res.p_light - gb.pos)
    ray = Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi,
                   t_max=res.dist * (1.0 - 1e-3))
    occ = pt.trace_occluded(scene, ray, act=gb.valid & (res.W > 0.0))
    res = res.replace(W=jnp.where(occ, 0.0, res.W))
    res_persist = res

    # temporal reuse
    if prev is not None:
        prev_res, prev_gb = prev
        pix = jnp.arange(n)
        px = (pix % W).astype(jnp.float32) + 0.5 + gb.motion[..., 0]
        py = (pix // W).astype(jnp.float32) + 0.5 + gb.motion[..., 1]
        ix = jnp.clip(px.astype(jnp.int32), 0, W - 1)
        iy = jnp.clip(py.astype(jnp.int32), 0, H - 1)
        in_b = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        pidx = iy * W + ix
        ok = in_b & surface_similar(gb, pix, prev_gb, pidx)
        pr = jax.tree.map(lambda a: a[pidx], prev_res)
        pr = pr.replace(M=jnp.minimum(pr.M, history_limit),
                        W=jnp.where(ok, pr.W, 0.0))
        state, u = rng.next_1d(state)
        res = _merge(res, pr, gb, params, wo_l, frame, u)
        res = _finalize(res)

    # persistent reservoir = TEMPORAL only (direct.cpp: shader0 owns the
    # reservoir buffer; shader1's spatial merge is shade-only). Spatial
    # feedback through temporal reuse compounds shared-history energy.
    res_persist = res

    # spatial reuse (shader1)
    for k in range(spatial_taps):
        state, u2 = rng.next_2d(state)
        ang = u2[..., 0] * 6.2831853
        rad = jnp.sqrt(u2[..., 1]) * spatial_radius
        dx = (jnp.cos(ang) * rad).astype(jnp.int32)
        dy = (jnp.sin(ang) * rad).astype(jnp.int32)
        pix = jnp.arange(n)
        nx = jnp.clip(pix % W + dx, 0, W - 1)
        ny = jnp.clip(pix // W + dy, 0, H - 1)
        nidx = ny * W + nx
        ok = surface_similar(gb, pix, gb, nidx)
        nb = jax.tree.map(lambda a: a[nidx], res)
        nb = nb.replace(W=jnp.where(ok, nb.W, 0.0),
                        M=jnp.where(ok, nb.M, 0.0))
        state, u = rng.next_1d(state)
        res = _merge(res, nb, gb, params, wo_l, frame, u)
    res = _finalize(res)

    # final visibility + shade: L = f*cos*Le * W
    wi = normalize(res.p_light - gb.pos)
    ray = Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi,
                   t_max=res.dist * (1.0 - 1e-3))
    occ = pt.trace_occluded(scene, ray, act=gb.valid & (res.W > 0.0))
    t, b, ns = frame
    wi_l = to_local(t, b, ns, wi)
    ev = ub.evaluate(params, wo_l, wi_l)
    f_cos = ev.f * jnp.abs(wi_l[..., 2])[..., None]
    L = f_cos * res.Le * res.W[..., None]
    L = jnp.where((gb.valid & jnp.logical_not(occ))[..., None], L, 0.0)
    L = L + gb.emission
    return state, L, res_persist
