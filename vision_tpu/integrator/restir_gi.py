"""ReSTIR GI: reservoir resampling of one-bounce indirect paths.

Equivalent of `/root/reference/src/render_core/integrator/ReSTIR/
indirect.{h,cpp}` (initial-sample PT -> temporal -> spatial): reservoirs
store the reconnection vertex (sample point, its normal, incident radiance);
reuse re-targets p_hat at the receiving surface with the solid-angle
reconnection Jacobian. Shading: L = f(wi) |cos| L_s W.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import rng
from ..core.math import (coordinate_system, dot, luminance, normalize,
                         safe_div, to_local, to_world)
from ..core.types import Ray
from ..shading import bsdf as ub
from ..shading.materials import gather_params
from . import pt
from .restir import surface_similar


@struct.dataclass
class GIReservoir:
    x_s: jnp.ndarray      # [N, 3] sample (reconnection) point
    n_s: jnp.ndarray      # [N, 3] its normal
    L_s: jnp.ndarray      # [N, 3] radiance leaving x_s toward the receiver
    wsum: jnp.ndarray
    M: jnp.ndarray
    W: jnp.ndarray
    p_hat: jnp.ndarray

    @classmethod
    def empty(cls, n):
        z = jnp.zeros((n,))
        return cls(x_s=jnp.zeros((n, 3)), n_s=jnp.zeros((n, 3)),
                   L_s=jnp.zeros((n, 3)), wsum=z, M=z, W=z, p_hat=z)


def _phat(gb, params, wo_l, frame, x_s, L_s):
    t, b, ns = frame
    wi = normalize(x_s - gb.pos)
    wi_l = to_local(t, b, ns, wi)
    ev = ub.evaluate(params, wo_l, wi_l)
    f_cos = ev.f * jnp.abs(wi_l[..., 2])[..., None]
    return jnp.maximum(luminance(f_cos * L_s), 0.0)


def initial_samples(scene, gb, state, bounce_depth=2, sharc=None,
                    cam_pos=None, surfel=None):
    """One BSDF-sampled indirect path per pixel (indirect.cpp initial pass).
    With `sharc` (a SharcCache) or `surfel` (a SurfelPool) the traced
    incident radiance is replaced by the cache value where the cache has
    converged (rt.cpp: radiance cache queried at secondary vertices; the
    cache plugin choice mirrors render_core/radiancecache/{sharc,surfel}),
    cutting initial-sample variance. Returns
    (state, reservoir, shading context, cache-update samples)."""
    n = gb.pos.shape[0]
    params, _ = gather_params(scene.materials, scene.atlas, gb.mat_id, gb.uv)
    t, b = coordinate_system(gb.normal)
    wo_l = to_local(t, b, gb.normal, gb.wo)
    frame = (t, b, gb.normal)

    state, bs = ub.sample(params, wo_l, state)
    wi = to_world(t, b, gb.normal, bs.wi)
    ray = Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi)
    hit = pt.trace_closest(scene, ray)
    x_s = ray.at(hit.t)
    pos, ng, ns2, uv, inst, mat_id, light_id = pt.compute_interaction(
        scene, ray, hit)
    x_s = jnp.where(hit.is_hit[..., None], pos,
                    gb.pos + wi * (2.0 * scene.world_radius))
    n_s = jnp.where(hit.is_hit[..., None], ns2, -wi)

    # incident radiance from the sample point: continue the path. The
    # FIRST segment's direct emission/env is excluded — that term is the
    # DI integrator's estimand (counting it here double-counted direct
    # light: measured +45% on the cbox steady state)
    L_path, _ = pt.radiance(scene, ray, state, max_depth=bounce_depth,
                            include_primary=False)
    L_s = L_path
    if sharc is not None:
        from ..caches import sharc as sh
        L_q, ok = sh.query(sharc, x_s, n_s, cam_pos)
        L_s = jnp.where((ok & hit.is_hit)[..., None], L_q, L_path)
    elif surfel is not None:
        from ..caches import surfel as sf
        val, wq = sf.query(surfel, x_s, n_s)
        ok = wq > 0.25
        L_q = safe_div(val, wq[..., None])
        L_s = jnp.where((ok & hit.is_hit)[..., None], L_q, L_path)

    p_hat = _phat(gb, params, wo_l, frame, x_s, L_s)
    src_pdf = jnp.maximum(bs.ev.pdf, 1e-8)
    w = safe_div(p_hat, src_pdf) * bs.valid.astype(jnp.float32)
    res = GIReservoir(x_s=x_s, n_s=n_s, L_s=L_s, wsum=w,
                      M=jnp.ones((n,)), W=jnp.zeros((n,)), p_hat=p_hat)
    res = _finalize(res)
    cache_samples = (x_s, n_s, L_path, hit.is_hit & gb.valid & bs.valid)
    return state, res, (params, wo_l, frame), cache_samples


def _finalize(res):
    # W cap mirrors reservoir.h safe_weight: near-zero p_hat samples
    # otherwise explode into fireflies that SVGF smears for many frames
    W = safe_div(res.wsum, res.M * res.p_hat)
    return res.replace(W=jnp.clip(jnp.where(jnp.isfinite(W), W, 0.0),
                                  0.0, 100.0))


def _jacobian(gb_from_pos, res_n_s, res_x_s, gb_to_pos):
    """Reconnection Jacobian between receivers (indirect.cpp reuse):
    |cos(at sample toward new receiver)| / d^2 ratio."""
    def geo(p):
        v = p - res_x_s
        d2 = jnp.maximum(jnp.sum(v * v, -1), 1e-8)
        c = jnp.abs(jnp.sum(normalize(v) * res_n_s, -1))
        return safe_div(c, d2)
    g_new = geo(gb_to_pos)
    g_old = geo(gb_from_pos)
    return jnp.clip(safe_div(g_new, g_old), 0.0, 10.0)


def _merge(res, other, other_origin_pos, gb, params, wo_l, frame, u):
    p_hat_here = _phat(gb, params, wo_l, frame, other.x_s, other.L_s)
    jac = _jacobian(other_origin_pos, other.n_s, other.x_s, gb.pos)
    w = p_hat_here * other.W * other.M * jac
    wsum = res.wsum + w
    take = (u * wsum < w) & (w > 0.0)
    tk = take[..., None]
    return res.replace(
        x_s=jnp.where(tk, other.x_s, res.x_s),
        n_s=jnp.where(tk, other.n_s, res.n_s),
        L_s=jnp.where(tk, other.L_s, res.L_s),
        p_hat=jnp.where(take, p_hat_here, res.p_hat),
        wsum=wsum, M=res.M + other.M)


def restir_gi(scene, gb, state, prev=None, resolution=None, spatial_taps=2,
              spatial_radius=12.0, history_limit=16.0, bounce_depth=2,
              sharc=None, cam_pos=None, surfel=None):
    """Full GI pass. prev: (prev_reservoir, prev_gbuffer) or None.
    Returns (state, L_indirect [N, 3], reservoir, cache_samples)."""
    n = gb.pos.shape[0]
    W_, H_ = resolution
    state, res, (params, wo_l, frame), cache_samples = initial_samples(
        scene, gb, state, bounce_depth, sharc=sharc, cam_pos=cam_pos,
        surfel=surfel)

    res_persist = res
    if prev is not None:
        prev_res, prev_gb = prev
        pix = jnp.arange(n)
        px = (pix % W_).astype(jnp.float32) + 0.5 + gb.motion[..., 0]
        py = (pix // W_).astype(jnp.float32) + 0.5 + gb.motion[..., 1]
        ix = jnp.clip(px.astype(jnp.int32), 0, W_ - 1)
        iy = jnp.clip(py.astype(jnp.int32), 0, H_ - 1)
        in_b = (px >= 0) & (px < W_) & (py >= 0) & (py < H_)
        pidx = iy * W_ + ix
        ok = in_b & surface_similar(gb, pix, prev_gb, pidx)
        pr = jax.tree.map(lambda a: a[pidx], prev_res)
        pr = pr.replace(M=jnp.minimum(pr.M, history_limit),
                        W=jnp.where(ok, pr.W, 0.0))
        state, u = rng.next_1d(state)
        res = _merge(res, pr, prev_gb.pos[pidx], gb, params, wo_l, frame, u)
        res = _finalize(res)

    # the PERSISTENT reservoir is the temporal one (reference indirect.cpp:
    # shader0 writes the reservoir buffer, shader1's spatial merge is
    # shade-only). Feeding spatially-merged reservoirs back through
    # temporal reuse double-counts shared neighbor history and the energy
    # compounds frame over frame (measured: 10x over 14 frames).
    res_persist = res

    for _ in range(spatial_taps):
        state, u2 = rng.next_2d(state)
        ang = u2[..., 0] * 6.2831853
        rad = jnp.sqrt(u2[..., 1]) * spatial_radius
        dx = (jnp.cos(ang) * rad).astype(jnp.int32)
        dy = (jnp.sin(ang) * rad).astype(jnp.int32)
        pix = jnp.arange(n)
        nx = jnp.clip(pix % W_ + dx, 0, W_ - 1)
        ny = jnp.clip(pix // W_ + dy, 0, H_ - 1)
        nidx = ny * W_ + nx
        ok = surface_similar(gb, pix, gb, nidx)
        nb = jax.tree.map(lambda a: a[nidx], res)
        nb = nb.replace(W=jnp.where(ok, nb.W, 0.0),
                        M=jnp.where(ok, nb.M, 0.0))
        state, u = rng.next_1d(state)
        res = _merge(res, nb, gb.pos[nidx], gb, params, wo_l, frame, u)
    res = _finalize(res)

    # shade + reconnection visibility
    wi = normalize(res.x_s - gb.pos)
    dist = jnp.linalg.norm(res.x_s - gb.pos, axis=-1)
    ray = Ray.make(pt.spawn_origin(gb.pos, gb.normal, wi), wi,
                   t_max=dist * (1.0 - 1e-3))
    occ = pt.trace_occluded(scene, ray, act=gb.valid & (res.W > 0.0))
    t, b, ns = frame
    wi_l = to_local(t, b, ns, wi)
    ev = ub.evaluate(params, wo_l, wi_l)
    f_cos = ev.f * jnp.abs(wi_l[..., 2])[..., None]
    L = f_cos * res.L_s * res.W[..., None]
    L = jnp.where((gb.valid & jnp.logical_not(occ))[..., None], L, 0.0)
    return state, L, res_persist, cache_samples
