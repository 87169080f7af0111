"""Wavefront path-tracing integrator.

Wavefront restructuring of the reference megakernel Li
(`/root/reference/src/base/integral/integrator.cpp:160-311`): the per-pixel
`$for` bounce loop becomes a `lax.fori_loop` over a whole wavefront of rays
(every lane = one pixel sample), with masked lanes instead of divergent
control flow. Per bounce:

  trace closest -> [miss: env MIS, deactivate]
               -> emissive-hit MIS (weight vs previous scatter pdf)
               -> NEE: light sample + shadow ray + MIS combine
               -> uber-BSDF sample -> RR (eta_scale-corrected) -> next ray

MIS follows integrator.cpp: balance heuristic, delta lights pdf<0 convention,
primary rays get scatter_pdf=1e16 (pt.cpp:73) so primary emission is
unweighted.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng, warp
from ..core.math import (dot, dotv, face_forward, normalize, safe_div,
                         to_local, to_world, coordinate_system, cross,
                         luminance)
from ..core.types import Ray
from ..accel import intersect as isect
from ..shading import bsdf as ub
from ..shading import medium as md
from ..shading.materials import gather_params
from ..lights import lights as lt

RAY_OFFSET = 2e-4


def trace_closest(scene, ray, act=None):
    """Closest hit (Hit) of each ray; lanes with act == False may miss."""
    return isect.trace(scene, ray, act=act)[0]


def trace_occluded(scene, ray, act=None):
    """Occlusion (bool [R]) of each shadow ray within its t_max."""
    return isect.trace(scene, ray, any_hit=True, act=act)[0]


def compute_interaction(scene, ray, hit):
    """Surface interaction from a hit (geometry.cpp:79-166
    compute_surface_interaction): barycentric lerp of position/uv/normal,
    shading frame from shading normal. One packed-row gather per lane
    (scene.tri_pack) instead of ~12 strided [T, 3] gathers."""
    from ..core.gather import fetch_rows
    pid = jnp.maximum(hit.prim_id, 0)
    b1 = hit.bary[..., 0]
    b2 = hit.bary[..., 1]
    b0 = 1.0 - b1 - b2
    a = fetch_rows([scene.tri_pack], pid)[0]
    p0 = a[..., 0:3]
    e1 = a[..., 3:6]
    e2 = a[..., 6:9]
    ns_raw = (b0[..., None] * a[..., 9:12]
              + b1[..., None] * a[..., 12:15]
              + b2[..., None] * a[..., 15:18])
    inst = a[..., 24].astype(jnp.int32)
    mat_id = a[..., 25].astype(jnp.int32)
    light_id = a[..., 26].astype(jnp.int32)
    pos = p0 + b1[..., None] * e1 + b2[..., None] * e2
    ng = normalize(cross(e1, e2))
    ns = normalize(ns_raw)
    # degenerate vertex normals -> geometric
    ns_ok = jnp.sum(ns_raw * ns_raw, -1) > 1e-12
    ns = jnp.where(ns_ok[..., None], ns, ng)
    # align ns with ng hemisphere (reference keeps ng as orientation ref)
    ns = face_forward(ns, ng)
    uv = (b0[..., None] * a[..., 18:20]
          + b1[..., None] * a[..., 20:22]
          + b2[..., None] * a[..., 22:24])

    # shade-time normal mapping (material.h bump slot; shadernode
    # converter.cpp normal_map:58-62). Static-gated on any material
    # carrying a normal map so unaffected scenes pay nothing.
    if "nmap" in getattr(scene.materials, "feats", ()):
        mt = scene.materials
        mid = jnp.clip(mat_id, 0, mt.normal_tex.shape[0] - 1)
        nt, strength = fetch_rows([mt.normal_tex, mt.bump_scale], mid)
        nt = nt.astype(jnp.int32)
        texn = scene.atlas.sample(jnp.maximum(nt, 0), uv) * 2.0 - 1.0
        s = strength
        nx = texn[..., 0] * s
        ny = texn[..., 1] * s
        nz = (1.0 - s) + s * texn[..., 2]
        # uv-aligned tangent (so the map's x follows the u direction)
        duv1 = a[..., 20:22] - a[..., 18:20]
        duv2 = a[..., 22:24] - a[..., 18:20]
        det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
        T = (e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2])
        T = T * jnp.sign(det)[..., None]
        # degenerate uv charts: fall back to an arbitrary tangent
        t_ok = (jnp.abs(det) > 1e-12) & (jnp.sum(T * T, -1) > 1e-16)
        T = jnp.where(t_ok[..., None], T, coordinate_system(ns)[0])
        T = normalize(T - ns * dot(T, ns)[..., None])
        B = cross(ns, T)
        ns_m = normalize(T * nx[..., None] + B * ny[..., None]
                         + ns * nz[..., None])
        ns = jnp.where((nt >= 0)[..., None], face_forward(ns_m, ng), ns)
    return pos, ng, ns, uv, inst, mat_id, light_id


def spawn_origin(pos, ng, w, factor=1.0):
    """Offset ray origin along the geometric normal (interaction.h
    custom_offset_ray_origin): magnitude-proportional so large scenes don't
    acne, scaled by render_setting.ray_offset_factor."""
    s = jnp.sign(dot(w, ng))[..., None]
    mag = jnp.maximum(jnp.max(jnp.abs(pos), axis=-1), 1.0)
    return pos + ng * s * (RAY_OFFSET * factor * mag)[..., None]


def _bounce(scene, spectrum, swl_proto, has_media, off_factor, min_depth,
            rr_threshold, depth, c, include_primary=True):
    """One wavefront bounce: trace + shade + NEE + BSDF sample + RR.

    `depth` may be a scalar (fori bounce-major loop, `radiance`) or a
    per-lane [R] int array (regeneration pool, `render_wave`); all depth
    comparisons are elementwise. Wavelengths ride the carry (lam/lpdf/alive)
    so regenerated paths can resample them per lane.
    """
    r = Ray.make(c["o"], c["d"])
    hit, trunc = isect.trace(scene, r, act=c["act"])
    nrays = c["nrays"] + jnp.sum(c["act"].astype(jnp.float32))
    act = c["act"]
    st = c["st"]
    L = c["L"]
    thr = c["thr"]

    S = c["thr"].shape[-1]
    swl_c = swl_proto.replace(lam=c["lam"], pdf=c["lpdf"],
                              secondary_alive=c["alive"])

    # ---------------- miss: environment ----------------
    miss = act & hit.is_miss
    env_L = lt.env_radiance(scene.lights, scene.atlas, c["d"],
                            spectrum, swl_c)
    env_pdf = lt.env_pdf_wi(scene.lights, c["d"])
    w_env = jnp.where(depth == 0, 1.0, warp.mis_weight(c["spdf"], env_pdf))
    if not include_primary:
        # ReSTIR GI bounce paths: light seen DIRECTLY by the first segment
        # is the DI integrator's estimand (indirect.cpp initial samples
        # exclude it) — counting it here double-counts direct lighting
        w_env = jnp.where(depth == 0, 0.0, w_env)
    L = L + jnp.where(miss[..., None], thr * env_L * w_env[..., None], 0.0)

    act = act & hit.is_hit
    pos, ng, ns, uv, inst, mat_id, light_id = compute_interaction(scene, r, hit)
    wo = -c["d"]

    # ---------------- medium distance sampling ----------------
    # (homogeneous.cpp sample(): analytic per-channel; medium-scatter
    # lanes do phase NEE + HG scattering instead of surface shading)
    med_id = c["med"]
    in_med = med_id >= 0
    samp_med = jnp.zeros_like(act)
    g_med = jnp.zeros(act.shape)
    sigma_t_sp = None
    pos_med = pos
    if has_media:
        sigma_t_sp, sigma_s_sp, g_med = md.gather_spectral(
            scene.mediums, med_id, spectrum, swl_c)
        sigma_t_sp = jnp.where(in_med[..., None], sigma_t_sp, 0.0)
        sigma_s_sp = jnp.where(in_med[..., None], sigma_s_sp, 0.0)
        st, t_med, samp_raw, w_surf, w_med = md.sample_distance(
            st, sigma_t_sp, hit.t, S)
        samp_med = act & in_med & samp_raw
        w = jnp.where(samp_med[..., None], w_med * sigma_s_sp,
                      jnp.where((act & in_med)[..., None], w_surf, 1.0))
        thr = thr * w
        pos_med = r.at(t_med)
        # medium scatter cancels the surface emission/material handling
        act_surface = act & jnp.logical_not(samp_med)
    else:
        act_surface = act

    # ---------------- emissive hit MIS ----------------
    Le, l_pdf = lt.eval_hit_area(scene.lights, light_id, hit.prim_id, None,
                                 c["o"], pos, ng, uv, scene.atlas,
                                 spectrum, swl_c)
    w_hit = jnp.where(depth == 0, 1.0, warp.mis_weight(c["spdf"], l_pdf))
    if not include_primary:
        w_hit = jnp.where(depth == 0, 0.0, w_hit)
    hit_light = act_surface & (light_id >= 0)
    L = L + jnp.where(hit_light[..., None], thr * Le * w_hit[..., None], 0.0)

    # ---------------- material params + shading frame ----------------
    params, dispersive = gather_params(scene.materials, scene.atlas,
                                       mat_id, uv, spectrum, swl_c,
                                       cos_wo=jnp.abs(dot(ns, wo)))
    # dispersion: kill secondary wavelengths on dispersive interactions
    # (SampledWavelengths::check_dispersive)
    alive = c["alive"] & jnp.logical_not(act & dispersive)
    swl_c = swl_c.replace(secondary_alive=alive)
    t, b = coordinate_system(ns)
    wo_l = to_local(t, b, ns, wo)

    # first-bounce AOVs
    is_first = depth == 0
    alb3 = ub.albedo(params, wo_l)
    alb3 = alb3 if alb3.shape[-1] == 3 else jnp.broadcast_to(
        jnp.mean(alb3, -1, keepdims=True), alb3.shape[:-1] + (3,))
    alb = jnp.where((is_first & act)[..., None], alb3, c["alb"])
    nrm = jnp.where((is_first & act)[..., None], ns, c["nrm"])

    # ---------------- NEE ----------------
    nee_pos = pos if not has_media else jnp.where(samp_med[..., None],
                                                  pos_med, pos)
    st, u_sel = rng.next_1d(st)
    st, u_l2 = rng.next_2d(st)
    ls = lt.sample_wi(scene.lights, scene.atlas, scene.tri_pack,
                      nee_pos, ns, u_sel, u_l2, scene.world_radius,
                      spectrum, swl_c)
    shadow_o = spawn_origin(pos, ng, ls.wi, off_factor)
    if has_media:
        shadow_o = jnp.where(samp_med[..., None], pos_med, shadow_o)
    shadow_ray = Ray.make(shadow_o, ls.wi,
                          t_max=ls.dist * (1.0 - 1e-3))
    wi_l_nee = to_local(t, b, ns, ls.wi)
    nee_eval = ub.evaluate(params, wo_l, wi_l_nee)
    f_nee = nee_eval.f * jnp.abs(wi_l_nee[..., 2])[..., None]
    nee_pdf = nee_eval.pdf
    if has_media:
        # phase-function NEE for medium-scatter lanes (no cosine)
        # hg_phase convention: cos between away-pointing wo and wi
        p_hg = md.hg_phase(dot(wo, ls.wi), g_med)
        f_nee = jnp.where(samp_med[..., None], p_hg[..., None], f_nee)
        nee_pdf = jnp.where(samp_med, p_hg, nee_pdf)
    is_delta = ls.pdf < 0.0
    l_pdf_pos = jnp.where(is_delta, -ls.pdf, ls.pdf)
    w_nee = jnp.where(is_delta, 1.0, warp.mis_weight(l_pdf_pos, nee_pdf))
    # only trace shadow rays that can contribute: specular interactions
    # (glass/mirror lobes) evaluate f=0 for NEE directions, and dark or
    # invalid light samples add nothing. Gated lanes get t_max=0 and
    # compact into free tail blocks — on the prism scene this skips most
    # shadow rays (integrator.cpp's `occluded()` traces unconditionally).
    nee_pre = (act & (l_pdf_pos > 0.0) & (nee_pdf >= 0.0)
               & (jnp.max(jnp.abs(ls.L * f_nee), -1) > 0.0))
    occ, trunc_sh = isect.trace(scene, shadow_ray, any_hit=True,
                                act=nee_pre)
    trunc = trunc + trunc_sh
    # ray accounting: BVH traversal skips gated lanes; the dense sweep
    # still processes every active lane
    counted = nee_pre if scene.bvh is not None else act
    nrays = nrays + jnp.sum(counted.astype(jnp.float32))
    nee_ok = nee_pre & jnp.logical_not(occ)
    Ld = ls.L * f_nee * safe_div(w_nee, l_pdf_pos)[..., None]
    if has_media:
        tr_sh = md.transmittance(sigma_t_sp, ls.dist, in_med)
        Ld = Ld * tr_sh
    L = L + jnp.where(nee_ok[..., None], thr * Ld, 0.0)

    # ---------------- BSDF / phase sample ----------------
    st, bs = ub.sample(params, wo_l, st)
    wi_world = to_world(t, b, ns, bs.wi)
    f_cos = bs.ev.f * jnp.abs(bs.wi[..., 2])[..., None]
    ratio = jnp.where(bs.valid[..., None],
                      f_cos * safe_div(1.0, bs.ev.pdf)[..., None], 0.0)
    spdf_next = bs.ev.pdf
    valid_next = bs.valid
    if has_media:
        st, u_hg = rng.next_2d(st)
        wi_hg, pdf_hg = md.hg_sample(wo, g_med, u_hg)
        wi_world = jnp.where(samp_med[..., None], wi_hg, wi_world)
        # phase: f == pdf -> ratio 1
        ratio = jnp.where(samp_med[..., None], 1.0, ratio)
        spdf_next = jnp.where(samp_med, pdf_hg, spdf_next)
        valid_next = valid_next | samp_med
    new_thr = thr * ratio
    act = act & valid_next & (jnp.max(new_thr, -1) > 0.0)

    # ---------------- russian roulette (integrator.cpp:289-297) ------
    eta = c["eta"] * bs.eta_scale
    lum = jnp.max(thr, axis=-1)
    st, u_rr = rng.next_1d(st)
    do_rr = (eta * lum < rr_threshold) & (depth >= min_depth)
    q = jnp.minimum(0.95, lum)
    kill = do_rr & (q < u_rr)
    new_thr = jnp.where((do_rr & jnp.logical_not(kill))[..., None],
                        new_thr * safe_div(1.0, q)[..., None], new_thr)
    act = act & jnp.logical_not(kill)

    new_o = spawn_origin(pos, ng, wi_world, off_factor)
    new_med = med_id
    if has_media:
        new_o = jnp.where(samp_med[..., None], pos_med, new_o)
        # medium transition on transmission through the surface
        crossed = jnp.logical_not(samp_med) & (dot(wi_world, ng) * dot(wo, ng) < 0.0)
        entering = dot(wi_world, ng) < 0.0
        trans_med = jnp.where(entering, scene.inst_in_medium[inst],
                              scene.inst_out_medium[inst])
        new_med = jnp.where(act & crossed, trans_med, med_id)
    out = dict(c)  # pass through keys owned by the caller (dep/fw/smp/film/it)
    out.update(o=new_o, d=wi_world, L=L, thr=new_thr,
               spdf=spdf_next, act=act, eta=eta, png=ng, st=st,
               alb=alb, nrm=nrm, alive=alive, med=new_med, nrays=nrays,
               trunc=c["trunc"] + trunc)
    return out


def _init_carry(scene, spectrum, ray, state, swl):
    R = ray.origin.shape[0]
    S = spectrum.dims
    return dict(o=ray.origin, d=ray.direction,
                L=jnp.zeros((R, S)), thr=jnp.ones((R, S)),
                spdf=jnp.full((R,), 1e16),
                act=jnp.ones((R,), bool),
                eta=jnp.ones((R,)), png=ray.direction, st=state,
                alb=jnp.zeros((R, 3)), nrm=jnp.zeros((R, 3)),
                alive=swl.secondary_alive, lam=swl.lam, lpdf=swl.pdf,
                med=jnp.full((R,), getattr(scene, "camera_medium", -1),
                             jnp.int32),
                nrays=jnp.zeros((), jnp.float32),
                trunc=jnp.zeros((), jnp.int32))


def radiance(scene, ray, state, max_depth=16, min_depth=0, rr_threshold=1.0,
             remat=False, include_primary=True):
    """Estimate L for a wavefront of rays. Returns (L [R, 3] linear sRGB,
    aovs dict). Spectral transport (hero wavelengths) happens internally when
    scene.spectrum is a hero model; the output is always converged to sRGB."""
    import functools
    spectrum = scene.spectrum
    off_factor = getattr(scene, "ray_offset", None)
    off_factor = 1.0 if off_factor is None else off_factor
    has_media = getattr(scene, "has_media", False)
    state, swl = spectrum.sample_wavelengths(state)
    carry = _init_carry(scene, spectrum, ray, state, swl)

    bounce = functools.partial(_bounce, scene, spectrum, swl, has_media,
                               off_factor, min_depth, rr_threshold,
                               include_primary=include_primary)
    # rematerialize each bounce under AD: O(1) live wavefront instead of
    # O(depth) residuals (SURVEY.md §7: replay instead of tape)
    body = jax.checkpoint(bounce) if remat else bounce
    out = jax.lax.fori_loop(0, max_depth, body, carry)
    Lf = spectrum.to_srgb(out["L"], swl.replace(secondary_alive=out["alive"]))
    Lf = jnp.where(jnp.isfinite(Lf), Lf, 0.0)
    return Lf, dict(albedo=out["alb"], normal=out["nrm"],
                    nrays=out["nrays"], truncated=out["trunc"])


def render_wave(scene, camera, filt, frame0, spp, max_depth=16, min_depth=0,
                rr_threshold=1.0, spp_budget=None):
    """Regeneration-wavefront renderer: one persistent ray pool (lane = pixel)
    where a finished path's lane is immediately refilled with that pixel's
    next sample, all inside a single on-device `lax.while_loop`.

    This is the answer to wavefront compaction (SURVEY §7.2): instead of
    shrinking the pool (dynamic shapes are hostile to XLA), keep every lane
    busy — utilization stays ~100% while the bounce-major fori version decays
    with ray attrition. Iterations ~= total path segments / R instead of
    spp * max_depth.

    spp_budget: optional per-pixel [R] int32 sample budget <= spp (adaptive
    sampling: converged pixels get 0 and cost nothing). `spp` stays the
    static loop bound.

    Returns (mean radiance [H, W, 3], aovs dict incl. traced-ray count,
    truncated-traversal count, per-pixel film sum and sample counts).
    """
    spectrum = scene.spectrum
    S = spectrum.dims
    off_factor = getattr(scene, "ray_offset", None)
    off_factor = 1.0 if off_factor is None else off_factor
    has_media = getattr(scene, "has_media", False)
    W, H = camera.resolution
    R = W * H
    pix = jnp.arange(R, dtype=jnp.uint32)
    px = (pix % W).astype(jnp.float32)
    py = (pix // W).astype(jnp.float32)
    cam_med = jnp.full((R,), getattr(scene, "camera_medium", -1), jnp.int32)

    def new_path(sample_idx):
        # decorrelate (pixel, frame0 + sample) streams
        st = rng.seed(pix, jnp.uint32(frame0) * jnp.uint32(0x9E3779B9)
                      + sample_idx.astype(jnp.uint32))
        st, u_film = rng.next_2d(st)
        offset, fw = filt.sample(u_film)
        p_film = jnp.stack([px + 0.5, py + 0.5], -1) + offset
        st, u_lens = rng.next_2d(st)
        ray = camera.generate_ray(p_film, u_lens)
        st, swl = spectrum.sample_wavelengths(st)
        return st, ray, swl, fw

    budget = (jnp.full((R,), spp, jnp.int32) if spp_budget is None
              else spp_budget.astype(jnp.int32))

    st0, ray0, swl0, fw0 = new_path(jnp.zeros((R,), jnp.uint32))
    c = _init_carry(scene, spectrum, ray0, st0, swl0)
    c["act"] = c["act"] & (budget > 0)
    c.update(dep=jnp.zeros((R,), jnp.int32), fw=fw0,
             smp=jnp.zeros((R,), jnp.uint32),
             film=jnp.zeros((R, 3)),
             it=jnp.zeros((), jnp.int32))

    # worst case: one lane serially runs spp paths of max_depth bounces
    max_iters = spp * max_depth + 4

    def cond(c):
        return jnp.any(c["act"]) & (c["it"] < max_iters)

    def body(c):
        act_in = c["act"]
        c = _bounce(scene, spectrum, swl0, has_media, off_factor, min_depth,
                    rr_threshold, c["dep"], c)
        dep = c["dep"] + 1
        act = c["act"] & (dep < max_depth)
        done = act_in & jnp.logical_not(act)

        # finished paths: convert to sRGB with their own wavelengths, splat
        # into the per-pixel film (lane == pixel: no scatter needed)
        swl_d = swl0.replace(lam=c["lam"], pdf=c["lpdf"],
                             secondary_alive=c["alive"])
        Lrgb = spectrum.to_srgb(c["L"], swl_d)
        Lrgb = jnp.where(jnp.isfinite(Lrgb), Lrgb, 0.0)
        film = c["film"] + jnp.where(done[..., None],
                                     Lrgb * c["fw"][..., None], 0.0)
        smp = c["smp"] + done.astype(jnp.uint32)

        # regenerate lanes that still owe samples
        regen = done & (smp < budget.astype(jnp.uint32))
        st_n, ray_n, swl_n, fw_n = new_path(smp)
        m = regen[..., None]
        c.update(
            o=jnp.where(m, ray_n.origin, c["o"]),
            d=jnp.where(m, ray_n.direction, c["d"]),
            L=jnp.where(m, 0.0, c["L"]),
            thr=jnp.where(m, 1.0, c["thr"]),
            spdf=jnp.where(regen, 1e16, c["spdf"]),
            act=act | regen,
            eta=jnp.where(regen, 1.0, c["eta"]),
            st=jnp.where(regen, st_n, c["st"]),
            alive=jnp.where(regen, swl_n.secondary_alive, c["alive"]),
            lam=jnp.where(m, swl_n.lam, c["lam"]),
            lpdf=jnp.where(m, swl_n.pdf, c["lpdf"]),
            med=jnp.where(regen, cam_med, c["med"]),
            dep=jnp.where(regen, 0, dep),
            fw=jnp.where(regen, fw_n, c["fw"]),
            smp=smp, film=film, it=c["it"] + 1)
        return c

    out = jax.lax.while_loop(cond, body, c)
    smp = out["smp"].astype(jnp.float32)
    img = (out["film"] / jnp.maximum(smp, 1.0)[..., None]).reshape(H, W, 3)
    aovs = dict(albedo=out["alb"].reshape(H, W, 3),
                normal=out["nrm"].reshape(H, W, 3),
                nrays=out["nrays"], truncated=out["trunc"], iters=out["it"],
                film=out["film"], smp=out["smp"])
    return img, aovs


def render_sample(scene, camera, filt, frame_index, max_depth=16, min_depth=0,
                  rr_threshold=1.0):
    """One sample per pixel (one 'frame' in reference terms). Returns
    (radiance [H, W, 3], aovs)."""
    W, H = camera.resolution
    n = W * H
    pix = jnp.arange(n, dtype=jnp.uint32)
    px = (pix % W).astype(jnp.float32)
    py = (pix // W).astype(jnp.float32)
    st = rng.seed(pix, jnp.uint32(frame_index))

    st, u_film = rng.next_2d(st)
    offset, fw = filt.sample(u_film)
    p_film = jnp.stack([px + 0.5, py + 0.5], -1) + offset
    st, u_lens = rng.next_2d(st)
    ray = camera.generate_ray(p_film, u_lens)

    L, aovs = radiance(scene, ray, st, max_depth, min_depth, rr_threshold)
    L = L * fw[..., None]
    img = L.reshape(H, W, 3)
    counts = {k: aovs.pop(k) for k in ("nrays", "truncated")}
    out_aovs = {k: v.reshape(H, W, -1) for k, v in aovs.items()}
    out_aovs.update(counts)
    return img, out_aovs
