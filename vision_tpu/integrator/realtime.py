"""Real-time integrator: G-buffer + ReSTIR DI + ReSTIR GI + SHARC + SVGF.

Equivalent of the reference `rt` integrator
(`/root/reference/src/render_core/integrator/rt.cpp` render flow, SURVEY.md
§3.3): compute_GBuffer -> ReSTIR DI dispatch -> ReSTIR GI dispatch (initial
PT sample -> temporal reuse -> spatial reuse) -> SHARC radiance-cache
update/resolve (queried at GI secondary vertices) -> combine -> SVGF
reproject/filter. State (DI + GI reservoirs, SHARC cache, SVGF history,
previous G-buffer) is an explicit pytree carried across frames — the
functional analog of the reference's persistent device buffers.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..caches import sharc as sharc_mod
from ..core import rng
from ..post import svgf as svgf_mod
from ..sensor.gbuffer import compute_gbuffer
from . import restir, restir_gi


@struct.dataclass
class RealTimeState:
    reservoir: object     # restir.Reservoir (DI)
    gi_reservoir: object  # restir_gi.GIReservoir
    sharc: object         # caches.sharc.SharcCache
    gbuffer: object       # GBuffer (previous frame)
    svgf: object          # SVGFState
    frame: jnp.ndarray    # scalar int
    # previous LOW-RES gbuffer when GI runs at reduced resolution
    # (gi_scale < 1): GI temporal reuse must validate against the same
    # lattice it renders on
    gbuffer_gi: object = None

    @classmethod
    def initial(cls, resolution, sharc_capacity=1 << 16, base_voxel=0.05,
                cache="sharc", gi_scale=1.0):
        """cache: the radiance-cache plugin choice, "sharc" (hash grid,
        render_core/radiancecache/sharc) or "surfel"
        (render_core/radiancecache/surfel). The `sharc` state field holds
        whichever cache object was selected."""
        W, H = resolution
        if cache == "surfel":
            from ..caches import surfel as surfel_mod
            c = surfel_mod.SurfelPool.create(sharc_capacity,
                                             cell_size=base_voxel * 3.0)
        else:
            c = sharc_mod.SharcCache.create(sharc_capacity, base_voxel)
        Wg, Hg = max(int(W * gi_scale), 1), max(int(H * gi_scale), 1)
        return cls(reservoir=restir.Reservoir.empty(W * H),
                   gi_reservoir=restir_gi.GIReservoir.empty(Wg * Hg),
                   sharc=c,
                   gbuffer=None, svgf=svgf_mod.init_state(H, W),
                   frame=jnp.zeros((), jnp.int32))


def render_realtime(scene, camera, rt_state, m_light=8, spatial_taps=2,
                    svgf_passes=3, gi=True, use_sharc=True,
                    gi_bounce_depth=2, prev_camera=None, gi_scale=1.0):
    """One real-time frame. Returns (display image [H, W, 3], new state).
    Pass prev_camera when the camera moved so motion vectors reproject
    correctly (sensor.cpp store_prev_data analog).

    gi_scale < 1 renders the indirect (ReSTIR GI) pass on a reduced
    lattice and joint-bilaterally upsamples it against the full-res
    G-buffer (the Upsampler plugin's production use; GI is ~60% of a
    classroom frame, so 0.5 cuts the frame time nearly 2x). Construct the
    state with RealTimeState.initial(gi_scale=...) so the GI reservoirs
    match. Known cost: edge-proportional energy bias from bilateral bleed
    at GI texel boundaries (+15% on a 64^2 cbox, shrinking with
    resolution) — default stays full-res."""
    W, H = camera.resolution
    frame = rt_state.frame
    prev_cam = prev_camera if prev_camera is not None else camera

    gb = compute_gbuffer(scene, camera, frame, prev_camera=prev_cam)
    n = W * H
    st = rng.seed(jnp.arange(n, dtype=jnp.uint32) ^ jnp.uint32(0x9e3779b9),
                  frame.astype(jnp.uint32))

    # GI lattice (optionally reduced)
    Wg, Hg = (max(int(W * gi_scale), 1), max(int(H * gi_scale), 1))
    lowres_gi = (Wg, Hg) != (W, H)
    if lowres_gi:
        cam_gi = camera.replace(resolution=(Wg, Hg))
        prev_cam_gi = prev_cam.replace(resolution=(Wg, Hg))
        gb_gi = compute_gbuffer(scene, cam_gi, frame,
                                prev_camera=prev_cam_gi)
        st_gi = rng.seed(jnp.arange(Wg * Hg, dtype=jnp.uint32)
                         ^ jnp.uint32(0x7f4a7c15), frame.astype(jnp.uint32))
    else:
        gb_gi = gb
        st_gi = rng.seed(jnp.arange(n, dtype=jnp.uint32)
                         ^ jnp.uint32(0x7f4a7c15), frame.astype(jnp.uint32))

    prev_di = prev_gi = None
    if rt_state.gbuffer is not None:
        prev_di = (rt_state.reservoir, rt_state.gbuffer)
        prev_gb_gi = (rt_state.gbuffer_gi if lowres_gi
                      else rt_state.gbuffer)
        if prev_gb_gi is not None:
            prev_gi = (rt_state.gi_reservoir, prev_gb_gi)

    # --- ReSTIR DI (rt.cpp: _direct->dispatch) ---
    st, L_direct, new_res = restir.restir_di(
        scene, gb, st, prev=prev_di, frame_index=frame, m_light=m_light,
        spatial_taps=spatial_taps, resolution=(W, H))

    # --- ReSTIR GI + SHARC (rt.cpp: _indirect->dispatch, cache update) ---
    new_gi = rt_state.gi_reservoir
    new_sharc = rt_state.sharc
    cam_pos = camera.position if hasattr(camera, "position") else \
        camera.c2w[:3, 3]
    if gi:
        from ..caches.surfel import SurfelPool
        is_surfel = isinstance(rt_state.sharc, SurfelPool)
        cache = rt_state.sharc if use_sharc else None
        _, L_ind, new_gi, cache_samples = restir_gi.restir_gi(
            scene, gb_gi, st_gi, prev=prev_gi, resolution=(Wg, Hg),
            spatial_taps=spatial_taps, bounce_depth=gi_bounce_depth,
            sharc=None if is_surfel else cache, cam_pos=cam_pos,
            surfel=cache if is_surfel else None)
        if lowres_gi:
            from ..post.upsample import bilateral_upsample
            L_ind = bilateral_upsample(
                L_ind.reshape(Hg, Wg, 3),
                gb.normal.reshape(H, W, 3),
                gb.depth.reshape(H, W)).reshape(n, 3)
        if use_sharc:
            x_s, n_s, L_path, ok = cache_samples
            if is_surfel:
                from ..caches import surfel as sf
                new_sharc = sf.spawn(rt_state.sharc, x_s, n_s, ok)
                new_sharc = sf.accumulate(new_sharc, x_s, L_path, ok)
            else:
                new_sharc = sharc_mod.update(rt_state.sharc, x_s, n_s,
                                             L_path, cam_pos, ok)
                new_sharc = sharc_mod.resolve(new_sharc)
        L = L_direct + L_ind
    else:
        L = L_direct

    # SVGF filters the demodulated SURFACE illumination only: emissive
    # pixels (albedo 0, radiance >> 0) explode under albedo demodulation
    # and primary-miss env pixels aren't illumination either — both are
    # composited back after filtering (reference modulator pass).
    from ..lights import lights as lt
    env = lt.env_radiance(scene.lights, scene.atlas, -gb.wo)
    L_surf = jnp.where(gb.valid[..., None], L - gb.emission, 0.0)

    img = L_surf.reshape(H, W, 3)
    filtered, new_svgf = svgf_mod.svgf_filter(
        img, gb.albedo.reshape(H, W, 3), gb.normal.reshape(H, W, 3),
        gb.depth.reshape(H, W), gb.motion.reshape(H, W, 2),
        rt_state.svgf, n_passes=svgf_passes)
    em_env = jnp.where(gb.valid[..., None], gb.emission, env)
    filtered = filtered + em_env.reshape(H, W, 3)

    new_state = RealTimeState(reservoir=new_res, gi_reservoir=new_gi,
                              sharc=new_sharc, gbuffer=gb, svgf=new_svgf,
                              frame=frame + 1,
                              gbuffer_gi=gb_gi if lowres_gi else None)
    return filtered, new_state
