"""G-buffer pass: primary visibility AOVs + motion vectors.

Equivalent of FrameBuffer::compute_geom (`/root/reference/src/base/sensor/
frame_buffer.cpp:156-221`): one primary ray per pixel producing position,
depth, shading normal, albedo, emission, material id, uv, and screen-space
motion vectors against the previous frame's camera (sensor.cpp
prev_raster_coord). Consumed by ReSTIR (surface data) and SVGF (reprojection).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core import rng
from ..core.math import coordinate_system, dot, normalize, to_local
from ..core.types import Ray
from ..integrator import pt
from ..shading import bsdf as ub
from ..shading.materials import gather_params


@struct.dataclass
class GBuffer:
    pos: jnp.ndarray       # [N, 3]
    depth: jnp.ndarray     # [N]
    normal: jnp.ndarray    # [N, 3]
    albedo: jnp.ndarray    # [N, 3]
    emission: jnp.ndarray  # [N, 3]
    mat_id: jnp.ndarray    # [N]
    inst_id: jnp.ndarray   # [N]
    uv: jnp.ndarray        # [N, 2]
    wo: jnp.ndarray        # [N, 3]
    valid: jnp.ndarray     # [N] bool (primary hit)
    motion: jnp.ndarray    # [N, 2] raster-space motion vector


def raster_coord(camera, pos):
    """World position -> raster xy (sensor.cpp raster_coord)."""
    W, H = camera.resolution
    R = camera.c2w[:3, :3]
    t = camera.c2w[:3, 3]
    local = (pos - t) @ R  # R^T (orthonormal-ish) - world to camera
    z = jnp.maximum(local[..., 2], 1e-6)
    sx = local[..., 0] / (z * camera.tan_half_fov)
    sy = local[..., 1] / (z * camera.tan_half_fov)
    (lx, ly), (ux, uy) = camera.screen_window()
    px = (sx - lx) / (ux - lx) * W
    py = (uy - sy) / (uy - ly) * H
    return jnp.stack([px, py], -1)


def compute_gbuffer(scene, camera, frame_index, prev_camera=None,
                    jitter=True):
    """One primary-visibility pass. Returns GBuffer with flat [N] layout."""
    spectrum = scene.spectrum
    W, H = camera.resolution
    n = W * H
    pix = jnp.arange(n, dtype=jnp.uint32)
    px = (pix % W).astype(jnp.float32)
    py = (pix // W).astype(jnp.float32)
    st = rng.seed(pix, jnp.uint32(frame_index) ^ jnp.uint32(0x51a7b0d1))
    if jitter:
        st, u = rng.next_2d(st)
    else:
        u = jnp.full((n, 2), 0.5)
    p_film = jnp.stack([px, py], -1) + u
    ray = camera.generate_ray(p_film)
    hit = pt.trace_closest(scene, ray)
    pos, ng, ns, uv, inst, mat_id, light_id = pt.compute_interaction(
        scene, ray, hit)
    valid = hit.is_hit

    state, swl = spectrum.sample_wavelengths(st)
    params, _ = gather_params(scene.materials, scene.atlas, mat_id, uv,
                              spectrum, swl)
    t, b = coordinate_system(ns)
    wo = -ray.direction
    wo_l = to_local(t, b, ns, wo)
    albedo = ub.albedo(params, wo_l)
    if albedo.shape[-1] != 3:
        albedo = jnp.broadcast_to(jnp.mean(albedo, -1, keepdims=True),
                                  albedo.shape[:-1] + (3,))

    from ..lights import lights as lt
    Le, _ = lt.eval_hit_area(scene.lights, light_id, hit.prim_id, None,
                             ray.origin, pos, ng, uv, scene.atlas)
    emission = jnp.where((light_id >= 0)[..., None], Le, 0.0)

    prev_cam = prev_camera if prev_camera is not None else camera
    prev_px = raster_coord(prev_cam, pos)
    cur_px = jnp.stack([px + 0.5, py + 0.5], -1)
    motion = jnp.where(valid[..., None], prev_px - cur_px, 0.0)

    return GBuffer(pos=pos, depth=jnp.where(valid, hit.t, 1e30),
                   normal=jnp.where(valid[..., None], ns, 0.0),
                   albedo=jnp.where(valid[..., None], albedo, 0.0),
                   emission=emission, mat_id=mat_id, inst_id=inst,
                   uv=uv, wo=wo, valid=valid, motion=motion)
