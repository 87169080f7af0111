"""Light-field framebuffer: an S x S grid of sub-aperture views.

TPU-native realization of the reference's `light_field` FrameBuffer plugin
(`/root/reference/src/render_core/framebuffer/light_field.cpp:20-26`),
whose role is to decouple ray generation from the display buffer via
`custom_generate_ray`. Here each sub-view pins the thin-lens aperture
sample to one fixed point of the lens disk (the `u_lens` input of
`Camera.generate_ray`), so the grid sweeps the synthetic aperture: every
tile is a parallax-shifted pinhole view through a different part of the
lens, and the set can be refocused a-posteriori by shift-and-sum
(`refocus`).

All views batch into ONE wavefront launch: the framebuffer presents a
stacked resolution (W, S*S*H) to the integrator (lane = (view, pixel)),
and the camera decodes the view index from the raster row — a
grid^2-times-wider launch keeps the chip busier than grid^2 small ones.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from .camera import Camera


@struct.dataclass
class SubApertureCamera(Camera):
    """Camera over the stacked (W, S*S*H) lane space: raster row encodes
    (view, local row); each view's aperture sample is pinned to its cell
    center of the lens' unit square. The stochastic `u_lens` the
    integrator passes is ignored — exactly `custom_generate_ray`
    overriding the sensor's sampling in the reference."""
    grid: int = struct.field(pytree_node=False, default=1)
    base_h: int = struct.field(pytree_node=False, default=0)

    def generate_ray(self, p_film, u_lens=None):
        S = self.grid
        H = self.base_h
        W = self.resolution[0]
        py = p_film[..., 1]
        view = jnp.clip(jnp.floor(py / H), 0, S * S - 1)
        local = py - view * H
        v = view.astype(jnp.int32)
        ui = ((v % S).astype(jnp.float32) + 0.5) / S
        uj = ((v // S).astype(jnp.float32) + 0.5) / S
        base = Camera(c2w=self.c2w, tan_half_fov=self.tan_half_fov,
                      lens_radius=self.lens_radius,
                      focal_distance=self.focal_distance,
                      resolution=(W, H))
        pf = jnp.stack([p_film[..., 0], local], -1)
        return base.generate_ray(pf, jnp.stack([ui, uj], -1))


def light_field_camera(camera, grid):
    """Wrap a (thin-lens) camera into the stacked S x S sub-aperture lane
    space: resolution (W, grid*grid*H), one sub-view per H-row band."""
    W, H = camera.resolution
    S = int(grid)
    return SubApertureCamera(
        c2w=camera.c2w, tan_half_fov=camera.tan_half_fov,
        lens_radius=camera.lens_radius,
        focal_distance=camera.focal_distance,
        resolution=(W, S * S * H),
        grid=S, base_h=H)


def film_to_tiles(img, base_resolution, grid):
    """Stacked film [S*S*H, W, 3] -> [S, S, H, W, 3] view tiles."""
    W, H = base_resolution
    S = int(grid)
    return jnp.reshape(img, (S, S, H, W, img.shape[-1]))


def mosaic(tiles):
    """[S, S, H, W, 3] -> one [S*H, S*W, 3] contact-sheet image."""
    S = tiles.shape[0]
    H, W, C = tiles.shape[2], tiles.shape[3], tiles.shape[4]
    return jnp.transpose(tiles, (0, 2, 1, 3, 4)).reshape(S * H, S * W, C)


def refocus(tiles, shift):
    """Shift-and-sum synthetic refocus: average the sub-views after
    translating each by `shift` pixels per unit aperture offset (0 keeps
    the lens' focal plane; +/- moves the virtual focus plane). Returns
    [H, W, 3]."""
    S = tiles.shape[0]
    out = jnp.zeros(tiles.shape[2:])
    for j in range(S):
        for i in range(S):
            du = (i + 0.5) / S - 0.5
            dv = (j + 0.5) / S - 0.5
            dx = int(round(du * shift))
            dy = int(round(dv * shift))
            out = out + jnp.roll(tiles[j, i], (dy, dx), axis=(0, 1))
    return out / (S * S)
