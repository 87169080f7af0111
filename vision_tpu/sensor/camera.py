"""Camera ray generation: pinhole + thin-lens.

Parity with `/root/reference/src/base/sensor/sensor.cpp:44-56`
(raster -> screen -> camera at z=1 scaled by tan(fov_y/2), then c2w) and
`render_core/sensor/thin_lens.cpp` (lens disk sample + focal plane).
Screen window follows frame_buffer.cpp update_screen_window: the wider axis
spans [-aspect, aspect].
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core.math import normalize, vec3
from ..core.types import Ray
from ..core import warp


@struct.dataclass
class Camera:
    c2w: jnp.ndarray          # [4, 4] camera-to-world (forward = +z col)
    tan_half_fov: jnp.ndarray  # scalar
    lens_radius: jnp.ndarray
    focal_distance: jnp.ndarray
    resolution: tuple = struct.field(pytree_node=False)  # (W, H)

    @classmethod
    def make(cls, c2w, fov_y_deg, resolution, lens_radius=0.0,
             focal_distance=5.0):
        return cls(
            c2w=jnp.asarray(np.asarray(c2w, np.float32)),
            tan_half_fov=jnp.asarray(np.tan(np.deg2rad(fov_y_deg) / 2.0),
                                     jnp.float32),
            lens_radius=jnp.asarray(lens_radius, jnp.float32),
            focal_distance=jnp.asarray(focal_distance, jnp.float32),
            resolution=tuple(resolution),
        )

    def screen_window(self):
        w, h = self.resolution
        ratio = w / h
        if ratio > 1.0:
            return (-ratio, -1.0), (ratio, 1.0)
        return (-1.0, -1.0 / ratio), (1.0, 1.0 / ratio)

    def generate_ray(self, p_film, u_lens=None):
        """p_film [..., 2] raster coords (pixel + filter offset).
        Returns world-space Ray."""
        w, h = self.resolution
        (lx, ly), (ux, uy) = self.screen_window()
        sx = lx + (p_film[..., 0] / w) * (ux - lx)
        sy = uy + (p_film[..., 1] / h) * (ly - uy)  # raster y down -> screen y up
        d_local = vec3(sx * self.tan_half_fov, sy * self.tan_half_fov,
                       jnp.ones_like(sx))
        o_local = jnp.zeros_like(d_local)
        if u_lens is not None:
            p_lens = warp.square_to_disk(u_lens) * self.lens_radius
            ft = self.focal_distance / d_local[..., 2]
            p_focus = d_local * ft[..., None]
            o_local = jnp.concatenate(
                [p_lens, jnp.zeros_like(p_lens[..., :1])], axis=-1)
            d_local = p_focus - o_local
        d_local = normalize(d_local)
        R = self.c2w[:3, :3]
        o_world = o_local @ R.T + self.c2w[:3, 3]
        d_world = normalize(d_local @ R.T)
        return Ray.make(o_world, d_world)

    @property
    def position(self):
        return self.c2w[:3, 3]
