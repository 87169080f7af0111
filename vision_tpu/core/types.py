"""Core SoA pytree types carried through the wavefront loop.

Replacements for the reference DSL structs: `RayVar`/`TriangleHit`
(`/root/reference/src/base/mgr/geometry.cpp`), `Interaction`
(`/root/reference/src/base/scattering/interaction.h:182-260`) and
`RayState` (`sample.h:48-60`). Every field is an array with a shared leading
wavefront axis; jax transforms (jit/grad/shard_map) treat them as pytrees.
"""
from __future__ import annotations

import jax.numpy as jnp
from . import struct


@struct.dataclass
class Ray:
    origin: jnp.ndarray      # [..., 3]
    direction: jnp.ndarray   # [..., 3] normalized
    t_max: jnp.ndarray       # [...]

    @classmethod
    def make(cls, origin, direction, t_max=None):
        if t_max is None:
            t_max = jnp.full(origin.shape[:-1], 1e30, jnp.float32)
        return cls(origin=origin, direction=direction, t_max=t_max)

    def at(self, t):
        return self.origin + t[..., None] * self.direction


@struct.dataclass
class Hit:
    """Closest-hit record (reference TriangleHit{inst_id, prim_id, bary})."""
    t: jnp.ndarray        # [...] hit distance (t_max if miss)
    prim_id: jnp.ndarray  # [...] int32 triangle index (-1 = miss)
    bary: jnp.ndarray     # [..., 2] barycentric (b1, b2)

    @property
    def is_miss(self):
        return self.prim_id < 0

    @property
    def is_hit(self):
        return self.prim_id >= 0


@struct.dataclass
class Interaction:
    """Shading-point record (reference interaction.h Interaction):
    position, geometric/shading normals, uv, wo, and flattened ids."""
    pos: jnp.ndarray        # [..., 3]
    ng: jnp.ndarray         # [..., 3] geometric normal
    ns: jnp.ndarray         # [..., 3] shading normal
    tangent: jnp.ndarray    # [..., 3] shading tangent (dp_du orthonormalized)
    uv: jnp.ndarray         # [..., 2]
    wo: jnp.ndarray         # [..., 3] outgoing dir (to viewer), world space
    inst_id: jnp.ndarray    # [...] int32
    mat_id: jnp.ndarray     # [...] int32 (-1 = none)
    light_id: jnp.ndarray   # [...] int32 (-1 = not emissive)
    prim_area_pdf: jnp.ndarray  # [...] pdf of the hit point wrt area measure of its light (filled for emissive hits)
