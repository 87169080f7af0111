"""Surfel-based radiance cache.

Equivalent of `/root/reference/src/render_core/radiancecache/surfel/`
(accelerator/element/surfel): a fixed pool of oriented disk probes
accumulating irradiance. TPU-native layout: surfels live in SoA arrays
bucketed by a world-space hash grid (one surfel slot per cell); spawning is
a scatter from G-buffer pixels into empty cells, queries blend the
containing cell's surfel with a distance/normal kernel.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core.math import safe_div
from .sharc import _hash, _U32


@struct.dataclass
class SurfelPool:
    pos: jnp.ndarray        # [C, 3]
    normal: jnp.ndarray     # [C, 3]
    radius: jnp.ndarray     # [C]
    irradiance: jnp.ndarray  # [C, 3]
    count: jnp.ndarray      # [C]
    live: jnp.ndarray       # [C] bool
    cell_size: float = struct.field(pytree_node=False)
    capacity: int = struct.field(pytree_node=False)

    @classmethod
    def create(cls, capacity=1 << 16, cell_size=0.15):
        return cls(pos=jnp.zeros((capacity, 3)),
                   normal=jnp.zeros((capacity, 3)),
                   radius=jnp.zeros(capacity),
                   irradiance=jnp.zeros((capacity, 3)),
                   count=jnp.zeros(capacity),
                   live=jnp.zeros(capacity, bool),
                   cell_size=cell_size, capacity=capacity)


def _slot(pool, pos):
    q = jnp.floor(pos / pool.cell_size).astype(jnp.int32).astype(_U32)
    h = _hash(q[..., 0] ^ _hash(q[..., 1] ^ _hash(q[..., 2])))
    return (h % _U32(pool.capacity)).astype(jnp.int32)


def spawn(pool, pos, normal, mask):
    """Allocate surfels for covered surface points (accelerator spawn pass).
    Existing live cells keep their surfel; empty cells take the last writer."""
    slot = _slot(pool, pos)
    fresh = jnp.logical_not(pool.live[slot]) & mask
    w = fresh.astype(jnp.float32)[..., None]
    return pool.replace(
        pos=pool.pos.at[slot].set(jnp.where(w > 0, pos, pool.pos[slot])),
        normal=pool.normal.at[slot].set(
            jnp.where(w > 0, normal, pool.normal[slot])),
        radius=pool.radius.at[slot].set(
            jnp.where(fresh, pool.cell_size, pool.radius[slot])),
        live=pool.live.at[slot].set(pool.live[slot] | fresh))


def accumulate(pool, pos, radiance, mask):
    """Add irradiance samples into the containing surfels."""
    slot = _slot(pool, pos)
    w = (mask & pool.live[slot]).astype(jnp.float32)
    return pool.replace(
        irradiance=pool.irradiance.at[slot].add(radiance * w[..., None]),
        count=pool.count.at[slot].add(w))


def query(pool, pos, normal):
    """(irradiance [N, 3], weight) with distance + orientation falloff."""
    slot = _slot(pool, pos)
    sp = pool.pos[slot]
    sn = pool.normal[slot]
    mean = safe_div(pool.irradiance[slot], pool.count[slot][..., None])
    d = jnp.linalg.norm(pos - sp, axis=-1)
    w_d = jnp.clip(1.0 - d / jnp.maximum(pool.radius[slot] * 2.0, 1e-6),
                   0.0, 1.0)
    w_n = jnp.clip(jnp.sum(normal * sn, -1), 0.0, 1.0)
    w = w_d * w_n * pool.live[slot] * (pool.count[slot] >= 4.0)
    return mean * w[..., None], w
