"""SHARC: spatial-hash radiance cache.

TPU-native equivalent of `/root/reference/src/render_core/radiancecache/
sharc/` (SpatialHashRadianceCache sharc.cpp, 64-bit hash-grid keys over
position+level+normal in hash_grid.h, voxel accumulate/resolve
sharc.h:122-500). Design changes for TPU:

  * the hash table is a fixed-size open-addressing SoA (key-check word,
    radiance accumulator, sample count) — no pointers, no device atomics:
    accumulation uses deterministic scatter-add, insertion uses scatter with
    last-writer-wins on fresh slots (collisions drop samples, which only
    costs variance);
  * camera-distance-based LOD picks the voxel size per sample (hash_grid.h
    GetGridLevel analog);
  * resolve() folds the frame's accumulation into an exponential moving
    average, matching the reference's temporal accumulation.

Implements the abstract RadianceCache interface of the reference
(`base/integral/radiance_cache.h:20-45`: update / resolve / compaction /
query).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core.math import safe_div

_U32 = jnp.uint32


@struct.dataclass
class SharcCache:
    key: jnp.ndarray        # [C] uint32 verification word (0 = empty)
    radiance: jnp.ndarray   # [C, 3] resolved cache value
    acc: jnp.ndarray        # [C, 3] frame accumulator
    acc_n: jnp.ndarray      # [C] frame sample count
    total_n: jnp.ndarray    # [C] lifetime count
    base_voxel: float = struct.field(pytree_node=False)
    capacity: int = struct.field(pytree_node=False)

    @classmethod
    def create(cls, capacity=1 << 18, base_voxel=0.05):
        return cls(key=jnp.zeros(capacity, _U32),
                   radiance=jnp.zeros((capacity, 3)),
                   acc=jnp.zeros((capacity, 3)),
                   acc_n=jnp.zeros(capacity),
                   total_n=jnp.zeros(capacity),
                   base_voxel=base_voxel, capacity=capacity)


def _hash(x):
    x = x.astype(_U32)
    x = x * _U32(747796405) + _U32(2891336453)
    w = ((x >> ((x >> _U32(28)) + _U32(4))) ^ x) * _U32(277803737)
    return (w >> _U32(22)) ^ w


def _cell_of(cache, pos, normal, cam_pos):
    """(slot index, verification key) for each sample (hash_grid.h keying:
    quantized position + LOD level + normal octant)."""
    dist = jnp.linalg.norm(pos - cam_pos, axis=-1)
    level = jnp.clip(jnp.log2(jnp.maximum(dist, 1e-3) + 1.0).astype(jnp.int32),
                     0, 7)
    voxel = cache.base_voxel * (2.0 ** level.astype(jnp.float32))
    q = jnp.floor(pos / voxel[..., None]).astype(jnp.int32).astype(_U32)
    oct_ = ((normal[..., 0] > 0).astype(_U32)
            | ((normal[..., 1] > 0).astype(_U32) << 1)
            | ((normal[..., 2] > 0).astype(_U32) << 2))
    h = _hash(q[..., 0] ^ _hash(q[..., 1] ^ _hash(q[..., 2])))
    h = _hash(h ^ (oct_ << _U32(8)) ^ (level.astype(_U32) << _U32(12)))
    key = h | _U32(1)  # never 0 (0 marks empty)
    slot = (h % _U32(cache.capacity)).astype(jnp.int32)
    return slot, key


def update(cache, pos, normal, radiance, cam_pos, mask):
    """Accumulate per-vertex radiance samples into the frame accumulator
    (sharc.h voxel accumulate). mask: valid lanes."""
    slot, key = _cell_of(cache, pos, normal, cam_pos)
    w = mask.astype(jnp.float32)
    # claim empty or matching slots; mismatched-key slots drop the sample
    cur = cache.key[slot]
    claimable = (cur == 0) | (cur == key)
    w = w * claimable.astype(jnp.float32)
    new_key = cache.key.at[slot].max(jnp.where(claimable & mask, key, 0))
    acc = cache.acc.at[slot].add(radiance * w[..., None])
    acc_n = cache.acc_n.at[slot].add(w)
    return cache.replace(key=new_key, acc=acc, acc_n=acc_n)


def resolve(cache, ema=0.2):
    """Fold the frame accumulator into the cache (sharc.h resolve pass)."""
    frame_mean = safe_div(cache.acc, cache.acc_n[..., None])
    has_new = cache.acc_n > 0
    fresh = cache.total_n == 0
    a = jnp.where(fresh, 1.0, ema)[..., None]
    rad = jnp.where(has_new[..., None],
                    cache.radiance + (frame_mean - cache.radiance) * a,
                    cache.radiance)
    return cache.replace(radiance=rad,
                         total_n=cache.total_n + cache.acc_n,
                         acc=jnp.zeros_like(cache.acc),
                         acc_n=jnp.zeros_like(cache.acc_n))


def query(cache, pos, normal, cam_pos):
    """(radiance [N, 3], hit_mask) — cache lookup at shading points."""
    slot, key = _cell_of(cache, pos, normal, cam_pos)
    ok = (cache.key[slot] == key) & (cache.total_n[slot] >= 4.0)
    return cache.radiance[slot] * ok[..., None].astype(jnp.float32), ok


def compaction(cache, min_count=1.0, decay=0.9):
    """Age entries; evict stale cells (sharc compaction pass)."""
    n = cache.total_n * decay
    dead = n < min_count
    return cache.replace(
        key=jnp.where(dead, 0, cache.key),
        radiance=jnp.where(dead[..., None], 0.0, cache.radiance),
        total_n=jnp.where(dead, 0.0, n))
