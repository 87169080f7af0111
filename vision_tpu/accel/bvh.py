"""LBVH build (host, vectorized numpy) over Morton-sorted triangles.

TPU-native replacement for OptiX BLAS/TLAS (`/root/reference/src/base/mgr/
geometry.cpp:36-53 build_accel`). Design rationale: TPU traversal wants a
*stackless* walk with per-lane node pointers, so we build an implicit,
perfectly balanced binary tree over Morton-ordered triangle chunks and
precompute DFS skip links:

  - leaves   = chunks of LEAF_SIZE consecutive Morton-sorted triangles
  - interior = implicit heap (children of k are 2k+1, 2k+2)
  - hit  -> descend to left child (k*2+1)
  - miss -> jump to skip[k] (next subtree in DFS order)

The whole build is O(N log N) numpy with no per-node Python loop, so even
million-triangle scenes build in well under a second. Quality is below SAH
but traversal never needs a stack, which keeps the device inner loop to two
gathers + compares per step.
"""
from __future__ import annotations

import numpy as np
from ..core import struct
import jax.numpy as jnp

LEAF_SIZE = 4


@struct.dataclass
class BVH:
    node_min: jnp.ndarray    # [n_nodes, 3]
    node_max: jnp.ndarray    # [n_nodes, 3]
    skip: jnp.ndarray        # [n_nodes] int32 DFS miss-link (-1 = done)
    first_leaf: jnp.ndarray  # scalar int32: index of first leaf node
    prim_order: jnp.ndarray  # [padded_prims] int32 triangle id (-1 = padding)
    # triangle soup in traversal order (pre-gathered to avoid double indirection)
    tri_p0: jnp.ndarray      # [padded_prims, 3]
    tri_e1: jnp.ndarray      # [padded_prims, 3]  (p1 - p0)
    tri_e2: jnp.ndarray      # [padded_prims, 3]  (p2 - p0)


def _morton3(x, y, z):
    """Interleave 10-bit ints -> 30-bit Morton codes (vectorized)."""
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (expand(x) << np.uint64(2)) | (expand(y) << np.uint64(1)) | expand(z)


def build_bvh(positions, triangles):
    """positions [V,3] f32, triangles [T,3] i32 -> BVH arrays (host numpy)."""
    tris = np.asarray(triangles, np.int64)
    P = np.asarray(positions, np.float32)
    p0 = P[tris[:, 0]]
    p1 = P[tris[:, 1]]
    p2 = P[tris[:, 2]]
    n = len(tris)

    cent = (p0 + p1 + p2) / 3.0
    lo = cent.min(0)
    hi = cent.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((cent - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int64)

    n_leaves = max(1, -(-n // LEAF_SIZE))
    depth = max(0, int(np.ceil(np.log2(n_leaves))))
    n_leaves_p = 1 << depth
    n_prims_p = n_leaves_p * LEAF_SIZE

    prim_order = np.full(n_prims_p, -1, np.int64)
    prim_order[:n] = order

    # per-prim AABBs in sorted order (padding = inverted boxes)
    big = np.float32(3e38)
    pmin = np.full((n_prims_p, 3), big, np.float32)
    pmax = np.full((n_prims_p, 3), -big, np.float32)
    sp0, sp1, sp2 = p0[order], p1[order], p2[order]
    pmin[:n] = np.minimum(np.minimum(sp0, sp1), sp2)
    pmax[:n] = np.maximum(np.maximum(sp0, sp1), sp2)

    # leaf AABBs
    lmin = pmin.reshape(n_leaves_p, LEAF_SIZE, 3).min(1)
    lmax = pmax.reshape(n_leaves_p, LEAF_SIZE, 3).max(1)

    # interior levels bottom-up; heap layout: level d has 2^d nodes,
    # node offset for level d = 2^d - 1
    n_nodes = 2 * n_leaves_p - 1
    node_min = np.full((n_nodes, 3), big, np.float32)
    node_max = np.full((n_nodes, 3), -big, np.float32)
    first_leaf = n_leaves_p - 1
    node_min[first_leaf:] = lmin
    node_max[first_leaf:] = lmax
    cur_min, cur_max = lmin, lmax
    for d in range(depth - 1, -1, -1):
        cur_min = np.minimum(cur_min[0::2], cur_min[1::2])
        cur_max = np.maximum(cur_max[0::2], cur_max[1::2])
        off = (1 << d) - 1
        node_min[off:off + (1 << d)] = cur_min
        node_max[off:off + (1 << d)] = cur_max

    # skip links: root -1; left child -> right sibling; right child -> parent skip
    skip = np.full(n_nodes, -1, np.int64)
    for d in range(0, depth):
        off = (1 << d) - 1
        nodes = np.arange(off, off + (1 << d))
        left = nodes * 2 + 1
        right = nodes * 2 + 2
        skip[left] = right
        skip[right] = skip[nodes]

    # pre-gathered triangle data in traversal order
    safe = np.maximum(prim_order, 0)
    t0 = P[tris[safe, 0]]
    t1 = P[tris[safe, 1]]
    t2 = P[tris[safe, 2]]
    pad = prim_order < 0
    t0[pad] = 0.0
    t1[pad] = 0.0
    t2[pad] = 0.0

    return BVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        skip=jnp.asarray(skip, jnp.int32),
        first_leaf=jnp.asarray(first_leaf, jnp.int32),
        prim_order=jnp.asarray(prim_order, jnp.int32),
        tri_p0=jnp.asarray(t0),
        tri_e1=jnp.asarray(t1 - t0),
        tri_e2=jnp.asarray(t2 - t0),
    )
