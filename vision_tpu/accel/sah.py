"""Binned-SAH tree in the packed layout the GPU traversal kernel walks.

The tree comes from the native builder (native/bvh_builder.cpp): DFS
preorder, left child of inner node i at i + 1, right child at skip[i + 1],
and the left child on the lower side of the node's split axis. Packed for
native/trace.cu:

  boxes [N, 8] f32   lo.xyz, 0, hi.xyz, 0
  links [N, 2] i32   inner: (right child, -(axis + 1)); leaf: (first row, count)
  tris  [T, 12] f32  p0.xyz 0, e1.xyz 0, e2.xyz 0 in leaf order
  prim  [T] i32      original triangle id of each row

The triangle rows are copied bit for bit from the scene's own p0/e1/e2, so
the kernel's intersection test sees exactly what the dense sweep sees.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import struct

LEAF_SIZE = 4


@struct.dataclass
class SahBVH:
    boxes: jnp.ndarray   # [N, 8] f32
    links: jnp.ndarray   # [N, 2] i32
    tris: jnp.ndarray    # [T, 12] f32
    prim: jnp.ndarray    # [T] i32


def pack_sah(tree, p0, e1, e2):
    """Native builder output (native.build_bvh_native) + the scene's
    triangle arrays -> numpy (boxes, links, tris, prim)."""
    n_nodes = len(tree["first"])
    boxes = np.zeros((n_nodes, 8), np.float32)
    boxes[:, 0:3] = tree["lo"]
    boxes[:, 4:7] = tree["hi"]
    count = tree["count"].astype(np.int64)
    inner = count == 0
    links = np.stack([tree["first"], count], -1).astype(np.int64)
    # right child of inner node i = skip of its left child i + 1
    idx = np.nonzero(inner)[0]
    links[idx, 0] = tree["skip"][idx + 1]
    links[idx, 1] = -(tree["axis"][idx].astype(np.int64) + 1)
    order = tree["order"].astype(np.int64)
    tris = np.zeros((len(order), 12), np.float32)
    tris[:, 0:3] = p0[order]
    tris[:, 4:7] = e1[order]
    tris[:, 8:11] = e2[order]
    return boxes, links.astype(np.int32), tris, order.astype(np.int32)


def build_sah(p0, e1, e2):
    """SahBVH over triangles (p0, e1 = p1 - p0, e2 = p2 - p0) [T, 3] f32,
    or None when the native builder cannot be built on this host."""
    from .. import native
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    tree = native.build_bvh_native(p0, p0 + e1, p0 + e2, max_leaf=LEAF_SIZE)
    if tree is None:
        return None
    boxes, links, tris, prim = pack_sah(tree, p0, e1, e2)
    return SahBVH(boxes=jnp.asarray(boxes), links=jnp.asarray(links),
                  tris=jnp.asarray(tris), prim=jnp.asarray(prim))
