"""Ray-scene intersection: the traversal routes and the router between them.

Replaces OptiX `trace_closest`/`trace_occlusion` (`/root/reference/src/base/
mgr/geometry.cpp:168-185`). Three routes:

  * brute — blocks of triangles tested against all rays as dense [R, B]
    Möller-Trumbore; XLA fuses the test chain into the min/any reduction.
    Scenes of at most BRUTE_FORCE_MAX_TRIS triangles (no BVH) take it on
    the CPU; on the GPU the same sweep runs as a Pallas-Triton kernel
    (sweep_triton.py, route 'triton').
  * bvh — per-lane skip-link DFS over the Morton LBVH in one
    `lax.while_loop` over all lanes (see bvh.py). BVH scenes take it on
    the CPU.
  * cuda — one thread per ray over the binned-SAH tree (cuda_trace.py,
    native/trace.cu). BVH scenes take it on the GPU.

`trace` picks the route and applies the gradient rule shared by all three:
no cotangent flows into traversal; t and the barycentrics are recomputed
differentiably from the winning prim_id (`recompute_hit`). prim_id indexes
the *original* triangle array.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Hit, Ray
from .bvh import LEAF_SIZE

_EPS = 1e-9


def _mt_batch(o, d, p0, e1, e2):
    """Möller-Trumbore: rays [R,3] vs tris [R,B,3] (per-ray candidate sets) or
    broadcastable. Returns (t, u, v, hit_mask) each [R, B].

    Component-separated math: every intermediate is an [R, B] array (the
    trailing axis is the triangle batch), never an [R, B, 3].
    """
    def comp(a):
        return a[..., 0], a[..., 1], a[..., 2]

    ox, oy, oz = (c[..., None] for c in comp(o))
    dx, dy, dz = (c[..., None] for c in comp(d))
    p0x, p0y, p0z = comp(p0)
    e1x, e1y, e1z = comp(e1)
    e2x, e2y, e2z = comp(e2)

    # pv = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = jnp.where(jnp.abs(det) > _EPS,
                        1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    # qv = tv x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    # 1e-6 barycentric slack closes shared-edge cracks (rays exactly on a
    # shared edge round to v ~ -1e-17 in one triangle and would miss both)
    ok = ((jnp.abs(det) > _EPS) & (u >= -1e-6) & (v >= -1e-6)
          & (u + v <= 1.0 + 1e-6) & (t > 0.0))
    return t, u, v, ok


def _pad_tris(tri_p0, tri_e1, tri_e2, block):
    T = tri_p0.shape[0]
    pad = (-T) % block
    if pad:
        z = jnp.zeros((pad, 3), tri_p0.dtype)
        tri_p0 = jnp.concatenate([tri_p0, z])
        tri_e1 = jnp.concatenate([tri_e1, z])
        tri_e2 = jnp.concatenate([tri_e2, z])
    return tri_p0, tri_e1, tri_e2


def recompute_hit(ray, prim_id, tri_p0, tri_e1, tri_e2):
    """Hit(t, prim_id, bary) for an already-found prim: one [R]-wide MT
    redo, differentiable in the ray and the triangle. Misses keep
    t = ray.t_max and bary = 0.

    Keeping u/v out of the sweep lets XLA fuse the whole [R, B] test chain
    into the (t, id) min-reduction instead of materializing u/v planes."""
    pid = jnp.maximum(prim_id, 0)
    p0x, p0y, p0z = (tri_p0[:, i][pid] for i in range(3))
    e1x, e1y, e1z = (tri_e1[:, i][pid] for i in range(3))
    e2x, e2y, e2z = (tri_e2[:, i][pid] for i in range(3))
    ox, oy, oz = ray.origin[:, 0], ray.origin[:, 1], ray.origin[:, 2]
    dx, dy, dz = (ray.direction[:, 0], ray.direction[:, 1],
                  ray.direction[:, 2])
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = jnp.where(jnp.abs(det) > _EPS,
                        1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = prim_id >= 0
    uv = jnp.where(hit[..., None], jnp.stack([u, v], -1), 0.0)
    return Hit(t=jnp.where(hit, t, ray.t_max), prim_id=prim_id, bary=uv)


def intersect_brute(ray, tri_p0, tri_e1, tri_e2, block=128):
    """Closest hit by dense sweep. ray fields [R,...]; tris [T,...].

    The sweep carries only (best_t, best_id); barycentrics are recomputed
    for the single winning triangle afterwards (see recompute_hit). Blocks
    are 128 wide, so a tiny scene pads 36 -> 128."""
    R = ray.origin.shape[0]
    tp0, te1, te2 = _pad_tris(tri_p0, tri_e1, tri_e2, block)
    nb = tp0.shape[0] // block
    p0b = tp0.reshape(nb, block, 3)
    e1b = te1.reshape(nb, block, 3)
    e2b = te2.reshape(nb, block, 3)

    def body(carry, blk):
        best_t, best_id = carry
        p0, e1, e2, base = blk
        t, u, v, ok = _mt_batch(ray.origin, ray.direction,
                                p0[None], e1[None], e2[None])
        t = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.min(t, axis=-1)
        better = tj < best_t
        best_id = jnp.where(better, base + j.astype(jnp.int32), best_id)
        best_t = jnp.where(better, tj, best_t)
        return (best_t, best_id), None

    init = (ray.t_max, jnp.full((R,), -1, jnp.int32))
    if nb == 1:
        (t, pid), _ = body(init, (p0b[0], e1b[0], e2b[0], jnp.int32(0)))
    else:
        bases = (jnp.arange(nb) * block).astype(jnp.int32)
        (t, pid), _ = jax.lax.scan(body, init, (p0b, e1b, e2b, bases))
    return recompute_hit(ray, pid, tp0, te1, te2).replace(t=t)


def occluded_brute(ray, tri_p0, tri_e1, tri_e2, block=128):
    """Any-hit within t_max (shadow rays): a pure boolean reduction — no
    argmin, no id, no bary — so the whole sweep fuses to one any()."""
    tp0, te1, te2 = _pad_tris(tri_p0, tri_e1, tri_e2, block)
    nb = tp0.shape[0] // block
    p0b = tp0.reshape(nb, block, 3)
    e1b = te1.reshape(nb, block, 3)
    e2b = te2.reshape(nb, block, 3)

    def body(carry, blk):
        p0, e1, e2 = blk
        t, u, v, ok = _mt_batch(ray.origin, ray.direction,
                                p0[None], e1[None], e2[None])
        hit = jnp.any(ok & (t < ray.t_max[..., None]), axis=-1)
        return carry | hit, None

    init = jnp.zeros((ray.origin.shape[0],), bool)
    if nb == 1:
        occ, _ = body(init, (p0b[0], e1b[0], e2b[0]))
    else:
        occ, _ = jax.lax.scan(body, init, (p0b, e1b, e2b))
    return occ


def intersect_bvh(ray, bvh, any_hit=False, max_steps=10000):
    """Stackless skip-link traversal; all lanes step in lock-step.

    Each iteration: gather current node AABB, slab test; on hit at a leaf,
    test its LEAF_SIZE triangles; advance to child or skip link. Returns
    (Hit, truncated): lanes still walking after `max_steps` iterations keep
    their best hit so far and are counted in `truncated` (int32 scalar).
    """
    R = ray.origin.shape[0]
    inv_d = jnp.where(jnp.abs(ray.direction) > 1e-12,
                      1.0 / jnp.where(ray.direction == 0, 1.0, ray.direction),
                      jnp.sign(ray.direction) * 1e12 + jnp.where(ray.direction == 0, 1e12, 0.0))

    first_leaf = bvh.first_leaf

    def cond(state):
        node, best_t, _, _, done, steps = state
        return jnp.any(node >= 0) & (steps < max_steps)

    def body(state):
        node, best_t, best_id, best_uv, done, steps = state
        active = node >= 0
        nid = jnp.maximum(node, 0)
        nmin = bvh.node_min[nid]
        nmax = bvh.node_max[nid]
        # slab test
        t0 = (nmin - ray.origin) * inv_d
        t1 = (nmax - ray.origin) * inv_d
        tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = active & (tfar >= jnp.maximum(tnear, 0.0)) & (tnear < best_t)

        is_leaf = nid >= first_leaf
        do_leaf = box_hit & is_leaf

        # leaf: test LEAF_SIZE prims
        leaf_idx = (nid - first_leaf) * LEAF_SIZE
        offs = jnp.arange(LEAF_SIZE, dtype=jnp.int32)
        pidx = leaf_idx[:, None] + offs[None, :]
        p0 = bvh.tri_p0[pidx]
        e1 = bvh.tri_e1[pidx]
        e2 = bvh.tri_e2[pidx]
        t, u, v, ok = _mt_batch(ray.origin, ray.direction, p0, e1, e2)
        real = bvh.prim_order[pidx] >= 0
        ok = ok & real & do_leaf[:, None] & (t < best_t[:, None])
        t = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], -1)[:, 0]
        better = tj < best_t
        uj = jnp.take_along_axis(u, j[:, None], -1)[:, 0]
        vj = jnp.take_along_axis(v, j[:, None], -1)[:, 0]
        sel = jnp.take_along_axis(pidx, j[:, None], -1)[:, 0]
        best_id = jnp.where(better, bvh.prim_order[sel], best_id)
        best_uv = jnp.where(better[:, None], jnp.stack([uj, vj], -1), best_uv)
        best_t = jnp.where(better, tj, best_t)

        if any_hit:
            done = done | (best_id >= 0)

        # advance: interior hit -> left child; else skip
        next_node = jnp.where(box_hit & jnp.logical_not(is_leaf),
                              nid * 2 + 1, bvh.skip[nid])
        next_node = jnp.where(active & jnp.logical_not(done), next_node, -1)
        return next_node, best_t, best_id, best_uv, done, steps + 1

    node0 = jnp.zeros((R,), jnp.int32)
    state = (node0, ray.t_max, jnp.full((R,), -1, jnp.int32),
             jnp.zeros((R, 2)), jnp.zeros((R,), bool), jnp.asarray(0, jnp.int32))
    node, t, pid, uv, done, _ = jax.lax.while_loop(cond, body, state)
    truncated = jnp.sum((node >= 0).astype(jnp.int32))
    return Hit(t=t, prim_id=pid, bary=uv), truncated


def choose_route(has_bvh, backend, has_sah=True, cuda_error=None):
    """Traversal route for a scene. Without a BVH (at most
    BRUTE_FORCE_MAX_TRIS triangles): 'triton' on the GPU, 'brute'
    elsewhere. With one: 'cuda' on the GPU, 'bvh' elsewhere. On the GPU a
    missing SAH tree or kernel library is an error, never a quiet switch
    to the slower walk."""
    if not has_bvh:
        return "triton" if backend == "gpu" else "brute"
    if backend != "gpu":
        return "bvh"
    if not has_sah:
        from .. import native
        raise RuntimeError("GPU traversal needs the native SAH builder: "
                           f"{native.build_error}")
    if cuda_error is not None:
        raise RuntimeError(cuda_error)
    return "cuda"


def trace(scene, ray, any_hit=False, act=None):
    """Closest hit (Hit) or occlusion (bool [R]) of `ray` against `scene`,
    plus the number of lanes whose traversal was truncated. Lanes with
    act == False are traced with t_max = 0 on the BVH routes, which skips
    their walk."""
    backend = jax.default_backend()
    has_bvh = scene.bvh is not None
    cuda_error = None
    if has_bvh and backend == "gpu":
        from . import cuda_trace
        cuda_error = cuda_trace.load()
    route = choose_route(has_bvh, backend, scene.sah is not None, cuda_error)

    sg = jax.lax.stop_gradient
    tmax = ray.t_max
    sweep = route in ("brute", "triton")
    if act is not None and not sweep:
        tmax = jnp.where(act, tmax, 0.0)
    r = Ray(origin=sg(ray.origin), direction=sg(ray.direction),
            t_max=sg(tmax))
    tris = (scene.tri_p0, scene.tri_e1, scene.tri_e2)
    truncated = jnp.zeros((), jnp.int32)
    if sweep:
        def sweep_xla(r_):
            if any_hit:
                return occluded_brute(r_, *tris)
            return intersect_brute(r_, *tris).prim_id

        if route == "triton":
            from .sweep_triton import sweep_triton

            def sweep_gpu(r_):
                _, out = sweep_triton(r_, *tris, any_hit=any_hit)
                return out > 0 if any_hit else out

            out = jax.lax.platform_dependent(r, cuda=sweep_gpu,
                                             default=sweep_xla)
        else:
            out = sweep_xla(r)
        if any_hit:
            return out, truncated
        pid = out
    else:
        def walk_xla(r_):
            hit, n = intersect_bvh(r_, scene.bvh, any_hit=any_hit)
            return hit.prim_id, n

        if route == "cuda":
            from .cuda_trace import intersect_cuda

            def walk_cuda(r_):
                _, pid_, n = intersect_cuda(r_, scene.sah, any_hit=any_hit)
                return pid_, n

            pid, truncated = jax.lax.platform_dependent(
                r, cuda=walk_cuda, default=walk_xla)
        else:
            pid, truncated = walk_xla(r)
    if any_hit:
        return pid >= 0, truncated
    return recompute_hit(ray, pid, *tris), truncated
