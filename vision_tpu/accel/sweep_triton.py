"""Dense ray-triangle sweep as a Pallas kernel through Triton (GPU).

The XLA sweep (intersect.intersect_brute / occluded_brute) evaluates the
[R, 128] Möller-Trumbore planes and reduces them. This kernel keeps the
running (best_t, best_id) of a block of rays in registers and loops over
the triangles, loading each triangle's nine floats as scalars: no [R, T]
plane exists anywhere. Ties keep the lowest triangle id, as the XLA sweep
does. Tested on the CPU in interpret mode.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

BLOCK_RAYS = 256
_DET_EPS = 1e-9
_EDGE_EPS = 1e-6


def _kernel(tri_ref, ray_ref, t_ref, id_ref, *, n_tris, any_hit):
    ox, oy, oz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    dx, dy, dz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    t_max = ray_ref[6, :]

    def body(j, carry):
        best_t, best_id = carry
        p0x, p0y, p0z = tri_ref[0, j], tri_ref[1, j], tri_ref[2, j]
        e1x, e1y, e1z = tri_ref[3, j], tri_ref[4, j], tri_ref[5, j]
        e2x, e2y, e2z = tri_ref[6, j], tri_ref[7, j], tri_ref[8, j]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        ok_det = jnp.abs(det) > _DET_EPS
        inv_det = 1.0 / jnp.where(ok_det, det, 1.0)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        ok = (ok_det & (u >= -_EDGE_EPS) & (v >= -_EDGE_EPS)
              & (u + v <= 1.0 + _EDGE_EPS) & (t > 0.0) & (t < best_t))
        return jnp.where(ok, t, best_t), jnp.where(ok, j, best_id)

    best_t, best_id = jax.lax.fori_loop(
        0, n_tris, body, (t_max, jnp.full(t_max.shape, -1, jnp.int32)))
    t_ref[...] = best_t
    id_ref[...] = best_id if not any_hit else (best_id >= 0).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def sweep_triton(ray, tri_p0, tri_e1, tri_e2, any_hit=False,
                 interpret=False):
    """(t [R], prim_id [R]) of the closest hit; with any_hit the second
    result is 1 where anything lies within t_max, else 0."""
    R = ray.origin.shape[0]
    n_tris = tri_p0.shape[0]
    rows = jnp.concatenate([ray.origin.T, ray.direction.T,
                            ray.t_max[None], jnp.zeros((1, R))], 0)
    pad = -R % BLOCK_RAYS
    rows = jnp.pad(rows.astype(jnp.float32), ((0, 0), (0, pad)))
    tris = jnp.concatenate([tri_p0.T, tri_e1.T, tri_e2.T], 0)
    # power-of-two block: 16 rows of components, triangles padded to 2^k
    n_pad = max(1, 1 << (n_tris - 1).bit_length())
    tris = jnp.pad(tris.astype(jnp.float32),
                   ((0, 16 - 9), (0, n_pad - n_tris)))
    Rp = R + pad
    t, pid = pl.pallas_call(
        functools.partial(_kernel, n_tris=n_tris, any_hit=any_hit),
        out_shape=(jax.ShapeDtypeStruct((Rp,), jnp.float32),
                   jax.ShapeDtypeStruct((Rp,), jnp.int32)),
        grid=(Rp // BLOCK_RAYS,),
        in_specs=[pl.BlockSpec((16, n_pad), lambda i: (0, 0)),
                  pl.BlockSpec((8, BLOCK_RAYS), lambda i: (0, i))],
        out_specs=(pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,)),
                   pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))),
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="vt_sweep",
    )(tris, rows)
    return t[:R], pid[:R]
