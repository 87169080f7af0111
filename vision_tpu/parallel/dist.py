"""Multi-chip distribution: pixel/sample sharding over a device mesh.

New capability vs the single-GPU reference (SURVEY.md §2.5): the pixel grid
is sharded over a `dp` mesh axis and samples over an `sp` axis; the scene
pytree is replicated (read-only during a frame). Sample averaging is a pmean
over `sp`. The cards of a host are joined all to all (NVLink), so the mesh
follows the algorithm alone: pick a mesh, annotate shardings, let XLA
insert collectives (NCCL).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import rng
from ..integrator import pt


def make_mesh(devices=None, sp=1):
    """Mesh over (dp, sp). dp = pixel shards, sp = sample shards."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    assert n % sp == 0, (n, sp)
    dev = np.asarray(devices).reshape(n // sp, sp)
    return Mesh(dev, ("dp", "sp"))


def render_sharded(scene, camera, filt, frame_index, mesh, max_depth=8,
                   min_depth=0, rr_threshold=1.0):
    """One distributed sample pass: pixels sharded over dp, `sp` independent
    sample sets psum-averaged over sp. Returns the full [H, W, 3] image
    (replicated)."""
    W, H = camera.resolution
    n = W * H
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    assert n % n_dp == 0, (n, n_dp)

    def tile_fn(scene_, camera_, filt_, frame_):
        dp_i = jax.lax.axis_index("dp")
        sp_i = jax.lax.axis_index("sp")
        n_local = n // n_dp
        pix = dp_i * n_local + jnp.arange(n_local, dtype=jnp.uint32)
        px = (pix % W).astype(jnp.float32)
        py = (pix // W).astype(jnp.float32)
        # distinct RNG stream per sample shard
        st = rng.seed(pix, frame_ * jnp.uint32(n_sp) + sp_i.astype(jnp.uint32))
        st, u_film = rng.next_2d(st)
        offset, fw = filt_.sample(u_film)
        p_film = jnp.stack([px + 0.5, py + 0.5], -1) + offset
        st, u_lens = rng.next_2d(st)
        ray = camera_.generate_ray(p_film, u_lens)
        L, _ = pt.radiance(scene_, ray, st, max_depth, min_depth, rr_threshold)
        L = L * fw[..., None]
        # average the sp sample sets
        L = jax.lax.pmean(L, "sp")
        return L

    fn = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P("dp", None),
        check_vma=False,
    )
    flat = jax.jit(fn)(scene, camera, filt, jnp.uint32(frame_index))
    return flat.reshape(H, W, 3)


def training_step(scene, camera, filt, frame_index, mesh, target,
                  max_depth=4, groups=("materials",), spp_local=1):
    """Differentiable render step sharded over the mesh: L2 loss against a
    target image, gradients w.r.t. the full differentiable surface
    (material floats, texture atlas texels, light color/position, camera
    pose — `base/encoded_object.h:21-60` equivalent groups), psum over all
    mesh axes.

    This is the renderer-shaped 'training step' (inverse rendering): the
    backward sweep re-traverses the wavefront; parameter grads are
    all-reduced over the mesh. spp_local: samples averaged per device
    before the loss (variance reduction at fixed step count).
    """
    from ..diff.optimize import apply_params, param_surface
    W, H = camera.resolution
    n = W * H
    n_dp = mesh.shape["dp"]

    def loss_local(params, scene_, camera_, filt_, frame_, target_local):
        dp_i = jax.lax.axis_index("dp")
        sp_i = jax.lax.axis_index("sp")
        n_sp = mesh.shape["sp"]
        scene_, camera_ = apply_params(scene_, camera_, params)
        n_local = n // n_dp
        pix = dp_i * n_local + jnp.arange(n_local, dtype=jnp.uint32)
        px = (pix % W).astype(jnp.float32)
        py = (pix // W).astype(jnp.float32)
        L = jnp.zeros((n_local, 3))
        for s in range(spp_local):
            st = rng.seed(pix, (frame_ * jnp.uint32(spp_local)
                                + jnp.uint32(s)) * jnp.uint32(n_sp)
                          + sp_i.astype(jnp.uint32))
            p_film = jnp.stack([px + 0.5, py + 0.5], -1)
            ray = camera_.generate_ray(p_film)
            Ls, _ = pt.radiance(scene_, ray, st, max_depth, 0, 1.0,
                                remat=True)
            L = L + Ls
        L = L / spp_local
        diff = L - target_local.reshape(-1, 3)
        return jnp.mean(diff * diff)

    def step_fn(scene_, camera_, filt_, frame_, target_):
        params = param_surface(scene_, camera_, groups)
        loss, grads = jax.value_and_grad(loss_local)(
            params, scene_, camera_, filt_, frame_, target_)
        # all-reduce over both mesh axes (grads must agree on every chip)
        loss = jax.lax.pmean(jax.lax.pmean(loss, "dp"), "sp")
        grads = jax.tree.map(
            lambda g: jax.lax.pmean(jax.lax.pmean(g, "dp"), "sp"), grads)
        return loss, grads

    fn = jax.shard_map(
        step_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("dp", None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    target = jnp.asarray(target).reshape(n_dp, n // n_dp, 3)
    return jax.jit(fn)(scene, camera, filt, jnp.uint32(frame_index), target)
