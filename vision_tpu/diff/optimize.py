"""Inverse rendering: differentiate the renderer w.r.t. scene parameters.

New capability vs the reference (which has no gradients): the whole wavefront
integrator is jax-differentiable — the bounce loop rematerializes under AD
(pt.radiance(remat=True)), so backward sweeps replay each bounce instead of
taping it (path-replay-style memory profile, SURVEY.md §7.9). Discrete
sampling decisions are constants wrt parameters (detached RNG), giving the
standard interior-derivative estimator; silhouette gradients need edge
sampling (future round).

Differentiable parameter surfaces: material table floats (albedo, roughness,
eta, weights), light colors/positions, camera pose, texture atlas texels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from ..core import rng
from ..integrator import pt


def float_leaves(table):
    """Dict of the float-valued arrays of a struct dataclass (grad
    surface)."""
    return {k: v for k, v in vars(table).items()
            if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating)}


# ---------------------------------------------------------------------------
# The full differentiable surface (base/encoded_object.h:21-60 equivalent:
# every Encodable's device data — here the four parameter groups that make
# sense to optimize). `params` is a nested dict keyed by group:
#   materials: material-table float leaves (albedo, roughness, eta, ...)
#   lights:    light-table float leaves (color, position, direction, ...)
#   atlas:     texture atlas texels (data [N, 3])
#   camera:    c2w pose matrix (+ tan_half_fov for intrinsics)
# ---------------------------------------------------------------------------

GROUPS = ("materials", "lights", "atlas", "camera")


def param_surface(scene, camera, groups=("materials",)):
    """Extract the requested differentiable parameter groups."""
    out = {}
    if "materials" in groups:
        out["materials"] = float_leaves(scene.materials)
    if "lights" in groups:
        keys = ("color", "position", "direction")
        out["lights"] = {k: v for k, v in
                         float_leaves(scene.lights).items() if k in keys}
    if "atlas" in groups:
        out["atlas"] = {"data": scene.atlas.data}
    if "camera" in groups:
        out["camera"] = {"c2w": camera.c2w}
    return out


def apply_params(scene, camera, params):
    """Rebuild (scene, camera) with `params` substituted."""
    if "materials" in params:
        scene = scene.replace(
            materials=scene.materials.replace(**params["materials"]))
    if "lights" in params:
        scene = scene.replace(
            lights=scene.lights.replace(**params["lights"]))
    if "atlas" in params:
        scene = scene.replace(atlas=scene.atlas.replace(**params["atlas"]))
    if "camera" in params:
        camera = camera.replace(**params["camera"])
    return scene, camera


def render_with_params(scene, camera, params, frame_index, max_depth=4,
                       spp=1):
    """Forward render with parameter groups overridden by `params`.
    `params` may be a flat materials dict (legacy) or a nested group dict."""
    if params and not any(k in GROUPS for k in params):
        params = {"materials": params}
    sc, camera = apply_params(scene, camera, params)
    W, H = camera.resolution
    n = W * H
    pix = jnp.arange(n, dtype=jnp.uint32)
    px = (pix % W).astype(jnp.float32)
    py = (pix // W).astype(jnp.float32)
    img = jnp.zeros((n, 3))
    for s in range(spp):
        st = rng.seed(pix, jnp.uint32(frame_index * spp + s))
        p_film = jnp.stack([px + 0.5, py + 0.5], -1)
        ray = camera.generate_ray(p_film)
        L, _ = pt.radiance(sc, ray, st, max_depth=max_depth, min_depth=99,
                           remat=True)
        img = img + L
    return (img / spp).reshape(H, W, 3)


def make_loss(scene, camera, target, max_depth=4, spp=1):
    target = jnp.asarray(target)

    def loss_fn(params, frame_index):
        img = render_with_params(scene, camera, params, frame_index,
                                 max_depth, spp)
        d = img - target
        return jnp.mean(d * d)

    return loss_fn


def optimize_materials(scene, camera, target, param_keys=("kd",), steps=32,
                       lr=5e-2, max_depth=3, spp=1, verbose=False,
                       fixed_frame=None):
    """Adam-optimize selected material-table parameters to match `target`.
    Returns (optimized params dict, losses).

    fixed_frame: render the loss with one fixed RNG frame (use the target's
    frame for a correlated, noise-cancelling estimator — standard
    finite-sample trick in differentiable rendering)."""
    all_params = float_leaves(scene.materials)
    params = {k: all_params[k] for k in param_keys}
    loss_fn = make_loss(scene, camera, target, max_depth, spp)

    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, frame):
        loss, grads = jax.value_and_grad(loss_fn)(params, frame)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params = jax.tree.map(lambda p: jnp.clip(p, 0.0, None), params)
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        f = i if fixed_frame is None else fixed_frame
        params, opt_state, loss = step(params, opt_state, jnp.uint32(f))
        losses.append(float(loss))
        if verbose and i % 8 == 0:
            print(f"  step {i}: loss {losses[-1]:.6f}")
    return params, losses


def _clip_physical(params):
    """Project back to physical ranges: reflectances/texels/light color are
    non-negative; positions/directions/pose stay free."""
    out = dict(params)
    for g in ("materials", "atlas"):
        if g in out:
            out[g] = jax.tree.map(lambda p: jnp.clip(p, 0.0, None), out[g])
    if "lights" in out and "color" in out["lights"]:
        lights = dict(out["lights"])
        lights["color"] = jnp.clip(lights["color"], 0.0, None)
        out["lights"] = lights
    return out


def optimize_scene(scene, camera, target, groups=("materials",), steps=32,
                   lr=5e-2, max_depth=3, spp=1, verbose=False,
                   fixed_frame=None):
    """Adam-optimize any differentiable parameter groups (texture texels,
    light color/position, camera pose, material floats) against `target`
    (BASELINE config 5: differentiable texture/light optimization).
    Returns (optimized nested params dict, losses)."""
    params = param_surface(scene, camera, groups)
    loss_fn = make_loss(scene, camera, target, max_depth, spp)

    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, frame):
        loss, grads = jax.value_and_grad(loss_fn)(params, frame)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params = _clip_physical(params)
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        f = i if fixed_frame is None else fixed_frame
        params, opt_state, loss = step(params, opt_state, jnp.uint32(f))
        losses.append(float(loss))
        if verbose and i % 8 == 0:
            print(f"  step {i}: loss {losses[-1]:.6f}")
    return params, losses
