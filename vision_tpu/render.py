"""High-level rendering driver.

Replaces the reference app/pipeline frame loop (`/root/reference/src/base/mgr/
pipeline.cpp display/render`): jit-compiled sample passes accumulated into a
running-average film, then tonemap + gamma for output.
"""
from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from .integrator import pt
from .sensor import film


@functools.partial(jax.jit, static_argnames=("max_depth", "min_depth"))
def _render_pass(scene_data, camera, filt, frame_index, max_depth, min_depth,
                 rr_threshold):
    img, aovs = pt.render_sample(scene_data, camera, filt, frame_index,
                                 max_depth=max_depth, min_depth=min_depth,
                                 rr_threshold=rr_threshold)
    return img, aovs


@functools.partial(jax.jit, static_argnames=("spp", "max_depth", "min_depth"))
def _wave_pass(scene_data, camera, filt, frame0, spp, max_depth, min_depth,
               rr_threshold, spp_budget=None):
    img, aovs = pt.render_wave(scene_data, camera, filt, frame0, spp=spp,
                               max_depth=max_depth, min_depth=min_depth,
                               rr_threshold=rr_threshold,
                               spp_budget=spp_budget)
    return img, aovs


# samples folded into one on-device regeneration wavefront per host step;
# bounds while-loop length (and recompiles) while keeping lanes ~100% busy.
# BVH scenes take a smaller chunk so progress reports stay frequent. Neither
# size has been measured on the GPU yet.
WAVE_CHUNK = 32
WAVE_CHUNK_BVH = 8


def render(scene, spp=None, verbose=False, adaptive=False):
    """Render `spp` samples (defaults to scene output spp or 64) with the
    regeneration-wavefront integrator. Returns linear HDR [H, W, 3] (numpy).

    adaptive=True runs the convergence inspector between wave chunks
    (reference `pt.cpp:64-69` ConvergenceInspector): pixels whose running
    variance drops below threshold stop being sampled, so converged regions
    cost no further rays.
    """
    spp = spp or scene.output_spp or 64
    t0 = time.time()
    if getattr(scene, "framebuffer_type", "normal") == "light_field":
        # light_field framebuffer plugin: contact sheet of the S x S
        # sub-aperture views (sensor/light_field.py)
        from .sensor import light_field as lf
        tiles = render_light_field(scene, spp=spp, verbose=verbose)
        return np.asarray(lf.mosaic(tiles))
    if adaptive:
        img, _ = render_adaptive(scene, spp, verbose)
        return img
    chunk = WAVE_CHUNK_BVH if getattr(scene, "use_bvh", False) else WAVE_CHUNK
    accum = None
    done = 0
    while done < spp:
        n = min(chunk, spp - done)
        img, _ = _wave_pass(scene.data, scene.camera, scene.filter,
                            jnp.uint32(done), n, scene.max_depth,
                            scene.min_depth, jnp.float32(scene.rr_threshold))
        w = n / float(done + n)
        accum = img if accum is None else accum * (1.0 - w) + img * w
        done += n
        if verbose:
            accum.block_until_ready()
            dt = time.time() - t0
            print(f"  spp {done}/{spp}  ({dt:.2f}s, {done / dt:.2f} spp/s)")
    accum.block_until_ready()
    return np.asarray(accum)


def render_light_field(scene, spp=16, grid=None, verbose=False):
    """Render the light_field framebuffer: one wavefront over the stacked
    (W, S*S*H) lane space, every lane's view decoded from its raster row.
    Returns view tiles [S, S, H, W, 3] (linear HDR)."""
    from .sensor import light_field as lf
    grid = grid or getattr(scene, "lf_grid", 3)
    cam = lf.light_field_camera(scene.camera, grid)
    chunk = WAVE_CHUNK_BVH if getattr(scene, "use_bvh", False) else WAVE_CHUNK
    accum = None
    done = 0
    while done < spp:
        n = min(chunk, spp - done)
        img, _ = _wave_pass(scene.data, cam, scene.filter,
                            jnp.uint32(done), n, scene.max_depth,
                            scene.min_depth, jnp.float32(scene.rr_threshold))
        w = n / float(done + n)
        accum = img if accum is None else accum * (1.0 - w) + img * w
        done += n
        if verbose:
            accum.block_until_ready()
            print(f"  light-field spp {done}/{spp}")
    return lf.film_to_tiles(accum, scene.camera.resolution, grid)


def render_adaptive(scene, spp, verbose=False, chunk=8, min_chunks=3,
                    threshold=0.02):
    """Adaptive sampling (ConvergenceInspector, `/root/reference/src/
    render_core/integrator/adaptive/inspector.h:49`): per-pixel relative
    standard error across wave-chunk means gates later chunks' per-pixel
    sample budgets, so converged pixels stop costing rays. Returns
    (image, stats dict with ray counts)."""
    from .integrator import adaptive as ad
    W, H = scene.camera.resolution
    R = W * H
    state = ad.InspectorState.initial(R)
    film_sum = jnp.zeros((R, 3))
    smp_tot = jnp.zeros((R,), jnp.int32)
    nrays = 0.0
    done = 0
    t0 = time.time()
    active_frac = 1.0
    while done < spp:
        n = min(chunk, spp - done)
        conv = ad.is_converged(state, threshold, min_samples=float(min_chunks))
        budget = jnp.where(conv, 0, n).astype(jnp.int32)
        img, aovs = _wave_pass(scene.data, scene.camera, scene.filter,
                               jnp.uint32(done), n, scene.max_depth,
                               scene.min_depth,
                               jnp.float32(scene.rr_threshold),
                               spp_budget=budget)
        film_sum = film_sum + aovs["film"]
        smp_tot = smp_tot + aovs["smp"].astype(jnp.int32)
        nrays += float(aovs["nrays"])
        # inspector sees chunk means (iid across chunks): only update pixels
        # that actually took samples this chunk
        took = aovs["smp"] > 0
        chunk_mean = aovs["film"] / jnp.maximum(
            aovs["smp"].astype(jnp.float32), 1.0)[..., None]
        state = ad.update_where(state, chunk_mean, took)
        done += n
        active_frac = 1.0 - float(jnp.mean(conv.astype(jnp.float32)))
        if verbose:
            print(f"  spp {done}/{spp}  active {active_frac * 100:.1f}%  "
                  f"({time.time() - t0:.2f}s)")
    img = np.asarray(film_sum / jnp.maximum(smp_tot, 1)[..., None]
                     ).reshape(H, W, 3)
    return img, dict(nrays=nrays, mean_spp=float(jnp.mean(smp_tot)),
                     active_frac=active_frac)


def postprocess(scene, hdr):
    """tonemap + gamma -> display image [H, W, 3] in [0,1]."""
    x = jnp.asarray(hdr)
    x = film.tonemap(x, scene.tone_mapper, scene.exposure)
    x = film.linear_to_srgb(x)
    return np.asarray(x)


def render_to_file(scene_path, out_path=None, spp=None, verbose=True):
    from .scene.scene import load_scene
    scene = load_scene(scene_path)
    hdr = render(scene, spp=spp, verbose=verbose)
    img = postprocess(scene, hdr)
    out = out_path or scene.output_fn
    if out.endswith(".exr"):
        film.to_exr(hdr, out)
    else:
        film.to_png(img, out)
    return out
