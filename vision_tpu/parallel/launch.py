"""Multi-host launch scaffold + scaling measurement.

New capability vs the single-GPU reference (SURVEY.md §2.5): standard JAX
multi-process runtime. Each host runs the same program; devices combine
into one global mesh; the renderer's shard_map code is unchanged
(collectives ride NVLink within a host, the network across hosts).

Usage (per host):
    from vision_tpu.parallel import launch
    launch.init_distributed("10.0.0.1:8476", num_processes=2, process_id=i)
    launch.init_distributed()              # or: cluster auto-detection
                                           # (SLURM, Open MPI, ...)
    mesh = dist.make_mesh()                # global devices

One process drives all the GPUs of a host; a single-host run needs no
initialization at all.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize the JAX multi-process runtime (no-op if already up or
    single-process). Call before any device use."""
    try:
        if jax.process_count() > 1:
            return True  # already initialized
    except RuntimeError:
        pass
    try:
        if coordinator_address is None:
            jax.distributed.initialize()  # cluster auto-detection
        else:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        return True
    except Exception:
        # single-process run (bench/dev boxes): proceed un-distributed
        return False


def measure_weak_scaling(scene, camera, filt, dp_sizes=(1, 8),
                         pixels_per_chip=64 * 64, max_depth=4, iters=3,
                         sp=1):
    """Weak scaling: fixed pixels per chip, growing dp. Returns
    {dp: seconds} wall times plus derived efficiency vs the smallest dp.

    On real multi-chip hardware efficiency = t[dp_min]/t[dp] directly. On a
    virtual (host-emulated, timesliced) mesh, devices share cores, so the
    honest figure is overhead-adjusted: eff = (dp_min/dp) * t[dp_min]/t[dp]
    * n_cores_scaling — callers on virtual meshes should compare against
    the serialization bound instead (see tests/test_scaling.py).
    """
    from . import dist
    times = {}
    for dp in dp_sizes:
        n_dev = dp * sp
        devices = jax.devices()[:n_dev]
        if len(devices) < n_dev:
            continue
        mesh = dist.make_mesh(devices, sp=sp)
        # resize the pixel grid: dp * pixels_per_chip total
        side = int(np.sqrt(dp * pixels_per_chip))
        # keep W divisible by dp for clean sharding
        W = (side // dp) * dp if side >= dp else dp
        H = max(side, 1)
        cam = camera.replace(resolution=(W, H))
        img = dist.render_sharded(scene, cam, filt, 0, mesh,
                                  max_depth=max_depth)
        img.block_until_ready()
        t0 = time.perf_counter()
        for i in range(iters):
            img = dist.render_sharded(scene, cam, filt, i + 1, mesh,
                                      max_depth=max_depth)
        img.block_until_ready()
        times[dp] = (time.perf_counter() - t0) / iters
    return times
