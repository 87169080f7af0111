"""Adaptive sampling: per-pixel convergence inspection.

Equivalent of the reference ConvergenceInspector
(`/root/reference/src/render_core/integrator/adaptive/inspector.h:49`,
used by pt.cpp:64-69): tracks per-pixel mean/variance across frames via
Welford updates; pixels whose relative standard error falls below the
threshold stop contributing work (their lanes deactivate immediately after
camera-ray generation, so the wavefront spends its time on unconverged
pixels).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core.math import luminance, safe_div


@struct.dataclass
class InspectorState:
    mean: jnp.ndarray    # [N] running mean luminance
    m2: jnp.ndarray      # [N] running sum of squared deviations
    count: jnp.ndarray   # [N]

    @classmethod
    def initial(cls, n):
        z = jnp.zeros((n,))
        return cls(mean=z, m2=z, count=z)


def update(state, sample_rgb):
    """Welford update with this frame's per-pixel luminance."""
    x = luminance(sample_rgb)
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return InspectorState(mean=mean, m2=m2, count=count)


def update_where(state, sample_rgb, took):
    """Welford update applied only where `took` is True (adaptive driver:
    converged pixels receive no new chunk and keep their stats frozen)."""
    x = luminance(sample_rgb) if sample_rgb.ndim > 1 else sample_rgb
    count = jnp.where(took, state.count + 1.0, state.count)
    delta = x - state.mean
    mean = jnp.where(took, state.mean + safe_div(delta, count), state.mean)
    m2 = jnp.where(took, state.m2 + delta * (x - mean), state.m2)
    return InspectorState(mean=mean, m2=m2, count=count)


def is_converged(state, threshold=0.05, min_samples=16.0):
    """Relative standard error below threshold (inspector.h variance test)."""
    var = safe_div(state.m2, jnp.maximum(state.count - 1.0, 1.0))
    se = jnp.sqrt(jnp.maximum(var, 0.0) / jnp.maximum(state.count, 1.0))
    rel = safe_div(se, jnp.maximum(state.mean, 1e-3))
    return (state.count >= min_samples) & (rel < threshold)


def active_fraction(state, threshold=0.05, min_samples=16.0):
    return 1.0 - jnp.mean(is_converged(state, threshold, min_samples)
                          .astype(jnp.float32))
