"""Alias tables: O(1) discrete sampling on device.

Replaces the reference warper plugins (`/root/reference/src/render_core/
warper/{alias.cpp,alias2d.cpp}`): Vose build on host (vectorized numpy),
two gathers per sample on device.
"""
from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp


def build_alias(weights):
    """Host build. weights [N] -> (prob [N] f32, alias [N] i32, pmf [N] f32)."""
    w = np.asarray(weights, np.float64)
    n = len(w)
    total = w.sum()
    if total <= 0:
        pmf = np.full(n, 1.0 / n)
    else:
        pmf = w / total
    scaled = pmf * n
    prob = np.ones(n)
    alias = np.arange(n)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        if scaled[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32), pmf.astype(np.float32)


from ..core.gather import fetch_rows  # noqa: E402


def sample_alias(prob, alias, pmf, u, offset=0, count=None):
    """Device sample from a (sub-)table at rows [offset, offset+count).
    u [...] in [0,1). Returns (index_in_subtable, pmf_value, u_remapped).

    Row fetches go through core.gather.fetch_rows: one fused fetch for
    (prob, alias, pmf@i) + one for pmf@idx instead of 4 gathers."""
    n = count if count is not None else prob.shape[0]
    x = u * n
    i = jnp.clip(x.astype(jnp.int32), 0, n - 1)
    frac = x - i.astype(jnp.float32)
    gi = offset + i
    p, ali, pmf_i = fetch_rows([prob, alias, pmf], gi)
    take_alias = frac >= p
    idx = jnp.where(take_alias, ali, i)
    pmf_out = jnp.where(take_alias,
                        fetch_rows([pmf], offset + ali)[0], pmf_i)
    # remap the fraction for reuse (reference warper does the same)
    u_rem = jnp.where(take_alias,
                      jnp.clip((frac - p) / jnp.maximum(1.0 - p, 1e-9), 0.0, 1.0),
                      jnp.clip(frac / jnp.maximum(p, 1e-9), 0.0, 1.0))
    return idx, pmf_out, u_rem
