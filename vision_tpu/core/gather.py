"""Row fetches of several columns at once.

`fetch_rows` stacks all the columns a call site needs into ONE [N, K]
matrix, so one gather of [..., K] rows replaces K separate gathers. On an
H100 a plain gather of 262,144 rows from a [N, 32] table (N = 36, 256, 512)
beats the one-hot matmul fetch at every N (PERF.md, Findings).
"""
from __future__ import annotations

import jax.numpy as jnp


def fetch_rows(cols, idx):
    """Fetch row `idx` from each column array in `cols` with one gather.

    cols: list of [N] or [N, k] arrays (float/int mixed; ints must fit f32
    exactly, i.e. |v| < 2^24 -- true for every id/flag table here).
    idx: [...] int32 row indices (caller clamps).
    Returns a list matching cols' shapes/dtypes with rows gathered.
    """
    parts, metas = [], []
    for c in cols:
        c2 = c[:, None] if c.ndim == 1 else c
        parts.append(c2.astype(jnp.float32))
        metas.append((c.ndim, c.dtype, c2.shape[1]))
    rows = jnp.concatenate(parts, axis=-1)[idx]
    out, o = [], 0
    for ndim, dtype, w in metas:
        r = rows[..., o:o + w]
        o += w
        if ndim == 1:
            r = r[..., 0]
        if dtype != jnp.float32:
            r = r.astype(dtype)
        out.append(r)
    return out
