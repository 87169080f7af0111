"""Reconstruction filters with filter importance sampling (FIS).

Replaces `/root/reference/src/render_core/filter/{box,triangle,gaussian,
mitchell,sinc}.cpp` + the FilterSampler fitted-curve tables
(`base/sensor/filter.h:29-61`). Each filter is separable f(x)f(y); we build a
binned |f| distribution per axis on the host, importance-sample it with an
alias table on device, and weight samples by sign(f) — so the estimator stays
unbiased for negative-lobe filters (Mitchell, sinc).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..lights.alias import build_alias, sample_alias

_N_BINS = 256


def _filter_fn(ftype, params):
    r = params.get("radius", [0.5, 0.5])
    rx = float(r[0] if isinstance(r, (list, tuple)) else r)
    if ftype == "box":
        return lambda x: np.ones_like(x), rx
    if ftype == "triangle":
        return lambda x: np.maximum(0.0, rx - np.abs(x)), rx
    if ftype == "gaussian":
        sigma = params.get("sigma", rx / 2.0)
        exp_r = np.exp(-(rx * rx) / (2 * sigma * sigma))
        return lambda x: np.maximum(
            0.0, np.exp(-(x * x) / (2 * sigma * sigma)) - exp_r), rx
    if ftype == "mitchell":
        b = params.get("b", 1.0 / 3.0)
        c = params.get("c", 1.0 / 3.0)

        def mitchell(x):
            x = np.abs(2.0 * x / rx)
            x2, x3 = x * x, x ** 3
            return np.where(
                x > 1,
                ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2 +
                 (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6,
                ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2 +
                 (6 - 2 * b)) / 6) * (x <= 2)
        return mitchell, rx
    if ftype in ("sinc", "lanczos"):
        tau = params.get("tau", 3.0)

        def windowed_sinc(x):
            def sinc(v):
                v = np.abs(v)
                return np.where(v < 1e-5, 1.0, np.sin(np.pi * v) / (np.pi * v))
            return np.where(np.abs(x) > rx, 0.0, sinc(x) * sinc(x / tau))
        return windowed_sinc, rx
    return lambda x: np.ones_like(x), rx


@struct.dataclass
class FilterSampler:
    radius: jnp.ndarray
    prob: jnp.ndarray     # [B] alias
    alias: jnp.ndarray
    pmf: jnp.ndarray
    sign: jnp.ndarray     # [B] f32 sign of f in each bin
    int_abs: jnp.ndarray  # scalar: integral |f| / integral f (weight scale)
    # static: box FIS degenerates to a uniform jitter; skipping the alias
    # machinery saves 8 table gathers per regeneration
    is_box: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def make(cls, ftype="box", params=None):
        params = params or {}
        fn, r = _filter_fn(ftype, params)
        xs = (np.arange(_N_BINS) + 0.5) / _N_BINS * 2 * r - r
        fv = fn(xs)
        prob, alias, pmf = build_alias(np.abs(fv) + 1e-12)
        int_f = np.sum(fv)
        int_abs = np.sum(np.abs(fv))
        return cls(radius=jnp.asarray(r, jnp.float32),
                   prob=jnp.asarray(prob), alias=jnp.asarray(alias),
                   pmf=jnp.asarray(pmf),
                   sign=jnp.asarray(np.sign(fv), jnp.float32),
                   int_abs=jnp.asarray(int_abs / max(int_f, 1e-9), jnp.float32),
                   is_box=(ftype == "box"))

    def sample(self, u2):
        """u2 [..., 2] -> (offset [..., 2] in [-r, r], weight [...]).

        weight = sign(fx)*sign(fy) * (int|f|/int f)^2; expectation matches the
        normalized filter (FilterSampler convention)."""
        if self.is_box:
            return ((u2 * 2.0 - 1.0) * self.radius,
                    jnp.ones(u2.shape[:-1], jnp.float32))
        from ..core.gather import fetch_rows
        bx, _, ux = sample_alias(self.prob, self.alias, self.pmf, u2[..., 0])
        by, _, uy = sample_alias(self.prob, self.alias, self.pmf, u2[..., 1])
        ox = ((bx.astype(jnp.float32) + ux) / _N_BINS * 2.0 - 1.0) * self.radius
        oy = ((by.astype(jnp.float32) + uy) / _N_BINS * 2.0 - 1.0) * self.radius
        sx = fetch_rows([self.sign], bx)[0]
        sy = fetch_rows([self.sign], by)[0]
        w = sx * sy * self.int_abs * self.int_abs
        return jnp.stack([ox, oy], -1), w
