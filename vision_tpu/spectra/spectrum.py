"""Spectrum models: 3-channel sRGB passthrough + hero-wavelength spectral.

Replaces the reference spectrum plugins (`/root/reference/src/render_core/
spectrum/{srgb,hero}.cpp`). One vectorized model drives both modes:

  * srgb: S=3, decode = identity, to_srgb = identity (srgb.cpp).
  * hero: S = n_lambda samples; visible-wavelength importance sampling with
    stratified offsets (hero.cpp:286-300), sRGB->spectrum sigmoid-polynomial
    upsampling from our own Jakob-Hanika-fit table
    (tools/gen_srgb2spec.py; the reference's srgb2spec.h data is absent from
    its tree), CIE XYZ integration and dispersion via per-lambda secondary
    termination (SampledWavelengths::check_dispersive).
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core import rng
from ..core.math import safe_div, sqr
from . import spd

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float32)

SRGB_TO_Y = np.array([0.212671, 0.715160, 0.072169], np.float32)

KIND_SRGB = 0
KIND_HERO = 1


@struct.dataclass
class SampledWavelengths:
    """Per-lane wavelength set: lambda [..., S], pdf [..., S], and the count
    of live secondaries (dispersion terminates all but the hero lambda)."""
    lam: jnp.ndarray
    pdf: jnp.ndarray
    secondary_alive: jnp.ndarray  # [...] bool

    def terminate_secondary(self, mask):
        """Kill secondary wavelengths where mask (dispersive scatter)."""
        alive = self.secondary_alive & jnp.logical_not(mask)
        return self.replace(secondary_alive=alive)


@struct.dataclass
class SpectrumModel:
    kind: int = struct.field(pytree_node=False)
    dims: int = struct.field(pytree_node=False)
    coeffs: jnp.ndarray     # [3, res, res, res, 3] sigmoid-poly table
    cie_x: jnp.ndarray      # [471]
    cie_y: jnp.ndarray
    cie_z: jnp.ndarray
    d65n: jnp.ndarray       # normalized D65 (integrates to white)

    # ---- construction ----

    @classmethod
    def make(cls, kind="srgb", dims=3):
        cie = np.load(os.path.join(_DATA_DIR, "cie.npz"))
        tbl = np.load(os.path.join(_DATA_DIR, "srgb2spec.npz"))
        y_int = float(cie["Y"].sum())
        d65n = cie["D65"] * (y_int / float((cie["Y"] * cie["D65"]).sum()))
        return cls(
            kind=KIND_SRGB if kind == "srgb" else KIND_HERO,
            dims=3 if kind == "srgb" else int(dims),
            coeffs=jnp.asarray(tbl["coeffs"]),
            cie_x=jnp.asarray(cie["X"]), cie_y=jnp.asarray(cie["Y"]),
            cie_z=jnp.asarray(cie["Z"]), d65n=jnp.asarray(d65n),
        )

    # ---- wavelength sampling ----

    def sample_wavelengths(self, state):
        """(state, SampledWavelengths). srgb mode returns dummies."""
        shape = state.shape
        n = self.dims
        if self.kind == KIND_SRGB:
            lam = jnp.broadcast_to(
                jnp.asarray(spd.RGB_PEAK_WAVELENGTHS, jnp.float32), shape + (3,))
            return state, SampledWavelengths(
                lam=lam, pdf=jnp.ones(shape + (3,)),
                secondary_alive=jnp.ones(shape, bool))
        state, u = rng.next_1d(state)
        offs = jnp.arange(n, dtype=jnp.float32) / n
        up = jnp.mod(u[..., None] + offs, 1.0)
        # visible-wavelength importance sample (hero.cpp:16-25)
        lam = 538.0 - 138.888889 * jnp.arctanh(0.85691062 - 1.82750197 * up)
        pdf = 0.0039398042 / sqr(jnp.cosh(0.0072 * (lam - 538.0)))
        return state, SampledWavelengths(
            lam=lam, pdf=pdf, secondary_alive=jnp.ones(shape, bool))

    # ---- rgb -> spectrum ----

    def _poly_coeffs(self, rgb):
        """Trilinear lookup of sigmoid-poly coeffs for rgb in [0,1]^3.
        Mirrors hero.cpp decode_albedo (incl. the grayscale special case)."""
        res = self.coeffs.shape[1]
        rgb = jnp.clip(rgb, 0.0, 1.0)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = jnp.where(r > g, jnp.where(r > b, 0, 2), jnp.where(g > b, 1, 2))
        z = jnp.take_along_axis(rgb, maxc[..., None], -1)[..., 0]
        x = jnp.take_along_axis(rgb, ((maxc + 1) % 3)[..., None], -1)[..., 0]
        y = jnp.take_along_axis(rgb, ((maxc + 2) % 3)[..., None], -1)[..., 0]
        zs = jnp.maximum(z, 1e-6)
        x = x / zs
        y = y / zs

        def ism(t):
            return 0.5 - jnp.sin(jnp.arcsin(1.0 - 2.0 * jnp.clip(t, 0.0, 1.0)) / 3.0)

        zz = ism(ism(z))
        fx = x * (res - 1)
        fy = y * (res - 1)
        fz = zz * (res - 1)
        xi = jnp.clip(fx.astype(jnp.int32), 0, res - 2)
        yi = jnp.clip(fy.astype(jnp.int32), 0, res - 2)
        zi = jnp.clip(fz.astype(jnp.int32), 0, res - 2)
        dx = (fx - xi)[..., None]
        dy = (fy - yi)[..., None]
        dz = (fz - zi)[..., None]

        def co(ddx, ddy, ddz):
            return self.coeffs[maxc, zi + ddz, yi + ddy, xi + ddx]  # [..., 3]

        c = ((1 - dz) * ((1 - dy) * ((1 - dx) * co(0, 0, 0) + dx * co(1, 0, 0))
                         + dy * ((1 - dx) * co(0, 1, 0) + dx * co(1, 1, 0)))
             + dz * ((1 - dy) * ((1 - dx) * co(0, 0, 1) + dx * co(1, 0, 1))
                     + dy * ((1 - dx) * co(0, 1, 1) + dx * co(1, 1, 1))))
        # grayscale: flat sigmoid at the value
        sg = (r - 0.5) * jax_rsqrt(jnp.maximum(r * (1.0 - r), 1e-9))
        gray = jnp.stack([jnp.zeros_like(sg), jnp.zeros_like(sg), sg], -1)
        is_gray = (jnp.abs(r - g) < 1e-6) & (jnp.abs(g - b) < 1e-6)
        return jnp.where(is_gray[..., None], gray, c)

    def _poly_eval(self, c, lam):
        """sigmoid(c0 x^2 + c1 x + c2) at wavelengths lam [..., S]."""
        xn = (lam - 360.0) / (830.0 - 360.0) * 2.0 - 1.0
        f = c[..., 0:1] * xn * xn + c[..., 1:2] * xn + c[..., 2:3]
        return 0.5 * (f * jax_rsqrt(f * f + 1.0) + 1.0)

    def decode_albedo(self, rgb, swl):
        """Reflectance spectrum [..., S] for rgb [..., 3]."""
        if self.kind == KIND_SRGB:
            return rgb
        return self._poly_eval(self._poly_coeffs(rgb), swl.lam)

    def decode_unbound(self, rgb, swl):
        if self.kind == KIND_SRGB:
            return rgb
        rgb = jnp.maximum(rgb, 0.0)
        m = jnp.max(rgb, -1, keepdims=True)
        scale = 2.0 * m
        safe = jnp.where(scale > 0.0, rgb / jnp.maximum(scale, 1e-12), 0.0)
        return self._poly_eval(self._poly_coeffs(safe), swl.lam) * scale

    def decode_illumination(self, rgb, swl):
        """Emission spectrum: unbound decode x normalized D65."""
        if self.kind == KIND_SRGB:
            return rgb
        d65 = spd.spd_eval(self.d65n, swl.lam)
        return self.decode_unbound(rgb, swl) * d65

    # ---- spectrum -> display ----

    def to_srgb(self, sp, swl):
        """[..., S] spectral radiance -> linear sRGB [..., 3]
        (hero.cpp cie_xyz + xyz_to_linear_srgb)."""
        if self.kind == KIND_SRGB:
            return sp
        alive = swl.secondary_alive
        w = safe_div(1.0, swl.pdf)
        # dead secondaries contribute nothing; hero keeps full weight
        mask = jnp.concatenate(
            [jnp.ones_like(alive[..., None]),
             jnp.broadcast_to(alive[..., None], sp[..., 1:].shape)], -1)
        w = w * mask
        n_valid = jnp.sum(mask, -1)
        cx = spd.spd_eval(self.cie_x, swl.lam)
        cy = spd.spd_eval(self.cie_y, swl.lam)
        cz = spd.spd_eval(self.cie_z, swl.lam)
        y_int = jnp.sum(self.cie_y)
        f = safe_div(1.0, n_valid * y_int)
        X = jnp.sum(cx * sp * w, -1) * f
        Y = jnp.sum(cy * sp * w, -1) * f
        Z = jnp.sum(cz * sp * w, -1) * f
        xyz = jnp.stack([X, Y, Z], -1)
        return xyz @ jnp.asarray(XYZ_TO_SRGB).T


def jax_rsqrt(x):
    import jax
    return jax.lax.rsqrt(x)
