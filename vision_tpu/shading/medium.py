"""Participating media: homogeneous medium table + Henyey-Greenstein phase.

Replaces `/root/reference/src/render_core/medium/homogeneous.cpp` and the
HG phase function (`base/scattering/interaction.h:136-160`). Media live in an
SoA table; per-lane medium ids ride the wavefront (RayState.medium in the
reference, `sample.h:48-60`). Distance sampling is per-channel analytic
(channel chosen uniformly, MIS-averaged pdf — homogeneous.cpp sample()).
Named presets (Skin1 etc.) come from the measured Jensen et al. table
(data/measured_ss.npz, node_desc.cpp get_sigma).
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core import rng, warp
from ..core.math import (Inv4Pi, Pi, TwoPi, dot, normalize, safe_div, sqr,
                         vec3, coordinate_system, to_world)

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def measured_ss(name):
    tbl = np.load(os.path.join(_DATA, "measured_ss.npz"))
    names = [str(n) for n in tbl["names"]]
    if name not in names:
        name = names[0]
    i = names.index(name)
    return tbl["sigma_s"][i], tbl["sigma_a"][i]


@struct.dataclass
class MediumTable:
    sigma_a: jnp.ndarray  # [Md, 3] (x scale folded in)
    sigma_s: jnp.ndarray  # [Md, 3]
    g: jnp.ndarray        # [Md]

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


class MediumBuilder:
    def __init__(self):
        self.rows = []
        self.by_name = {}
        self.global_medium = -1

    def add(self, desc):
        from ..scene.desc import ParameterSet
        p = ParameterSet(desc.get("param", {}))
        name = desc.get("name")
        scale = p.as_float("scale", 1.0)
        mname = p.as_str("medium_name", "")
        if mname:
            ss, sa = measured_ss(mname)
        else:
            ss = np.asarray(p.as_float3("sigma_s", (1, 1, 1)), np.float32)
            sa = np.asarray(p.as_float3("sigma_a", (0, 0, 0)), np.float32)
        g = float(np.clip(p.as_float("g", 0.0), -0.99, 0.99))
        mid = len(self.rows)
        self.rows.append((ss * scale, sa * scale, g))
        if name:
            self.by_name[name] = mid
        return mid

    def get(self, name):
        return self.by_name.get(name, -1)

    def build(self):
        if not self.rows:
            self.rows.append((np.zeros(3, np.float32), np.zeros(3, np.float32), 0.0))
        ss = np.stack([r[0] for r in self.rows])
        sa = np.stack([r[1] for r in self.rows])
        g = np.asarray([r[2] for r in self.rows], np.float32)
        return MediumTable(sigma_a=jnp.asarray(sa), sigma_s=jnp.asarray(ss),
                           g=jnp.asarray(g))


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function (interaction.h phase_HG)
# ---------------------------------------------------------------------------

def hg_phase(cos_theta, g):
    denom = 1.0 + sqr(g) + 2.0 * g * cos_theta
    return Inv4Pi * (1.0 - sqr(g)) / (denom * jnp.sqrt(jnp.maximum(denom, 1e-8)))


def hg_sample(wo, g, u2):
    """Sample wi from HG around -wo-forward convention (PBRT): returns
    (wi, pdf). wo points away from the scatter point."""
    g = jnp.where(jnp.abs(g) < 1e-3, jnp.full_like(g, 1e-3) * jnp.sign(g + 1e-9), g)
    sqr_term = (1.0 - sqr(g)) / (1.0 + g - 2.0 * g * u2[..., 0])
    cos_theta = -(1.0 + sqr(g) - sqr(sqr_term)) / (2.0 * g)
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - sqr(cos_theta)))
    phi = TwoPi * u2[..., 1]
    # frame around wo
    t, b = coordinate_system(wo)
    wi_local = vec3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
    wi = to_world(t, b, wo, wi_local)
    pdf = hg_phase(cos_theta, g)
    return normalize(wi), pdf


def gather_spectral(table, mid, spectrum, swl):
    """(sigma_t [..., S], sigma_s [..., S], g [...]) for lanes with medium id
    mid (clamped; callers mask by mid >= 0). Unbound decode in hero mode."""
    m = jnp.clip(mid, 0, table.g.shape[0] - 1)
    st = table.sigma_t[m]
    ss = table.sigma_s[m]
    if spectrum is not None:
        st = spectrum.decode_unbound(st, swl)
        ss = spectrum.decode_unbound(ss, swl)
    return st, ss, table.g[m]


def sample_distance(state, sigma_t, t_surf, S):
    """Analytic distance sampling (homogeneous.cpp sample()): pick a channel
    uniformly, sample exp(-sigma_t_c d); returns
    (state, t, in_scatter_mask_factorless, weight_surface, weight_medium).

    weight_* are the throughput ratios tr*sigma_s/pdf (medium event — the
    sigma_s factor is applied by the caller) and tr/pdf (surface event)."""
    state, u_c = rng.next_1d(state)
    state, u_d = rng.next_1d(state)
    ch = jnp.minimum((u_c * S).astype(jnp.int32), S - 1)
    s_ch = jnp.take_along_axis(sigma_t, ch[..., None], -1)[..., 0]
    dist = -jnp.log(jnp.maximum(1.0 - u_d, 1e-9)) / jnp.maximum(s_ch, 1e-9)
    t = jnp.minimum(dist, t_surf)
    sampled_medium = (dist < t_surf) & (s_ch > 0.0)
    tr = jnp.exp(-sigma_t * t[..., None])
    density_m = jnp.mean(sigma_t * tr, -1)
    density_s = jnp.mean(tr, -1)
    w_medium = tr * safe_div(1.0, density_m)[..., None]
    w_surface = tr * safe_div(1.0, density_s)[..., None]
    return state, t, sampled_medium, w_surface, w_medium


def transmittance(sigma_t, dist, in_medium):
    """Shadow-ray transmittance for lanes inside a homogeneous medium."""
    tr = jnp.exp(-sigma_t * dist[..., None])
    return jnp.where(in_medium[..., None], tr, jnp.ones_like(tr))
