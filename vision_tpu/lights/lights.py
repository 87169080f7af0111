"""Flat light table: sampling + evaluation for all light types, uber-style.

Replaces the light plugins + polymorphic LightSampler of the reference
(`/root/reference/src/base/illumination/{light.h,lightsampler.cpp}` and
`render_core/light/*.cpp`). Same design move as materials: every light type
becomes rows of one SoA table, and sample/eval run all type formulas masked.

Conventions (parity with the reference):
  * sample_wi returns radiance L and a solid-angle pdf; DELTA lights return
    pdf = -pmf (negative marks delta; the integrator flips the sign and skips
    MIS — lightsampler.cpp / integrator.cpp:158 convention).
  * area lights: L = color*scale if front-facing (or two_sided);
    pdf_wi = (1/total_area) * r^2 / cos_light * pmf_light.
  * point: L = color*scale / r^2.   spot: x falloff^4 window (spot.cpp).
  * projector: perspective-projected texture / r^2 (projector.cpp).
  * spherical env: lat-long HDRI, 2D alias-table importance sampling,
    pdf = pmf * WH / (2 pi^2 sin(theta)) (spherical.cpp).
  * light selection: uniform or power-weighted; env light separated with
    fixed probability env_prob (lightsampler.cpp:161-196).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core.math import (Inv2Pi, InvPi, Pi, TwoPi, dot, length_squared,
                         normalize, safe_div, safe_sqrt, spherical_phi,
                         spherical_theta, vec3)
from ..core import warp
from .alias import build_alias, sample_alias
from ..core.gather import fetch_rows


def _decode_illum(rgb, spectrum, swl):
    if spectrum is None:
        return rgb
    return spectrum.decode_illumination(rgb, swl)

L_AREA = 0
L_POINT = 1
L_SPOT = 2
L_PROJECTOR = 3
L_SPHERICAL = 4
L_DIRECTIONAL = 5


@struct.dataclass
class LightTable:
    n_lights: int = struct.field(pytree_node=False)
    env_index: int = struct.field(pytree_node=False)   # -1 if none
    env_prob: float = struct.field(pytree_node=False)
    ltype: jnp.ndarray        # [L] int32
    color: jnp.ndarray        # [L, 3] radiance/intensity * scale
    color_tex: jnp.ndarray    # [L] texture id (-1 const)
    position: jnp.ndarray     # [L, 3]
    direction: jnp.ndarray    # [L, 3]
    cos_angle: jnp.ndarray    # [L] spot cone cos / directional angular radius
    cos_falloff: jnp.ndarray  # [L] spot falloff-start cos
    tan_xy: jnp.ndarray       # [L, 2] projector half-tangents
    w2o: jnp.ndarray          # [L, 3, 3] world->light rotation (env/projector)
    two_sided: jnp.ndarray    # [L] int32
    inst_id: jnp.ndarray      # [L] area-light instance id
    total_area: jnp.ndarray   # [L] area-light summed area
    # area-light triangle alias tables (concatenated)
    tri_offset: jnp.ndarray   # [L] offset into alias arrays
    tri_count: jnp.ndarray    # [L]
    a_prob: jnp.ndarray       # [AT]
    a_alias: jnp.ndarray      # [AT]
    a_pmf: jnp.ndarray        # [AT]
    tri_base: jnp.ndarray     # [L] first global-triangle id of the light's mesh
    # env map alias table over pixels (single env light supported)
    env_tex: jnp.ndarray      # scalar texture id
    env_w: jnp.ndarray        # scalar int
    env_h: jnp.ndarray
    e_prob: jnp.ndarray       # [W*H]
    e_alias: jnp.ndarray
    e_pmf: jnp.ndarray
    # light selection distribution (power/uniform) over non-env lights
    sel_prob: jnp.ndarray     # [L]
    sel_alias: jnp.ndarray
    sel_pmf: jnp.ndarray      # [L] pmf of selecting light l (excluding env split)
    # static light-type usage flags (same design as LobeParams.feats): type
    # branches for light kinds absent from the scene compile to nothing.
    # "tex" marks that some non-env light carries a texture slot.
    feats: tuple = struct.field(pytree_node=False,
                                default=("area", "point", "spot", "proj",
                                         "env", "dir", "tex"))

    # IES angular profiles (base/illumination/ies.cpp, wired as a
    # spot/projector mask — the reference parses but never consumes them)
    ies_id: jnp.ndarray = None        # [L] profile row (-1 none)
    ies_profiles: jnp.ndarray = None  # [P, 64] polar profile, peak 1

    def has(self, name):
        return name in self.feats


@struct.dataclass
class LightSample:
    p_light: jnp.ndarray   # [..., 3] sampled point (or far point for env/dir)
    wi: jnp.ndarray        # [..., 3] direction from shading point
    L: jnp.ndarray         # [..., S] radiance
    pdf: jnp.ndarray       # [...] solid-angle pdf; negative = delta
    dist: jnp.ndarray      # [...] distance for occlusion test


def _falloff_spot(cos_theta, cos_angle, cos_falloff):
    c = jnp.clip(cos_theta, cos_angle, cos_falloff)
    factor = safe_div(c - cos_angle, cos_falloff - cos_angle)
    return factor ** 4


def _rotate(m, v):
    """Apply [...,3,3] (or [3,3]) to [...,3]."""
    return jnp.einsum("...ij,...j->...i", m, v)


def env_radiance(table, atlas, world_dir, spectrum=None, swl=None):
    """Environment radiance for direction(s) (miss shading). Spectral when a
    hero SpectrumModel is given (illumination decode of the texel)."""
    S = 3 if spectrum is None else spectrum.dims
    if table.env_index < 0:
        return jnp.zeros(world_dir.shape[:-1] + (S,))
    li = table.env_index
    local = _rotate(table.w2o[li], world_dir)
    theta = spherical_theta(local)
    phi = spherical_phi(local)
    uv = jnp.stack([phi * Inv2Pi, theta * InvPi], -1)
    scale = table.color[li]
    # env uses direct lat-long addressing (v=0 at top row => no flip)
    rgb = _sample_env_tex(table, atlas, uv) * scale
    return _decode_illum(rgb, spectrum, swl)


def _sample_env_tex(table, atlas, uv):
    """Bilinear env fetch WITHOUT the v-flip used for surface textures
    (lat-long v grows downward from +z pole, matching image rows)."""
    flip = jnp.stack([uv[..., 0], 1.0 - uv[..., 1]], -1)
    return atlas.sample(table.env_tex, flip)


def env_pdf_wi(table, world_dir):
    """Solid-angle pdf of env sampling for MIS on miss (evaluate_miss_wi)."""
    if table.env_index < 0:
        return jnp.zeros(world_dir.shape[:-1])
    li = table.env_index
    local = _rotate(table.w2o[li], world_dir)
    theta = spherical_theta(local)
    phi = spherical_phi(local)
    sin_t = jnp.sin(theta)
    w = table.env_w
    h = table.env_h
    x = jnp.clip((phi * Inv2Pi * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((theta * InvPi * h).astype(jnp.int32), 0, h - 1)
    pmf = table.e_pmf[y * w + x]
    pdf = pmf * (w * h).astype(jnp.float32) / (2.0 * Pi * Pi * jnp.maximum(sin_t, 1e-6))
    pdf = jnp.where(sin_t > 1e-6, pdf, 0.0)
    # combine with selection prob
    sel = table.env_prob if table.n_lights > 1 else 1.0
    return pdf * sel


def select_light(table, u):
    """Pick a light id: env with prob env_prob, else alias over sel weights.
    Returns (light_id, pmf, u_remapped)."""
    L = table.ltype.shape[0]
    if L == 1 and table.env_index < 0:
        # single-light fast path: no alias walk, u passes through untouched
        return jnp.zeros(u.shape, jnp.int32), jnp.ones_like(u), u
    if table.env_index >= 0 and L > 1:
        ep = table.env_prob
        pick_env = u < ep
        u2 = jnp.where(pick_env, u / ep, (u - ep) / (1.0 - ep))
        idx, pmf, u3 = sample_alias(table.sel_prob, table.sel_alias,
                                    table.sel_pmf, u2)
        lid = jnp.where(pick_env, table.env_index, idx)
        pmf = jnp.where(pick_env, ep, pmf * (1.0 - ep))
        return lid, pmf, jnp.where(pick_env, u2, u3)
    if table.env_index >= 0 and L == 1:
        return jnp.full(u.shape, table.env_index, jnp.int32), jnp.ones_like(u), u
    idx, pmf, u2 = sample_alias(table.sel_prob, table.sel_alias, table.sel_pmf, u)
    return idx, pmf, u2


def light_pmf(table, light_id):
    """PMF of having selected light_id (for hit/miss MIS)."""
    base = table.sel_pmf[jnp.clip(light_id, 0, table.ltype.shape[0] - 1)]
    if table.env_index >= 0 and table.ltype.shape[0] > 1:
        return jnp.where(light_id == table.env_index, table.env_prob,
                         base * (1.0 - table.env_prob))
    return base


def sample_wi(table, atlas, tri_pack, ref_pos, ref_ng, u_sel, u2,
              world_radius, spectrum=None, swl=None):
    """NEE light sample for every lane. tri_pack = [T, 32] packed triangle
    rows (p0 e1 e2 ... uv0 uv1 uv2) for area lights. Returns LightSample;
    L is [..., S] (spectral under a hero SpectrumModel)."""
    lid, sel_pmf, u_sel2 = select_light(table, u_sel)
    # one fused row fetch for every per-light column used below
    # (core/gather.py)
    (lt, color, l_ctex, l_pos, l_dir, l_cosang, l_cosfall, l_tanxy, l_w2o,
     l_two, l_area_tot, l_toff, l_tcnt, l_tbase) = fetch_rows(
        [table.ltype, table.color, table.color_tex, table.position,
         table.direction, table.cos_angle, table.cos_falloff, table.tan_xy,
         table.w2o.reshape(table.w2o.shape[0], 9), table.two_sided,
         table.total_area, table.tri_offset, table.tri_count,
         table.tri_base], lid)
    l_w2o = l_w2o.reshape(l_w2o.shape[:-1] + (3, 3))

    def ies_weight(cos_theta):
        """IES angular mask for the selected light (1 when no profile):
        per-lane profile row + linear interpolation over the polar angle."""
        if "ies" not in table.feats or table.ies_id is None:
            return jnp.ones_like(cos_theta)
        l_ies = fetch_rows([table.ies_id], lid)[0]
        prof = table.ies_profiles[jnp.clip(l_ies, 0,
                                           table.ies_profiles.shape[0] - 1)]
        n = prof.shape[-1]
        theta = jnp.degrees(jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0)))
        t = theta / 180.0 * (n - 1)
        i0 = jnp.clip(t.astype(jnp.int32), 0, n - 1)
        i1 = jnp.clip(i0 + 1, 0, n - 1)
        f = (t - i0.astype(jnp.float32))[..., None]
        v0 = jnp.take_along_axis(prof, i0[..., None], axis=-1)
        v1 = jnp.take_along_axis(prof, i1[..., None], axis=-1)
        w = (v0 * (1 - f) + v1 * f)[..., 0]
        return jnp.where(l_ies >= 0, w, 1.0)

    shape = ref_pos.shape[:-1]
    zeros = jnp.zeros(shape)
    false = jnp.zeros(shape, bool)
    zero3 = jnp.zeros(shape + (3,))

    # per-type masks; absent types are statically False so every masked
    # branch below (and its gathers/atlas fetches) compiles to nothing
    is_area = (lt == L_AREA) if table.has("area") else false
    is_point = (lt == L_POINT) if table.has("point") else false
    is_spot = (lt == L_SPOT) if table.has("spot") else false
    is_proj = (lt == L_PROJECTOR) if table.has("proj") else false
    is_env = (lt == L_SPHERICAL) if (table.has("env")
                                     and table.env_index >= 0) else false
    is_dir = (lt == L_DIRECTIONAL) if table.has("dir") else false

    wi = zero3
    L = zero3
    p_light = ref_pos
    pdf = jnp.ones(shape)
    dist2 = jnp.ones(shape)

    # ---- area light: pick triangle by alias over areas, warp to barycentric
    if table.has("area"):
        off = l_toff
        cnt = jnp.maximum(l_tcnt, 1)
        tri_i, tri_pmf, u_rem = sample_alias(table.a_prob, table.a_alias,
                                             table.a_pmf, u_sel2, off, cnt)
        gtri = l_tbase + tri_i
        gtri = jnp.clip(gtri, 0, tri_pack.shape[0] - 1)
        trow = fetch_rows([tri_pack], gtri)[0]
        p0 = trow[..., 0:3]
        e1 = trow[..., 3:6]
        e2 = trow[..., 6:9]
        u_tri = jnp.stack([u_rem, u2[..., 1]], -1)
        b = warp.square_to_triangle(u_tri)
        p_area = p0 + b[..., 0:1] * e1 + b[..., 1:2] * e2
        ng_l = jnp.cross(e1, e2)
        area2 = jnp.sqrt(jnp.maximum(jnp.sum(ng_l * ng_l, -1), 1e-20))
        ng_l = ng_l / area2[..., None]
        to_ref = ref_pos - p_area
        dist2_a = jnp.maximum(jnp.sum(to_ref * to_ref, -1), 1e-12)
        w_lr = to_ref / jnp.sqrt(dist2_a)[..., None]
        front = jnp.sum(w_lr * ng_l, -1)
        vis_a = (front > 0.0) | (l_two > 0)
        # pdf_pos = 1/total_area (alias pmf folds the per-tri area back in)
        pdf_pos = safe_div(1.0, l_area_tot)
        cos_l = jnp.abs(front)
        pdf_a = safe_div(pdf_pos * dist2_a, cos_l)
        L_a = color * vis_a[..., None]
        # textured emission (light.h color slot evaluated at the surface uv)
        if table.has("tex") and getattr(atlas, "has_textures", True):
            b0 = 1.0 - b[..., 0:1] - b[..., 1:2]
            uv_area = (b0 * trow[..., 18:20] + b[..., 0:1] * trow[..., 20:22]
                       + b[..., 1:2] * trow[..., 22:24])
            ctex = l_ctex
            tex_a = atlas.sample(ctex, uv_area)
            L_a = L_a * jnp.where((ctex >= 0)[..., None], tex_a,
                                  jnp.ones_like(tex_a))
        m = is_area[..., None]
        wi = jnp.where(m, normalize(p_area - ref_pos), wi)
        p_light = jnp.where(m, p_area, p_light)
        L = jnp.where(m, L_a, L)
        pdf = jnp.where(is_area, pdf_a, pdf)
        dist2 = jnp.where(is_area, dist2_a, dist2)

    # ---- point / spot / projector (delta, positional)
    if table.has("point") or table.has("spot") or table.has("proj"):
        pos = l_pos
        to_light = pos - ref_pos
        d2 = jnp.maximum(jnp.sum(to_light * to_light, -1), 1e-12)
        wi_near = normalize(to_light)
        L_p = color / d2[..., None]
        near = is_point | is_spot | is_proj
        m = near[..., None]
        wi = jnp.where(m, wi_near, wi)
        p_light = jnp.where(m, pos, p_light)
        dist2 = jnp.where(near, d2, dist2)
        if table.has("point"):
            L = jnp.where(is_point[..., None], L_p, L)
        if table.has("spot"):
            dirn_s = l_dir
            w_from_light = -wi_near
            cos_sp = jnp.sum(dirn_s * w_from_light, -1)
            fall = _falloff_spot(cos_sp, l_cosang, l_cosfall)
            fall = fall * ies_weight(cos_sp)
            L = jnp.where(is_spot[..., None], L_p * fall[..., None], L)
        if table.has("proj"):
            # projector: transform ref into light space
            pl = _rotate(l_w2o, ref_pos - pos)
            valid_pr = pl[..., 2] > 0.0
            pxy = pl[..., :2] / jnp.maximum(pl[..., 2:3], 1e-8)
            txy = l_tanxy
            uv_pr = (pxy + txy) / (2.0 * txy)
            in_frame = valid_pr & jnp.all((uv_pr >= 0.0) & (uv_pr <= 1.0), -1)
            if getattr(atlas, "has_textures", True):
                ctex = l_ctex
                tex_pr = atlas.sample(ctex, uv_pr)
                proj_col = jnp.where((ctex >= 0)[..., None], tex_pr,
                                     jnp.ones_like(tex_pr))
            else:
                proj_col = jnp.ones(uv_pr.shape[:-1] + (3,))
            cos_pr = normalize(pl)[..., 2]
            L_pr = (color * proj_col / d2[..., None] * in_frame[..., None]
                    * ies_weight(cos_pr)[..., None])
            L = jnp.where(is_proj[..., None], L_pr, L)

    # ---- spherical env: alias over pixels
    if table.has("env") and table.env_index >= 0:
        W = table.env_w
        H = table.env_h
        n_px = jnp.maximum(W * H, 1)
        px, px_pmf, u_rem2 = sample_alias(table.e_prob, table.e_alias,
                                          table.e_pmf, u_sel2, 0, n_px)
        py = px // jnp.maximum(W, 1)
        pxx = px - py * W
        uv_e = jnp.stack(
            [(pxx.astype(jnp.float32) + u_rem2) / jnp.maximum(W, 1),
             (py.astype(jnp.float32) + u2[..., 1]) / jnp.maximum(H, 1)], -1)
        theta = uv_e[..., 1] * Pi
        phi = uv_e[..., 0] * TwoPi
        sin_t = jnp.sin(theta)
        local_dir = vec3(jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t,
                         jnp.cos(theta))
        o2w_env = jnp.swapaxes(l_w2o, -1, -2)
        wi_env = _rotate(o2w_env, local_dir)
        pdf_e = safe_div(px_pmf * n_px.astype(jnp.float32),
                         2.0 * Pi * Pi * jnp.maximum(sin_t, 1e-6))
        pdf_e = jnp.where(sin_t > 1e-6, pdf_e, 0.0)
        L_e = _sample_env_tex(table, atlas, uv_e) * color
        m = is_env[..., None]
        wi = jnp.where(m, wi_env, wi)
        L = jnp.where(m, L_e, L)
        pdf = jnp.where(is_env, pdf_e, pdf)

    # ---- directional (directional.cpp): delta; wi = -direction, L = color
    if table.has("dir"):
        dirn = l_dir
        m = is_dir[..., None]
        wi = jnp.where(m, -dirn, wi)
        L = jnp.where(m, color, L)

    far = is_env | is_dir
    p_light = jnp.where(far[..., None],
                        ref_pos + wi * (2.0 * world_radius), p_light)
    L = _decode_illum(L, spectrum, swl)
    delta = is_point | is_spot | is_proj | is_dir
    pdf = pdf * sel_pmf
    pdf = jnp.where(delta, -pdf, pdf)
    dist = jnp.where(far, 2.0 * world_radius, jnp.sqrt(dist2))
    return LightSample(p_light=p_light, wi=wi, L=L, pdf=pdf, dist=dist)


def eval_hit_area(table, light_id, prim_id, tri_base_area, ref_pos, hit_pos,
                  hit_ng, hit_uv, atlas, spectrum=None, swl=None):
    """(L, pdf_wi) when a scatter ray hits an emissive surface
    (lightsampler.cpp evaluate_hit_wi). pdf includes light selection pmf."""
    lid = jnp.clip(light_id, 0, table.ltype.shape[0] - 1)
    color, ctex, two, area_tot, selp = fetch_rows(
        [table.color, table.color_tex, table.two_sided, table.total_area,
         table.sel_pmf], lid)
    if (hit_uv is not None and table.has("tex")
            and getattr(atlas, "has_textures", True)):
        tex = atlas.sample(ctex, hit_uv)
        color = color * jnp.where((ctex >= 0)[..., None], tex,
                                  jnp.ones_like(tex))
    w = ref_pos - hit_pos
    front = dot(normalize(w), hit_ng)
    vis = (front > 0.0) | (two > 0)
    L = _decode_illum(color, spectrum, swl) * vis[..., None]
    pdf_pos = safe_div(1.0, area_tot)
    pdf_wi = warp.pdf_wi_from_point(pdf_pos, hit_ng, w)
    pdf_wi = jnp.where(jnp.isfinite(pdf_wi), pdf_wi, 0.0)
    if table.env_index >= 0 and table.ltype.shape[0] > 1:
        sel = jnp.where(lid == table.env_index, table.env_prob,
                        selp * (1.0 - table.env_prob))
    else:
        sel = selp
    pdf_wi = pdf_wi * sel
    ok = light_id >= 0
    return jnp.where(ok[..., None], L, 0.0), jnp.where(ok, pdf_wi, 0.0)


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------

class LightBuilder:
    def __init__(self, sampler_type="uniform", env_prob=0.5):
        self.rows = []
        self.area_weights = []     # per-light list of triangle areas
        self.env = None            # (tex_id, weights2d [H,W], w, h)
        self.sampler_type = sampler_type
        self.env_prob = env_prob

    def _default(self):
        return dict(ltype=L_POINT, color=[0, 0, 0], color_tex=-1,
                    position=[0, 0, 0], direction=[0, 0, 1],
                    cos_angle=0.0, cos_falloff=1.0, tan_xy=[1.0, 1.0],
                    w2o=np.eye(3, dtype=np.float32),
                    two_sided=0, inst_id=-1, total_area=1.0, tri_base=0,
                    power=1.0, ies_id=-1)

    def add_area(self, color, inst_id, tri_base, tri_areas, two_sided=False,
                 tex_id=-1):
        r = self._default()
        total = float(np.sum(tri_areas))
        lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
        r.update(ltype=L_AREA, color=list(color), inst_id=inst_id,
                 tri_base=tri_base, total_area=max(total, 1e-12),
                 two_sided=1 if two_sided else 0, color_tex=tex_id,
                 power=(2.0 if two_sided else 1.0) * lum * total * Pi)
        self.rows.append(r)
        self.area_weights.append(np.asarray(tri_areas, np.float64))
        return len(self.rows) - 1

    def add_point(self, color, position):
        r = self._default()
        lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
        r.update(ltype=L_POINT, color=list(color), position=list(position),
                 power=4 * Pi * lum)
        self.rows.append(r)
        self.area_weights.append(np.ones(1))
        return len(self.rows) - 1

    def add_ies_profile(self, profile):
        """Register a [64] polar attenuation profile; returns its id."""
        if not hasattr(self, "ies_profiles"):
            self.ies_profiles = []
        self.ies_profiles.append(np.asarray(profile, np.float32))
        return len(self.ies_profiles) - 1

    def add_spot(self, color, position, direction, angle_deg, falloff_deg,
                 ies=-1):
        r = self._default()
        angle = np.deg2rad(np.clip(angle_deg, 1.0, 89.0))
        falloff = np.deg2rad(np.clip(falloff_deg, 0.0, np.rad2deg(angle)))
        lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        r.update(ltype=L_SPOT, color=list(color), position=list(position),
                 direction=list(d), cos_angle=float(np.cos(angle)),
                 cos_falloff=float(np.cos(max(0.0, angle - falloff))),
                 power=2 * Pi * lum, ies_id=ies)
        self.rows.append(r)
        self.area_weights.append(np.ones(1))
        return len(self.rows) - 1

    def add_projector(self, color, o2w, angle_deg, ratio, tex_id, ies=-1):
        r = self._default()
        tan_y = float(np.tan(np.deg2rad(angle_deg)))
        tan_x = ratio * tan_y
        lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
        w2o = np.linalg.inv(o2w[:3, :3]).astype(np.float32)
        r.update(ltype=L_PROJECTOR, color=list(color),
                 position=list(np.asarray(o2w[:3, 3], np.float64)),
                 tan_xy=[tan_x, tan_y], w2o=w2o, color_tex=tex_id,
                 power=lum, ies_id=ies)
        self.rows.append(r)
        self.area_weights.append(np.ones(1))
        return len(self.rows) - 1

    def add_spherical(self, scale_color, o2w, tex_id, image):
        r = self._default()
        h, w = image.shape[:2]
        lum = (0.212671 * image[..., 0] + 0.715160 * image[..., 1]
               + 0.072169 * image[..., 2])
        theta = (np.arange(h) + 0.5) / h * np.pi
        weights = lum * np.sin(theta)[:, None]
        w2o = np.linalg.inv(o2w[:3, :3]).astype(np.float32)
        r.update(ltype=L_SPHERICAL, color=list(scale_color), w2o=w2o,
                 color_tex=tex_id, power=float(lum.mean()) * 4 * Pi)
        self.rows.append(r)
        self.area_weights.append(np.ones(1))
        self.env = (tex_id, weights, w, h)
        return len(self.rows) - 1

    def add_directional(self, color, direction):
        r = self._default()
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
        r.update(ltype=L_DIRECTIONAL, color=list(color), direction=list(d),
                 power=lum)
        self.rows.append(r)
        self.area_weights.append(np.ones(1))
        return len(self.rows) - 1

    def build(self):
        if not self.rows:
            # sentinel empty light
            self.rows.append(self._default())
            self.area_weights.append(np.ones(1))
        rows = self.rows
        L = len(rows)
        env_index = next((i for i, r in enumerate(rows)
                          if r["ltype"] == L_SPHERICAL), -1)

        # area triangle alias tables, concatenated
        offs, cnts = [], []
        probs, aliases, pmfs = [], [], []
        off = 0
        for wts in self.area_weights:
            p, a, m = build_alias(wts)
            offs.append(off)
            cnts.append(len(wts))
            probs.append(p)
            aliases.append(a)
            pmfs.append(m)
            off += len(wts)

        # env pixel alias
        if self.env is not None:
            tex_id, wts2d, ew, eh = self.env
            ep, ea, em = build_alias(wts2d.reshape(-1))
        else:
            tex_id, ew, eh = 0, 1, 1
            ep = np.ones(1, np.float32)
            ea = np.zeros(1, np.int32)
            em = np.ones(1, np.float32)

        # selection distribution over non-env lights
        if self.sampler_type == "power":
            sw = np.array([r["power"] for r in rows], np.float64)
        else:
            sw = np.ones(L)
        if env_index >= 0:
            sw[env_index] = 0.0
        if sw.sum() <= 0:
            sw[:] = 1.0
        sp, sa, sm = build_alias(sw)

        def col(key, dtype=np.float32):
            return jnp.asarray(np.asarray([r[key] for r in rows]), dtype)

        # static type-usage flags -> sample_wi/eval compile only live branches
        types = {r["ltype"] for r in rows}
        name_of = {L_AREA: "area", L_POINT: "point", L_SPOT: "spot",
                   L_PROJECTOR: "proj", L_SPHERICAL: "env",
                   L_DIRECTIONAL: "dir"}
        feats = tuple(sorted(name_of[t] for t in types)) + ((
            ("tex",) if any(r["color_tex"] >= 0 and r["ltype"] != L_SPHERICAL
                            for r in rows) else ()))

        profs = getattr(self, "ies_profiles", [])
        if any(r["ies_id"] >= 0 for r in rows):
            feats = feats + ("ies",)
        prof_arr = (np.stack(profs) if profs
                    else np.ones((1, 64), np.float32))

        return LightTable(
            feats=feats,
            n_lights=L, env_index=env_index,
            env_prob=float(np.clip(self.env_prob, 0.01, 0.99)),
            ltype=col("ltype", np.int32), color=col("color"),
            color_tex=col("color_tex", np.int32), position=col("position"),
            direction=col("direction"), cos_angle=col("cos_angle"),
            cos_falloff=col("cos_falloff"), tan_xy=col("tan_xy"),
            w2o=col("w2o"), two_sided=col("two_sided", np.int32),
            inst_id=col("inst_id", np.int32), total_area=col("total_area"),
            tri_offset=jnp.asarray(offs, jnp.int32),
            tri_count=jnp.asarray(cnts, jnp.int32),
            a_prob=jnp.asarray(np.concatenate(probs)),
            a_alias=jnp.asarray(np.concatenate(aliases), jnp.int32),
            a_pmf=jnp.asarray(np.concatenate(pmfs)),
            tri_base=col("tri_base", np.int32),
            env_tex=jnp.asarray(tex_id, jnp.int32),
            env_w=jnp.asarray(ew, jnp.int32), env_h=jnp.asarray(eh, jnp.int32),
            e_prob=jnp.asarray(ep), e_alias=jnp.asarray(ea, jnp.int32),
            e_pmf=jnp.asarray(em),
            sel_prob=jnp.asarray(sp), sel_alias=jnp.asarray(sa, jnp.int32),
            sel_pmf=jnp.asarray(sm),
            ies_id=col("ies_id", np.int32),
            ies_profiles=jnp.asarray(prof_arr),
        )
