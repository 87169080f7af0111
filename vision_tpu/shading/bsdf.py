"""Unified lobe-set BSDF ("uber-BSDF"), the TPU-native material dispatch.

The reference dispatches `Polymorphic<Material>.dispatch(mat_id)` into
per-material DSL code (`/root/reference/src/base/scattering/lobe.h` LobeSet).
On TPU, divergent per-lane dispatch is poison, so instead EVERY material
compiles into parameters of one fixed superset of lobes:

  0 diffuse      (Lambert / Oren-Nayar / Ashikhmin-Shirley FresnelBlend diffuse)
  1 specular     (GGX reflection; Fresnel: dielectric/conductor/schlick/const/F82)
  2 transmission (GGX dielectric refraction, coupled to lobe 1 via (1-F))
  3 clearcoat    (iso GGX, schlick F0 = 0.04)
  4 sheen        (Burley-style sheen)

eval/sample run all lobes on all lanes (masked by weights) — one code path,
VPU-friendly, zero divergence. Colors carry a trailing spectral axis S
(S=3 sRGB mode, S=n_lambda hero mode). Directions are in the local shading
frame (z = ns).

Reference parity notes:
  diffuse.cpp      -> kind=0 (sigma>0 gives Oren-Nayar)
  mirror.cpp       -> lobe 1, FR_CONSTANT
  metal.cpp        -> lobe 1, FR_CONDUCTOR (eta/k spectra)
  metallic.cpp     -> lobe 1, FR_F82
  glass.cpp        -> lobes 1+2, FR_DIELECTRIC (+ dispersion via spectral eta)
  substrate.cpp    -> kind=2 diffuse + lobe 1 schlick (FresnelBlend coupling)
  plastic.cpp      -> diffuse + lobe 1 dielectric fresnel
  principled_bsdf  -> all lobes
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..core.math import (InvPi, Pi, abs_cos_theta, cos_theta, dot, lerp,
                         normalize, reflect, refract, safe_div, safe_sqrt,
                         same_hemisphere, sqr, vec3)
from ..core import rng, warp
from . import fresnel as fr
from . import microfacet as mf

# diffuse kinds
DIFF_LAMBERT = 0      # + oren-nayar via sigma
DIFF_FRESNEL_BLEND = 1  # substrate (Ashikhmin-Shirley)
DIFF_DISNEY = 2       # Burley diffuse + retro


@struct.dataclass
class LobeParams:
    """Per-lane evaluated material parameters. Leading batch shape [...];
    colors [..., S]."""
    # diffuse
    kd: jnp.ndarray
    sigma: jnp.ndarray          # oren-nayar sigma in degrees-mapped A/B form (0 => lambert)
    diffuse_kind: jnp.ndarray   # int32
    diffuse_weight: jnp.ndarray
    # specular reflection
    spec_tint: jnp.ndarray      # [..., S]
    ax: jnp.ndarray
    ay: jnp.ndarray
    fr_mode: jnp.ndarray        # int32 (fresnel.FR_*)
    eta: jnp.ndarray            # [..., S] spectral relative IOR (dielectric; hero disp.)
    eta3: jnp.ndarray           # [..., S] conductor eta / F0 (schlick) / F82 F0
    k3: jnp.ndarray             # [..., S] conductor k / F82 b coefficient
    spec_weight: jnp.ndarray
    # transmission (glass)
    trans_weight: jnp.ndarray
    # clearcoat
    cc_weight: jnp.ndarray
    cc_alpha: jnp.ndarray
    # sheen
    sheen_weight: jnp.ndarray
    sheen_tint: jnp.ndarray     # [..., S]
    # disney extras
    flatness: jnp.ndarray
    metallic: jnp.ndarray
    # static lobe-usage flags (computed from the material table at scene
    # build): unused lobe families compile to nothing
    feats: tuple = struct.field(pytree_node=False,
                                default=("diff", "spec", "trans", "cc",
                                         "sheen", "oren", "blend", "disney"))
    # GGX directional-albedo LUT (shared rows, not per-lane) for the
    # Kulla-Conty multiple-scattering lobe (tools/gen_energy_lut.py;
    # PureReflectionLobe energy compensation in the reference)
    ems_E: jnp.ndarray = None       # [Na, Nmu]
    ems_Eavg: jnp.ndarray = None    # [Na]
    # self-fit LTC sheen table (tools/gen_sheen_ltc.py; the reference's
    # SheenLTC lobe, principled_bsdf.cpp:17-118): [32, 32, 3] over
    # (cos_theta_o, alpha) -> (a, b, R). None -> Burley sheen fallback.
    sheen_ltc: jnp.ndarray = None
    sheen_alpha: jnp.ndarray = None  # [...] sheen roughness (LTC table axis)
    # LobeSet mixture (lobe.h:277-330 create_mix/create_add): a second full
    # parameter row plus per-row weights. f = wa*f_a + wb*f_b; sampling uses
    # normalized weights as the one-sample-MIS mixture pdf. Non-mixture lanes
    # carry wa=1, wb=0 (formulas reduce exactly). None when no scene material
    # mixes ("mix2" not in feats) so plain scenes compile none of this.
    mix_b: "LobeParams" = None
    mix_wa: jnp.ndarray = None      # [...]
    mix_wb: jnp.ndarray = None      # [...]

    def has(self, name):
        return name in self.feats


@struct.dataclass
class ScatterEval:
    f: jnp.ndarray       # [..., S] BSDF value (no cosine)
    pdf: jnp.ndarray     # [...]

    def throughput(self, wi_cos):
        """f * |cos| / pdf (reference ScatterEval::throughput)."""
        w = safe_div(jnp.abs(wi_cos), self.pdf)
        return self.f * w[..., None]


@struct.dataclass
class BSDFSample:
    wi: jnp.ndarray       # [..., 3] local
    ev: ScatterEval
    eta_scale: jnp.ndarray  # relative ior^2 carried for RR (1 unless refracted)
    valid: jnp.ndarray


def _hemi_eta(p, wo):
    """Per-lane relative eta seen from wo side: eta if entering, 1/eta if exiting.
    Uses hero wavelength (index 0) for direction math."""
    eta0 = p.eta[..., 0]
    return jnp.where(cos_theta(wo) > 0.0, eta0, safe_div(1.0, eta0))


def _eval_fresnel(p, cos_i):
    """Evaluate the lobe-1 Fresnel for |cos_i|, by mode, shape [..., S]."""
    abs_ci = jnp.abs(cos_i)
    S = p.kd.shape[-1]
    f_diel = fr.fresnel_dielectric(abs_ci[..., None], p.eta)
    f_cond = fr.fresnel_complex(abs_ci[..., None], p.eta3, p.k3)
    f_schl = fr.fresnel_schlick(p.eta3, abs_ci)
    f_cons = jnp.ones_like(p.kd)
    f_f82 = fr.fresnel_f82(abs_ci, p.eta3, p.k3)
    m = p.fr_mode[..., None]
    out = jnp.where(m == fr.FR_DIELECTRIC, f_diel,
          jnp.where(m == fr.FR_CONDUCTOR, f_cond,
          jnp.where(m == fr.FR_SCHLICK, f_schl,
          jnp.where(m == fr.FR_F82, f_f82, f_cons))))
    return out


def _dielectric_F0(p, wo):
    """Fresnel at the actual interface orientation for dielectric: uses the
    directed eta (flipped when exiting)."""
    eta_dir = jnp.where((cos_theta(wo) > 0.0)[..., None], p.eta, safe_div(1.0, p.eta))
    return fr.fresnel_dielectric(abs_cos_theta(wo)[..., None], eta_dir)


# ---------------------------------------------------------------------------
# Per-lobe eval
# ---------------------------------------------------------------------------

def _oren_nayar_AB(sigma):
    s2 = sqr(sigma)
    A = 1.0 - (s2 / (2.0 * (s2 + 0.33)))
    B = 0.45 * s2 / (s2 + 0.09)
    return A, B


def _eval_diffuse(p, wo, wi):
    """Diffuse lobe f [..., S] (reflection only, same hemisphere). Variant
    formulas compile only when a scene material uses them (p.feats)."""
    from ..core.math import sin_theta as _sin_theta, cos_phi as _cos_phi, sin_phi as _sin_phi
    abs_ci, abs_co = abs_cos_theta(wi), abs_cos_theta(wo)

    if p.has("oren"):
        A, B = _oren_nayar_AB(p.sigma)
        sin_ti, sin_to = _sin_theta(wi), _sin_theta(wo)
        cos_dphi = _cos_phi(wi) * _cos_phi(wo) + _sin_phi(wi) * _sin_phi(wo)
        max_cos = jnp.maximum(0.0, cos_dphi)
        sin_alpha = jnp.where(abs_ci > abs_co, sin_to, sin_ti)
        tan_beta = jnp.where(abs_ci > abs_co,
                             safe_div(sin_ti, abs_ci), safe_div(sin_to, abs_co))
        on = (A + B * max_cos * sin_alpha * tan_beta)
        f_lambert = p.kd * (InvPi * jnp.where(p.sigma > 0.0, on, 1.0))[..., None]
    else:
        f_lambert = p.kd * InvPi

    f = f_lambert
    if p.has("blend"):
        # substrate diffuse (FresnelBlend, substrate.cpp f_diffuse)
        Rs = p.eta3  # schlick F0 doubles as Rs
        w5 = (1.0 - fr.schlick_weight(0.5 * abs_ci)) * (1.0 - fr.schlick_weight(0.5 * abs_co))
        f_blend = (28.0 / (23.0 * Pi)) * p.kd * (1.0 - Rs) * w5[..., None]
        f = jnp.where((p.diffuse_kind == DIFF_FRESNEL_BLEND)[..., None],
                      f_blend, f)
    if p.has("disney"):
        # disney diffuse + retro-reflection (principled_bsdf.cpp / Burley 2015)
        wh_n = normalize(wo + wi)
        cos_d = dot(wi, wh_n)
        fo = fr.schlick_weight(abs_co)
        fi = fr.schlick_weight(abs_ci)
        f_base = (1.0 - fo / 2.0) * (1.0 - fi / 2.0)
        roughness = jnp.sqrt(jnp.sqrt(jnp.maximum(p.ax * p.ay, 1e-12)))
        rr = 2.0 * roughness * sqr(cos_d)
        f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
        f_disney = p.kd * (InvPi * (f_base + f_retro))[..., None]
        f = jnp.where((p.diffuse_kind == DIFF_DISNEY)[..., None], f_disney, f)

    valid = same_hemisphere(wo, wi)
    return jnp.where(valid[..., None], f, 0.0)


def _pdf_diffuse(p, wo, wi):
    pdf = warp.cosine_hemisphere_pdf(abs_cos_theta(wi))
    return jnp.where(same_hemisphere(wo, wi), pdf, 0.0)


def _eval_spec_reflect(p, wo, wi):
    """Lobe 1: GGX reflection with the material's Fresnel. Returns (f, pdf)."""
    valid = same_hemisphere(wo, wi)
    wh = normalize(wo + wi)
    wh = wh * jnp.sign(cos_theta(wh))[..., None]  # canonical orientation
    F = _eval_fresnel_oriented(p, wo, wh)
    fr_core = mf.brdf_div_fr(wo, wh, wi, p.ax, p.ay)
    f = p.spec_tint * F * fr_core[..., None]
    # substrate uses the Ashikhmin max-denominator form (substrate.cpp f_specular)
    abs_ci, abs_co = abs_cos_theta(wi), abs_cos_theta(wo)
    f_ash_core = safe_div(mf.D_ggx(wh, p.ax, p.ay),
                          4.0 * jnp.abs(dot(wi, wh)) * jnp.maximum(abs_ci, abs_co))
    F_ash = fr.fresnel_schlick(p.eta3, dot(wi, wh))
    f_sub = F_ash * f_ash_core[..., None]
    f = jnp.where((p.diffuse_kind == DIFF_FRESNEL_BLEND)[..., None], f_sub, f)
    pdf = mf.pdf_wi_reflection(mf.pdf_wh_ggx(wo, wh, p.ax, p.ay), wo, wh)
    ok = valid & (pdf > 0.0)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _eval_fresnel_oriented(p, wo, wh):
    """Fresnel at the half-vector angle; dielectric eta directed by wo side."""
    cos_wh = dot(wo, wh)
    out = _eval_fresnel(p, cos_wh)
    # dielectric: flip eta when wo exits the surface
    eta_dir = jnp.where((cos_theta(wo) > 0.0)[..., None], p.eta, safe_div(1.0, p.eta))
    f_diel = fr.fresnel_dielectric(jnp.abs(cos_wh)[..., None], eta_dir)
    return jnp.where((p.fr_mode == fr.FR_DIELECTRIC)[..., None], f_diel, out)


def _eval_spec_transmit(p, wo, wi):
    """Lobe 2: GGX dielectric transmission. Returns (f, pdf).

    Convention (microfacet.h BTDF_div_ft): eta = eta_i/eta_o relative to the
    transport; here we use eta_rel = eta(transmitted)/eta(incident) seen from
    wo: wh = normalize(wo + wi*eta_rel)."""
    trans = jnp.logical_not(same_hemisphere(wo, wi))
    eta_rel = _hemi_eta(p, wo)
    wh = normalize(wo + wi * eta_rel[..., None])
    wh = wh * jnp.sign(cos_theta(wh))[..., None]
    # discard configurations where wo/wi are on the same side of wh
    ok = trans & (dot(wo, wh) * dot(wi, wh) < 0.0)
    F = _dielectric_F_at(p, wo, wh)
    ft = mf.btdf_div_ft(wo, wh, wi, eta_rel, p.ax, p.ay)
    f = p.spec_tint * ((1.0 - F) * ft[..., None])
    pdf_wh = mf.pdf_wh_ggx(wo, wh, p.ax, p.ay)
    pdf = mf.pdf_wi_transmission(pdf_wh, wo, wh, wi, eta_rel)
    ok = ok & (pdf > 0.0) & jnp.isfinite(pdf)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _dielectric_F_at(p, wo, wh):
    eta_dir = jnp.where((cos_theta(wo) > 0.0)[..., None], p.eta, safe_div(1.0, p.eta))
    return fr.fresnel_dielectric(jnp.abs(dot(wo, wh))[..., None], eta_dir)


def _eval_clearcoat(p, wo, wi):
    """Lobe 3: isotropic GGX clearcoat, schlick F0=0.04 scalar."""
    valid = same_hemisphere(wo, wi)
    wh = normalize(wo + wi)
    wh = wh * jnp.sign(cos_theta(wh))[..., None]
    D = mf.D_ggx(wh, p.cc_alpha, p.cc_alpha)
    G = mf.G_ggx(wo, wi, p.cc_alpha, p.cc_alpha)
    F = 0.04 + 0.96 * fr.schlick_weight(dot(wo, wh))
    f_scalar = safe_div(D * G * F, jnp.abs(4.0 * cos_theta(wo) * cos_theta(wi)))
    pdf = mf.pdf_wi_reflection(mf.pdf_wh_ggx(wo, wh, p.cc_alpha, p.cc_alpha), wo, wh)
    ok = valid & (pdf > 0.0)
    f = jnp.broadcast_to(f_scalar[..., None], p.kd.shape)
    return jnp.where(ok[..., None], f, 0.0), jnp.where(ok, pdf, 0.0)


def _sheen_ltc_coeffs(p, wo):
    """Bilinear (a, b, R) fetch from the self-fit LTC sheen table over
    (|cos_theta_o|, alpha). Mirrors SheenLTC::fetch_ltc."""
    T = p.sheen_ltc                      # [32, 32, 3]
    n = T.shape[0]
    alpha = (p.sheen_alpha if p.sheen_alpha is not None
             else jnp.full(wo.shape[:-1], 0.5))

    def axis(v):
        t = jnp.clip(v * n - 0.5, 0.0, n - 1.0)
        i0 = jnp.clip(t.astype(jnp.int32), 0, n - 1)
        i1 = jnp.clip(i0 + 1, 0, n - 1)
        return i0, i1, (t - i0.astype(jnp.float32))[..., None]

    c0, c1, fc = axis(abs_cos_theta(wo))
    a0, a1, fa = axis(jnp.clip(alpha, 1e-3, 1.0))
    v = ((T[c0, a0] * (1 - fa) + T[c0, a1] * fa) * (1 - fc)
         + (T[c1, a0] * (1 - fa) + T[c1, a1] * fa) * fc)
    return v[..., 0], v[..., 1], jnp.clip(v[..., 2], 0.0, 1.0)


def _sheen_azimuth(wo):
    """cos/sin of wo's azimuth: the LTC skew axis (b) lives in the plane
    of incidence, so wi rotates into the frame where wo.y == 0."""
    r = jnp.sqrt(wo[..., 0] ** 2 + wo[..., 1] ** 2)
    ok = r > 1e-8
    return (jnp.where(ok, wo[..., 0] / jnp.maximum(r, 1e-8), 1.0),
            jnp.where(ok, wo[..., 1] / jnp.maximum(r, 1e-8), 0.0))


def _eval_sheen(p, wo, wi):
    """Lobe 4: sheen. LTC lobe when the self-fit table is present
    (SheenLTC::evaluate_local_impl: f = R tint ltc / cos_i, pdf = ltc);
    Burley schlick-weight fallback otherwise."""
    valid = same_hemisphere(wo, wi)
    if p.sheen_ltc is None:
        wh = normalize(wo + wi)
        cos_d = jnp.abs(dot(wi, wh))
        f = p.sheen_tint * fr.schlick_weight(cos_d)[..., None]
        pdf = warp.cosine_hemisphere_pdf(abs_cos_theta(wi))
        return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)
    a, b, R = _sheen_ltc_coeffs(p, wo)
    ca, sa_ = _sheen_azimuth(wo)
    sgn = jnp.sign(cos_theta(wo))
    sgn = jnp.where(sgn == 0.0, 1.0, sgn)
    # rotate wi into the incidence frame, mirror to the upper hemisphere
    x = ca * wi[..., 0] + sa_ * wi[..., 1]
    y = -sa_ * wi[..., 0] + ca * wi[..., 1]
    z = wi[..., 2] * sgn
    # ltc density: cosine pushed through M (eval_ltc: inv_M + jacobian)
    xi = a * x + b * z
    yi = a * y
    l2 = xi * xi + yi * yi + z * z
    ln = jnp.sqrt(jnp.maximum(l2, 1e-12))
    cz = jnp.clip(z / ln, 0.0, 1.0)
    ltc = cz / jnp.pi * (a * a) / jnp.maximum(l2 * ln, 1e-12)
    f = (p.sheen_tint * (R * ltc)[..., None]
         / jnp.maximum(abs_cos_theta(wi), 1e-6)[..., None])
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, ltc, 0.0)


def _sample_sheen_ltc(p, wo, u2):
    """SheenLTC::sample_wi_local_impl: cosine sample pushed through M,
    rotated back out of the incidence frame."""
    a, b, R = _sheen_ltc_coeffs(p, wo)
    ca, sa_ = _sheen_azimuth(wo)
    sgn = jnp.sign(cos_theta(wo))
    sgn = jnp.where(sgn == 0.0, 1.0, sgn)
    v = warp.square_to_cosine_hemisphere(u2)
    # M(v) = ((x - b z)/a, y/a, z)
    x = (v[..., 0] - b * v[..., 2]) / jnp.maximum(a, 1e-6)
    y = v[..., 1] / jnp.maximum(a, 1e-6)
    z = v[..., 2]
    # rotate back by +azimuth, restore hemisphere
    wx = ca * x - sa_ * y
    wy = sa_ * x + ca * y
    return normalize(jnp.stack([wx, wy, z * sgn], -1))


# ---------------------------------------------------------------------------
# Lobe selection weights
# ---------------------------------------------------------------------------

def _mean_s(x):
    return jnp.mean(x, axis=-1)


def _lut_E(p, alpha, mu):
    """Bilinear fetch of the GGX single-scatter albedo E(alpha, mu)."""
    E = p.ems_E
    na, nm = E.shape
    # alpha grid is linspace(0,1,na)^2 (gen_energy_lut) -> invert
    fa = jnp.sqrt(jnp.clip(alpha, 0.0, 1.0)) * (na - 1)
    fm = jnp.clip(mu, 0.0, 1.0) * (nm - 1)
    ia = jnp.clip(fa.astype(jnp.int32), 0, na - 2)
    im = jnp.clip(fm.astype(jnp.int32), 0, nm - 2)
    da = fa - ia
    dm = fm - im
    e = ((1 - da) * ((1 - dm) * E[ia, im] + dm * E[ia, im + 1])
         + da * ((1 - dm) * E[ia + 1, im] + dm * E[ia + 1, im + 1]))
    return jnp.clip(e, 1e-3, 1.0)


def _eval_ems(p, wo, wi):
    """Kulla-Conty multiple-scattering reflection lobe for rough
    conductors/mirrors (MirrorLobe::compensate): 
    f_ms = F_ms (1-E(mu_o))(1-E(mu_i)) / (pi (1-E_avg))."""
    alpha = jnp.sqrt(p.ax * p.ay)
    mu_o = abs_cos_theta(wo)
    mu_i = abs_cos_theta(wi)
    Eo = _lut_E(p, alpha, mu_o)
    Ei = _lut_E(p, alpha, mu_i)
    na = p.ems_Eavg.shape[0]
    ia = jnp.clip((jnp.sqrt(jnp.clip(alpha, 0.0, 1.0)) * (na - 1)).astype(jnp.int32),
                  0, na - 1)
    E_avg = jnp.clip(p.ems_Eavg[ia], 1e-3, 1.0 - 1e-3)
    # average Fresnel: constant -> 1; conductor/F82/schlick -> (20 F0 + 1)/21
    F0 = _eval_fresnel(p, jnp.ones_like(mu_o))
    F_avg = jnp.clip(_mean_s((20.0 * F0 + 1.0) / 21.0), 0.0, 1.0)
    F_avg = jnp.where(p.fr_mode == fr.FR_CONSTANT, 1.0, F_avg)
    F_ms = safe_div(F_avg * F_avg * E_avg,
                    1.0 - F_avg * (1.0 - E_avg))
    f_scalar = F_ms * safe_div((1.0 - Eo) * (1.0 - Ei), Pi * (1.0 - E_avg))
    # only conductor-family reflection lobes are compensated
    metalish = ((p.fr_mode == fr.FR_CONSTANT) | (p.fr_mode == fr.FR_CONDUCTOR)
                | (p.fr_mode == fr.FR_F82))
    ok = same_hemisphere(wo, wi) & metalish & (alpha > 0.02)
    f = p.spec_tint * jnp.where(ok, f_scalar, 0.0)[..., None]
    return f


def _lobe_weights(p, wo):
    """Sampling weights for the 5 lobes given wo. Deterministic function of
    (params, wo) so eval and sample agree exactly -> consistent MIS pdfs."""
    F_diel = _dielectric_F0(p, wo)          # [..., S]
    mean_F = _mean_s(_eval_fresnel(p, wo[..., 2]))

    zero = jnp.zeros(p.kd.shape[:-1])
    w_diff = p.diffuse_weight * _mean_s(p.kd) if p.has("diff") else zero
    is_diel = p.fr_mode == fr.FR_DIELECTRIC
    spec_F = jnp.where(is_diel, _mean_s(F_diel), mean_F)
    w_spec = (p.spec_weight * _mean_s(p.spec_tint) * jnp.maximum(spec_F, 0.02)
              if p.has("spec") else zero)
    w_trans = (p.trans_weight * _mean_s(p.spec_tint)
               * jnp.maximum(1.0 - _mean_s(F_diel), 0.0)
               if p.has("trans") else zero)
    w_cc = p.cc_weight * 0.25 if p.has("cc") else zero
    if p.has("sheen"):
        sheen_scale = 0.08
        if p.sheen_ltc is not None:
            _, _, R_sh = _sheen_ltc_coeffs(p, wo)
            sheen_scale = jnp.maximum(R_sh, 0.02)
        w_sheen = p.sheen_weight * _mean_s(p.sheen_tint) * sheen_scale
    else:
        w_sheen = zero
    w = jnp.stack([w_diff, w_spec, w_trans, w_cc, w_sheen], axis=-1)
    total = jnp.sum(w, axis=-1, keepdims=True)
    return safe_div(w, total), total[..., 0]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def evaluate(p, wo, wi):
    """Full BSDF eval at local (wo, wi): ScatterEval(f [..., S], pdf).
    Unused lobe families (p.feats) compile to nothing. Mixture rows
    (LobeSet::create_mix/add) combine two full rows: f = wa f_a + wb f_b,
    pdf = pa pdf_a + (1-pa) pdf_b with pa = wa/(wa+wb)."""
    if p.mix_b is not None:
        ev_a = _evaluate_single(p, wo, wi)
        ev_b = _evaluate_single(p.mix_b, wo, wi)
        wa, wb = p.mix_wa, p.mix_wb
        pa = safe_div(wa, wa + wb)
        f = wa[..., None] * ev_a.f + wb[..., None] * ev_b.f
        pdf = pa * ev_a.pdf + (1.0 - pa) * ev_b.pdf
        return ScatterEval(f=f, pdf=pdf)
    return _evaluate_single(p, wo, wi)


def _evaluate_single(p, wo, wi):
    probs, total = _lobe_weights(p, wo)
    f = jnp.zeros_like(p.kd)
    pdf = jnp.zeros(p.kd.shape[:-1])
    if p.has("diff"):
        f = f + _eval_diffuse(p, wo, wi) * p.diffuse_weight[..., None]
        pdf = pdf + probs[..., 0] * _pdf_diffuse(p, wo, wi)
    if p.has("spec"):
        f_s, pdf_s = _eval_spec_reflect(p, wo, wi)
        f = f + f_s * p.spec_weight[..., None]
        pdf = pdf + probs[..., 1] * pdf_s
    if p.has("trans"):
        f_t, pdf_t = _eval_spec_transmit(p, wo, wi)
        f = f + f_t * p.trans_weight[..., None]
        pdf = pdf + probs[..., 2] * pdf_t
    if p.has("cc"):
        f_c, pdf_c = _eval_clearcoat(p, wo, wi)
        f = f + f_c * p.cc_weight[..., None]
        pdf = pdf + probs[..., 3] * pdf_c
    if p.has("sheen"):
        f_sh, pdf_sh = _eval_sheen(p, wo, wi)
        f = f + f_sh * p.sheen_weight[..., None]
        pdf = pdf + probs[..., 4] * pdf_sh
    if p.has("ems") and p.ems_E is not None:
        f = f + _eval_ems(p, wo, wi) * p.spec_weight[..., None]

    valid = (total > 0.0) & (abs_cos_theta(wo) > 1e-7)
    f = jnp.where(valid[..., None], f, 0.0)
    pdf = jnp.where(valid, pdf, 0.0)
    return ScatterEval(f=f, pdf=pdf)


def albedo(p, wo):
    """Approximate reflectance for AOVs / RR (reference Lobe::albedo)."""
    if p.mix_b is not None:
        return jnp.clip(p.mix_wa[..., None] * _albedo_single(p, wo)
                        + p.mix_wb[..., None] * _albedo_single(p.mix_b, wo),
                        0.0, 1.0)
    return _albedo_single(p, wo)


def _albedo_single(p, wo):
    F = _eval_fresnel(p, abs_cos_theta(wo))
    a = (p.kd * p.diffuse_weight[..., None]
         + p.spec_tint * (p.spec_weight * _mean_s(F))[..., None]
         + p.spec_tint * p.trans_weight[..., None]
         + p.sheen_tint * (0.08 * p.sheen_weight)[..., None])
    return jnp.clip(a, 0.0, 1.0)


def sample(p, wo, state):
    """Sample the uber-BSDF. Returns (state, BSDFSample). Mixture rows pick a
    row by normalized weight, sample it, then MIS-evaluate the mixture
    (LobeSet::sample_wi_local_impl one-sample estimator)."""
    if p.mix_b is not None:
        pa = safe_div(p.mix_wa, p.mix_wa + p.mix_wb)
        state, u_row = rng.next_1d(state)
        pick_a = u_row < pa
        state, sa = _sample_single(p, wo, state)
        state, sb = _sample_single(p.mix_b, wo, state)
        wi = jnp.where(pick_a[..., None], sa.wi, sb.wi)
        ev = evaluate(p, wo, wi)
        eta_scale = jnp.where(pick_a, sa.eta_scale, sb.eta_scale)
        valid = jnp.where(pick_a, sa.valid, sb.valid) & (ev.pdf > 0.0)
        return state, BSDFSample(wi=wi, ev=ev, eta_scale=eta_scale,
                                 valid=valid)
    return _sample_single(p, wo, state)


def _sample_single(p, wo, state):
    probs, total = _lobe_weights(p, wo)
    state, u_sel = rng.next_1d(state)
    state, u2 = rng.next_2d(state)

    cdf = jnp.cumsum(probs, axis=-1)
    lobe = jnp.sum((u_sel[..., None] >= cdf).astype(jnp.int32), axis=-1)
    lobe = jnp.clip(lobe, 0, 4)

    sgn = jnp.sign(cos_theta(wo))[..., None]
    sgn = jnp.where(sgn == 0.0, 1.0, sgn)

    # lobe 0/4: cosine hemisphere on wo side
    wi = warp.square_to_cosine_hemisphere(u2) * sgn
    if p.has("sheen") and p.sheen_ltc is not None:
        # lobe 4: LTC sheen draws through the M transform so its sampling
        # density equals _eval_sheen's pdf (consistent one-sample MIS)
        wi_sh = _sample_sheen_ltc(p, wo, u2)
        wi = jnp.where((lobe == 4)[..., None], wi_sh, wi)

    if p.has("spec") or p.has("trans"):
        # lobe 1: reflect about sampled wh
        wh = mf.sample_wh_ggx(wo, u2, p.ax, p.ay)
        wi_spec = reflect(wo, wh)
        wi = jnp.where((lobe == 1)[..., None], wi_spec, wi)
    if p.has("trans"):
        # lobe 2: refract about sampled wh
        eta_rel = _hemi_eta(p, wo)
        wh_t = wh * jnp.sign(dot(wh, wo))[..., None]  # same side as wo
        ref_ok, wi_trans = refract(wo, wh_t, eta_rel)
        # total internal reflection -> fall back to reflection
        wi_trans = jnp.where(ref_ok[..., None], wi_trans, reflect(wo, wh_t))
        wi = jnp.where((lobe == 2)[..., None], wi_trans, wi)
    else:
        ref_ok = jnp.ones(wo.shape[:-1], bool)
    if p.has("cc"):
        # lobe 3: clearcoat wh
        wh_c = mf.sample_wh_ggx(wo, u2, p.cc_alpha, p.cc_alpha)
        wi_cc = reflect(wo, wh_c)
        wi = jnp.where((lobe == 3)[..., None], wi_cc, wi)
    wi = normalize(wi)

    ev = _evaluate_single(p, wo, wi)
    valid = (total > 0.0) & (ev.pdf > 0.0) & jnp.all(jnp.isfinite(wi), axis=-1)
    refracted = (lobe == 2) & jnp.logical_not(same_hemisphere(wo, wi))
    eta_scale = jnp.where(refracted, sqr(_hemi_eta(p, wo)), 1.0)
    return state, BSDFSample(wi=wi, ev=ev, eta_scale=eta_scale, valid=valid)
