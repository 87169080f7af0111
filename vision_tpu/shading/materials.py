"""Material compilation: JSON material descs -> flat material table rows.

Replaces the reference material plugin constructors
(`/root/reference/src/render_core/material/*.cpp`): each material type maps to
parameters of the uber-BSDF (see bsdf.py). The table is SoA over material id;
at shade time rows are gathered by per-lane mat_id and textured slots are
resolved against the texture atlas — the TPU equivalent of
`Polymorphic<Material>.dispatch`.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..scene.desc import ParameterSet, parse_slot
from ..spectra import spd
from . import bsdf
from . import fresnel as frs
from .microfacet import calculate_alpha, roughness_to_alpha


@struct.dataclass
class MaterialTable:
    """[M, ...] rows of uber-BSDF parameters + texture slot ids (-1 = const)."""
    kd: jnp.ndarray          # [M, 3]
    kd_tex: jnp.ndarray      # [M]
    sigma: jnp.ndarray
    diffuse_kind: jnp.ndarray
    diffuse_weight: jnp.ndarray
    spec_tint: jnp.ndarray   # [M, 3]
    spec_tex: jnp.ndarray
    ax: jnp.ndarray
    ay: jnp.ndarray
    rough_tex: jnp.ndarray   # scalar roughness texture (remapped at runtime)
    rough_remap: jnp.ndarray
    anisotropic: jnp.ndarray
    fr_mode: jnp.ndarray
    eta: jnp.ndarray         # [M] scalar dielectric ior (RGB mode)
    eta3: jnp.ndarray        # [M, 3]
    k3: jnp.ndarray          # [M, 3]
    spec_weight: jnp.ndarray
    trans_weight: jnp.ndarray
    cc_weight: jnp.ndarray
    cc_alpha: jnp.ndarray
    sheen_weight: jnp.ndarray
    sheen_tint: jnp.ndarray  # [M, 3]
    flatness: jnp.ndarray
    metallic: jnp.ndarray
    dispersive_id: jnp.ndarray  # index into glass_coeffs rows (-1 none)
    metal_id: jnp.ndarray       # index into metal SPD rows (-1 none)
    # LobeSet mixtures (lobe.h:277-330): second row id + weights
    mix_b: jnp.ndarray          # [M] int32 (-1 = plain material)
    mix_wa: jnp.ndarray         # [M]
    mix_wb: jnp.ndarray         # [M]
    frac_tex: jnp.ndarray       # [M] textured mix fraction (-1 const)
    # tangent-space normal map (material.h bump slot; shadernode
    # converter.cpp normal_map evaluated at shade time, not baked)
    normal_tex: jnp.ndarray     # [M] atlas tex id (-1 none)
    bump_scale: jnp.ndarray     # [M] normal_map strength
    # spectral registries (shared rows, gathered in hero mode)
    glass_coeffs: jnp.ndarray   # [G, 6] Sellmeier B1 C1 B2 C2 B3 C3
    metal_eta_spd: jnp.ndarray  # [Mt, 95]
    metal_k_spd: jnp.ndarray    # [Mt, 95]
    # static lobe-usage flags: which lobe families any material uses
    feats: tuple = struct.field(
        pytree_node=False,
        default=("diff", "spec", "trans", "cc", "sheen", "oren", "blend",
                 "disney"))
    # GGX energy LUT (gen_energy_lut.py)
    ems_E: jnp.ndarray = None
    ems_Eavg: jnp.ndarray = None
    # shade-time shader-graph nodes (render_core/shadernode/converter.cpp):
    # fresnel-driven color mix (FresnelNode) and uv TRS (VectorMapping)
    fres_ior: jnp.ndarray = None   # [M] mix ior (0 = slot not fresnel-driven)
    fres_a: jnp.ndarray = None     # [M, 3] color at F=0
    fres_b: jnp.ndarray = None     # [M, 3] color at F=1
    uv_xform: jnp.ndarray = None   # [M, 6] uv' = [a b;c d]@uv + (tx,ty)
    sheen_rough: jnp.ndarray = None  # [M] sheen LTC roughness
    sheen_ltc: jnp.ndarray = None    # [32, 32, 3] self-fit LTC table


def _default_row():
    return dict(
        kd=[0.0, 0.0, 0.0], kd_tex=-1, sigma=0.0, diffuse_kind=bsdf.DIFF_LAMBERT,
        diffuse_weight=0.0,
        spec_tint=[1.0, 1.0, 1.0], spec_tex=-1,
        ax=1e-4, ay=1e-4, rough_tex=-1, rough_remap=1, anisotropic=0.0,
        fr_mode=frs.FR_DIELECTRIC, eta=1.5,
        eta3=[1.0, 1.0, 1.0], k3=[0.0, 0.0, 0.0],
        spec_weight=0.0, trans_weight=0.0,
        cc_weight=0.0, cc_alpha=0.01,
        sheen_weight=0.0, sheen_tint=[0.0, 0.0, 0.0], sheen_rough=0.5,
        flatness=0.0, metallic=0.0,
        dispersive_id=-1, metal_id=-1,
        mix_b=-1, mix_wa=1.0, mix_wb=0.0, frac_tex=-1,
        normal_tex=-1, bump_scale=1.0,
        fres_ior=0.0, fres_a=[0.0, 0.0, 0.0], fres_b=[1.0, 1.0, 1.0],
        uv_xform=[1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    )


class MaterialCompiler:
    """Accumulates material rows; dedups by name."""

    def __init__(self, atlas_builder, scene_dir="."):
        self.rows = []
        self.by_name = {}
        self.atlas = atlas_builder
        self.scene_dir = scene_dir
        # material id -> (sigma_a, sigma_s, g) interior-medium request
        # (subsurface materials; the scene attaches it as inside_medium)
        self.sss = {}

    # ---- slot helpers ----

    def _slot_rgb(self, pset, key, default):
        """Resolve a color slot -> (rgb const [3], tex_id). Calculation node
        trees (multiply/add/lerp/... over images & numbers) fold/bake on the
        host via shader_graph.fold_slot — see shader_graph.py. Context-
        dependent nodes (fresnel mix, vector_mapping uv TRS) are detected
        here and staged for shade-time evaluation on the row being
        compiled."""
        if key not in pset:
            return list(default), -1
        from . import shader_graph as sg
        raw = pset.raw(key)
        dyn = sg.detect_fresnel_mix(raw, self.scene_dir)
        if dyn is not None:
            ior, A, B = dyn
            self._pending_fresnel = (ior, A, B)
            # static stand-in: the normal-incidence..grazing average
            return [0.5 * (a + b) for a, b in zip(A, B)], -1
        uvm = sg.detect_uv_mapping(raw)
        if uvm is not None:
            affine, inner = uvm
            self._pending_uvmap = affine
            raw = inner
        return sg.resolve_rgb(raw, self.atlas, self.scene_dir, default)

    def _slot_scalar(self, pset, key, default):
        if key not in pset:
            return float(default), -1
        from .shader_graph import resolve_scalar
        return resolve_scalar(pset.raw(key), self.atlas, self.scene_dir,
                              default)

    def _slot_rough2(self, pset, key, default):
        """Roughness may be scalar or [rx, ry] (glass.cpp)."""
        v = pset.raw(key, default)
        kind, payload, _ = parse_slot(v)
        if kind == "const":
            if len(payload) >= 2:
                return float(payload[0]), float(payload[1]), -1
            return float(payload[0]), float(payload[0]), -1
        if kind == "image":
            import os
            try:
                tex = self.atlas.add_image(
                    os.path.join(self.scene_dir, payload.get("fn")), "linear")
            except Exception:
                return float(default), float(default), -1
            return float(default), float(default), tex
        return float(default), float(default), -1

    # ---- compile entry ----

    def _row_with_dynamic(self, desc):
        """_compile_row + attach any shade-time nodes its slots staged."""
        saved = (getattr(self, "_pending_fresnel", None),
                 getattr(self, "_pending_uvmap", None))
        self._pending_fresnel = None
        self._pending_uvmap = None
        row = self._compile_row(desc)
        if self._pending_fresnel is not None:
            ior, A, B = self._pending_fresnel
            row["fres_ior"] = float(max(ior, 1.0001))
            row["fres_a"] = list(A)
            row["fres_b"] = list(B)
        if self._pending_uvmap is not None:
            row["uv_xform"] = list(self._pending_uvmap)
        self._pending_fresnel, self._pending_uvmap = saved
        return row

    def compile(self, desc):
        """Compile one material desc; returns material id."""
        name = desc.get("name")
        if name and name in self.by_name:
            return self.by_name[name]
        row = self._row_with_dynamic(desc)
        mid = len(self.rows)
        sss = row.pop("_sss", None)
        if sss is not None:
            self.sss[mid] = sss
        self.rows.append(row)
        if name:
            self.by_name[name] = mid
        return mid

    def _append_child(self, desc):
        """Compile a sub-material of a mixture into its own (anonymous) row."""
        row = self._row_with_dynamic(desc)
        row.pop("_sss", None)
        self.rows.append(row)
        return len(self.rows) - 1

    def get(self, name):
        return self.by_name.get(name, -1)

    def _alpha_from(self, pset, lo=0.0001):
        rx, ry, rtex = self._slot_rough2(pset, "roughness", 0.5)
        aniso = self._slot_scalar(pset, "anisotropic", 0.0)[0]
        aniso = float(np.clip(aniso, -0.9, 0.9))
        remap = pset.as_bool("remapping_roughness", True)
        rx = float(np.clip(rx, lo, 1.0))
        ry = float(np.clip(ry, lo, 1.0))
        if remap:
            ax_s, ay_s = roughness_to_alpha(rx), roughness_to_alpha(ry)
        else:
            ax_s, ay_s = rx, ry
        if abs(aniso) > 1e-4 and rx == ry:
            ax_s, ay_s = calculate_alpha(np.float32(ax_s), np.float32(aniso))
            ax_s, ay_s = float(ax_s), float(ay_s)
        return max(ax_s, 1e-6), max(ay_s, 1e-6), rtex, (1 if remap else 0), aniso

    def _compile_row(self, desc):
        mtype = desc.get("type", "diffuse")
        p = ParameterSet(desc.get("param", {}))
        row = _default_row()
        fn = getattr(self, f"_mat_{mtype}", None)
        if fn is None:
            # unknown material -> grey diffuse
            row.update(diffuse_weight=1.0, kd=[0.5, 0.5, 0.5])
            return row
        fn(row, p)
        # base-material bump slot (material.h): tangent-space normal map,
        # evaluated at shade time (pt.compute_interaction)
        if p.raw("bump", None) is not None:
            _, btex = self._slot_rgb(p, "bump", [0.5, 0.5, 1.0])
            row.update(normal_tex=btex,
                       bump_scale=p.as_float("bump_scale", 1.0))
        return row

    # ---- per-type compilers (cite: render_core/material/<type>.cpp) ----

    def _mat_diffuse(self, row, p):
        kd, tex = self._slot_rgb(p, "color", [0.5, 0.5, 0.5])
        row.update(kd=kd, kd_tex=tex, diffuse_weight=1.0,
                   sigma=self._slot_scalar(p, "sigma", 0.0)[0])

    def _mat_mirror(self, row, p):
        tint, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        row.update(spec_tint=tint, spec_tex=tex, ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso,
                   fr_mode=frs.FR_CONSTANT, spec_weight=1.0)

    def _mat_metal(self, row, p):
        name = p.as_str("material_name", "Ag")
        eta, k = spd.metal_ior_rgb(name)
        if name not in spd.METAL_NAMES:
            name = "Ag"
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        row.update(fr_mode=frs.FR_CONDUCTOR, eta3=list(map(float, eta)),
                   k3=list(map(float, k)), ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso, spec_weight=1.0,
                   metal_id=spd.METAL_NAMES.index(name))

    def _mat_metallic(self, row, p):
        color, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        edge, _ = self._slot_rgb(p, "edge_tint", [1.0, 1.0, 1.0])
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.01)
        f0 = np.asarray(color, np.float32)
        b = frs.f82_b_from_edge_tint(f0, np.asarray(edge, np.float32))
        row.update(fr_mode=frs.FR_F82, eta3=list(map(float, f0)),
                   k3=list(map(float, np.asarray(b))), spec_tex=tex,
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0)

    def _mat_glass(self, row, p):
        tint, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        name = p.as_str("material_name", "")
        if name:
            eta = spd.glass_ior_scalar(name)
            disp = spd.GLASS_NAMES.index(name if name in spd.GLASS_NAMES else "BK7")
        else:
            eta = self._slot_scalar(p, "ior", 1.5)[0]
            disp = -1
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.01)
        row.update(spec_tint=tint, spec_tex=tex, fr_mode=frs.FR_DIELECTRIC,
                   eta=float(eta), ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso,
                   spec_weight=1.0, trans_weight=1.0, dispersive_id=disp)

    def _mat_substrate(self, row, p):
        kd, kdtex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        rs, _ = self._slot_rgb(p, "spec", [0.05, 0.05, 0.05])
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        # substrate.cpp double-remaps alpha (alpha = (roughness^2)^2)
        if remap:
            ax, ay = ax * ax, ay * ay
        ax, ay = float(np.clip(ax, 1e-4, 1.0)), float(np.clip(ay, 1e-4, 1.0))
        row.update(kd=kd, kd_tex=kdtex, diffuse_kind=bsdf.DIFF_FRESNEL_BLEND,
                   diffuse_weight=1.0, eta3=rs, fr_mode=frs.FR_SCHLICK,
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0, eta=1.5)

    def _mat_plastic(self, row, p):
        kd, kdtex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        rs, _ = self._slot_rgb(p, "spec", [0.05, 0.05, 0.05])
        ior = self._slot_scalar(p, "ior", 1.3)[0]
        ax, ay, rtex, remap, aniso = self._alpha_from(p)
        if remap:  # plastic.cpp also double-remaps
            ax, ay = ax * ax, ay * ay
        ax, ay = float(np.clip(ax, 1e-4, 1.0)), float(np.clip(ay, 1e-4, 1.0))
        f0 = float(frs.schlick_F0_from_ior(np.float32(ior)))
        row.update(kd=kd, kd_tex=kdtex, diffuse_weight=1.0,
                   fr_mode=frs.FR_SCHLICK,
                   eta3=[f0 * rs[0], f0 * rs[1], f0 * rs[2]],
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0, eta=float(ior))

    def _mat_principled_bsdf(self, row, p):
        """Disney-style uber material (principled_bsdf.cpp)."""
        kd, kdtex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        ior = self._slot_scalar(p, "ior", 1.5)[0]
        metallic = self._slot_scalar(p, "metallic", 0.0)[0]
        spec_trans = self._slot_scalar(p, "spec_trans", 0.0)[0]
        sheen = self._slot_scalar(p, "sheen",
                                  p.as_float("sheen_weight", 0.0))[0]
        sheen_tint = self._slot_scalar(p, "sheen_tint", 0.0)[0]
        sheen_rough = self._slot_scalar(p, "sheen_roughness", 0.5)[0]
        cc = self._slot_scalar(p, "clearcoat", 0.0)[0]
        cc_alpha = self._slot_scalar(p, "clearcoat_alpha", 0.1)[0]
        flatness = self._slot_scalar(p, "flatness", 0.0)[0]
        spec_tint_amt = self._slot_scalar(p, "spec_tint", 0.0)[0]
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.001)

        lum = 0.212671 * kd[0] + 0.715160 * kd[1] + 0.072169 * kd[2]
        ctint = [c / lum if lum > 0 else 1.0 for c in kd]
        f0d = float(frs.schlick_F0_from_ior(np.float32(ior)))
        f0 = [f0d * ((1 - spec_tint_amt) + spec_tint_amt * c) for c in ctint]
        f0 = [(1 - metallic) * f + metallic * c for f, c in zip(f0, kd)]
        stint = [(1 - sheen_tint) + sheen_tint * c for c in ctint]

        diff_w = (1.0 - metallic) * (1.0 - spec_trans)
        row.update(kd=kd, kd_tex=kdtex, diffuse_kind=bsdf.DIFF_DISNEY,
                   diffuse_weight=diff_w,
                   fr_mode=frs.FR_SCHLICK, eta3=f0, eta=float(ior),
                   ax=ax, ay=ay, rough_tex=rtex, rough_remap=remap,
                   anisotropic=aniso, spec_weight=1.0,
                   trans_weight=(1.0 - metallic) * spec_trans,
                   spec_tint=kd if spec_trans > 0 else [1.0, 1.0, 1.0],
                   cc_weight=cc, cc_alpha=max(float(cc_alpha), 1e-3),
                   sheen_weight=sheen * (1.0 - metallic),
                   sheen_tint=stint, sheen_rough=float(np.clip(
                       sheen_rough, 1.0 / 32, 1.0)),
                   flatness=flatness, metallic=metallic)

    def _mat_subsurface(self, row, p):
        """Subsurface = rough dielectric interface + homogeneous interior
        medium built from sigma_a/sigma_s (subsurface.cpp slots; the
        reference's own sss path wires a medium the same way —
        res/render_scene/cbox/vision_sss.json). The scene attaches the
        medium as the instance's inside_medium."""
        tint, tex = self._slot_rgb(p, "color", [1.0, 1.0, 1.0])
        ior = self._slot_scalar(p, "ior", 1.5)[0]
        ax, ay, rtex, remap, aniso = self._alpha_from(p, lo=0.01)
        row.update(spec_tint=tint, spec_tex=tex, fr_mode=frs.FR_DIELECTRIC,
                   eta=float(ior), ax=ax, ay=ay, rough_tex=rtex,
                   rough_remap=remap, anisotropic=aniso,
                   spec_weight=1.0, trans_weight=1.0)
        sigma_a = p.as_float3("sigma_a", (0.0011, 0.0024, 0.014))
        sigma_s = p.as_float3("sigma_s", (2.55, 3.21, 3.77))
        scale = p.as_float("sigma_scale", 1.0)
        row["_sss"] = dict(sigma_a=[c * scale for c in sigma_a],
                           sigma_s=[c * scale for c in sigma_s],
                           g=p.as_float("g", 0.0),
                           medium_name=p.as_str("medium_name", ""))

    def _mat_emission(self, row, p):
        row.update(diffuse_weight=0.0)

    def _mat_black_body(self, row, p):
        row.update(diffuse_weight=0.0)

    def _mix_parent(self, row, id0, id1, wa, wb, frac_tex=-1):
        """Make `row` a true LobeSet mixture (lobe.h:277-330): the parent row
        carries mat0's full parameters; mix_b points at mat1's row; eval/
        sample combine both rows with (wa, wb). One nesting level (the
        reference flattens its tree; deeper nests collapse to their A side)."""
        r0, r1 = self.rows[id0], self.rows[id1]
        if r0["mix_b"] >= 0 or r1["mix_b"] >= 0:
            import warnings
            warnings.warn("nested material mixtures flatten to one level")
        for k, v in r0.items():
            row[k] = v
        row.update(mix_b=id1, mix_wa=float(wa), mix_wb=float(wb),
                   frac_tex=frac_tex)

    def _mat_mix(self, row, p):
        fkey = "frac" if "frac" in p else "scale"
        frac, ftex = self._slot_scalar(p, fkey, 0.5)
        id0 = self._append_child(p.raw("mat0", {}))
        id1 = self._append_child(p.raw("mat1", {}))
        # LobeSet::create_mix(frac, m0, m1): m0 weighted by frac
        self._mix_parent(row, id0, id1, frac, 1.0 - frac, ftex)

    def _mat_add(self, row, p):
        id0 = self._append_child(p.raw("mat0", {}))
        id1 = self._append_child(p.raw("mat1", {}))
        # LobeSet::create_add: both at full weight (sampling normalized)
        self._mix_parent(row, id0, id1, 1.0, 1.0)

    def _mat_multi_layered(self, row, p):
        # reference multi_layered.cpp is slots-only (no lobe creation
        # upstream); treat bottom+top as an additive lobe set
        id0 = self._append_child(p.raw("mat0", p.raw("bottom", {})))
        id1 = self._append_child(p.raw("mat1", p.raw("top", {})))
        self._mix_parent(row, id0, id1, 1.0, 1.0)

    def build(self):
        if not self.rows:
            self.rows.append(_default_row())
        keys = self.rows[0].keys()
        cols = {k: [r[k] for r in self.rows] for k in keys}
        int_keys = {"kd_tex", "spec_tex", "rough_tex", "rough_remap",
                    "diffuse_kind", "fr_mode", "dispersive_id", "metal_id",
                    "mix_b", "frac_tex", "normal_tex"}
        arrs = {}
        for k, v in cols.items():
            dt = jnp.int32 if k in int_keys else jnp.float32
            arrs[k] = jnp.asarray(np.asarray(v), dt)
        arrs["glass_coeffs"] = jnp.asarray(
            [spd._SELLMEIER[n] for n in spd.GLASS_NAMES], jnp.float32)
        eta_rows, k_rows = [], []
        for n in spd.METAL_NAMES:
            e, kk = spd.metal_complex_ior(n)
            eta_rows.append(e)
            k_rows.append(kk)
        arrs["metal_eta_spd"] = jnp.asarray(np.stack(eta_rows))
        arrs["metal_k_spd"] = jnp.asarray(np.stack(k_rows))
        import os
        feats = []
        rows = self.rows
        if any(r["diffuse_weight"] > 0 for r in rows):
            feats.append("diff")
        if any(r["spec_weight"] > 0 for r in rows):
            feats.append("spec")
        if any(r["trans_weight"] > 0 for r in rows):
            feats.append("trans")
        if any(r["cc_weight"] > 0 for r in rows):
            feats.append("cc")
        if any(r["sheen_weight"] > 0 for r in rows):
            feats.append("sheen")
            ltc_path = os.path.join(os.path.dirname(__file__), "..",
                                    "data", "sheen_ltc.npz")
            if os.path.exists(ltc_path):
                arrs["sheen_ltc"] = jnp.asarray(
                    np.load(ltc_path)["table"])
        if any(r["sigma"] > 0 for r in rows):
            feats.append("oren")
        if any(r["diffuse_kind"] == bsdf.DIFF_FRESNEL_BLEND for r in rows):
            feats.append("blend")
        if any(r["diffuse_kind"] == bsdf.DIFF_DISNEY for r in rows):
            feats.append("disney")
        if any(r["mix_b"] >= 0 for r in rows):
            feats.append("mix2")
        if any(r["normal_tex"] >= 0 for r in rows):
            feats.append("nmap")  # shade-time normal mapping active
        if any(r["fres_ior"] > 0 for r in rows):
            feats.append("fresmix")  # shade-time fresnel-driven color
        if any(r["uv_xform"] != [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
               for r in rows):
            feats.append("uvmap")   # shade-time vector_mapping uv TRS
        # rough conductor/mirror -> enable the multiple-scattering lobe
        lut_path = os.path.join(os.path.dirname(__file__), "..", "data",
                                "ggx_energy.npz")
        metalish = {frs.FR_CONSTANT, frs.FR_CONDUCTOR, frs.FR_F82}
        if os.path.exists(lut_path) and any(
                r["spec_weight"] > 0 and r["fr_mode"] in metalish
                and max(r["ax"], r["ay"]) > 0.02 for r in rows):
            feats.append("ems")
            lut = np.load(lut_path)
            arrs["ems_E"] = jnp.asarray(lut["E"])
            arrs["ems_Eavg"] = jnp.asarray(lut["E_avg"])
        arrs["feats"] = tuple(feats)
        return MaterialTable(**arrs)


def _sellmeier_eta(coeffs, lam_nm):
    """coeffs [..., 6], lam [..., S] (nm) -> eta [..., S] (glass.cpp IORCurve)."""
    l2 = (lam_nm / 1000.0) ** 2
    b1, c1 = coeffs[..., 0:1], coeffs[..., 1:2]
    b2, c2 = coeffs[..., 2:3], coeffs[..., 3:4]
    b3, c3 = coeffs[..., 4:5], coeffs[..., 5:6]
    f = b1 * l2 / (l2 - c1) + b2 * l2 / (l2 - c2) + b3 * l2 / (l2 - c3)
    return jnp.sqrt(jnp.maximum(f + 1.0, 1.0))


def gather_params(table, atlas, mat_id, uv, spectrum=None, swl=None,
                  cos_wo=None):
    """Gather per-lane LobeParams from the table + resolve textured slots.
    mat_id [...] int32 (clamped; invalid lanes get row 0 with zero weights).
    cos_wo: |n.wo| per lane for shade-time fresnel-driven slots
    (converter.cpp FresnelNode) — None falls back to the baked average.

    With a hero SpectrumModel, colors decode to spectra at swl.lam, conductor
    eta/k gather from metal SPD rows, and dispersive glass evaluates the
    Sellmeier curve per wavelength. LobeSet mixture rows (mix/add/
    multi_layered) gather their second row into params.mix_b with per-lane
    weights. Returns (LobeParams, dispersive_mask)."""
    from ..spectra.spectrum import KIND_HERO
    valid = mat_id >= 0
    mid = jnp.clip(mat_id, 0, table.kd.shape[0] - 1)
    hero = spectrum is not None and spectrum.kind == KIND_HERO
    feats = getattr(table, "feats",
                    ("diff", "spec", "trans", "cc", "sheen", "oren",
                     "blend", "disney"))
    textured = getattr(atlas, "has_textures", True)
    wvalid = valid.astype(jnp.float32)

    def decode_alb(rgb):
        if hero:
            return spectrum.decode_albedo(rgb, swl)
        return rgb

    def _one(mid):
        """LobeParams + dispersive mask for one row-id array. All per-row
        column reads are batched into ONE fused fetch (core/gather.py)
        instead of 25 separate [R]-gathers."""
        cols = [table.kd, table.kd_tex, table.spec_tint, table.spec_tex,
                table.ax, table.ay, table.rough_tex, table.rough_remap,
                table.dispersive_id, table.eta, table.eta3, table.k3,
                table.sigma, table.diffuse_kind, table.diffuse_weight,
                table.fr_mode, table.spec_weight, table.trans_weight,
                table.cc_weight, table.cc_alpha, table.sheen_weight,
                table.sheen_tint, table.flatness, table.metallic,
                table.metal_id, table.sheen_rough]
        if "uvmap" in feats:
            cols.append(table.uv_xform)
        if "fresmix" in feats and cos_wo is not None:
            cols += [table.fres_ior, table.fres_a, table.fres_b]
        from ..core.gather import fetch_rows
        fetched = fetch_rows(cols, mid)
        lut = {id(c): v for c, v in zip(cols, fetched)}

        def g(col):
            return lut[id(col)]

        # shade-time vector_mapping (converter.cpp:93-105): per-material
        # TRS over the lookup uv
        uv_l = uv
        if "uvmap" in feats:
            xfm = g(table.uv_xform)
            uv_l = jnp.stack(
                [xfm[..., 0] * uv[..., 0] + xfm[..., 1] * uv[..., 1]
                 + xfm[..., 2],
                 xfm[..., 3] * uv[..., 0] + xfm[..., 4] * uv[..., 1]
                 + xfm[..., 5]], -1)

        kd = g(table.kd)
        if textured:
            kd_tex = g(table.kd_tex)
            kd = jnp.where((kd_tex >= 0)[..., None],
                           atlas.sample(kd_tex, uv_l), kd)
        # shade-time fresnel mix (converter.cpp FresnelNode:26-34)
        if "fresmix" in feats and cos_wo is not None:
            fi = g(table.fres_ior)
            F = frs.fresnel_dielectric(jnp.abs(cos_wo),
                                       jnp.maximum(fi, 1.0001))
            kd = jnp.where((fi > 0.0)[..., None],
                           g(table.fres_a)
                           + F[..., None] * (g(table.fres_b)
                                             - g(table.fres_a)), kd)
        kd = decode_alb(kd)

        spec_tint = g(table.spec_tint)
        if textured:
            spec_tex = g(table.spec_tex)
            spec_tint = jnp.where((spec_tex >= 0)[..., None],
                                  atlas.sample(spec_tex, uv_l), spec_tint)
        spec_tint = decode_alb(spec_tint)

        ax = g(table.ax)
        ay = g(table.ay)
        if textured:
            rough_tex = g(table.rough_tex)
            r_sample = atlas.sample(rough_tex, uv_l)[..., 0]
            r_alpha = jnp.where(g(table.rough_remap) > 0, r_sample * r_sample,
                                r_sample)
            ax = jnp.where(rough_tex >= 0, jnp.maximum(r_alpha, 1e-6), ax)
            ay = jnp.where(rough_tex >= 0, jnp.maximum(r_alpha, 1e-6), ay)

        # dielectric eta: scalar, or per-lambda Sellmeier when dispersive+hero
        disp_id = g(table.dispersive_id)
        eta = g(table.eta)[..., None]
        dispersive = jnp.zeros(mid.shape, bool)
        if hero:
            gc = table.glass_coeffs[
                jnp.clip(disp_id, 0, table.glass_coeffs.shape[0] - 1)]
            eta_spd = _sellmeier_eta(gc, swl.lam)
            dispersive = disp_id >= 0
            eta = jnp.where(dispersive[..., None], eta_spd, eta)

        # conductor eta/k: RGB triplets, or metal SPD rows at swl in hero mode
        eta3 = g(table.eta3)
        k3 = g(table.k3)
        if hero:
            from ..spectra import spd as spdmod
            metal_id = g(table.metal_id)
            mrow = jnp.clip(metal_id, 0, table.metal_eta_spd.shape[0] - 1)
            me = spdmod.spd_eval_rows(table.metal_eta_spd, mrow, swl.lam)
            mk = spdmod.spd_eval_rows(table.metal_k_spd, mrow, swl.lam)
            is_metal = (metal_id >= 0)[..., None]
            eta3 = jnp.where(is_metal, me, decode_alb(eta3))
            k3 = jnp.where(is_metal, mk, decode_alb(k3))

        sheen_tint = decode_alb(g(table.sheen_tint))

        params = bsdf.LobeParams(
            kd=kd, sigma=g(table.sigma), diffuse_kind=g(table.diffuse_kind),
            diffuse_weight=g(table.diffuse_weight) * wvalid,
            spec_tint=spec_tint, ax=ax, ay=ay,
            fr_mode=g(table.fr_mode), eta=eta,
            eta3=eta3, k3=k3,
            spec_weight=g(table.spec_weight) * wvalid,
            trans_weight=g(table.trans_weight) * wvalid,
            cc_weight=g(table.cc_weight) * wvalid, cc_alpha=g(table.cc_alpha),
            sheen_weight=g(table.sheen_weight) * wvalid,
            sheen_tint=sheen_tint,
            sheen_alpha=g(table.sheen_rough),
            sheen_ltc=getattr(table, "sheen_ltc", None),
            flatness=g(table.flatness), metallic=g(table.metallic),
            feats=feats,
            ems_E=getattr(table, "ems_E", None),
            ems_Eavg=getattr(table, "ems_Eavg", None),
        )
        return params, dispersive

    params, dispersive = _one(mid)
    if "mix2" in feats:
        from ..core.gather import fetch_rows
        midb_raw, wa, wb, ftex = fetch_rows(
            [table.mix_b, table.mix_wa, table.mix_wb, table.frac_tex], mid)
        has_b = midb_raw >= 0
        midb = jnp.clip(midb_raw, 0, table.kd.shape[0] - 1)
        params_b, disp_b = _one(midb)
        if textured:
            frac_t = atlas.sample(ftex, uv)[..., 0]
            wa = jnp.where(ftex >= 0, frac_t, wa)
            wb = jnp.where(ftex >= 0, 1.0 - frac_t, wb)
        wa = jnp.where(has_b, wa, 1.0)
        wb = jnp.where(has_b, wb, 0.0)
        params = params.replace(mix_b=params_b, mix_wa=wa, mix_wb=wb)
        dispersive = dispersive | (disp_b & has_b)
    return params, dispersive & valid
