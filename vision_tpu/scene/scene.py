"""Scene: JSON description -> flat device SceneData.

Replaces `/root/reference/src/base/mgr/scene.{h,cpp}` + `geometry.cpp`:
instead of per-instance device buffers + BLAS/TLAS, everything flattens to
world-space triangle soup (SoA) + id tables at load time; a mesh used by
several shapes is loaded once and placed once per shape. Load order mirrors
Scene::init (scene.cpp:16-34): light_sampler -> spectrum -> materials ->
sensor -> shapes (+ area-light emissions) -> integrator -> sampler.
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core import transform as xf
from ..shading.materials import MaterialCompiler
from ..lights.lights import LightBuilder
from ..sensor.camera import Camera
from ..sensor.filters import FilterSampler
from ..accel.bvh import build_bvh
from ..accel.sah import build_sah
from . import desc as dsc
from . import shapes as shp
from .texture import AtlasBuilder

BRUTE_FORCE_MAX_TRIS = 2048


@struct.dataclass
class SceneData:
    """Everything the kernels need, as one pytree (replicated across devices)."""
    # geometry (world space)
    tri_p0: jnp.ndarray    # [T, 3]
    tri_e1: jnp.ndarray    # [T, 3]
    tri_e2: jnp.ndarray    # [T, 3]
    tri_n0: jnp.ndarray    # [T, 3] vertex normals
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray   # [T, 2]
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    tri_inst: jnp.ndarray  # [T] int32
    tri_pack: jnp.ndarray  # [T, 32] packed attrs: p0 e1 e2 n0 n1 n2 uv012 inst mat light
    inst_mat: jnp.ndarray  # [I] int32
    inst_light: jnp.ndarray  # [I] int32 (-1 = not emissive)
    materials: object      # MaterialTable
    mediums: object        # MediumTable
    inst_in_medium: jnp.ndarray   # [I] int32 (-1 vacuum)
    inst_out_medium: jnp.ndarray  # [I] int32
    has_media: bool = struct.field(pytree_node=False)
    camera_medium: int = struct.field(pytree_node=False)
    lights: object         # LightTable
    atlas: object          # TextureAtlas
    bvh: object            # BVH or None (XLA skip-link walk; CPU route)
    sah: object            # SahBVH or None (GPU traversal kernel route)
    spectrum: object       # SpectrumModel
    world_radius: jnp.ndarray
    # render_setting.ray_offset_factor (node_desc.cpp:375); spawn offsets are
    # position-magnitude-scaled and multiplied by this
    ray_offset: jnp.ndarray = None


class Scene:
    """Host-side scene container (load + build)."""

    def __init__(self, path_or_dict, scene_dir=None):
        if isinstance(path_or_dict, (str, os.PathLike)):
            self.scene_dir = scene_dir or os.path.dirname(os.path.abspath(path_or_dict))
            p = os.fspath(path_or_dict)
            if p.lower().endswith((".gltf", ".glb")):
                # full-scene import: materials/lights/camera mapped from
                # glTF (importers/assimp breadth; scene/gltf.py)
                from .gltf import load_gltf_scene
                raw = load_gltf_scene(p)
            else:
                raw = dsc.load_jsonc(p)
        else:
            self.scene_dir = scene_dir or "."
            raw = path_or_dict
        self.raw = raw
        self._build()

    def _build(self):
        raw = self.raw
        self.atlas_builder = AtlasBuilder()
        self.mat_compiler = MaterialCompiler(self.atlas_builder, self.scene_dir)

        # ---- materials ----
        for mdesc in raw.get("materials", []):
            self.mat_compiler.compile(mdesc)

        # ---- mediums (vision_sss.json schema: {process, list|global}) ----
        from ..shading.medium import MediumBuilder
        self.medium_builder = MediumBuilder()
        med_desc = raw.get("mediums", {})
        self.process_mediums = bool(med_desc.get("process", False))
        for md in med_desc.get("list", []):
            self.medium_builder.add(md)
        gname = med_desc.get("global", "")
        self.global_medium = self.medium_builder.get(gname) if gname else -1
        self.n_mediums = len(self.medium_builder.rows)

        # ---- light sampler config ----
        ls = raw.get("light_sampler", {})
        ls_type = ls.get("type", "uniform")
        ls_param = ls.get("param", {})
        self.light_builder = LightBuilder(
            sampler_type=ls_type,
            env_prob=ls_param.get("env_prob", 0.5))

        # ---- shapes: load meshes (hash-dedup registry) ----
        # Mirrors the reference MeshRegistry (`mgr/mesh_registry.h:12-38`):
        # identical geometry loads once; every shape then places its own
        # world-space copy in the flat soup (shape.h:21-33 o2w).
        self._inst_media = []
        raw_parts = []  # (mesh_obj, o2w, inst_id, emission|None)
        inst_mat, inst_light = [], []
        mesh_cache = {}
        for sdesc in raw.get("shapes", []):
            stype = sdesc.get("type", "quad")
            p = sdesc.get("param", {})
            key = shp.geometry_key(stype, p, self.scene_dir)
            try:
                mesh = mesh_cache.get(key)
                if mesh is None:
                    mesh = shp.make_shape(stype, p, self.scene_dir)
                    if key is not None:
                        mesh_cache[key] = mesh
            except (FileNotFoundError, ValueError) as e:
                import warnings
                warnings.warn(f"skipping shape '{sdesc.get('name')}': {e}")
                continue
            m = xf.from_json(p.get("transform"))
            inst_id = len(inst_mat)
            mat_name = p.get("material")
            if isinstance(mat_name, dict):
                mid = self.mat_compiler.compile(mat_name)
            else:
                mid = self.mat_compiler.get(mat_name) if mat_name else -1
            inst_mat.append(mid)
            inst_light.append(-1)
            med = p.get("medium", {})
            inside = self.medium_builder.get(med.get("inside", "")) if med else -1
            outside = (self.medium_builder.get(med.get("outside", ""))
                       if med else self.global_medium)
            # subsurface materials carry an interior medium (subsurface.cpp
            # sigma_a/sigma_s slots -> homogeneous medium inside the shape)
            sss = self.mat_compiler.sss.get(mid)
            if sss is not None and inside < 0:
                inside = self._obtain_sss_medium(mid, sss)
            self._inst_media.append((inside, outside))
            raw_parts.append((mesh, m, inst_id, p.get("emission")))

        mesh_parts = []                  # (TriMesh world, inst_id)
        pending_emissions = []           # (inst_id, edesc, tri_base, areas)
        tri_base = 0
        for (mesh, m, inst_id, emission) in raw_parts:
            world = mesh.transformed(m)
            mesh_parts.append((world, inst_id))
            if emission is not None:
                t0, t1, t2 = (world.positions[world.triangles[:, k]]
                              for k in range(3))
                areas = 0.5 * np.linalg.norm(np.cross(t1 - t0, t2 - t0),
                                             axis=-1)
                pending_emissions.append((inst_id, emission, tri_base, areas))
            tri_base += world.num_triangles

        # ---- lights ----
        for ldesc in (raw.get("light_sampler", {}).get("param", {})
                      .get("lights", [])):
            self._add_light(ldesc, mesh_parts, inst_mat, inst_light,
                            pending_emissions)
        for inst_id, edesc, tb, areas in pending_emissions:
            ep = dsc.ParameterSet(edesc.get("param", {}))
            color, tex_id = self._emission_color(ep)
            lid = self.light_builder.add_area(
                color, inst_id, tb, areas,
                two_sided=ep.as_bool("two_sided", False), tex_id=tex_id)
            inst_light[inst_id] = lid

        # a scene whose ONLY light was a missing-asset HDRI would render
        # black; substitute a constant gray sky with the light's scale and
        # orientation so it stays renderable (classroom: the env map is not
        # checked into the reference repo)
        skipped = getattr(self, "_skipped_env", None)
        if skipped is not None and not self.light_builder.rows:
            import warnings
            warnings.warn("scene has no lights; substituting a constant "
                          "environment for the missing HDRI")
            _, o2w_raw = skipped
            # unit radiance sky: the original scale targeted an HDRI whose
            # mean is unknown (classroom's is 300); applying it to a flat
            # sky blows out the frame
            image = np.full((8, 16, 3), 1.0, np.float32)
            tex = self.atlas_builder.add_array(image)
            self.light_builder.add_spherical([1.0, 1.0, 1.0],
                                             xf.from_json(o2w_raw),
                                             tex, image)

        # ---- flatten geometry ----
        self.tri_arrays, self.inst_mat, self.inst_light = self._flatten(
            mesh_parts, inst_mat, inst_light)

        # ---- camera ----
        cam = raw.get("camera", {})
        cp = dsc.ParameterSet(cam.get("param", {}))
        c2w = xf.from_json(cp.raw("transform"))
        rc = cp.raw("radiance_collector", cp.raw("film", {})) or {}
        rc_param = rc.get("param", {}) if isinstance(rc, dict) else {}
        res = rc_param.get("resolution", [512, 512])
        fb = raw.get("pipeline", {}).get("param", {}).get("frame_buffer", {})
        if not rc_param and fb:
            res = fb.get("param", {}).get("resolution", res)
        self.resolution = (int(res[0]), int(res[1]))
        # framebuffer plugin choice (render_core/framebuffer/{normal,
        # light_field}.cpp): light_field renders an S x S sub-aperture grid
        self.framebuffer_type = fb.get("type", "normal")
        self.lf_grid = int(fb.get("param", {}).get("grid", 3))
        # pipeline plugin choice (pipelines/{fixed,customized,bake}) — the
        # CLI's -p overrides; render() consumes framebuffer_type directly
        self.pipeline_type = raw.get("pipeline", {}).get("type", "fixed")
        self.camera = Camera.make(
            c2w, cp.as_float("fov_y", 20.0), self.resolution,
            lens_radius=cp.as_float("lens_radius", 0.0),
            focal_distance=cp.as_float("focal_distance", 5.0))
        tm = rc_param.get("tone_mapper", {})
        self.tone_mapper = tm.get("type", "linear")
        self.exposure = tm.get("param", {}).get("exposure", 1.0)

        fdesc = cam.get("param", {}).get("filter", {"type": "box"})
        self.filter = FilterSampler.make(fdesc.get("type", "box"),
                                         fdesc.get("param", {}))

        # ---- integrator / sampler / output ----
        idesc = raw.get("integrator", {})
        ip = dsc.ParameterSet(idesc.get("param", {}))
        self.max_depth = ip.as_int("max_depth", 16)
        self.min_depth = ip.as_int("min_depth", 0)
        self.rr_threshold = ip.as_float("rr_threshold", 1.0)
        self.sampler_spp = dsc.ParameterSet(
            raw.get("sampler", {}).get("param", {})).as_int("spp", 1)
        out = raw.get("output", {})
        self.output_spp = int(out.get("spp", 0))
        self.output_fn = out.get("fn", "output.png")

        rs = dsc.ParameterSet(raw.get("render_setting", {}))
        self.ray_offset_factor = rs.as_float("ray_offset_factor", 1.0)

        sp_desc = raw.get("spectrum", {})
        self.spectrum_type = sp_desc.get("type", "srgb")
        self.spectrum_dims = sp_desc.get("param", {}).get("dimension", 3)
        if self.spectrum_type not in ("srgb", "hero"):
            self.spectrum_type = "srgb"
        # hero needs >= 1 lambda; keep 3-4 typical
        from ..spectra.spectrum import SpectrumModel
        self.spectrum = SpectrumModel.make(self.spectrum_type,
                                           self.spectrum_dims)

        # ---- device data ----
        self.atlas = self.atlas_builder.build()
        self.material_table = self.mat_compiler.build()
        self.light_table = self.light_builder.build()
        self.medium_table = self.medium_builder.build()
        self._build_device_geometry()

    def _emission_color(self, ep):
        """Emission color slot -> (rgb*scale, atlas tex id | -1). Textured
        emission (light.h color slot, e.g. res/emission_tex.json) loads into
        the atlas; the constant becomes the scale."""
        kind, payload, _ = dsc.parse_slot(ep.raw("color", [1, 1, 1]))
        tex_id = -1
        if kind == "image":
            try:
                tex_id = self.atlas_builder.add_image(
                    os.path.join(self.scene_dir, payload["fn"]),
                    payload.get("color_space", "srgb"))
            except Exception as e:
                import warnings
                warnings.warn(f"emission texture missing: {e}")
            color = [1.0, 1.0, 1.0]
        else:
            color = payload if kind == "const" else [1.0, 1.0, 1.0]
        color = list(color) + [color[-1]] * (3 - len(color))
        sk, sp_, _ = dsc.parse_slot(ep.raw("scale", 1.0))
        scale = sp_[0] if sk == "const" else 1.0
        return [c * scale for c in color[:3]], tex_id

    def _add_light(self, ldesc, mesh_parts, inst_mat, inst_light,
                   pending_emissions):
        lt = ldesc.get("type")
        p = dsc.ParameterSet(ldesc.get("param", {}))
        scale = p.as_float("scale", 1.0)

        def color3(key="color", default=(1, 1, 1)):
            kind, payload, _ = dsc.parse_slot(p.raw(key, list(default)))
            if kind == "const":
                c = payload + [payload[-1]] * (3 - len(payload))
                return [v * scale for v in c[:3]], None
            if kind == "image":
                return [scale] * 3, payload
            return [scale] * 3, None

        def ies_id():
            """Optional IES angular profile (illumination/ies.cpp parser,
            consumed here as a spot/projector mask)."""
            fn = p.raw("ies", None)
            if not fn:
                return -1
            try:
                from ..lights.ies import IESProfile
                prof = IESProfile.load(os.path.join(self.scene_dir, fn))
                return self.light_builder.add_ies_profile(
                    np.asarray(prof.to_table()))
            except Exception as e:
                import warnings
                warnings.warn(f"ies profile '{fn}' unusable: {e}")
                return -1

        if lt == "point":
            c, _ = color3()
            self.light_builder.add_point(c, p.as_float3("position"))
        elif lt == "spot":
            c, _ = color3()
            self.light_builder.add_spot(c, p.as_float3("position"),
                                        p.as_float3("direction", (0, 0, 1)),
                                        p.as_float("angle", 45.0),
                                        p.as_float("falloff", 10.0),
                                        ies=ies_id())
        elif lt == "projector":
            c, img = color3()
            tex = -1
            if img is not None:
                try:
                    tex = self.atlas_builder.add_image(
                        os.path.join(self.scene_dir, img["fn"]),
                        img.get("color_space", "srgb"))
                except Exception as e:
                    import warnings
                    warnings.warn(f"projector texture missing: {e}")
            o2w = xf.from_json(p.raw("o2w"))
            self.light_builder.add_projector(c, o2w, p.as_float("angle", 30.0),
                                             p.as_float("ratio", 1.0), tex,
                                             ies=ies_id())
        elif lt == "spherical":
            c, img = color3()
            if img is None:
                return
            path = os.path.join(self.scene_dir, img["fn"])
            from .texture import load_image
            try:
                image = load_image(path, img.get("color_space", "linear"))
                tex = self.atlas_builder.add_image(
                    path, img.get("color_space", "linear"))
            except Exception as e:
                # some reference scenes (classroom) reference HDRIs that were
                # never checked into the repo; remember the skipped light so
                # an otherwise-unlit scene can get a substitute gray sky
                # instead of rendering black (see _build)
                import warnings
                warnings.warn(f"skipping spherical light, asset missing: {e}")
                self._skipped_env = (c, p.raw("o2w"))
                return
            o2w = xf.from_json(p.raw("o2w"))
            self.light_builder.add_spherical(c, o2w, tex, image)
        elif lt == "directional":
            c, _ = color3()
            self.light_builder.add_directional(c, p.as_float3("direction", (0, -1, 0)))
        elif lt == "mix":
            # environments/mix.cpp: weighted blend of two environments.
            # Pre-combine the HDRIs into one spherical light at load time
            # (scale0*env0 + scale1*env1), resampled to the larger resolution;
            # orientation taken from env0.
            self._add_mix_env(p)
        elif lt == "area":
            # standalone area light: builds its own quad geometry (area.cpp
            # init_geometry)
            c, _ = color3()
            mesh = shp.make_quad(p.as_float("width", 1.0), p.as_float("height", 1.0))
            o2w = xf.from_json(p.raw("o2w"))
            world = mesh.transformed(o2w)
            inst_id = len(inst_mat)
            inst_mat.append(-1)
            inst_light.append(-1)
            self._inst_media.append((-1, self.global_medium))
            tri_base = sum(m.num_triangles for m, _ in mesh_parts)
            mesh_parts.append((world, inst_id))
            t0, t1, t2 = (world.positions[world.triangles[:, k]] for k in range(3))
            areas = 0.5 * np.linalg.norm(np.cross(t1 - t0, t2 - t0), axis=-1)
            lid = self.light_builder.add_area(c, inst_id, tri_base, areas,
                                              p.as_bool("two_sided", False))
            inst_light[inst_id] = lid

    def _obtain_sss_medium(self, mid, sss):
        key = f"__sss_{mid}"
        existing = self.medium_builder.get(key)
        if existing >= 0:
            return existing
        desc = {"type": "homogeneous", "name": key,
                "param": {"sigma_a": sss["sigma_a"],
                          "sigma_s": sss["sigma_s"], "g": sss["g"]}}
        if sss.get("medium_name"):
            desc["param"] = {"medium_name": sss["medium_name"],
                             "g": sss["g"]}
        med_id = self.medium_builder.add(desc)
        self.process_mediums = True
        self.n_mediums = len(self.medium_builder.rows)
        return med_id

    def _add_mix_env(self, p):
        from .texture import load_image

        def load_env(key, skey):
            sub = p.raw(key, {}) or {}
            sp_ = dsc.ParameterSet(sub.get("param", {}))
            kind, payload, _ = dsc.parse_slot(sp_.raw("color", [1, 1, 1]))
            if kind != "image":
                return None
            path = os.path.join(self.scene_dir, payload["fn"])
            try:
                img = load_image(path, payload.get("color_space", "linear"))
            except Exception:
                return None
            scale = p.as_float(skey, 1.0) * sp_.as_float("scale", 1.0)
            o2w = xf.from_json(sp_.raw("o2w"))
            return img, scale, o2w

        e0 = load_env("env0", "scale0")
        e1 = load_env("env1", "scale1")
        if e0 is None and e1 is None:
            return
        if e0 is None or e1 is None:
            img, scale, o2w = e0 or e1
            combined = img * scale
        else:
            h = max(e0[0].shape[0], e1[0].shape[0])
            w = max(e0[0].shape[1], e1[0].shape[1])

            def up(img):
                if img.shape[:2] == (h, w):
                    return img
                yi = (np.arange(h) * img.shape[0] // h)
                xi = (np.arange(w) * img.shape[1] // w)
                return img[yi][:, xi]

            combined = up(e0[0]) * e0[1] + up(e1[0]) * e1[1]
            o2w = e0[2]
        tex = self.atlas_builder.add_array(combined.astype(np.float32))
        self.light_builder.add_spherical([1.0, 1.0, 1.0], o2w, tex, combined)

    def _flatten(self, mesh_parts, inst_mat, inst_light):
        P0, E1, E2, N0, N1, N2, U0, U1, U2, TI = [], [], [], [], [], [], [], [], [], []
        for world, inst_id in mesh_parts:
            t = world.triangles
            p0 = world.positions[t[:, 0]]
            p1 = world.positions[t[:, 1]]
            p2 = world.positions[t[:, 2]]
            P0.append(p0)
            E1.append(p1 - p0)
            E2.append(p2 - p0)
            N0.append(world.normals[t[:, 0]])
            N1.append(world.normals[t[:, 1]])
            N2.append(world.normals[t[:, 2]])
            U0.append(world.uvs[t[:, 0]])
            U1.append(world.uvs[t[:, 1]])
            U2.append(world.uvs[t[:, 2]])
            TI.append(np.full(len(t), inst_id, np.int32))
        cat = lambda xs: np.concatenate(xs, 0) if xs else np.zeros((0, 3), np.float32)
        tri = dict(
            p0=cat(P0).astype(np.float32), e1=cat(E1).astype(np.float32),
            e2=cat(E2).astype(np.float32),
            n0=cat(N0).astype(np.float32), n1=cat(N1).astype(np.float32),
            n2=cat(N2).astype(np.float32),
            uv0=np.concatenate(U0, 0).astype(np.float32) if U0 else np.zeros((0, 2), np.float32),
            uv1=np.concatenate(U1, 0).astype(np.float32) if U1 else np.zeros((0, 2), np.float32),
            uv2=np.concatenate(U2, 0).astype(np.float32) if U2 else np.zeros((0, 2), np.float32),
            inst=np.concatenate(TI, 0) if TI else np.zeros((0,), np.int32),
        )
        return tri, np.asarray(inst_mat, np.int32), np.asarray(inst_light, np.int32)

    @staticmethod
    def _pack_rows(p0, e1, e2, n0, n1, n2, uv0, uv1, uv2, inst=None,
                   mat=None, light=None):
        """Packed per-triangle attribute rows: one gather per hit instead
        of ~12 separate [T, 3] gathers."""
        n = max(len(p0), 1)
        tp = np.zeros((n, 32), np.float32)
        if len(p0):
            tp[:, 0:3] = p0
            tp[:, 3:6] = e1
            tp[:, 6:9] = e2
            tp[:, 9:12] = n0
            tp[:, 12:15] = n1
            tp[:, 15:18] = n2
            tp[:, 18:20] = uv0
            tp[:, 20:22] = uv1
            tp[:, 22:24] = uv2
            if inst is not None:
                tp[:, 24] = inst.astype(np.float32)
                tp[:, 25] = mat.astype(np.float32)
                tp[:, 26] = light.astype(np.float32)
        return tp

    def _build_device_geometry(self):
        t = self.tri_arrays
        n_tris = len(t["p0"])
        bvh = None
        sah = None
        self.use_bvh = n_tris > BRUTE_FORCE_MAX_TRIS
        if self.use_bvh:
            # two trees over the same triangles: the Morton LBVH for the
            # XLA walk (CPU) and the binned-SAH tree for the GPU kernel
            sah = build_sah(t["p0"], t["e1"], t["e2"])
            tris = np.arange(n_tris * 3, dtype=np.int64).reshape(n_tris, 3)
            verts = np.stack([t["p0"], t["p0"] + t["e1"],
                              t["p0"] + t["e2"]], axis=1).reshape(-1, 3)
            bvh = build_bvh(verts, tris)
        tri_pack = self._pack_rows(
            t["p0"], t["e1"], t["e2"], t["n0"], t["n1"], t["n2"],
            t["uv0"], t["uv1"], t["uv2"], t["inst"],
            self.inst_mat[t["inst"]] if len(t["p0"]) else np.zeros(0),
            self.inst_light[t["inst"]] if len(t["p0"]) else np.zeros(0))
        p_all = np.concatenate([t["p0"], t["p0"] + t["e1"],
                                t["p0"] + t["e2"]], 0)

        if len(p_all):
            center = 0.5 * (p_all.min(0) + p_all.max(0))
            radius = float(np.linalg.norm(p_all - center, axis=-1).max())
        else:
            radius = 1.0

        self.data = SceneData(
            tri_p0=jnp.asarray(t["p0"]), tri_e1=jnp.asarray(t["e1"]),
            tri_e2=jnp.asarray(t["e2"]),
            tri_n0=jnp.asarray(t["n0"]), tri_n1=jnp.asarray(t["n1"]),
            tri_n2=jnp.asarray(t["n2"]),
            tri_uv0=jnp.asarray(t["uv0"]), tri_uv1=jnp.asarray(t["uv1"]),
            tri_uv2=jnp.asarray(t["uv2"]),
            tri_inst=jnp.asarray(t["inst"]),
            tri_pack=jnp.asarray(tri_pack),
            inst_mat=jnp.asarray(self.inst_mat),
            inst_light=jnp.asarray(self.inst_light),
            materials=self.material_table,
            mediums=self.medium_table,
            inst_in_medium=jnp.asarray(
                [m[0] for m in self._inst_media] or [-1], jnp.int32),
            inst_out_medium=jnp.asarray(
                [m[1] for m in self._inst_media] or [-1], jnp.int32),
            has_media=self.process_mediums and self.n_mediums > 0,
            camera_medium=self.global_medium,
            lights=self.light_table,
            atlas=self.atlas,
            bvh=bvh,
            sah=sah,
            spectrum=self.spectrum,
            world_radius=jnp.asarray(max(radius, 1e-3), jnp.float32),
            ray_offset=jnp.asarray(self.ray_offset_factor, jnp.float32),
        )


def load_scene(path):
    return Scene(path)
