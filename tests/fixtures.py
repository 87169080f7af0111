"""Self-contained test scenes (no external assets).

CBOX_JSON mirrors the canonical cornell box
(`/root/reference/res/render_scene/cbox/vision_scene.json`) simplified to the
BASELINE config-1 ladder: 512x512, pinhole-ish camera, diffuse walls, two
boxes, one area light.
"""

def _wall(name, mat, m):
    return {
        "type": "quad", "name": name,
        "param": {"width": 1.0, "height": 1.0, "material": mat,
                  "transform": {"type": "matrix4x4",
                                "param": {"matrix4x4": m}}},
    }


# row-vector convention matrices (translation in 4th row) as the reference uses
_FLOOR = [[0, 0, -2, 0], [0, 4, 0, 0], [2, 0, 0, 0], [0, 0, 0, 1]]
_CEIL = [[-2, 0, 0, 0], [0, -4, 0, 0], [0, 0, 2, 0], [0, 2, 0, 1]]
_BACK = [[0, 2, 0, 0], [0, 0, 4, 0], [2, 0, 0, 0], [0, 1, -1, 1]]
_LEFT = [[0, 2, 0, 0], [4, 0, 0, 0], [0, 0, -2, 0], [-1, 1, 0, 1]]
_RIGHT = [[0, 2, 0, 0], [-4, 0, 0, 0], [0, 0, 2, 0], [1, 1, 0, 1]]
_SHORT = [[-0.1703285, 0, 0.5699020, 0], [-0.5790837, 0, -0.1730727, 0],
          [0, -0.6, 0, 0], [0.328631, 0.299, 0.374592, 1]]
_TALL = [[0.5735512, 0, -0.1995971, 0], [0.1964583, 0, 0.5645317, 0],
         [0, -1.2, 0, 0], [-0.335439, 0.599, -0.291415, 1]]
_LIGHT = [[0.47, 0, 0, 0], [0, -0.1786, 0, 0], [0, 0, -0.38, 0],
          [-0.005, 1.98, -0.03, 1]]

CBOX_JSON = {
    "shapes": [
        _wall("floor", "White", _FLOOR),
        _wall("ceiling", "White", _CEIL),
        _wall("back", "White", _BACK),
        _wall("left", "Red", _LEFT),
        _wall("right", "Green", _RIGHT),
        {"type": "cube", "name": "short",
         "param": {"x": 1, "y": 1, "z": 1, "material": "White",
                   "transform": {"type": "matrix4x4",
                                 "param": {"matrix4x4": _SHORT}}}},
        {"type": "cube", "name": "tall",
         "param": {"x": 1, "y": 1, "z": 1, "material": "White",
                   "transform": {"type": "matrix4x4",
                                 "param": {"matrix4x4": _TALL}}}},
        {"type": "quad", "name": "light",
         "param": {"width": 1, "height": 1, "material": "Black",
                   "transform": {"type": "matrix4x4",
                                 "param": {"matrix4x4": _LIGHT}},
                   "emission": {"type": "area",
                                "param": {"color": {"channels": "xyz",
                                                    "node": [17, 12, 4]},
                                          "two_sided": False,
                                          "scale": 1}}}},
    ],
    "materials": [
        {"type": "diffuse", "name": "Red", "param": {"color": [0.63, 0.065, 0.05]}},
        {"type": "diffuse", "name": "Green", "param": {"color": [0.14, 0.45, 0.091]}},
        {"type": "diffuse", "name": "White", "param": {"color": [0.725, 0.71, 0.68]}},
        {"type": "diffuse", "name": "Black", "param": {"color": [0, 0, 0]}},
    ],
    "sampler": {"type": "independent", "param": {"spp": 1}},
    "camera": {
        "type": "thin_lens",
        "param": {
            "fov_y": 19.5,
            "transform": {"type": "look_at",
                          "param": {"position": [0, 1, 6.8], "up": [0, 1, 0],
                                    "target_pos": [0, 1, 0]}},
            "radiance_collector": {
                "type": "normal",
                "param": {"resolution": [512, 512],
                          "tone_mapper": {"type": "linear",
                                          "param": {"exposure": 1.0}}}},
            "filter": {"type": "box", "param": {"radius": [0.5, 0.5]}},
        },
    },
    "integrator": {"type": "pt",
                   "param": {"min_depth": 0, "max_depth": 8, "rr_threshold": 1}},
    "spectrum": {"type": "srgb", "param": {"dimension": 3}},
    "light_sampler": {"type": "uniform", "param": {"lights": []}},
    "output": {"spp": 16, "fn": "cbox_test.png"},
}


def make_glass_cbox():
    """cbox with a glass tall box + mirror short box (ladder config 2)."""
    import copy
    s = copy.deepcopy(CBOX_JSON)
    s["materials"] += [
        {"type": "glass", "name": "Glass",
         "param": {"material_name": "BK7", "roughness": [0.01, 0.01],
                   "color": [1, 1, 1]}},
        {"type": "mirror", "name": "Mirror",
         "param": {"color": [1, 1, 1], "roughness": 0.001}},
        {"type": "metal", "name": "Cu",
         "param": {"material_name": "Cu", "roughness": [0.01, 0.01]}},
    ]
    s["shapes"][5]["param"]["material"] = "Glass"
    s["shapes"][6]["param"]["material"] = "Mirror"
    return s


def _sphere(name, radius, sub_div, pos, rot_y=0.0, material="White"):
    import math
    c, s = math.cos(rot_y), math.sin(rot_y)
    # row-vector convention: rotation about y, translation in the 4th row
    m = [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], list(pos) + [1]]
    return {"type": "sphere", "name": name,
            "param": {"radius": radius, "sub_div": sub_div,
                      "material": material,
                      "transform": {"type": "matrix4x4",
                                    "param": {"matrix4x4": m}}}}


def make_sphere_cbox(sub_div=256, res=512):
    """cbox plus one lat-long sphere of about 4 * sub_div^2 triangles
    floating above the short box (sub_div=256: ~262k triangles, a BVH
    scene of the size of a furnished interior)."""
    import copy
    s = copy.deepcopy(CBOX_JSON)
    s["shapes"].append(_sphere("sphere", 0.3, sub_div, (0.35, 1.05, 0.35)))
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [res, res]
    return s


def make_repeated_cbox(n=4, sub_div=128, res=128):
    """cbox plus `n` copies of one sphere mesh (one geometry key, placed by
    per-shape transforms, some rotated)."""
    import copy
    spots = [(-0.55, 1.45, 0.3), (0.55, 1.45, -0.3), (0.0, 1.25, 0.55),
             (0.4, 0.95, 0.45), (-0.5, 0.35, 0.55), (0.6, 0.35, -0.6)]
    s = copy.deepcopy(CBOX_JSON)
    for i in range(n):
        s["shapes"].append(_sphere(f"sphere{i}", 0.2, sub_div, spots[i],
                                   rot_y=0.6 * (i % 2)))
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [res, res]
    return s


def _write_ply(path, mesh):
    import numpy as np
    P, N, UV, T = mesh.positions, mesh.normals, mesh.uvs, mesh.triangles
    head = (f"ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(P)}\n"
            + "".join(f"property float {c}\n"
                      for c in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
            + f"element face {len(T)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    verts = np.concatenate([P, N, UV], 1).astype("<f4")
    faces = np.zeros(len(T), [("n", "u1"), ("i", "<i4", (3,))])
    faces["n"] = 3
    faces["i"] = T
    with open(path, "wb") as f:
        f.write(head.encode() + verts.tobytes() + faces.tobytes())


def flatten_by_hand(scene, out_dir):
    """The same scene with every sphere replaced by a world-space PLY model
    (identity transform): the repeated meshes placed by hand. Returns the
    new scene dict; the models are written to `out_dir`."""
    import copy
    import os
    from vision_tpu.core import transform as xf
    from vision_tpu.scene import shapes as shp
    s = copy.deepcopy(scene)
    for k, sh in enumerate(s["shapes"]):
        if sh["type"] != "sphere":
            continue
        p = sh["param"]
        world = shp.make_shape("sphere", p).transformed(
            xf.from_json(p["transform"]))
        fn = f"placed_{k}.ply"
        _write_ply(os.path.join(out_dir, fn), world)
        s["shapes"][k] = {"type": "model", "name": sh.get("name"),
                          "param": {"fn": fn, "material": p["material"]}}
    return s
