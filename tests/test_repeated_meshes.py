"""Repeated meshes: one geometry key loaded once (mesh registry,
`mgr/mesh_registry.h:12-38`), each shape placed into the flat world-space
soup by its own transform (`base/shape.h:21-33`). The scene must equal the
same geometry placed by hand."""

import numpy as np
import jax.numpy as jnp

from tests.fixtures import flatten_by_hand, make_repeated_cbox
from vision_tpu.scene.scene import Scene


def _pair(tmp_path, n=3, sub_div=10, res=16):
    desc = make_repeated_cbox(n, sub_div, res)
    inst = Scene(desc)
    hand = Scene(flatten_by_hand(desc, str(tmp_path)),
                 scene_dir=str(tmp_path))
    return inst, hand


def test_repeated_meshes_flatten_into_the_soup(tmp_path):
    inst, hand = _pair(tmp_path)
    n_sphere = 4 * 10 * 10 - 2 * 2 * 10   # lat-long: 2*phi*(theta-1) tris
    cbox = 36
    assert inst.data.tri_p0.shape[0] == cbox + 3 * n_sphere
    for k in ("p0", "e1", "e2", "uv0", "inst"):
        np.testing.assert_array_equal(inst.tri_arrays[k], hand.tri_arrays[k])
    np.testing.assert_allclose(inst.tri_arrays["n0"], hand.tri_arrays["n0"],
                               atol=1e-6)
    # the light's triangles keep their ids
    lt = inst.data.lights
    tb = int(np.asarray(lt.tri_base)[0])
    assert np.asarray(inst.data.tri_pack)[tb, 26] >= 0


def test_repeated_meshes_render_like_hand_placed(tmp_path):
    from vision_tpu.core import rng
    from vision_tpu.integrator import pt
    inst, hand = _pair(tmp_path, n=4, sub_div=8, res=16)
    R = 16 * 16
    pix = jnp.arange(R, dtype=jnp.uint32)
    p_film = jnp.stack([(pix % 16).astype(jnp.float32) + 0.5,
                        (pix // 16).astype(jnp.float32) + 0.5], -1)
    ray = inst.camera.generate_ray(p_film, jnp.zeros((R, 2)))
    st = rng.seed(pix, jnp.uint32(0))
    a, _ = pt.radiance(inst.data, ray, st, max_depth=3)
    b, _ = pt.radiance(hand.data, ray, st, max_depth=3)
    a, b = np.asarray(a), np.asarray(b)
    bad = (np.abs(a - b) > 1e-3 + 1e-3 * np.abs(b)).any(-1)
    assert bad.mean() < 0.02, f"{bad.sum()} lanes disagree"
    np.testing.assert_allclose(a.mean(0), b.mean(0), rtol=0.01, atol=1e-4)
