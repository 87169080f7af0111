"""Absolute-energy verification against the independent referee renderer.

tests/ref_renderer.py shares no transport code with vision_tpu; agreement
of the per-depth image means pins the whole energy chain (camera rays,
NEE + MIS, BSDF sampling throughput, emission sidedness, visibility).
This is the verification layer SURVEY.md §4 says the reference lacks.

History: this referee caught an 11% energy loss from bf16-truncated
one-hot row fetches quantizing geometry, and itself initially
double-counted back-side emission of the one-sided light — both renderers
now agree to MC noise at every depth.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np

from tests.fixtures import CBOX_JSON
from tests.ref_renderer import RefTracer
from vision_tpu.scene.scene import Scene
from vision_tpu.integrator import pt


def _ours(scene_json, res, spp, depth):
    s = copy.deepcopy(scene_json)
    s["camera"]["param"]["radiance_collector"]["param"]["resolution"] = \
        [res, res]
    sc = Scene(s)
    fn = jax.jit(lambda sd, c, f, i: pt.render_sample(
        sd, c, f, i, max_depth=depth, min_depth=99)[0])
    acc = 0.0
    for i in range(spp):
        acc = acc + fn(sc.data, sc.camera, sc.filter, jnp.uint32(700 + i))
    return np.asarray(acc / spp)


def test_energy_matches_referee_per_depth():
    res, spp = 32, 24
    ref = RefTracer(CBOX_JSON, seed=3)
    for depth in (1, 2, 4):
        ours = _ours(CBOX_JSON, res, spp, depth)
        theirs = ref.render(res, spp, depth)
        m_o, m_r = ours.mean(), theirs.mean()
        # image means over 24k samples: ~2-3% MC noise; 6% budget
        assert abs(m_o - m_r) / m_r < 0.06, (depth, m_o, m_r)


def test_energy_matches_referee_empty_box():
    s = copy.deepcopy(CBOX_JSON)
    s["shapes"] = [sh for sh in s["shapes"]
                   if sh["name"] not in ("short", "tall")]
    ref = RefTracer(s, seed=5)
    ours = _ours(s, 32, 24, 8)
    theirs = ref.render(32, 24, 8)
    assert abs(ours.mean() - theirs.mean()) / theirs.mean() < 0.06, \
        (ours.mean(), theirs.mean())
