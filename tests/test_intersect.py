"""Intersection: Möller-Trumbore, brute force vs BVH agreement."""
import jax.numpy as jnp
import numpy as np

from vision_tpu.accel import intersect as isect
from vision_tpu.accel.bvh import build_bvh
from vision_tpu.core.types import Ray


def random_tri_soup(n_tris=300, seed=0):
    rs = np.random.RandomState(seed)
    p0 = rs.rand(n_tris, 3).astype(np.float32) * 4 - 2
    e1 = (rs.rand(n_tris, 3).astype(np.float32) - 0.5)
    e2 = (rs.rand(n_tris, 3).astype(np.float32) - 0.5)
    return p0, e1, e2


def random_rays(n=500, seed=1):
    rs = np.random.RandomState(seed)
    o = rs.rand(n, 3).astype(np.float32) * 6 - 3
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray.make(jnp.asarray(o), jnp.asarray(d))


class TestBrute:
    def test_single_triangle_hit(self):
        p0 = jnp.asarray([[0.0, 0.0, 0.0]])
        e1 = jnp.asarray([[1.0, 0.0, 0.0]])
        e2 = jnp.asarray([[0.0, 1.0, 0.0]])
        ray = Ray.make(jnp.asarray([[0.2, 0.2, 1.0]]),
                       jnp.asarray([[0.0, 0.0, -1.0]]))
        hit = isect.intersect_brute(ray, p0, e1, e2)
        assert int(hit.prim_id[0]) == 0
        assert abs(float(hit.t[0]) - 1.0) < 1e-5
        np.testing.assert_allclose(np.asarray(hit.bary[0]), [0.2, 0.2], atol=1e-5)

    def test_miss(self):
        p0 = jnp.asarray([[0.0, 0.0, 0.0]])
        e1 = jnp.asarray([[1.0, 0.0, 0.0]])
        e2 = jnp.asarray([[0.0, 1.0, 0.0]])
        ray = Ray.make(jnp.asarray([[5.0, 5.0, 1.0]]),
                       jnp.asarray([[0.0, 0.0, -1.0]]))
        hit = isect.intersect_brute(ray, p0, e1, e2)
        assert int(hit.prim_id[0]) == -1

    def test_backface_still_hits(self):
        # reference traces both faces (no culling)
        p0 = jnp.asarray([[0.0, 0.0, 0.0]])
        e1 = jnp.asarray([[1.0, 0.0, 0.0]])
        e2 = jnp.asarray([[0.0, 1.0, 0.0]])
        ray = Ray.make(jnp.asarray([[0.2, 0.2, -1.0]]),
                       jnp.asarray([[0.0, 0.0, 1.0]]))
        hit = isect.intersect_brute(ray, p0, e1, e2)
        assert int(hit.prim_id[0]) == 0


class TestBVH:
    def test_matches_brute_force(self):
        p0, e1, e2 = random_tri_soup(300)
        verts = np.stack([p0, p0 + e1, p0 + e2], 1).reshape(-1, 3)
        tris = np.arange(300 * 3).reshape(300, 3)
        bvh = build_bvh(verts, tris)
        ray = random_rays(400)
        hb = isect.intersect_brute(ray, jnp.asarray(p0), jnp.asarray(e1),
                                   jnp.asarray(e2))
        hv, truncated = isect.intersect_bvh(ray, bvh)
        assert int(truncated) == 0
        tb = np.asarray(hb.t)
        tv = np.asarray(hv.t)
        same_hit = np.asarray(hb.prim_id >= 0) == np.asarray(hv.prim_id >= 0)
        assert same_hit.all()
        m = np.asarray(hb.prim_id) >= 0
        np.testing.assert_allclose(tv[m], tb[m], rtol=1e-4)
        # same primitive chosen (allow ties within epsilon)
        diff = np.asarray(hb.prim_id)[m] != np.asarray(hv.prim_id)[m]
        assert diff.mean() < 0.01

    def test_any_hit_consistent(self):
        p0, e1, e2 = random_tri_soup(200, seed=3)
        verts = np.stack([p0, p0 + e1, p0 + e2], 1).reshape(-1, 3)
        tris = np.arange(200 * 3).reshape(200, 3)
        bvh = build_bvh(verts, tris)
        ray = random_rays(300, seed=4)
        occ_b = np.asarray(isect.occluded_brute(
            ray, jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2)))
        hv, truncated = isect.intersect_bvh(ray, bvh, any_hit=True)
        assert int(truncated) == 0
        assert (occ_b == np.asarray(hv.prim_id >= 0)).all()

    def test_step_bound_counts_truncated_lanes(self):
        p0, e1, e2 = random_tri_soup(300, seed=5)
        verts = np.stack([p0, p0 + e1, p0 + e2], 1).reshape(-1, 3)
        bvh = build_bvh(verts, np.arange(300 * 3).reshape(300, 3))
        ray = random_rays(64, seed=6)
        _, full = isect.intersect_bvh(ray, bvh)
        _, cut = isect.intersect_bvh(ray, bvh, max_steps=2)
        assert int(full) == 0
        # every ray that enters the root walks more than two steps
        assert 0 < int(cut) <= 64
