"""Traversal routes: the SAH layout the GPU kernel walks, a numpy model of
the kernel's walk against the dense sweep, the kernel wrapper's padding, the
route choice, and the gradient rule shared by every route.

The CUDA kernel itself (native/trace.cu) only runs on a GPU; chip_smoke.py
checks it there against the dense sweep at 262k triangles.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vision_tpu.accel import intersect as isect
from vision_tpu.accel.sah import build_sah
from vision_tpu.core.types import Ray
from vision_tpu import native

_DET_EPS, _EDGE_EPS = np.float32(1e-9), np.float32(1e-6)


def _soup(n, seed, scale=4.0):
    rs = np.random.RandomState(seed)
    p0 = rs.rand(n, 3).astype(np.float32) * scale
    e1 = rs.rand(n, 3).astype(np.float32) * 0.5 - 0.1
    e2 = rs.rand(n, 3).astype(np.float32) * 0.5 - 0.1
    return p0, e1, e2


def _rays(R, seed, scale=4.0, tmax=None):
    rs = np.random.RandomState(seed)
    o = (rs.rand(R, 3) * scale).astype(np.float32)
    d = rs.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = (np.full(R, 1e30, np.float32) if tmax is None
         else (rs.rand(R) * tmax).astype(np.float32))
    return Ray(origin=jnp.asarray(o), direction=jnp.asarray(d),
               t_max=jnp.asarray(t))


def _model_walk(sah, o, d, t_max, any_hit):
    """numpy model of native/trace.cu for one ray: near-child-first by the
    split axis, far child stacked with its entry distance, skipped on pop
    once a closer hit exists. Returns (t, prim_id)."""
    boxes, links, tris, prim = (np.asarray(a) for a in
                                (sah.boxes, sah.links, sah.tris, sah.prim))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(d) > 1e-12, 1.0 / d,
                       np.copysign(1e12, d)).astype(np.float32)

    def box(node, t_best):
        a = (boxes[node, 0:3] - o) * inv
        b = (boxes[node, 4:7] - o) * inv
        tn = np.minimum(a, b).max()
        tf = np.maximum(a, b).min()
        return (tf >= max(tn, 0.0)) and (tn < t_best), tn

    def tri(k, t_best):
        p0, e1, e2 = tris[k, 0:3], tris[k, 4:7], tris[k, 8:11]
        pv = np.cross(d, e2)
        det = np.dot(e1, pv)
        if not abs(det) > _DET_EPS:
            return -1.0
        inv_det = np.float32(1.0) / det
        tv = o - p0
        u = np.dot(tv, pv) * inv_det
        qv = np.cross(tv, e1)
        v = np.dot(d, qv) * inv_det
        t = np.dot(e2, qv) * inv_det
        ok = (u >= -_EDGE_EPS and v >= -_EDGE_EPS and u + v <= 1 + _EDGE_EPS
              and 0.0 < t < t_best)
        return t if ok else -1.0

    t_best, best, stack = t_max, -1, []
    live = t_best > 0 and box(0, t_best)[0]
    node = 0
    while live:
        a, b = links[node]
        if b > 0:
            for k in range(a, a + b):
                t = tri(k, t_best)
                if t > 0:
                    t_best, best = t, k
            if any_hit and best >= 0:
                break
        else:
            near, far = ((node + 1, a) if d[-b - 1] >= 0 else (a, node + 1))
            h_near, _ = box(near, t_best)
            h_far, t_far = box(far, t_best)
            if h_near and h_far:
                stack.append((far, t_far))
            if h_near or h_far:
                node = near if h_near else far
                continue
        live = False
        while stack:
            node, t_entry = stack.pop()
            if t_entry < t_best:
                live = True
                break
    return t_best, (prim[best] if best >= 0 else -1)


needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native SAH builder not built")


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sah_layout_invariants(seed):
    p0, e1, e2 = _soup(300 + 100 * seed, seed)
    sah = build_sah(p0, e1, e2)
    boxes, links = np.asarray(sah.boxes), np.asarray(sah.links)
    inner = links[:, 1] <= 0
    leaf = ~inner
    # every triangle row belongs to exactly one leaf, leaves hold <= 4
    cover = np.zeros(len(p0), int)
    for a, b in links[leaf]:
        assert 1 <= b <= 4
        cover[a:a + b] += 1
    assert (cover == 1).all()
    assert sorted(np.asarray(sah.prim).tolist()) == list(range(len(p0)))
    # children nest inside their parent; axis in {0, 1, 2}
    for i in np.nonzero(inner)[0]:
        assert 0 <= -links[i, 1] - 1 <= 2
        for c in (i + 1, links[i, 0]):
            assert (boxes[c, 0:3] >= boxes[i, 0:3]).all()
            assert (boxes[c, 4:7] <= boxes[i, 4:7]).all()
    # rows are the scene's triangles, bit for bit
    prim = np.asarray(sah.prim)
    np.testing.assert_array_equal(np.asarray(sah.tris)[:, 0:3], p0[prim])
    np.testing.assert_array_equal(np.asarray(sah.tris)[:, 8:11], e2[prim])


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_model_matches_dense_sweep(seed, any_hit):
    p0, e1, e2 = _soup(400, 10 + seed)
    sah = build_sah(p0, e1, e2)
    ray = _rays(160, 20 + seed, tmax=2.5 if any_hit else None)
    o, d, tm = (np.asarray(a) for a in (ray.origin, ray.direction, ray.t_max))
    got = [_model_walk(sah, o[i], d[i], tm[i], any_hit)
           for i in range(len(o))]
    t_m = np.array([g[0] for g in got], np.float32)
    id_m = np.array([g[1] for g in got])
    P0, E1, E2 = jnp.asarray(p0), jnp.asarray(e1), jnp.asarray(e2)
    if any_hit:
        occ = np.asarray(isect.occluded_brute(ray, P0, E1, E2))
        assert occ.any() and (~occ).any()
        np.testing.assert_array_equal(id_m >= 0, occ)
        return
    ref = isect.intersect_brute(ray, P0, E1, E2)
    id_r, t_r = np.asarray(ref.prim_id), np.asarray(ref.t)
    assert (id_r >= 0).any() and (id_r < 0).any()
    np.testing.assert_array_equal(id_m, id_r)
    hit = id_r >= 0
    np.testing.assert_allclose(t_m[hit], t_r[hit], rtol=1e-5)


@pytest.mark.parametrize("R", [1, 128, 300])
def test_kernel_wrapper_pads_rays_to_blocks(R):
    from vision_tpu.accel.cuda_trace import BLOCK, pack_rays
    ray = _rays(R, 3)
    rows = np.asarray(pack_rays(ray))
    assert rows.shape == (-(-R // BLOCK) * BLOCK, 8)
    np.testing.assert_array_equal(rows[:R, 0:3], np.asarray(ray.origin))
    np.testing.assert_array_equal(rows[:R, 3], np.asarray(ray.t_max))
    np.testing.assert_array_equal(rows[:R, 4:7], np.asarray(ray.direction))
    # padding rays have t_max = 0: the kernel reports them as misses
    assert (rows[R:] == 0).all()


@pytest.mark.parametrize("has_bvh,backend,has_sah,err,route", [
    (False, "cpu", False, None, "brute"),
    (False, "gpu", False, None, "triton"),
    (True, "cpu", False, None, "bvh"),
    (True, "cpu", True, None, "bvh"),
    (True, "gpu", True, None, "cuda"),
])
def test_route_choice(has_bvh, backend, has_sah, err, route):
    assert isect.choose_route(has_bvh, backend, has_sah, err) == route


@pytest.mark.parametrize("has_sah,err,match", [
    (False, None, "native SAH builder"),
    (True, "GPU traversal kernel unavailable: no nvcc", "no nvcc"),
])
def test_route_on_gpu_raises_without_kernel_or_tree(has_sah, err, match):
    with pytest.raises(RuntimeError, match=match):
        isect.choose_route(True, "gpu", has_sah, err)


def _small_bvh_scene(res=16):
    from tests.fixtures import make_sphere_cbox
    from vision_tpu.scene.scene import Scene
    # 4 * 24^2 sphere triangles + the box: just past the BVH threshold
    sc = Scene(make_sphere_cbox(sub_div=24, res=res))
    assert sc.data.tri_p0.shape[0] > 2048
    return sc


def _film_points(camera, seed=7):
    """One jittered film point per pixel. Pixel centres of this symmetric
    camera fall exactly on quad diagonals and wall corners, where two
    triangles tie in t and either is a correct closest hit."""
    W, H = camera.resolution
    pix = np.arange(W * H)
    jitter = np.random.RandomState(seed).rand(W * H, 2)
    return jnp.asarray(np.stack([pix % W, pix // W], -1) + jitter,
                       jnp.float32)


@needs_native
def test_scene_route_by_triangle_count(cbox_scene):
    assert cbox_scene.data.bvh is None and cbox_scene.data.sah is None
    sc = _small_bvh_scene()
    assert sc.data.bvh is not None and sc.data.sah is not None
    ray = sc.camera.generate_ray(_film_points(sc.camera),
                                 jnp.zeros((256, 2)))
    hit, trunc = isect.trace(sc.data, ray)
    ref, _ = isect.trace(sc.data.replace(bvh=None, sah=None), ray)
    assert int(trunc) == 0
    np.testing.assert_array_equal(np.asarray(hit.prim_id),
                                  np.asarray(ref.prim_id))
    np.testing.assert_allclose(np.asarray(hit.bary), np.asarray(ref.bary),
                               atol=1e-6)


def test_gradient_rule_same_on_bvh_and_brute_routes():
    """Camera-pose and material gradients on a BVH scene equal the brute
    route's: traversal carries no cotangent, t and bary are recomputed from
    the winning prim on every route."""
    from vision_tpu.core import rng
    from vision_tpu.diff.optimize import apply_params, param_surface
    from vision_tpu.integrator import pt
    sc = _small_bvh_scene(res=12)
    W, H = sc.camera.resolution
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    p_film = _film_points(sc.camera)

    def loss(params, scene, camera):
        scene, camera = apply_params(scene, camera, params)
        ray = camera.generate_ray(p_film)
        L, _ = pt.radiance(scene, ray, rng.seed(pix, jnp.uint32(3)),
                           max_depth=2, remat=True)
        return jnp.mean(L * L)

    params = param_surface(sc.data, sc.camera, ("materials", "camera"))
    step = jax.jit(jax.value_and_grad(loss))
    l_b, g_b = step(params, sc.data, sc.camera)
    l_r, g_r = step(params, sc.data.replace(bvh=None, sah=None), sc.camera)
    np.testing.assert_allclose(float(l_b), float(l_r), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g_b), jax.tree.leaves(g_r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-7)
    g_cam = np.asarray(g_b["camera"]["c2w"])
    assert np.isfinite(g_cam).all() and np.abs(g_cam).sum() > 0


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris,R", [(36, 200), (300, 513)])
def test_triton_sweep_matches_xla_sweep(any_hit, n_tris, R):
    """The Pallas-Triton dense sweep (GPU route for small scenes) in
    interpret mode against the XLA sweep: same ids, ties to the lowest."""
    from vision_tpu.accel.sweep_triton import sweep_triton
    p0, e1, e2 = (jnp.asarray(a) for a in _soup(n_tris, 30 + n_tris))
    ray = _rays(R, 40 + R, tmax=3.0 if any_hit else None)
    t, out = sweep_triton(ray, p0, e1, e2, any_hit=any_hit, interpret=True)
    assert t.shape == (R,) and out.shape == (R,)
    if any_hit:
        ref = np.asarray(isect.occluded_brute(ray, p0, e1, e2))
        np.testing.assert_array_equal(np.asarray(out) > 0, ref)
        return
    ref = isect.intersect_brute(ray, p0, e1, e2)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref.prim_id))
    np.testing.assert_allclose(np.asarray(t), np.asarray(ref.t), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bvh_scene", [False, True])
def test_gpu_route_matches_xla_sweep(cbox_scene, bvh_scene):
    """On the card: the Triton sweep (small scene) or the CUDA kernel (BVH
    scene) against the XLA dense sweep, closest and any hit."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this path")
    sc = _small_bvh_scene() if bvh_scene else cbox_scene
    d = sc.data
    cam = sc.camera.replace(resolution=(16, 16))
    ray = cam.generate_ray(_film_points(cam), jnp.zeros((256, 2)))
    hit, trunc = isect.trace(d, ray)
    ref = isect.intersect_brute(ray, d.tri_p0, d.tri_e1, d.tri_e2)
    assert int(trunc) == 0
    np.testing.assert_array_equal(np.asarray(hit.prim_id),
                                  np.asarray(ref.prim_id))
    shadow = ray.replace(t_max=jnp.full((256,), 7.0))
    occ, _ = isect.trace(d, shadow, any_hit=True)
    np.testing.assert_array_equal(
        np.asarray(occ),
        np.asarray(isect.occluded_brute(shadow, d.tri_p0, d.tri_e1,
                                        d.tri_e2)))
