"""BVH builder + traversal tests: structural invariants and exact agreement
with the brute-force intersector (the oracle strategy SURVEY.md §7 asks for)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.accel.bvh import build_scene_bvh, intersect_bvh, make_bvh_intersector
from tracy_tpu.accel.bvh_build import build_bvh
from tracy_tpu.render.intersect import intersect_bruteforce
from tracy_tpu.scene.scn_parser import default_scene, load_scene


def _random_tris(n, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    tris = base + rng.normal(scale=0.4, size=(n, 3, 3))
    return tris.astype(np.float32)


def _bounds(tris):
    return tris.min(axis=1), tris.max(axis=1)


def test_build_structure():
    tris = _random_tris(500)
    tmin, tmax = _bounds(tris)
    bvh = build_bvh(tmin, tmax, leaf_size=8)
    meta = bvh.node_meta
    leaves = meta[meta[:, 1] > 0]
    inner = meta[meta[:, 1] == 0]
    # Every triangle in exactly one leaf.
    assert leaves[:, 1].sum() == 500
    assert sorted(np.asarray(bvh.tri_order)) == list(range(500))
    # Leaf sizes bounded.
    assert leaves[:, 1].max() <= 8
    # Full binary tree: #leaves = #inner + 1.
    assert len(leaves) == len(inner) + 1
    assert (inner[:, 0] > 0).all() and (inner[:, 2] > 0).all()
    assert bvh.max_depth < 60


def test_build_child_bounds_contained():
    tris = _random_tris(300, seed=1)
    tmin, tmax = _bounds(tris)
    bvh = build_bvh(tmin, tmax, leaf_size=4)
    nb = bvh.node_bounds
    for node, (a, cnt, b) in enumerate(bvh.node_meta):
        if cnt == 0:
            for child in (a, b):
                assert (nb[child][:3] >= nb[node][:3] - 1e-5).all()
                assert (nb[child][3:] <= nb[node][3:] + 1e-5).all()
        else:
            # Leaf bbox contains its triangles.
            ids = bvh.tri_order[a : a + cnt]
            assert (tmin[ids] >= nb[node][:3] - 1e-5).all()
            assert (tmax[ids] <= nb[node][3:] + 1e-5).all()


@pytest.mark.parametrize("num_tris,seed", [(37, 2), (500, 3), (2000, 4)])
def test_bvh_matches_bruteforce_random(num_tris, seed):
    from tracy_tpu.accel.bvh import device_bvh

    tris = _random_tris(num_tris, seed=seed)
    tmin, tmax = _bounds(tris)
    host = build_bvh(tmin, tmax, leaf_size=8)
    bvh = device_bvh(host, leaf_size=8)

    rng = np.random.default_rng(seed + 10)
    n_rays = 256
    o = jnp.asarray(rng.uniform(-8, 8, size=(n_rays, 3)).astype(np.float32))
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)

    p0 = jnp.asarray(tris[:, 0])
    e1 = jnp.asarray(tris[:, 1] - tris[:, 0])
    e2 = jnp.asarray(tris[:, 2] - tris[:, 0])

    brute = intersect_bruteforce(o, d, p0, e1, e2)

    order = np.asarray(bvh.tri_order)
    p0s = jnp.asarray(tris[order][:, 0])
    e1s = jnp.asarray(tris[order][:, 1] - tris[order][:, 0])
    e2s = jnp.asarray(tris[order][:, 2] - tris[order][:, 0])
    hb = intersect_bvh(o, d, p0s, e1s, e2s, bvh, leaf_size=8)

    np.testing.assert_array_equal(np.asarray(brute.mask), np.asarray(hb.mask))
    m = np.asarray(brute.mask)
    np.testing.assert_allclose(np.asarray(brute.t)[m], np.asarray(hb.t)[m], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(brute.tri)[m], np.asarray(hb.tri)[m])
    np.testing.assert_allclose(np.asarray(brute.uv)[m], np.asarray(hb.uv)[m], rtol=2e-4, atol=2e-6)


def test_bvh_scene_intersector_matches_bruteforce():
    from tracy_tpu.render.integrator import make_bruteforce_intersector

    scene = default_scene(32, 24).build()
    host, bvh = build_scene_bvh(scene, leaf_size=8)
    isect_bvh = make_bvh_intersector(scene, bvh, leaf_size=8)
    isect_bf = make_bruteforce_intersector(scene)

    ss, tt = jnp.meshgrid(jnp.linspace(0.05, 0.95, 16), jnp.linspace(0.05, 0.95, 12))
    o, d = scene.camera.generate_rays(ss.ravel(), tt.ravel())
    active = jnp.ones(o.shape[0], bool)

    hb = isect_bvh(o, d, active)
    hf = isect_bf(o, d, active)
    np.testing.assert_array_equal(np.asarray(hb.mask), np.asarray(hf.mask))
    m = np.asarray(hf.mask)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(hf.t)[m], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(hb.tri)[m], np.asarray(hf.tri)[m])


def test_bvh_cornell_render_matches_bruteforce(scene_file):
    """Full render equality: same RNG + same hits => identical images."""
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render.renderer import Renderer, init_state

    b = load_scene(scene_file("cornell"))
    b.width, b.height = 32, 32
    scene = b.build()
    host, bvh = build_scene_bvh(scene, leaf_size=8)

    cfg = RenderConfig(width=32, height=32, spp=2, tonemap="none", accel="none")
    r_bf = Renderer(cfg)
    s_bf, rays_bf = r_bf.step(scene, init_state(cfg))

    r_bvh = Renderer(cfg, intersector_factory=lambda sc: make_bvh_intersector(sc, bvh))
    s_bvh, rays_bvh = r_bvh.step(scene, init_state(cfg))

    np.testing.assert_allclose(
        np.asarray(s_bf.accum), np.asarray(s_bvh.accum), rtol=1e-5, atol=1e-6
    )
    assert int(rays_bf) == int(rays_bvh)


def test_single_triangle_bvh():
    tris = _random_tris(1)
    tmin, tmax = _bounds(tris)
    bvh = build_bvh(tmin, tmax, leaf_size=8)
    assert bvh.num_nodes == 1
    assert bvh.node_meta[0, 1] == 1
