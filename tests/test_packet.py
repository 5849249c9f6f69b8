"""Packet traversal correctness: exact agreement with brute force on hits,
distances and interpolated attributes, across scenes and packet sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.accel.packet import (
    build_packet_bvh,
    make_packet_intersector,
)
from tracy_tpu.config import RenderConfig
from tracy_tpu.render.integrator import interpolate_hit, make_bruteforce_intersector
from tracy_tpu.render.renderer import Renderer, init_state
from tracy_tpu.scene.scn_parser import default_scene, load_scene


def _rays_for(scene, n):
    rng = np.random.default_rng(0)
    ss = jnp.asarray(rng.uniform(0.02, 0.98, n).astype(np.float32))
    tt = jnp.asarray(rng.uniform(0.02, 0.98, n).astype(np.float32))
    return scene.camera.generate_rays(ss, tt)


@pytest.mark.parametrize("packet_size", [64, 256])
def test_packet_matches_bruteforce(packet_size):
    scene = default_scene(32, 24).build()
    bvh, host = build_packet_bvh(scene, leaf_size=16)
    isect_p = make_packet_intersector(scene, bvh, leaf_size=16,
                                      packet_size=packet_size)
    isect_bf = make_bruteforce_intersector(scene)

    o, d = _rays_for(scene, 512)
    act = jnp.ones(512, bool)
    hp, attrs = isect_p(o, d, act)
    hb = isect_bf(o, d, act)

    np.testing.assert_array_equal(np.asarray(hp.mask), np.asarray(hb.mask))
    m = np.asarray(hb.mask)
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hb.t)[m], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hp.uv)[m], np.asarray(hb.uv)[m],
                               rtol=1e-4, atol=1e-6)

    # Interpolated attributes match the gather-based reference path.
    ref = interpolate_hit(scene, hb, o, d)
    np.testing.assert_allclose(np.asarray(attrs.normal)[m],
                               np.asarray(ref.normal)[m], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(attrs.uv)[m],
                               np.asarray(ref.uv)[m], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(attrs.material)[m],
                                  np.asarray(ref.material)[m])


def test_packet_inactive_rays():
    scene = default_scene(16, 16).build()
    bvh, _ = build_packet_bvh(scene, leaf_size=16)
    isect = make_packet_intersector(scene, bvh, leaf_size=16, packet_size=64)
    o, d = _rays_for(scene, 128)
    act = jnp.zeros(128, bool).at[:5].set(True)
    hit, _ = isect(o, d, act)
    assert not np.asarray(hit.mask)[5:].any()


def test_packet_nondivisible_ray_count():
    scene = default_scene(16, 16).build()
    bvh, _ = build_packet_bvh(scene, leaf_size=16)
    isect = make_packet_intersector(scene, bvh, leaf_size=16, packet_size=256)
    o, d = _rays_for(scene, 100)  # 100 % 256 != 0
    hit, attrs = isect(o, d, jnp.ones(100, bool))
    assert hit.t.shape == (100,)
    assert attrs.normal.shape == (100, 3)


def test_packet_render_matches_bruteforce_image(scene_file):
    b = load_scene(scene_file("cornell"))
    b.width, b.height = 32, 32
    scene = b.build()

    cfg_bf = RenderConfig(width=32, height=32, spp=2, tonemap="none", accel="none")
    r_bf = Renderer(cfg_bf)
    s_bf, rays_bf = r_bf.step(scene, init_state(cfg_bf))

    cfg_p = cfg_bf.replace(accel="packet", packet_leaf_size=32, packet_size=256)
    r_p = Renderer(cfg_p)
    s_p, rays_p = r_p.step(scene, init_state(cfg_p))

    np.testing.assert_allclose(
        np.asarray(s_bf.accum), np.asarray(s_p.accum), rtol=1e-5, atol=1e-6
    )
    assert int(rays_bf) == int(rays_p)


def test_packet_dragon_primary_rays(scene_file):
    b = load_scene(scene_file("dragon"))
    scene = b.build()
    bvh, host = build_packet_bvh(scene, leaf_size=64)
    isect_p = make_packet_intersector(scene, bvh, leaf_size=64, packet_size=256)
    isect_bf = make_bruteforce_intersector(scene, tri_chunk=4096)

    o, d = _rays_for(scene, 512)
    act = jnp.ones(512, bool)
    hp, _ = isect_p(o, d, act)
    hb = jax.jit(isect_bf)(o, d, act)
    np.testing.assert_array_equal(np.asarray(hp.mask), np.asarray(hb.mask))
    m = np.asarray(hb.mask)
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hb.t)[m], rtol=1e-6)
