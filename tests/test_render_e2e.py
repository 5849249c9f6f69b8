"""End-to-end render tests: furnace energy conservation, cornell sanity,
AOVs, accumulation. The furnace scene is the reference's own correctness
fixture ("sphere color should be exactly 0.18", data/scenes/furnace.scn:1-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.config import RenderConfig
from tracy_tpu.render import film
from tracy_tpu.render.renderer import Renderer, init_state
from tracy_tpu.scene.scn_parser import default_scene, load_scene


@pytest.fixture(scope="module")
def furnace_scene(scene_file):
    b = load_scene(scene_file("furnace"))
    b.width, b.height = 64, 48  # small for test speed; camera ratio from file kept
    return b.build()


# Expected furnace sphere radiance under Tracy's BRDF. The scene comment
# claims "exactly 0.18" (furnace.scn:3) but the reference's own scatter gives
# every bounce a lerp(.1, 1, metalness)=10% specular chance with specular
# color lerp(.85, albedo, metalness)=0.85 (material.h:252-260), so a diffuse
# sphere under a unit sky converges to 0.1*0.85 + 0.9*0.18 = 0.2465, and rays
# leave the convex sphere after exactly one bounce. We reproduce the BRDF,
# not the comment.
FURNACE_EXPECTED = 0.1 * 0.85 + 0.9 * 0.18


def test_furnace_energy_conservation(furnace_scene):
    cfg = RenderConfig(
        width=64, height=48, spp=16, max_bounces=5, tonemap="none",
        accel="none", russian_roulette=True,
    )
    r = Renderer(cfg)
    state = init_state(cfg)
    for _ in range(8):
        state, _rays = r.step(furnace_scene, state)
    img = np.asarray(state.accum)
    # Background pixels see the sky directly: exactly 1.
    corner = img[0, 0]
    np.testing.assert_allclose(corner, 1.0, rtol=1e-3)
    # Central sphere disk converges to the BRDF's furnace value.
    yy, xx = np.mgrid[0:48, 0:64]
    mask = (xx - 32) ** 2 + (yy - 24) ** 2 < 8**2
    np.testing.assert_allclose(img[mask].mean(), FURNACE_EXPECTED, rtol=0.02)


def test_furnace_no_roulette_matches(scene_file):
    """Same expectation without RR (pure analytic single-bounce paths)."""
    b = load_scene(scene_file("furnace"))
    b.width, b.height = 64, 48
    scene = b.build()
    cfg = RenderConfig(width=64, height=48, spp=32, max_bounces=3,
                       tonemap="none", accel="none", russian_roulette=False)
    r = Renderer(cfg)
    state, _ = r.step(scene, init_state(cfg))
    img = np.asarray(state.accum)
    yy, xx = np.mgrid[0:48, 0:64]
    mask = (xx - 32) ** 2 + (yy - 24) ** 2 < 8**2
    np.testing.assert_allclose(img[mask].mean(), FURNACE_EXPECTED, rtol=0.02)


def test_ray_counting(furnace_scene):
    cfg = RenderConfig(width=32, height=24, spp=1, max_bounces=5,
                       tonemap="none", accel="none", russian_roulette=False)
    r = Renderer(cfg)
    state = init_state(cfg)
    state, rays = r.step(furnace_scene, state)
    n = 32 * 24
    # Every pixel fires a primary ray; sky-only pixels die after 1 bounce, so
    # total rays is between N and N * max_bounces.
    assert n <= int(rays) <= n * 5


def test_accumulation_running_average():
    prev = jnp.full((2, 2, 3), 1.0)
    new = jnp.full((2, 2, 3), 0.0)
    # frame_counter=1 -> blend 1/2.
    out = np.asarray(film.accumulate(prev, new, 1.0))
    np.testing.assert_allclose(out, 0.5)
    # frame_counter=0 -> output = new frame entirely.
    out0 = np.asarray(film.accumulate(prev, new, 0.0))
    np.testing.assert_allclose(out0, 0.0)


def test_aov_views():
    scene = default_scene(48, 32).build()
    for aov in ("basecolor", "normals", "metalness", "roughness", "emissive", "depth"):
        cfg = RenderConfig(width=48, height=32, aov=aov, accel="none", tonemap="none")
        r = Renderer(cfg)
        state, _ = r.step(scene, init_state(cfg))
        img = np.asarray(state.accum)
        assert np.isfinite(img).all(), aov
        assert img.shape == (32, 48, 3)
        if aov == "basecolor":
            assert img.max() > 0.1  # spheres visible


def test_default_scene_renders_finite():
    scene = default_scene(48, 32).build()
    cfg = RenderConfig(width=48, height=32, spp=2, accel="none", tonemap="srgb")
    r = Renderer(cfg)
    state, _ = r.step(scene, init_state(cfg))
    img = r.display(state)
    assert np.isfinite(img).all()
    assert img.max() <= 1.0 and img.min() >= 0.0
    assert img.std() > 0.01  # not a constant image


def test_tonemap_u8_matches_reference_quantization():
    x = jnp.asarray([[[0.0, 0.5, 1.0]]])
    cfg = RenderConfig(tonemap="none")
    u8 = np.asarray(film.to_u8(film.tonemap(x, cfg)))
    # clamp(255.99 * x) -> 0, 127, 255
    np.testing.assert_array_equal(u8, [[[0, 127, 255]]])


def test_production_tier_image_on_cpu():
    """End-to-end image of the GPU default path (config.default_path) against
    the packet tier with wave compaction: different intersector
    implementations, same physics, so the images must agree."""
    import dataclasses

    from tracy_tpu.config import default_path

    builder = default_scene(64, 48)
    scene = builder.build()
    frames = 4

    def render(cfg):
        r = Renderer(cfg)
        st = init_state(cfg)
        for _ in range(frames):
            st, _ = r.step(scene, st)
        return np.asarray(st.accum)

    cfg_d = RenderConfig(width=64, height=48, spp=1, tonemap="none",
                         **default_path("gpu", 64 * 48,
                                        builder.num_triangles,
                                        builder.has_translucent))
    img_default = render(cfg_d)
    cfg_p = dataclasses.replace(cfg_d, accel="packet", wave_compact_group=2048)
    img_packet = render(cfg_p)

    assert np.isfinite(img_default).all()
    d = np.abs(img_packet - img_default)
    # ulp differences between the two traversals' arithmetic can flip
    # rare knife-edge winners; the images must agree everywhere else.
    assert float(np.mean(d)) < 2e-3, float(np.mean(d))
    assert (d < 1e-3).mean() > 0.995
