"""Texture pipeline: sampling semantics (nearest/repeat/v-flip, texture.h:50-57),
sRGB decode at load, atlas packing, and the fully-textured helmet scene."""

import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.render.texture import sample_nearest
from tracy_tpu.scene.textures import TextureAtlas, srgb_to_linear_np


def _atlas_with(img):
    atlas = TextureAtlas()
    tid = atlas.add(img)
    data, table = atlas.pack()
    return jnp.asarray(data), jnp.asarray(table), tid


def test_nearest_sampling_centers():
    # 2x2 texture with distinct colors.
    img = np.zeros((2, 2, 4), np.float32)
    img[0, 0] = [1, 0, 0, 1]  # top-left
    img[0, 1] = [0, 1, 0, 1]  # top-right
    img[1, 0] = [0, 0, 1, 1]  # bottom-left
    img[1, 1] = [1, 1, 0, 1]  # bottom-right
    data, table, tid = _atlas_with(img)

    # GetPixel: i = frac(u)*w, j = frac(1-v)*h -> v=1 is image row 0 (top).
    uv = jnp.asarray([[0.25, 0.75], [0.75, 0.75], [0.25, 0.25], [0.75, 0.25]])
    tids = jnp.full((4,), tid, jnp.int32)
    out = np.asarray(sample_nearest(data, table, tids, uv))
    np.testing.assert_allclose(out[0], [1, 0, 0, 1])
    np.testing.assert_allclose(out[1], [0, 1, 0, 1])
    np.testing.assert_allclose(out[2], [0, 0, 1, 1])
    np.testing.assert_allclose(out[3], [1, 1, 0, 1])


def test_repeat_wrap():
    img = np.zeros((1, 2, 4), np.float32)
    img[0, 0] = [1, 0, 0, 1]
    img[0, 1] = [0, 1, 0, 1]
    data, table, tid = _atlas_with(img)
    uv = jnp.asarray([[0.25, 0.5], [1.25, 0.5], [-0.75, 0.5], [2.75, 0.5]])
    tids = jnp.full((4,), tid, jnp.int32)
    out = np.asarray(sample_nearest(data, table, tids, uv))
    np.testing.assert_allclose(out[0], [1, 0, 0, 1])
    np.testing.assert_allclose(out[1], [1, 0, 0, 1])  # frac(1.25)=0.25
    np.testing.assert_allclose(out[2], [1, 0, 0, 1])  # frac(-0.75)=0.25
    np.testing.assert_allclose(out[3], [0, 1, 0, 1])  # frac(2.75)=0.75


def test_bilinear_matches_gl_semantics():
    """sample_bilinear = the raster preview's GL_LINEAR filter
    (opengl_render.cpp:476-480): texel centers at half-integers, 2x2
    footprint, REPEAT wrap. At texel centers it equals nearest; between
    centers it interpolates; across the u=0 seam it wraps."""
    from tracy_tpu.render.texture import sample_bilinear

    img = np.zeros((2, 2, 4), np.float32)
    img[0, 0] = [1, 0, 0, 1]
    img[0, 1] = [0, 1, 0, 1]
    img[1, 0] = [0, 0, 1, 1]
    img[1, 1] = [1, 1, 0, 1]
    data, table, tid = _atlas_with(img)

    # Texel centers: bilinear == nearest exactly.
    centers = jnp.asarray(
        [[0.25, 0.75], [0.75, 0.75], [0.25, 0.25], [0.75, 0.25]])
    tids = jnp.full((4,), tid, jnp.int32)
    np.testing.assert_allclose(
        np.asarray(sample_bilinear(data, table, tids, centers)),
        np.asarray(sample_nearest(data, table, tids, centers)),
        atol=1e-6,
    )

    # Midpoint of the top row: average of the two top texels.
    mid = np.asarray(sample_bilinear(
        data, table, tids[:1], jnp.asarray([[0.5, 0.75]])))[0]
    np.testing.assert_allclose(mid, [0.5, 0.5, 0, 1], atol=1e-6)

    # Center of the texture: average of all four.
    c = np.asarray(sample_bilinear(
        data, table, tids[:1], jnp.asarray([[0.5, 0.5]])))[0]
    np.testing.assert_allclose(c, [0.5, 0.5, 0.25, 1], atol=1e-6)

    # u=0 on the top row: REPEAT wrap blends texel 1 and texel 0 equally.
    seam = np.asarray(sample_bilinear(
        data, table, tids[:1], jnp.asarray([[0.0, 0.75]])))[0]
    np.testing.assert_allclose(seam, [0.5, 0.5, 0, 1], atol=1e-6)

    # Constant texture: bilinear is exactly constant everywhere.
    flat = np.full((3, 5, 4), 0.3, np.float32)
    data2, table2, tid2 = _atlas_with(flat)
    uv = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (64, 2)),
                     jnp.float32)
    out = np.asarray(sample_bilinear(
        data2, table2, jnp.full((64,), tid2, jnp.int32), uv))
    np.testing.assert_allclose(out, 0.3, atol=1e-6)


def test_atlas_multiple_sizes():
    atlas = TextureAtlas()
    a = atlas.add(np.full((2, 3, 4), 0.25, np.float32))
    b = atlas.add(np.full((5, 4, 4), 0.75, np.float32))
    data, table = atlas.pack()
    data, table = jnp.asarray(data), jnp.asarray(table)
    out_a = np.asarray(sample_nearest(data, table, jnp.asarray([a]), jnp.asarray([[0.5, 0.5]])))
    out_b = np.asarray(sample_nearest(data, table, jnp.asarray([b]), jnp.asarray([[0.9, 0.1]])))
    np.testing.assert_allclose(out_a, 0.25)
    np.testing.assert_allclose(out_b, 0.75)


def test_srgb_decode_at_load():
    atlas = TextureAtlas()
    img = np.full((1, 1, 4), 0.5, np.float32)
    tid = atlas.add(img, srgb=True)
    data, _ = atlas.pack()
    np.testing.assert_allclose(data[0, :3], srgb_to_linear_np(np.float32(0.5)), rtol=1e-5)
    np.testing.assert_allclose(data[0, 3], 0.5)  # alpha untouched


@pytest.mark.slow
def test_helmet_scene_textured_render(scene_file):
    """Damaged Helmet: 5 jpg texture maps + HDR sky fallback; the textured
    basecolor AOV must show texture variation (not flat material albedo)."""
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import load_scene

    b = load_scene(scene_file("helmet"))
    b.width, b.height = 96, 72
    scene = b.build()
    assert len(b.atlas) == 6  # 5 maps + fallback sky
    assert b.num_triangles > 10000

    cfg = RenderConfig(width=96, height=72, aov="basecolor", tonemap="none")
    r = Renderer(cfg)
    st, _ = r.step(scene, init_state(cfg))
    img = np.asarray(st.accum)
    assert np.isfinite(img).all()
    cover = img.max(axis=-1) > 0.01
    assert cover.mean() > 0.1  # helmet visible
    # Texture variation: covered pixels are not a single flat color.
    assert img[cover].std(axis=0).max() > 0.05

    # Normal-mapped beauty render is finite.
    cfg2 = RenderConfig(width=96, height=72, spp=2, max_bounces=3)
    r2 = Renderer(cfg2)
    st2, _ = r2.step(scene, init_state(cfg2))
    assert np.isfinite(np.asarray(st2.accum)).all()
