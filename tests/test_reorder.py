"""Wave compaction (accel/reorder.py): routing exactness + render equality.

The butterfly routing must be a bit-exact permutation (forward compaction
and inverse scatter), and a render with per-wave compaction enabled must
match the uncompacted render — compaction only changes which packet a ray
traverses in, never its result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.accel.reorder import (
    compact_intersector,
    compact_rays,
    scatter_results,
)
from tracy_tpu.config import RenderConfig
from tracy_tpu.render.renderer import Renderer, init_state
from tracy_tpu.scene.scn_parser import default_scene, load_scene


@pytest.mark.parametrize("group,blocks,frac", [
    (8, 3, 0.5), (64, 2, 0.1), (1024, 2, 0.3), (4096, 1, 0.9),
])
def test_routing_bit_exact(group, blocks, frac):
    rng = np.random.default_rng(group + blocks)
    n = group * blocks
    alive = rng.uniform(size=n) < frac
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)

    o_c, d_c, a_c, dist_c, valid_c = jax.jit(
        compact_rays, static_argnums=3
    )(o, d, alive, group)
    o_c, a_c = np.asarray(o_c), np.asarray(a_c)
    d_c = np.asarray(d_c)

    for b in range(blocks):
        lo = b * group
        live_idx = np.where(alive[lo:lo + group])[0] + lo
        nl = len(live_idx)
        # live rays, stably compacted to the block front, bit-exact
        assert a_c[lo:lo + group].sum() == nl
        assert np.all(a_c[lo:lo + nl])
        np.testing.assert_array_equal(o_c[lo:lo + nl], o[live_idx])
        np.testing.assert_array_equal(d_c[lo:lo + nl], d[live_idx])

    # inverse: per-slot payload returns to the original ray order
    payload = np.concatenate([np.asarray(o_c), d_c], axis=1)
    r = np.asarray(jax.jit(scatter_results, static_argnums=3)(
        payload, dist_c, valid_c, group
    ))
    np.testing.assert_array_equal(r[alive, 0:3], o[alive])
    np.testing.assert_array_equal(r[alive, 3:6], d[alive])


def test_compacted_intersector_matches_plain():
    """Wrapper vs raw rich intersector on mixed live/dead rays."""
    from tracy_tpu.accel.packet import build_packet_bvh, make_packet_intersector

    scene = default_scene(32, 24).build()
    bvh, _ = build_packet_bvh(scene, leaf_size=64)
    isect = make_packet_intersector(scene, bvh, leaf_size=64,
                                    packet_size=1024, with_tangent=True)
    rng = np.random.default_rng(7)
    n = 4096
    ss = jnp.asarray(rng.uniform(0.02, 0.98, n).astype(np.float32))
    tt = jnp.asarray(rng.uniform(0.02, 0.98, n).astype(np.float32))
    o, d = scene.camera.generate_rays(ss, tt)
    act = jnp.asarray(rng.uniform(size=n) < 0.35)

    h0, a0 = isect(o, d, act)
    h1, a1 = compact_intersector(isect, group=2048)(o, d, act)

    live = np.asarray(act)
    np.testing.assert_array_equal(np.asarray(h1.mask), np.asarray(h0.mask) & live)
    m = np.asarray(h1.mask)
    np.testing.assert_array_equal(np.asarray(h1.t)[m], np.asarray(h0.t)[m])
    np.testing.assert_array_equal(np.asarray(h1.uv)[m], np.asarray(h0.uv)[m])
    np.testing.assert_array_equal(np.asarray(a1.normal)[m], np.asarray(a0.normal)[m])
    np.testing.assert_array_equal(np.asarray(a1.uv)[m], np.asarray(a0.uv)[m])
    np.testing.assert_array_equal(np.asarray(a1.material)[m],
                                  np.asarray(a0.material)[m])


def test_pick_compact_group():
    from tracy_tpu.accel.reorder import pick_compact_group

    # 640x480: the old 262144 clamp padded +71%; bounded pad picks 65536.
    assert pick_compact_group(640 * 480) == 65536
    # 1080p: 262144 pads only +1.1% — keep the deep group.
    assert pick_compact_group(1920 * 1080) == 262144
    # Exact power of two: no padding at all.
    assert pick_compact_group(128 * 128) == 16384
    # Every returned group is a power of two and the pad bound holds.
    for n in (307200, 2073600, 480000, 196608, 65536, 12000):
        g = pick_compact_group(n)
        assert g & (g - 1) == 0
        npad = -(-n // g) * g
        assert g == 2048 or (npad - n) / n <= 0.125
    # Scene-adaptive branch (COMPACT_MIN_TRIS=16384): opaque scenes below
    # the threshold skip the butterfly; larger and translucent scenes keep
    # it.
    n = 1920 * 1080
    assert pick_compact_group(n, num_tris=15452,
                              has_translucent=False) == 0
    assert pick_compact_group(n, num_tris=20108,
                              has_translucent=False) == 262144
    assert pick_compact_group(n, num_tris=13973,
                              has_translucent=True) == 262144


@pytest.mark.parametrize("scn", ["cornell", "trimesh"])
def test_render_equal_with_compaction(scn, scene_file):
    """Full progressive renders, with and without per-wave compaction."""
    b = load_scene(scene_file(scn))
    b.width, b.height = 64, 64
    scene = b.build()

    imgs = {}
    for grp, skip1 in ((0, True), (2048, True), (2048, False)):
        cfg = RenderConfig(width=64, height=64, spp=1, max_bounces=4,
                           accel="packet", wave_compact_group=grp,
                           wave_compact_skip_first=skip1)
        r = Renderer(cfg)
        state = init_state(cfg)
        for _ in range(2):
            state, _ = r.step(scene, state)
        imgs[grp, skip1] = np.asarray(state.accum)

    # The bounce-0 peel must be EXACTLY the compacted render: the primary
    # wave is all-live, so its compaction routing is an identity
    # permutation — peeling it changes nothing but the op count.
    np.testing.assert_array_equal(imgs[2048, True], imgs[2048, False])

    # identical physics; tiny tolerance for closest-hit ties between
    # equal-t triangles where packet composition may pick either winner.
    np.testing.assert_allclose(imgs[2048, True], imgs[0, True],
                               rtol=1e-5, atol=1e-5)
