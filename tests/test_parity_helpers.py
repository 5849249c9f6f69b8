"""tracy_tpu.utils.parity: the shared image and hit parity helpers that the
golden tests and chip_smoke.py both use."""

import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.utils import parity


def _img(seed, shape=(32, 48, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_check_parity_passes_identical():
    a = _img(0)
    assert parity.check_parity("same", a, a.copy(),
                               parity.Tolerance(1, 0.0, 0.0, 0.0)) == (
        0.0, 0.0, 0.0)


@pytest.mark.parametrize("which", ["mean", "p95", "max"])
def test_check_parity_names_the_failing_metric(which):
    ref = _img(1)
    ours = ref.copy()
    if which == "mean":
        ours += 0.05  # every block moves: mean, p95 and max all move
        tol = parity.Tolerance(1, 0.01, 1.0, 1.0)
    elif which == "p95":
        ours[:, :24] += 0.05  # half the blocks
        tol = parity.Tolerance(1, 1.0, 0.01, 1.0)
    else:
        ours[:16, :16] += 0.5  # one block
        tol = parity.Tolerance(1, 1.0, 1.0, 0.1)
    with pytest.raises(AssertionError, match={"mean": "mean", "p95": "p95",
                                              "max": "block max"}[which]):
        parity.check_parity("x", ref, ours, tol)


def test_parity_metrics_rejects_shape_mismatch():
    with pytest.raises(ValueError):
        parity.parity_metrics(_img(0), _img(0, (16, 48, 3)))


def test_ours_linear_flips_and_linearizes():
    img = np.zeros((2, 1, 3), np.float32)
    img[0] = 1.0  # top row white
    white = parity.srgb_to_linear(255.0 / 255.99)  # the 255 quantum
    lin = parity.ours_linear(img)
    np.testing.assert_allclose(lin[1], white, rtol=1e-6)  # now the bottom row
    np.testing.assert_allclose(lin[0], 0.0)
    np.testing.assert_allclose(parity.ours_linear(img, flip=False)[0], white,
                               rtol=1e-6)


def test_golden_table_covers_in_repo_scenes():
    import os

    for name, tol in parity.TOLERANCES.items():
        assert os.path.exists(os.path.join(parity.SCENE_DIR, f"{name}.scn"))
        ref = parity.load_golden(name)
        assert ref.ndim == 3 and np.isfinite(ref).all()
        assert tol.frames > 0


def test_primary_and_bounce_rays():
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(32, 24).build()
    o, d, n_bounce = parity.primary_and_bounce_rays(scene, 32, 24, 256)
    assert o.shape == d.shape == (256, 3)
    assert 0 < n_bounce <= 128
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("rich", [False, True])
def test_hit_materials(rich):
    from tracy_tpu.accel.packet import PacketAttrs
    from tracy_tpu.render.intersect import Hit
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(8, 8).build()
    tri = jnp.asarray([0, scene.num_triangles - 1])
    hit = Hit(t=jnp.ones(2), tri=tri, uv=jnp.zeros((2, 2)),
              mask=jnp.ones(2, bool))
    want = np.asarray(scene.tri_material)[np.asarray(tri)]
    res = hit
    if rich:
        z = jnp.zeros((2, 3))
        res = (hit, PacketAttrs(normal=z, tangent=z, uv=jnp.zeros((2, 2)),
                                material=jnp.asarray(want)))
    got_hit, mat = parity.hit_materials(scene, res)
    assert got_hit is hit
    np.testing.assert_array_equal(np.asarray(mat), want)
