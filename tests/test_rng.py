import jax.numpy as jnp
import numpy as np

from tracy_tpu.core.rng import RngSpec, uniform_fast


def test_uniform_range_and_determinism():
    idx = jnp.arange(10000, dtype=jnp.uint32)
    a = np.asarray(uniform_fast(0xABCDEF, idx, 0, 0, 0))
    b = np.asarray(uniform_fast(0xABCDEF, idx, 0, 0, 0))
    assert (a >= 0).all() and (a < 1).all()
    np.testing.assert_array_equal(a, b)


def test_uniform_decorrelated_across_counters():
    idx = jnp.arange(10000, dtype=jnp.uint32)
    a = np.asarray(uniform_fast(1, idx, 0, 0, 0))
    b = np.asarray(uniform_fast(1, idx, 1, 0, 0))
    c = np.asarray(uniform_fast(1, idx, 0, 1, 0))
    d = np.asarray(uniform_fast(1, idx, 0, 0, 1))
    for other in (b, c, d):
        assert abs(np.corrcoef(a, other)[0, 1]) < 0.05


def test_uniform_mean_variance():
    idx = jnp.arange(1 << 16, dtype=jnp.uint32)
    x = np.asarray(uniform_fast(7, idx, 3, 1, 2))
    assert abs(x.mean() - 0.5) < 0.01
    assert abs(x.var() - 1.0 / 12.0) < 0.01


def test_rngspec_threefry_runs():
    spec = RngSpec("threefry", 42)
    x = np.asarray(spec.uniform(jnp.arange(128, dtype=jnp.uint32), 0, 0, 0))
    assert (x >= 0).all() and (x < 1).all()


def test_rng_menu_quality():
    """The xorshift/LCG menu entries (reference random.h:9-97's
    compile-time algorithm choice, here a runtime knob) must each be
    deterministic, uniform, and decorrelated across counters."""
    idx = jnp.arange(1 << 16, dtype=jnp.uint32)
    for kind in ("fast", "xorshift", "lcg"):
        r = RngSpec(kind, 0xABCDEF)
        a = np.asarray(r.uniform(idx, 0, 0, 0))
        b = np.asarray(r.uniform(idx, 0, 0, 0))
        np.testing.assert_array_equal(a, b)
        assert (a >= 0).all() and (a < 1).all()
        assert abs(a.mean() - 0.5) < 0.01, kind
        assert abs(a.var() - 1.0 / 12.0) < 0.01, kind
        c = np.asarray(r.uniform(idx, 1, 0, 0))
        d = np.asarray(r.uniform(idx, 0, 1, 0))
        for other in (c, d):
            assert abs(np.corrcoef(a, other)[0, 1]) < 0.05, kind
    # distinct algorithms produce distinct streams
    f = np.asarray(RngSpec("fast", 1).uniform(idx, 0, 0, 0))
    x = np.asarray(RngSpec("xorshift", 1).uniform(idx, 0, 0, 0))
    l = np.asarray(RngSpec("lcg", 1).uniform(idx, 0, 0, 0))
    assert not np.array_equal(f, x) and not np.array_equal(f, l)


def test_rng_menu_renders(scene_file):
    """A couple of frames through the full renderer with each algorithm:
    finite image, furnace background exactly 1.0."""
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import load_scene

    b = load_scene(scene_file("furnace"))
    b.width, b.height = 64, 48
    scene = b.build()
    for kind in ("xorshift", "lcg"):
        cfg = RenderConfig(width=64, height=48, spp=2, accel="none",
                           rng=kind, tonemap="none")
        r = Renderer(cfg)
        st = init_state(cfg)
        st, _ = r.step(scene, st)
        acc = np.asarray(st.accum)
        assert np.isfinite(acc).all(), kind
        assert acc[2, 2, 0] == 1.0, kind
