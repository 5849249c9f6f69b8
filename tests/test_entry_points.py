"""The entry points a user calls, run in-process on the CPU at tiny sizes,
each on the platform's default render path (config.default_path)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCN = os.path.join(REPO, "tests", "goldens", "scn")


def test_graft_entry_forward_renders():
    import __graft_entry__ as g

    fn, args = g.entry()
    img = np.asarray(jax.jit(fn)(*args))
    assert img.shape == (128, 128, 3)
    assert np.isfinite(img).all() and img.std() > 0.01


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_render_cli_mesh_uses_default_accel(tmp_path):
    from tracy_tpu.apps import render_cli

    out = str(tmp_path / "mesh.png")
    rc = render_cli.main(["-scene", os.path.join(SCN, "cornell.scn"),
                          "-width", "32", "-height", "32", "-spp", "2",
                          "-frames", "2", "-mesh", "4x2", "-out", out])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_viewer_headless_burst(tmp_path):
    from tracy_tpu.apps import viewer

    out = str(tmp_path / "viewer.ppm")
    assert viewer.main(["-scene", os.path.join(SCN, "furnace.scn"),
                        "-width", "48", "-height", "32", "-frames", "2",
                        "-out", out]) == 0
    with open(out, "rb") as f:
        assert f.read(2) == b"P6"


def test_optimize_cli_selftest_albedo(tmp_path):
    from tracy_tpu.apps import optimize_cli

    rc = optimize_cli.main(["-width", "24", "-height", "16", "-spp", "2",
                            "-steps", "30", "-lr", "0.1", "-selftest",
                            "albedo", "-out", str(tmp_path / "r.ppm")])
    assert rc == 0


@pytest.mark.parametrize("accel,group", [("none", 0), ("bvh", 0),
                                         ("packet", 0), ("packet", 1024),
                                         ("tlas", 0)])
def test_build_accel_tiers(accel, group):
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render.renderer import build_accel
    from tracy_tpu.scene.procedural import sphere_grid

    scene = sphere_grid(32, 32, num_spheres=4, steps=8).build()
    cfg = RenderConfig(width=32, height=32, accel=accel,
                       wave_compact_group=group)
    acc = build_accel(scene, cfg)
    assert (acc.bind_first is not None) == (group > 0)
    n = 64
    o = jnp.tile(jnp.asarray([[0.0, 5.0, 14.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -0.3, -1.0]]), (n, 1))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    from tracy_tpu.utils.parity import hit_materials

    hit, _ = hit_materials(scene, acc.bind(scene, acc.data)(
        o, d, jnp.ones(n, bool)))
    assert np.asarray(hit.mask).all()


def test_step_many_equals_repeated_steps():
    from tracy_tpu.config import RenderConfig, default_path
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.procedural import sphere_grid

    b = sphere_grid(32, 32, num_spheres=4, steps=8)
    scene = b.build()
    cfg = RenderConfig(width=32, height=32, spp=1, tonemap="none",
                       **default_path("gpu", 32 * 32, b.num_triangles,
                                      b.has_translucent))
    r = Renderer(cfg)
    st = init_state(cfg)
    for _ in range(3):
        st, _ = r.step(scene, st)
    st_many, rays = Renderer(cfg).step_many(scene, init_state(cfg), 3)
    np.testing.assert_array_equal(np.asarray(st.accum),
                                  np.asarray(st_many.accum))
    assert int(st_many.frame) == 3 and int(rays) > 0
