"""Gradient correctness: autodiff vs finite differences, and inverse-rendering
convergence. The counter-based RNG makes f(theta±h) share random numbers, so
central differences are exact up to smoothness (detached discrete decisions
change only at measure-zero boundaries)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tracy_tpu.config import RenderConfig
from tracy_tpu.diff import (
    TrainableParams,
    apply_params,
    extract_params,
    make_train_step,
    render_loss,
)
from tracy_tpu.render.renderer import sample_radiance
from tracy_tpu.scene.scn_parser import load_scene
from tracy_tpu.scene.scene import SceneBuilder


@pytest.fixture(scope="module")
def furnace_small(scene_file):
    b = load_scene(scene_file("furnace"))
    b.width, b.height = 24, 18
    return b.build()


def _mean_pixel(scene, cfg, params=None, frame=0):
    s = scene if params is None else apply_params(scene, params)
    radiance, _ = sample_radiance(s, cfg, jnp.asarray(frame, jnp.int32))
    return jnp.mean(radiance)


def test_albedo_gradient_matches_fd(furnace_small):
    """Albedo doesn't influence any detached decision when RR is off, so
    autodiff and FD must agree tightly."""
    cfg = RenderConfig(width=24, height=18, spp=2, max_bounces=3,
                       tonemap="none", russian_roulette=False, accel="none")
    params = extract_params(furnace_small)

    def f(albedo):
        return _mean_pixel(furnace_small, cfg, params._replace(albedo=albedo))

    g = jax.grad(f)(params.albedo)
    # FD on the grey material (id 1), red channel.
    h = 1e-3
    e = jnp.zeros_like(params.albedo).at[1, 0].set(1.0)
    fd = (f(params.albedo + h * e) - f(params.albedo - h * e)) / (2 * h)
    np.testing.assert_allclose(float(g[1, 0]), float(fd), rtol=2e-2)
    assert float(g[1, 0]) > 0  # brighter albedo -> brighter image


def test_emissive_gradient_matches_fd(furnace_small):
    cfg = RenderConfig(width=24, height=18, spp=2, max_bounces=3,
                       tonemap="none", russian_roulette=False, accel="none")
    params = extract_params(furnace_small)

    def f(emissive):
        return _mean_pixel(furnace_small, cfg, params._replace(emissive=emissive))

    g = jax.grad(f)(params.emissive)
    h = 1e-3
    # Sky material (slot 0) emission is linear in the image -> exact match.
    e = jnp.zeros_like(params.emissive).at[0, 1].set(1.0)
    fd = (f(params.emissive + h * e) - f(params.emissive - h * e)) / (2 * h)
    np.testing.assert_allclose(float(g[0, 1]), float(fd), rtol=5e-3)


def test_vertex_gradient_nonzero_depth():
    """Depth AOV is smooth in vertex positions: check FD agreement."""
    b = SceneBuilder(16, 16)
    b.set_sky_color((0, 0, 0))
    m = b.add_material((0.5, 0.5, 0.5), 1.0, 0.0)
    b.add_triangle((-2, -2, -3), (2, -2, -3), (0, 2, -3), m)
    b.set_camera(eye=(0, 0, 2), center=(0, 0, -3), up=(0, 1, 0), fov_degrees=60)
    scene = b.build()
    cfg = RenderConfig(width=16, height=16, aov="depth", tonemap="none", accel="none")
    params = extract_params(scene)

    def f(vpos):
        return _mean_pixel(scene, cfg, params._replace(vertex_pos=vpos))

    g = jax.grad(f)(params.vertex_pos)
    assert np.isfinite(np.asarray(g)).all()
    # Moving all vertices away from the camera (-z) increases depth.
    dz = float(np.asarray(g)[:, 2].sum())
    h = 1e-3
    shift = jnp.zeros_like(params.vertex_pos).at[:, 2].add(1.0)
    fd = (f(params.vertex_pos + h * shift) - f(params.vertex_pos - h * shift)) / (2 * h)
    np.testing.assert_allclose(dz, float(fd), rtol=5e-2)
    assert dz < 0  # -z shift => farther => larger t; +z shift decreases depth


def test_texture_gradient_flows():
    b = SceneBuilder(16, 16)
    b.set_sky_color((1, 1, 1))
    m = b.add_material((1, 1, 1), 1.0, 0.0)
    tex = b.add_texture(np.full((4, 4, 4), 0.5, np.float32))
    b.set_material_texture(m, 0, tex)  # basecolor
    b.add_sphere((0, 0, -3), 1.0, m, steps=8)
    b.set_camera(eye=(0, 0, 1), center=(0, 0, -3), up=(0, 1, 0), fov_degrees=60)
    scene = b.build()
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3,
                       tonemap="none", russian_roulette=False, accel="none")
    params = extract_params(scene)

    def f(tex_data):
        return _mean_pixel(scene, cfg, params._replace(tex_data=tex_data))

    g = np.asarray(jax.grad(f)(params.tex_data))
    assert np.isfinite(g).all()
    assert np.abs(g[:, :3]).sum() > 0  # radiance depends on the albedo texels
    assert np.abs(g[:, 3]).sum() == 0  # alpha unused


def test_roulette_gradients_finite(furnace_small):
    """With RR on, gradients must stay finite (detached decisions)."""
    cfg = RenderConfig(width=24, height=18, spp=1, max_bounces=5,
                       tonemap="none", russian_roulette=True, accel="none")
    params = extract_params(furnace_small)
    g = jax.grad(
        lambda p: _mean_pixel(furnace_small, cfg, p)
    )(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_inverse_rendering_recovers_albedo(furnace_small):
    """Optimize the grey material's albedo to match a target rendered with a
    different albedo — the canonical differentiable-rendering demo."""
    cfg = RenderConfig(width=24, height=18, spp=4, max_bounces=3,
                       tonemap="none", russian_roulette=False, accel="none")

    # Target: albedo 0.6, rendered at a FIXED RNG frame. Optimizing with the
    # same frame makes the objective deterministic with its exact minimum at
    # 0.6 (the counter-based RNG gives identical sample paths), isolating the
    # gradient correctness from Monte Carlo noise.
    frame = jnp.asarray(7, jnp.int32)
    target_params = extract_params(furnace_small)
    target_params = target_params._replace(
        albedo=target_params.albedo.at[1].set(jnp.asarray([0.6, 0.6, 0.6]))
    )
    target, _ = sample_radiance(
        apply_params(furnace_small, target_params), cfg, frame
    )

    opt = optax.adam(1e-1)
    base = extract_params(furnace_small)
    mask = jax.tree_util.tree_map(lambda x: jnp.zeros_like(x, bool), base)
    mask = mask._replace(albedo=mask.albedo.at[1].set(True))
    step, opt_state = make_train_step(furnace_small, cfg, opt, trainable_mask=mask)
    params = extract_params(furnace_small)  # starts at 0.18

    losses = []
    for i in range(60):
        params, opt_state, loss = step(params, opt_state, target, frame)
        losses.append(float(loss))

    recovered = np.asarray(params.albedo[1])
    np.testing.assert_allclose(recovered, 0.6, atol=0.05)
    assert losses[-1] < losses[0] * 0.01


@pytest.mark.parametrize("accel", ["packet", "bvh"])
def test_training_forward_gradients_match_fd(furnace_small, accel):
    """Material gradients through the training intersector's zero-VJP
    forward: its discrete outputs carry all material-gradient paths, so
    autodiff == FD although the traversal itself is never differentiated."""
    from tracy_tpu.diff.gradients import make_training_intersector

    cfg = RenderConfig(width=24, height=18, spp=1, max_bounces=3,
                       tonemap="none", russian_roulette=False, accel=accel)
    isect = make_training_intersector(furnace_small, cfg,
                                      needs_geometry_grads=False)
    params = extract_params(furnace_small)

    def f(albedo):
        s = apply_params(furnace_small, params._replace(albedo=albedo))
        radiance, _ = sample_radiance(s, cfg, jnp.asarray(0, jnp.int32), isect)
        return jnp.mean(radiance)

    g = jax.grad(f)(params.albedo)
    h = 1e-3
    e = jnp.zeros_like(params.albedo).at[1, 0].set(1.0)
    fd = (f(params.albedo + h * e) - f(params.albedo - h * e)) / (2 * h)
    np.testing.assert_allclose(float(g[1, 0]), float(fd), rtol=2e-2)
    assert float(g[1, 0]) > 0


def _tri_depth_scene():
    b = SceneBuilder(16, 16)
    b.set_sky_color((0, 0, 0))
    m = b.add_material((0.5, 0.5, 0.5), 1.0, 0.0)
    b.add_triangle((-2, -2, -3), (2, -2, -3), (0, 2, -3), m)
    b.set_camera(eye=(0, 0, 2), center=(0, 0, -3), up=(0, 1, 0), fov_degrees=60)
    return b.build()


def _depth_fd_check(scene, cfg, isect_factory):
    """FD-vs-autodiff agreement of mean depth w.r.t. a global z shift, with
    the winner-recompute intersector rebuilt per evaluation (the winner
    tables are baked from the evaluation's own vertex positions)."""
    import dataclasses

    def f(vpos):
        s = dataclasses.replace(scene, vertex_pos=vpos)
        isect = isect_factory(jax.lax.stop_gradient(s))
        radiance, _ = sample_radiance(s, cfg, jnp.asarray(0, jnp.int32),
                                      isect.bind(s))
        return jnp.mean(radiance)

    vpos = scene.vertex_pos
    g = jax.grad(f)(vpos)
    assert np.isfinite(np.asarray(g)).all()
    dz = float(np.asarray(g)[:, 2].sum())
    h = 1e-3
    shift = jnp.zeros_like(vpos).at[:, 2].add(1.0)
    fd = (f(vpos + h * shift) - f(vpos - h * shift)) / (2 * h)
    np.testing.assert_allclose(dz, float(fd), rtol=5e-2)
    assert dz < 0  # -z shift => farther => larger depth


@pytest.mark.parametrize("accel", ["packet", "bvh"])
def test_geometry_diff_packet_fd(accel):
    """Vertex gradients through the winner-recompute intersector on each
    traversal base: the detached winner + Möller–Trumbore recompute must
    match finite differences (round 1's differentiable_geometry path could
    not reverse-differentiate at all: lax.while_loop has no reverse rule)."""
    from tracy_tpu.diff.gradients import make_training_intersector

    scene = _tri_depth_scene()
    cfg = RenderConfig(width=16, height=16, aov="depth", tonemap="none",
                       accel=accel)

    def factory(s):
        return make_training_intersector(s, cfg, needs_geometry_grads=True)

    _depth_fd_check(scene, cfg, factory)


def test_geometry_diff_compacted_fd():
    """Same FD check with per-wave compaction around the packet base: the
    winner-slot plane rides the compaction route into the same recompute."""
    from tracy_tpu.diff.gradients import GeometryDiffIntersector, make_training_intersector

    scene = _tri_depth_scene()
    cfg = RenderConfig(width=16, height=16, aov="depth", tonemap="none",
                       accel="packet", wave_compact_group=1024)

    def factory(s):
        isect = make_training_intersector(s, cfg, needs_geometry_grads=True)
        assert isinstance(isect, GeometryDiffIntersector)
        return isect

    _depth_fd_check(scene, cfg, factory)


def test_geometry_diff_recompute_consistent(furnace_small):
    """Bound recompute values must equal the base kernel's own outputs
    (same vertex data): t/uv/normal allclose on a real scene's primary wave."""
    from tracy_tpu.diff.gradients import make_training_intersector

    cfg = RenderConfig(width=24, height=18, accel="packet")
    isect = make_training_intersector(furnace_small, cfg,
                                      needs_geometry_grads=True)
    base = isect._base

    from tracy_tpu.core.camera import pixel_samples_rows
    h, w = 18, 24
    rows = jnp.arange(h, dtype=jnp.int32)
    ss, tt = pixel_samples_rows(
        w, h, rows, jnp.full((h, w), 0.5), jnp.full((h, w), 0.5)
    )
    o, d = furnace_small.camera.generate_rays(ss, tt)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    act = jnp.ones((h * w,), bool)

    hit0, at0, slot = base(o, d, act)
    hit1, at1 = isect.bind(furnace_small)(o, d, act)
    m = np.asarray(hit0.mask)
    assert m.any()
    np.testing.assert_allclose(np.asarray(hit1.t)[m], np.asarray(hit0.t)[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(hit1.uv)[m], np.asarray(hit0.uv)[m],
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(at1.normal)[m],
                               np.asarray(at0.normal)[m], atol=2e-3)
    assert (np.asarray(at1.material)[m] == np.asarray(at0.material)[m]).all()


def test_material_grads_with_compaction():
    """Wave compaction around the training intersector must not change the
    loss or the material gradients (routing is bit-exact selects)."""
    import jax
    import numpy as np

    from tracy_tpu.config import RenderConfig
    from tracy_tpu.diff import extract_params
    from tracy_tpu.diff.gradients import make_training_intersector, render_loss
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(32, 32).build()
    target = jax.numpy.zeros((32, 32, 3))
    frame = jax.numpy.asarray(1, jax.numpy.int32)
    outs = {}
    for grp in (0, 1024):
        cfg = RenderConfig(width=32, height=32, spp=1, accel="packet",
                           max_bounces=2, tonemap="none",
                           wave_compact_group=grp)
        isect = make_training_intersector(scene, cfg,
                                          needs_geometry_grads=False)
        params = extract_params(scene)
        loss, grads = jax.value_and_grad(
            lambda p: render_loss(p, scene, target, cfg, frame, isect)
        )(params)
        outs[grp] = (float(loss), np.asarray(grads.albedo))
    assert outs[0][0] == outs[1024][0]
    np.testing.assert_array_equal(outs[0][1], outs[1024][1])


def test_geometry_grads_with_compaction():
    """Slot-routing compaction around the geometry-training base must not
    change the loss or the vertex gradients."""
    import jax
    import numpy as np

    from tracy_tpu.config import RenderConfig
    from tracy_tpu.diff import extract_params
    from tracy_tpu.diff.gradients import (
        make_training_intersector, render_loss,
    )
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(32, 32).build()
    target = jax.numpy.zeros((32, 32, 3))
    frame = jax.numpy.asarray(1, jax.numpy.int32)
    outs = {}
    for grp in (0, 1024):
        cfg = RenderConfig(width=32, height=32, spp=1, accel="packet",
                           max_bounces=2, tonemap="none",
                           wave_compact_group=grp)
        isect = make_training_intersector(scene, cfg,
                                          needs_geometry_grads=True)
        params = extract_params(scene)
        loss, grads = jax.value_and_grad(
            lambda p: render_loss(p, scene, target, cfg, frame, isect)
        )(params)
        outs[grp] = (float(loss), np.asarray(grads.vertex_pos))
    assert outs[0][0] == outs[1024][0]
    np.testing.assert_array_equal(outs[0][1], outs[1024][1])


def _textured_scene():
    b = SceneBuilder(16, 16)
    b.set_sky_color((1, 1, 1))
    m = b.add_material((1, 1, 1), 1.0, 0.0)
    tex = b.add_texture(np.full((4, 4, 4), 0.5, np.float32))
    b.set_material_texture(m, 0, tex)  # basecolor
    plain = b.add_material((0.6, 0.5, 0.4), 1.0, 0.0)
    b.add_sphere((-0.6, 0, -3), 0.8, m, steps=8)
    b.add_sphere((0.7, 0, -3), 0.6, plain, steps=8)
    b.set_camera(eye=(0, 0, 1), center=(0, 0, -3), up=(0, 1, 0), fov_degrees=60)
    return b.build()


@pytest.mark.parametrize("accel", ["packet", "bvh"])
@pytest.mark.parametrize("field,index,rtol", [
    ("albedo", (2, 0), 2e-2),
    ("emissive", (0, 1), 5e-3),
    ("tex_data", (8, 1), 2e-2),
])
def test_training_loss_gradient_matches_fd(accel, field, index, rtol):
    """Each differentiable parameter kind through make_training_intersector
    and render_loss (the train step's loss), autodiff against central
    differences. Geometry is covered by test_geometry_diff_packet_fd."""
    from tracy_tpu.diff.gradients import make_training_intersector

    scene = _textured_scene()
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3,
                       tonemap="none", russian_roulette=False, accel=accel)
    isect = make_training_intersector(scene, cfg, needs_geometry_grads=False)
    target = jnp.zeros((16, 16, 3), jnp.float32)
    frame = jnp.asarray(1, jnp.int32)
    params = extract_params(scene)

    def f(x):
        return render_loss(params._replace(**{field: x}), scene, target, cfg,
                           frame, isect)

    x0 = getattr(params, field)
    g = np.asarray(jax.grad(f)(x0))[index]
    h = 1e-3
    e = jnp.zeros_like(x0).at[index].set(1.0)
    fd = (f(x0 + h * e) - f(x0 - h * e)) / (2 * h)
    assert g != 0.0
    np.testing.assert_allclose(float(g), float(fd), rtol=rtol)
