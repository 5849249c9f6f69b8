"""Elastic failure recovery: checkpoints are mesh-agnostic.

The failure story (SURVEY.md §5 failure detection/recovery):
accum state + RNG streams are keyed by GLOBAL pixel/sample ids, so a
checkpoint written under one mesh shape restores onto ANY other shape —
lose half the devices, restore the last checkpoint on what remains, continue
bit-identically. Training state (params + Adam moments + step) resumes
exactly too; without the moments a resumed Adam run diverges.
"""

import jax
import numpy as np
import optax
import pytest

from tracy_tpu.config import RenderConfig
from tracy_tpu.diff import TrainableParams, extract_params
from tracy_tpu.parallel import (
    make_render_mesh,
    make_sharded_render_step,
    make_sharded_train_step,
    replicate_scene,
)
from tracy_tpu.render.renderer import Renderer, init_state
from tracy_tpu.scene.scn_parser import default_scene
from tracy_tpu.utils.checkpoint import (
    load_render_state,
    load_train_state,
    save_render_state,
    save_train_state,
)


@pytest.fixture(scope="module")
def scene():
    return default_scene(32, 32).build()


def test_render_restore_across_mesh_shapes(scene, tmp_path):
    """8-device 4x2 render, checkpoint, 'lose half the slice', restore the
    checkpoint on a 2x2 mesh of the surviving 4 devices: the finished image
    must be bit-identical to the uninterrupted 4x2 run (same 'sample' axis
    size -> same reduction order), and match the single-chip render."""
    assert len(jax.devices()) == 8
    cfg = RenderConfig(width=32, height=32, spp=2, max_bounces=3,
                       tonemap="none", accel="none")
    path = str(tmp_path / "elastic.npz")

    mesh_a = make_render_mesh(4, 2)
    step_a = make_sharded_render_step(cfg, mesh_a)
    sc_a = replicate_scene(scene, mesh_a)
    st = init_state(cfg)
    for _ in range(4):
        st, _ = step_a(sc_a, st)
    full = np.asarray(st.accum)

    st = init_state(cfg)
    for _ in range(2):
        st, _ = step_a(sc_a, st)
    save_render_state(path, st)

    mesh_b = make_render_mesh(2, 2, devices=jax.devices()[:4])
    step_b = make_sharded_render_step(cfg, mesh_b)
    sc_b = replicate_scene(scene, mesh_b)
    st_b = load_render_state(path, mesh=mesh_b)
    assert int(np.asarray(st_b.frame)) == 2
    for _ in range(2):
        st_b, _ = step_b(sc_b, st_b)

    np.testing.assert_array_equal(full, np.asarray(st_b.accum))

    # And down to a single chip (reduction order differs only in the spp
    # mean: allclose).
    st_c = load_render_state(path)
    r = Renderer(cfg)
    for _ in range(2):
        st_c, _ = r.step(scene, st_c)
    np.testing.assert_allclose(full, np.asarray(st_c.accum),
                               atol=3e-6, rtol=1e-5)


def test_train_resume_bit_identical(scene, tmp_path):
    """4 Adam steps == 2 steps + save/load(params, moments, step) + 2 steps,
    restored onto a DIFFERENT mesh shape. Saving params alone would reset
    the moments and diverge."""
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=2,
                       tonemap="none", accel="none")
    opt = optax.adam(2e-2)
    target = jax.numpy.zeros((16, 16, 3), jax.numpy.float32) + 0.25
    path = str(tmp_path / "train.npz")

    mesh_a = make_render_mesh(4, 2)
    step_a, init_a = make_sharded_train_step(
        replicate_scene(scene, mesh_a), cfg, mesh_a, opt)
    params = extract_params(scene)
    opt_state = init_a
    for i in range(4):
        params, opt_state, loss = step_a(params, opt_state, target,
                                         jax.numpy.uint32(i))
    full = params

    params = extract_params(scene)
    opt_state = init_a
    for i in range(2):
        params, opt_state, _ = step_a(params, opt_state, target,
                                      jax.numpy.uint32(i))
    save_train_state(path, params, opt_state, 2)

    # Same mesh shape: resume is bit-identical.
    params_a, opt_a, start = load_train_state(path, TrainableParams, init_a)
    assert start == 2
    for i in range(start, 4):
        params_a, opt_a, _ = step_a(params_a, opt_a, target,
                                    jax.numpy.uint32(i))
    for a, b in zip(full, params_a):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # Different mesh shape: the gradient psum reduces in a different order
    # across 8 vs 4 devices — identical up to f32 summation order.
    mesh_b = make_render_mesh(2, 2, devices=jax.devices()[:4])
    step_b, init_b = make_sharded_train_step(
        replicate_scene(scene, mesh_b), cfg, mesh_b, opt)
    params_b, opt_b, start = load_train_state(path, TrainableParams, init_b)
    assert start == 2
    for i in range(start, 4):
        params_b, opt_b, _ = step_b(params_b, opt_b, target,
                                    jax.numpy.uint32(i))
    for a, b in zip(full, params_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-7, rtol=1e-6)


def test_cli_crash_resume(tmp_path):
    """The render CLI's -checkpoint flag: a 'crashed' 2-frame run resumed
    to 4 frames produces the same image as an uninterrupted 4-frame run."""
    from tracy_tpu.apps.render_cli import main

    ck = str(tmp_path / "cli.npz")
    out1 = str(tmp_path / "full.png")
    out2 = str(tmp_path / "resumed.png")
    base = ["-width", "24", "-height", "16", "-spp", "1", "-accel", "none",
            "-tonemap", "none", "-cpu"]
    assert main(base + ["-frames", "4", "-out", out1]) == 0
    # "crash" after 2 frames (checkpoint saved every frame)
    assert main(base + ["-frames", "2", "-out", str(tmp_path / "x.png"),
                        "-checkpoint", ck, "-checkpoint-every", "1"]) == 0
    assert main(base + ["-frames", "4", "-out", out2,
                        "-checkpoint", ck, "-checkpoint-every", "1"]) == 0
    from PIL import Image

    a = np.asarray(Image.open(out1))
    b = np.asarray(Image.open(out2))
    np.testing.assert_array_equal(a, b)
