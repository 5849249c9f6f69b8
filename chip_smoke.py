#!/usr/bin/env python3
"""Smoke test of the path tracer on one NVIDIA GPU, in one process.

Drives the main path through the entry points a user calls, at full size,
and checks every result against the repository's own references. Any failed
check stops the run with a non-zero exit; the last line of standard output
is then not the result line. Phases, in order:

  1. device   - JAX must report a GPU; print its kind, the device count, the
                JAX version and nvidia-smi's name and power limit.
  2. hits     - the default intersector against brute force (accel='none')
                on 65,536 rays of the seeded 520K-triangle sphere grid at
                1080p: 32,768 primary rays plus 32,768 rays of one scattered
                bounce.
  3. goldens  - cornell, furnace, testtree, spheres and random at their
                native size through the default path, against the
                reference's own pixels (tracy_tpu/utils/parity.py).
  4. cpu      - one 256x256 1-spp frame of cornell on the GPU and on the
                CPU device of this process.
  5. main     - full size: the 1080p 4-spp sphere-grid render through
                Renderer, render_cli.main and viewer.main at 1080p on
                spheres.scn, and 3 training steps at 640x480 (materials on
                the beauty image, then vertex positions on the depth AOV).

With --four the script runs only the four-card path: the 1080p 4-spp
render over ('data','sample') meshes of 4x1 and 2x2 and one sharded
training step, each against the same work on card 0 alone.

The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Full sizes (the rehearsal on a CPU shrinks these module constants).
RENDER_W, RENDER_H = 1920, 1080  # render, CLI, viewer and four-card runs
TRAIN_W, TRAIN_H = 640, 480
GRID_SPHERES = 64  # sphere_grid: 64 UV spheres of 64 steps, ~520K tris
# Rays compared in the hit-parity phase: half primary, half one bounce.
HIT_RAYS = 65536
# Four-card phase: sharded and single-card images may differ only by float
# summation order (the 'sample' mean is taken in another order) and by
# the rare path that such a difference sends elsewhere.
FOUR_IMAGE_TOL = 1e-3  # |mean diff| of the linear image
FOUR_BLOCK_TOL = 0.05  # max |diff| of 16x16 block means
FOUR_LOSS_RTOL = 1e-4
# GPU against CPU (phase 4): same RNG streams, so only float ordering and
# the transcendental functions' last bits differ.
CPU_IMAGE_TOL = 5e-3
CPU_BLOCK_TOL = 0.05

LABEL = ""  # "[<card name>, <power limit>]", set in phase 1


def say(msg: str):
    print(f"{LABEL} {msg}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def peak_bytes(dev) -> str:
    stats = dev.memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "(not reported)"))


def builder_name() -> str:
    from tracy_tpu.utils.native import get_native_lib

    return "native" if get_native_lib() is not None else "numpy"


class StepClock:
    """Records the wall time and ray count of every Renderer.step and
    Renderer.step_many call, and the time of every build_accel, made while
    it is active (the entry points build their own Renderer)."""

    def __init__(self):
        self.steps = []  # (seconds, frames, rays)
        self.builds = []

    def __enter__(self):
        from tracy_tpu.render import renderer as R

        self._R = R
        self._orig = (R.Renderer.step, R.Renderer.step_many, R.build_accel)
        step, step_many, build = self._orig
        clock = self

        def timed_step(r, scene, state):
            t0 = time.perf_counter()
            state, rays = step(r, scene, state)
            clock.steps.append((time.perf_counter() - t0, 1, float(rays)))
            return state, rays

        def timed_step_many(r, scene, state, n):
            t0 = time.perf_counter()
            state, rays = step_many(r, scene, state, n)
            clock.steps.append((time.perf_counter() - t0, n, float(rays)))
            return state, rays

        def timed_build(scene, cfg):
            t0 = time.perf_counter()
            out = build(scene, cfg)
            clock.builds.append(time.perf_counter() - t0)
            return out

        R.Renderer.step = timed_step
        R.Renderer.step_many = timed_step_many
        R.build_accel = timed_build
        return self

    def __exit__(self, *exc):
        R = self._R
        R.Renderer.step, R.Renderer.step_many, R.build_accel = self._orig
        return False

    def report(self, name: str, dev):
        """First step = compile + accel build + frame; the rest are
        steady frames."""
        first, rest = self.steps[0], self.steps[1:]
        frames = sum(f for _, f, _ in rest)
        secs = sum(s for s, _, _ in rest)
        rays = sum(r for _, _, r in rest)
        build = sum(self.builds)
        say(f"{name}: first step (compile + accel build + frame) "
            f"{first[0]:.3f} s; accel build {build:.3f} s "
            f"({builder_name()} BVH builder); steady frame "
            f"{1e3 * secs / max(frames, 1):.3f} ms over {frames} frames; "
            f"{rays / 1e6 / secs:.3f} MRays/s; peak device memory "
            f"{peak_bytes(dev)} B")


def phase_device():
    global LABEL
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(2)
    smi = nvidia_smi()
    LABEL = f"[{smi}]"
    print(smi, flush=True)
    say(f"device: {dev.device_kind}, {len(jax.devices())} device(s), "
        f"jax {jax.__version__}, python {sys.version.split()[0]}")
    return dev


def render_cfg(builder, **kw):
    import jax

    from tracy_tpu.config import RenderConfig, default_path

    fields = default_path(jax.default_backend(),
                          builder.width * builder.height,
                          builder.num_triangles, builder.has_translucent)
    fields.update(kw)
    return RenderConfig(width=builder.width, height=builder.height, **fields)


def phase_hits(dev):
    """Default intersector vs brute force at real widths. All of it is
    float32 elementwise math with no contraction, so a TF32 matmul mode
    cannot enter either side."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tracy_tpu.render.integrator import make_bruteforce_intersector
    from tracy_tpu.render.renderer import build_accel
    from tracy_tpu.scene.procedural import sphere_grid
    from tracy_tpu.utils import parity

    b = sphere_grid(RENDER_W, RENDER_H, GRID_SPHERES)
    scene = b.build()
    cfg = render_cfg(b)
    t0 = time.perf_counter()
    accel = build_accel(scene, cfg)
    say(f"hits: {b.num_triangles} triangles, accel={cfg.accel} built in "
        f"{time.perf_counter() - t0:.3f} s ({builder_name()} BVH builder)")

    o, d, n_bounce = parity.primary_and_bounce_rays(
        scene, RENDER_W, RENDER_H, HIT_RAYS)
    say(f"hits: {n_bounce} scattered rays, {HIT_RAYS - n_bounce} primary "
        f"rays")
    brute = jax.jit(lambda sc, o, d: make_bruteforce_intersector(sc)(
        o, d, jnp.ones(o.shape[:1], bool)))
    default = jax.jit(lambda sc, data, o, d: accel.bind(sc, data)(
        o, d, jnp.ones(o.shape[:1], bool)))
    times = {}
    for name, fn, args in (("brute", brute, (scene, o, d)),
                           ("default", default, (scene, accel.data, o, d))):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(*args))
        times[name] = time.perf_counter() - t0
        if name == "brute":
            ref_hit, ref_mat = parity.hit_materials(scene, res)
        else:
            hit, mat = parity.hit_materials(scene, res)
    m_ref = np.asarray(ref_hit.mask)
    m = np.asarray(hit.mask)
    agree = float((m_ref == m).mean())
    both = m_ref & m
    t_ref = np.asarray(ref_hit.t)[both]
    rel = np.abs(np.asarray(hit.t)[both] - t_ref) / np.abs(t_ref)
    mat_bad = int((np.asarray(ref_mat)[both] != np.asarray(mat)[both]).sum())
    worst = float(rel.max()) if rel.size else 0.0
    say(f"hits: mask agreement {agree:.6f} ({int((m_ref != m).sum())} of "
        f"{HIT_RAYS} differ), {int(both.sum())} both hit, max |dt|/t "
        f"{worst:.3e}, material mismatches {mat_bad}; brute force "
        f"{times['brute']:.4f} s, {cfg.accel} {times['default']:.4f} s")
    assert agree >= 0.9999, f"hit masks agree on only {agree:.6f}"
    assert mat_bad == 0, f"{mat_bad} material ids differ"
    assert worst <= 1e-5, f"|dt|/t reaches {worst:.3e}"


def phase_goldens(dev):
    from tracy_tpu.render import film
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import load_scene
    from tracy_tpu.utils import parity

    for name, tol in parity.TOLERANCES.items():
        b = load_scene(os.path.join(parity.SCENE_DIR, f"{name}.scn"))
        scene = b.build()
        cfg = render_cfg(b, spp=1)
        r = Renderer(cfg)
        st = r.render_progressive(scene, tol.frames, state=init_state(cfg),
                                  steps_per_dispatch=tol.frames)
        ours = parity.ours_linear(film.tonemap(st.accum, cfg))
        dmean, p95, dmax = parity.check_parity(
            name, parity.load_golden(name), ours, tol)
        say(f"goldens: {name} {b.width}x{b.height} {tol.frames} frames "
            f"accel={cfg.accel}: mean {dmean:.4f} (tol {tol.mean}), p95 "
            f"{p95:.4f} (tol {tol.p95}), max {dmax:.4f} (tol {tol.max})")


def phase_cpu(dev):
    import jax
    import numpy as np

    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.scn_parser import load_scene
    from tracy_tpu.utils import parity

    b = load_scene(os.path.join(parity.SCENE_DIR, "cornell.scn"))
    b.width, b.height = 256, 256
    imgs = []
    for d in (dev, jax.devices("cpu")[0]):
        with jax.default_device(d):
            scene = b.build()
            cfg = render_cfg(b, spp=1, tonemap="none")
            r = Renderer(cfg)
            st, _ = r.step(scene, init_state(cfg))
            imgs.append(np.asarray(st.accum))
    g, c = imgs
    diff = np.abs(g - c)
    dmean = abs(float(g.mean()) - float(c.mean()))
    dblock = float(np.abs(parity.block_means(g) - parity.block_means(c)).max())
    say(f"cpu: cornell 256x256 1 spp: largest pixel difference "
        f"{float(diff.max()):.4e}, pixels differing by > 1e-4: "
        f"{int((diff.max(axis=-1) > 1e-4).sum())} of {256 * 256}, "
        f"|mean diff| {dmean:.3e} (tol {CPU_IMAGE_TOL}), max block-mean "
        f"diff {dblock:.3e} (tol {CPU_BLOCK_TOL})")
    assert np.isfinite(g).all() and np.isfinite(c).all()
    assert dmean <= CPU_IMAGE_TOL, f"GPU/CPU mean differs by {dmean}"
    assert dblock <= CPU_BLOCK_TOL, f"GPU/CPU block means differ by {dblock}"


def phase_render(dev):
    import numpy as np

    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.procedural import sphere_grid

    b = sphere_grid(RENDER_W, RENDER_H, GRID_SPHERES)
    scene = b.build()
    cfg = render_cfg(b, spp=1)
    with StepClock() as clock:
        r = Renderer(cfg)
        r.step_many(scene, init_state(cfg), 4)
        for _ in range(3):
            st, _ = r.step_many(scene, init_state(cfg), 4)
    assert np.isfinite(np.asarray(st.accum)).all(), "non-finite render"
    runs = [s for s, _, _ in clock.steps[1:]]
    say(f"render: sphere grid {RENDER_W}x{RENDER_H} 4 spp, accel={cfg.accel} "
        f"compact={cfg.wave_compact_group}: median of 3 runs "
        f"{statistics.median(runs):.4f} s ({[round(x, 4) for x in runs]})")
    clock.report("render", dev)


def phase_apps(dev, out_dir):
    from tracy_tpu.apps import render_cli, viewer
    from tracy_tpu.utils import parity

    scn = os.path.join(parity.SCENE_DIR, "spheres.scn")
    for name, main in (("cli", render_cli.main), ("viewer", viewer.main)):
        out = os.path.join(out_dir, f"{name}.png")
        with StepClock() as clock:
            rc = main(["-scene", scn, "-width", str(RENDER_W), "-height",
                       str(RENDER_H), "-frames", "4", "-out", out])
        assert rc == 0, f"{name} exited {rc}"
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", f"{name}: not a PNG"
        clock.report(f"{name} spheres.scn {RENDER_W}x{RENDER_H} 4 frames",
                     dev)


def phase_train(dev):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from tracy_tpu.diff import (
        extract_params, make_train_step, make_training_intersector,
    )
    from tracy_tpu.render.renderer import sample_radiance
    from tracy_tpu.scene.procedural import sphere_grid

    b = sphere_grid(TRAIN_W, TRAIN_H, GRID_SPHERES)
    scene = b.build()
    cfg = render_cfg(b, spp=4, max_bounces=5, tonemap="none",
                     russian_roulette=False)
    frame = jnp.asarray(3, jnp.int32)
    base = extract_params(scene)
    rng = np.random.default_rng(0)
    # Beauty renders of this scene carry no vertex gradient: its sky and
    # materials are constants, so geometry moves the image only through
    # discrete (detached) choices. The vertex step fits the depth AOV,
    # whose value is the recomputed hit distance.
    for fields, geometry, lr in (
            (("albedo", "roughness", "metalness"), False, 5e-2),
            (("vertex_pos",), True, 5e-3)):
        cfg = cfg.replace(aov="depth" if geometry else "beauty")
        t0 = time.perf_counter()
        isect = make_training_intersector(scene, cfg,
                                          needs_geometry_grads=geometry)
        build_s = time.perf_counter() - t0
        bound = isect.bind(scene) if hasattr(isect, "bind") else isect
        target, rays = jax.jit(
            lambda s: sample_radiance(s, cfg, frame, bound,
                                      getattr(bound, "first", None)))(scene)
        start = base
        for f in fields:
            x = getattr(base, f)
            if geometry:
                x = x + jnp.asarray(
                    rng.normal(0.0, 0.01, x.shape).astype(np.float32))
            else:
                x = jnp.clip(x + jnp.asarray(rng.uniform(
                    -0.2, 0.2, x.shape).astype(np.float32)), 0.02, 1.0)
            start = start._replace(**{f: x})
        mask = jax.tree_util.tree_map(lambda x: jnp.zeros_like(x, bool), base)
        for f in fields:
            mask = mask._replace(**{f: jnp.ones_like(getattr(base, f), bool)})
        step, opt = make_train_step(scene, cfg, optax.adam(lr),
                                    intersect_fn=isect, trainable_mask=mask)
        params, losses, times = start, [], []
        for _ in range(3):
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, target, frame)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        steady = statistics.median(times[1:])
        say(f"train {'+'.join(fields)} {TRAIN_W}x{TRAIN_H} 4 spp 5 bounces "
            f"aov={cfg.aov} accel={cfg.accel}: losses {losses}; first step "
            f"(compile + "
            f"step) {times[0]:.3f} s; steady step {steady:.4f} s; "
            f"{float(rays) / 1e6 / steady:.3f} MRays/s (forward rays per "
            f"step / step time); accel build {build_s:.3f} s "
            f"({builder_name()} BVH builder); peak device memory "
            f"{peak_bytes(dev)} B")
        assert all(np.isfinite(losses)), f"non-finite loss {losses}"
        assert losses[-1] < losses[0], f"loss did not fall: {losses}"


def phase_four(dev):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from tracy_tpu.diff import extract_params, make_training_intersector
    from tracy_tpu.parallel import (
        make_render_mesh, make_sharded_render_step, make_sharded_train_step,
        replicate_scene,
    )
    from tracy_tpu.render.renderer import Renderer, build_accel, init_state
    from tracy_tpu.scene.procedural import sphere_grid
    from tracy_tpu.utils import parity

    devs = jax.devices()
    assert len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}"
    b = sphere_grid(RENDER_W, RENDER_H, GRID_SPHERES)
    scene = b.build()
    cfg = render_cfg(b, spp=4)

    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # compile + warm
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        return out, time.perf_counter() - t0

    r = Renderer(cfg)
    r.step(scene, init_state(cfg))
    t0 = time.perf_counter()
    ref, _ = r.step(scene, init_state(cfg))
    t1 = time.perf_counter() - t0
    ref = np.asarray(ref.accum)
    say(f"four: card 0 alone {RENDER_W}x{RENDER_H} 4 spp accel={cfg.accel}: "
        f"{t1:.4f} s")
    for nd, ns in ((4, 1), (2, 2)):
        mesh = make_render_mesh(nd, ns, devices=devs)
        step = make_sharded_render_step(cfg, mesh,
                                        accel=build_accel(scene, cfg))
        sc = replicate_scene(scene, mesh)
        st, t = timed(step, sc, init_state(cfg))
        img = np.asarray(st[0].accum)
        same = bool((img == ref).all())
        dmean = abs(float(img.mean()) - float(ref.mean()))
        dblock = float(np.abs(parity.block_means(img)
                              - parity.block_means(ref)).max())
        say(f"four: mesh {nd}x{ns}: {t:.4f} s, scaling {t1 / t:.3f}x over "
            f"card 0 alone; bit-identical {same}; largest pixel difference "
            f"{float(np.abs(img - ref).max()):.3e}; |mean diff| {dmean:.3e} "
            f"(tol {FOUR_IMAGE_TOL}); max block-mean diff {dblock:.3e} "
            f"(tol {FOUR_BLOCK_TOL})")
        assert dmean <= FOUR_IMAGE_TOL and dblock <= FOUR_BLOCK_TOL

    tb = sphere_grid(TRAIN_W, TRAIN_H, GRID_SPHERES)
    tscene = tb.build()
    tcfg = render_cfg(tb, spp=4, tonemap="none", russian_roulette=False)
    isect = make_training_intersector(tscene, tcfg, needs_geometry_grads=False)
    target = jnp.zeros((TRAIN_H, TRAIN_W, 3), jnp.float32)
    frame = jnp.asarray(0, jnp.int32)
    losses = {}
    for nd, ns in ((1, 1), (2, 2)):
        mesh = make_render_mesh(nd, ns, devices=devs[:nd * ns])
        step, opt = make_sharded_train_step(
            replicate_scene(tscene, mesh), tcfg, mesh, optax.adam(1e-2),
            intersect_fn=isect)
        params = extract_params(tscene)
        (_, _, loss), t = timed(step, params, opt, target, frame)
        losses[(nd, ns)] = float(loss)
        say(f"four: train step on mesh {nd}x{ns}: {t:.4f} s, loss "
            f"{float(loss):.6e}")
    a, c = losses[(1, 1)], losses[(2, 2)]
    say(f"four: train loss bit-identical {a == c}; relative difference "
        f"{abs(a - c) / abs(a):.3e} (tol {FOUR_LOSS_RTOL})")
    assert abs(a - c) <= FOUR_LOSS_RTOL * abs(a)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card path and its comparison")
    args = p.parse_args(argv)

    import jax

    from tracy_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dev = phase_device()
    t_start = time.perf_counter()
    if args.four:
        phases = [phase_four]
    else:
        phases = [phase_hits, phase_goldens, phase_cpu, phase_render,
                  lambda d: phase_apps(d, out_dir), phase_train]
    with tempfile.TemporaryDirectory() as out_dir:
        for ph in phases:
            t0 = time.perf_counter()
            ph(dev)
            say(f"phase done in {time.perf_counter() - t0:.1f} s")
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
