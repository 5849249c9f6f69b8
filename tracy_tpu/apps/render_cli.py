"""Command-line renderer — the framework's `main()`.

Equivalent of the reference entry point (win_raytracer.cpp:431-589): parses
`-scene` / `-kernel`, loads the scene, runs progressive frames, reports
MRays/s + fps, and (beyond the reference, which never saves images) writes
the result to a PNG/PPM.

Kernels (reference -kernel CPURTX|CUDA|OpenGL|CPU, win_raytracer.cpp:48-56):
  pt      — wavefront path tracer, BVH (the CPURTX/CUDA analogue; default)
  pt-bf   — path tracer, brute-force intersection (the CUDA kernel's strategy)
  raster  — software rasterizer preview (the CPU/OpenGL raster analogue)

Usage:
  python -m tracy_tpu.apps.render_cli -scene data/scenes/cornell.scn \
      -frames 64 -spp 4 -out cornell.png [-kernel pt] [-aov normals] ...
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def human_count(n: float) -> str:
    """Reference TracySizeToHumanReadableString (win_raytracer.cpp:402-423)."""
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return str(int(n))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-scene", default=None, help=".scn file (default: builtin scene)")
    p.add_argument("-kernel", default="pt",
                   choices=["pt", "pt-bf", "raster", "raster-gl"])
    p.add_argument("-width", type=int, default=640)
    p.add_argument("-height", type=int, default=480)
    p.add_argument("-frames", type=int, default=16)
    p.add_argument("-spp", type=int, default=1)
    p.add_argument("-bounces", type=int, default=5)
    p.add_argument("-out", default="render.png")
    p.add_argument("-aov", default="beauty")
    p.add_argument("-tonemap", default="srgb",
                   choices=["none", "srgb", "aces", "reinhard"])
    p.add_argument("-exposure", type=float, default=1.0)
    p.add_argument("-data-root", default=None)
    p.add_argument("-no-rr", action="store_true", help="disable russian roulette")
    p.add_argument("-ray-chunk", type=int, default=0)
    p.add_argument("-accel", default=None,
                   choices=["packet", "tlas", "bvh", "none"],
                   help="acceleration tier (default: chosen per platform"
                        " and scene by config.default_path; none for pt-bf)")
    p.add_argument("-compact", type=int, default=None,
                   help="per-wave live-ray compaction group (rays; default:"
                        " config.default_path)")
    p.add_argument("-cpu", action="store_true", help="force the CPU backend")
    p.add_argument("-mesh", default=None,
                   help="multi-chip mesh as DATAxSAMPLE, e.g. 4x2")
    p.add_argument("-checkpoint", default=None,
                   help="checkpoint npz path: auto-resume if it exists, "
                        "auto-save every -checkpoint-every frames (crash "
                        "recovery; resume is bit-identical and works across "
                        "mesh shapes)")
    p.add_argument("-checkpoint-every", type=int, default=8,
                   help="frames between checkpoint saves (with -checkpoint)")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from tracy_tpu.config import RenderConfig, default_path
    from tracy_tpu.scene.scn_parser import default_scene, load_scene
    from tracy_tpu.utils.compile_cache import setup_compile_cache
    from tracy_tpu.utils.log import log

    if args.scene:
        builder = load_scene(args.scene, data_root=args.data_root,
                             width=args.width, height=args.height)
    else:
        builder = default_scene(args.width, args.height)
    scene = builder.build()

    log("objects: %s, triangles: %s" % (
        human_count(builder.num_objects), human_count(builder.num_triangles)))

    import jax

    setup_compile_cache()
    path = default_path(jax.default_backend(), builder.width * builder.height,
                        builder.num_triangles, builder.has_translucent)
    if args.accel is not None:
        accel = args.accel
    elif args.kernel == "pt-bf":
        accel = "none"
    else:
        accel = path["accel"]
    compact = args.compact
    if compact is None:
        compact = (path["wave_compact_group"]
                   if accel == path["accel"] else 0)

    cfg = RenderConfig(
        width=builder.width,
        height=builder.height,
        spp=args.spp,
        max_bounces=args.bounces,
        tonemap=args.tonemap,
        exposure=args.exposure,
        aov=args.aov,
        accel=accel,
        russian_roulette=not args.no_rr,
        ray_chunk=args.ray_chunk,
        wave_compact_group=compact,
    )

    if args.kernel in ("raster", "raster-gl"):
        from tracy_tpu.raster.rasterizer import render_raster

        shaded = args.kernel == "raster-gl"
        t0 = time.perf_counter()
        img = render_raster(scene, cfg, shaded=shaded)
        if shaded:
            from tracy_tpu.render import film

            img = film.tonemap(img, cfg)
        dt = time.perf_counter() - t0
        log("raster frame: %.3fs" % dt)
        _save(np.asarray(img), args.out)
        return 0

    from tracy_tpu.render.renderer import Renderer, build_accel

    if args.mesh:
        from tracy_tpu.parallel import (
            make_render_mesh, make_sharded_render_step, replicate_scene,
        )

        nd, ns = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_render_mesh(nd, ns)
        step = make_sharded_render_step(cfg, mesh,
                                        accel=build_accel(scene, cfg))
        scene = replicate_scene(scene, mesh)
        state, start = _resume_or_init(args, cfg, mesh=mesh)
        total_rays, t0 = 0.0, time.perf_counter()
        for f in range(start, args.frames):
            state, rays = step(scene, state)
            total_rays += float(rays)
            _maybe_checkpoint(args, state, f)
        jax.block_until_ready(state.accum)
        dt = time.perf_counter() - t0
        from tracy_tpu.render import film

        img = np.asarray(film.to_u8(film.tonemap(state.accum, cfg)))
        log("*** Performance: %.2f MRays/s and %.2f fps on average ***"
            % (total_rays / 1e6 / dt, args.frames / dt))
        _save(img, args.out)
        return 0

    r = Renderer(cfg)
    state, start = _resume_or_init(args, cfg)
    last_report = time.perf_counter()
    for f in range(start, args.frames):
        state, _rays = r.step(scene, state)
        _maybe_checkpoint(args, state, f)
        now = time.perf_counter()
        if now - last_report > 1.0 or f == args.frames - 1:
            # Reference window-title telemetry (win_raytracer.cpp:521-553).
            log("frame %d/%d: %.2f MRays/s @ %.2f fps"
                % (f + 1, args.frames, r.mrays_per_sec,
                   (f + 1) / max(r.timer.total, 1e-9)))
            last_report = now

    log("*** Performance: %.2f MRays/s and %.2f fps on average - Run time: %.1fs ***"
        % (r.mrays_per_sec, args.frames / max(r.timer.total, 1e-9), r.timer.total))
    _save(r.display_u8(state), args.out)
    return 0


def _resume_or_init(args, cfg, mesh=None):
    """(state, start_frame): resume from -checkpoint if the file exists
    (any mesh shape — checkpoints are elastic), else a fresh state."""
    import os

    from tracy_tpu.render.renderer import init_state
    from tracy_tpu.utils.log import log

    if args.checkpoint and os.path.exists(args.checkpoint):
        from tracy_tpu.utils.checkpoint import load_render_state

        state = load_render_state(args.checkpoint, mesh=mesh)
        start = int(np.asarray(state.frame))
        log(f"resumed {args.checkpoint} at frame {start}")
        return state, start
    return init_state(cfg), 0


def _maybe_checkpoint(args, state, frame_idx: int):
    if args.checkpoint and args.checkpoint_every > 0 and (
            (frame_idx + 1) % args.checkpoint_every == 0):
        from tracy_tpu.utils.checkpoint import save_render_state

        save_render_state(args.checkpoint, state)


def _save(img: np.ndarray, path: str):
    from tracy_tpu.utils.image_io import save_image
    from tracy_tpu.utils.log import log

    save_image(img, path)
    log(f"saved {path}")


if __name__ == "__main__":
    sys.exit(main())
