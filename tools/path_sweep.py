#!/usr/bin/env python3
"""Time the kept render-path configurations on one device.

Renders the seeded sphere grid (tracy_tpu.scene.procedural.sphere_grid) at
the given size under each configuration, all else equal: warm-up (compile +
one run), then `--reps` timed runs of `Renderer.step_many` over `--frames`
progressive frames of 1 spp, 5 bounces, Russian roulette on. Prints one
line per run and a JSON summary with the median per configuration. All
configurations run in this one process, in the order given.

Configurations:
  packet          accel='packet', compaction off
  packet-compact  accel='packet', compaction group from pick_compact_group
  bvh             accel='bvh' (per-ray stack)

A configuration whose warm-up exceeds `--slow-s` gets no timed runs (its
warm-up time is still printed), and no configuration starts once
`--budget-s` has passed.

Usage:
  python tools/path_sweep.py --width 1920 --height 1080 --frames 4 --reps 3 \
      --configs bvh,packet-compact,packet
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--configs", default="bvh,packet-compact,packet")
    p.add_argument("--slow-s", type=float, default=1e9)
    p.add_argument("--budget-s", type=float, default=1e9)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from tracy_tpu.accel.reorder import pick_compact_group
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.procedural import sphere_grid
    from tracy_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    start = time.perf_counter()
    dev = jax.devices()[0]
    b = sphere_grid(args.width, args.height)
    scene = b.build()
    n = args.width * args.height
    fields = {
        "packet": {"accel": "packet", "wave_compact_group": 0},
        "packet-compact": {"accel": "packet",
                           "wave_compact_group": pick_compact_group(
                               n, num_tris=b.num_triangles,
                               has_translucent=b.has_translucent)},
        "bvh": {"accel": "bvh", "wave_compact_group": 0},
    }
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "width": args.width, "height": args.height,
           "frames": args.frames, "triangles": b.num_triangles,
           "results": {}}
    for name in args.configs.split(","):
        if time.perf_counter() - start > args.budget_s:
            print(f"[sweep] {name}: skipped, budget spent", flush=True)
            continue
        cfg = RenderConfig(width=args.width, height=args.height, spp=1,
                           max_bounces=5, russian_roulette=True,
                           tonemap="srgb", **fields[name])
        r = Renderer(cfg)
        t0 = time.perf_counter()
        r._ensure_accel(scene)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, _ = r.step_many(scene, init_state(cfg), args.frames)
        warm_s = time.perf_counter() - t0
        res = {"fields": fields[name], "accel_build_s": build_s,
               "warm_s": warm_s, "run_s": [], "mrays": []}
        print(f"[sweep] {name}: accel build {build_s:.3f}s, warm-up "
              f"(compile + run) {warm_s:.3f}s", flush=True)
        if warm_s <= args.slow_s:
            for _ in range(args.reps):
                r.timer.reset()
                r.total_rays = 0.0
                st, _ = r.step_many(scene, init_state(cfg), args.frames)
                res["run_s"].append(r.timer.total)
                res["mrays"].append(r.mrays_per_sec)
                print(f"[sweep] {name}: {r.timer.total:.4f}s "
                      f"{r.mrays_per_sec:.4f} MRays/s", flush=True)
        res["finite"] = bool(np.isfinite(np.asarray(st.accum)).all())
        if res["run_s"]:
            res["median_s"] = float(np.median(res["run_s"]))
            res["median_mrays"] = float(np.median(res["mrays"]))
        out["results"][name] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
