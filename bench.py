"""Render benchmark on the GPU: the seeded 520K-triangle sphere grid at
1920x1080, 4 spp (4 progressive frames of 1 spp), 5 bounces, Russian
roulette on, sRGB tonemap, through the platform's default render path
(config.default_path).

Prints ONE JSON line on stdout naming the device it ran on:
  {"metric", "value", "unit", "reps", "compile_s", "device": {...}, "config"}
where value is the median MRays/s of 3 timed repetitions, with the
reference's ray accounting (one ray per live bounce iteration,
cpu_trace.cpp:113-116). Fails (non-zero exit, no JSON) where JAX finds no
GPU: a CPU number is not a device measurement.

Usage: python bench.py
"""

from __future__ import annotations

import json
import sys
import time

WIDTH, HEIGHT, SPP, BOUNCES, REPS = 1920, 1080, 4, 5, 3


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    import numpy as np

    from tracy_tpu.config import RenderConfig, default_path
    from tracy_tpu.render.renderer import Renderer, init_state
    from tracy_tpu.scene.procedural import sphere_grid
    from tracy_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    b = sphere_grid(WIDTH, HEIGHT)
    scene = b.build()
    path = default_path(dev.platform, WIDTH * HEIGHT, b.num_triangles,
                        b.has_translucent)
    # spp is realized as progressive frames of 1 spp (statistically
    # identical: the RNG sample axis advances with the frame counter).
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=1,
                       max_bounces=BOUNCES, russian_roulette=True,
                       tonemap="srgb", **path)
    r = Renderer(cfg)
    t0 = time.perf_counter()
    state, _ = r.step_many(scene, init_state(cfg), SPP)
    compile_s = time.perf_counter() - t0

    reps = []
    for _ in range(REPS):
        r.timer.reset()
        r.total_rays = 0.0
        state, _ = r.step_many(scene, init_state(cfg), SPP)
        reps.append(r.mrays_per_sec)
    if not np.isfinite(np.asarray(state.accum)).all():
        print("bench.py: non-finite image", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "spheregrid_1080p_4spp_mrays_per_s",
        "value": float(np.median(reps)),
        "unit": "MRays/s",
        "reps": reps,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "config": {"accel": cfg.accel,
                   "wave_compact_group": cfg.wave_compact_group,
                   "triangles": b.num_triangles},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
