"""Runtime render configuration.

The reference exposes its knobs as a two-tier config: argv flags (`-scene`,
`-kernel`) plus a large compile-time CMake-cache -> preprocessor-define layer
(reference `CMakeLists.txt:23-116,169-215`: tonemap operator, exposure, max
bounces, russian roulette, sample accumulation, acceleration structure choice,
AOV debug views, RNG algorithm, tiling). Here all of those become one
runtime dataclass — everything is a `jit`-static field, so flipping a knob just
triggers a retrace instead of a rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


# AOV debug views, mirroring DEBUG_SHOW_* of reference CMakeLists.txt:23-35 /
# cpu_trace.cpp:127-137.
AOV_BEAUTY = "beauty"
AOV_BASECOLOR = "basecolor"
AOV_NORMALS = "normals"
AOV_METALNESS = "metalness"
AOV_ROUGHNESS = "roughness"
AOV_EMISSIVE = "emissive"
AOV_DEPTH = "depth"  # extra (not in reference): hit distance
AOVS = (
    AOV_BEAUTY,
    AOV_BASECOLOR,
    AOV_NORMALS,
    AOV_METALNESS,
    AOV_ROUGHNESS,
    AOV_EMISSIVE,
    AOV_DEPTH,
)

TONEMAP_NONE = "none"
TONEMAP_SRGB = "srgb"
TONEMAP_ACES = "aces"
TONEMAP_REINHARD = "reinhard"
TONEMAPS = (TONEMAP_NONE, TONEMAP_SRGB, TONEMAP_ACES, TONEMAP_REINHARD)

ACCEL_NONE = "none"  # brute force over all triangles (reference CUDA kernel behavior)
ACCEL_BVH = "bvh"  # per-ray-stack BVH traversal, all rays in lock-step
ACCEL_PACKET = "packet"  # packet traversal: one shared stack per ray packet
ACCEL_TLAS = "tlas"  # two-level TLAS/BLAS, stitched flat -> packet traversal
ACCELS = (ACCEL_NONE, ACCEL_BVH, ACCEL_PACKET, ACCEL_TLAS)

RNG_FAST = "fast"  # counter-based PCG-style hash (cheap, stateless)
RNG_XORSHIFT = "xorshift"  # xorshift32 permutation (reference random.h:22)
RNG_LCG = "lcg"  # Numerical-Recipes LCG (reference random.h:36)
RNG_THREEFRY = "threefry"  # jax.random keyed per (pixel, frame, bounce)
RNGS = (RNG_FAST, RNG_XORSHIFT, RNG_LCG, RNG_THREEFRY)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render. Hashable; safe as a jit-static arg."""

    width: int = 640
    height: int = 480

    # Path tracing quality — defaults match reference CMakeLists.txt:92-116.
    max_bounces: int = 5
    russian_roulette: bool = True
    accumulate: bool = True
    spp: int = 1  # samples per pixel per call (reference: 1 per frame, progressive)

    # Post-processing — reference TRACY_TONEMAPPING / TRACY_EXPOSURE.
    tonemap: str = TONEMAP_SRGB
    exposure: float = 1.0

    # Debug AOV view (reference DEBUG_VIEW).
    aov: str = AOV_BEAUTY

    # Intersection backend.
    accel: str = ACCEL_PACKET
    bvh_leaf_size: int = 8
    traversal_stack_depth: int = 40
    packet_leaf_size: int = 64  # dense-test granularity for accel='packet'
    packet_size: int = 1024  # rays per shared-stack packet

    # RNG algorithm (reference CPU_RAND_ALGORITHM).
    rng: str = RNG_FAST
    seed: int = 0xABCDEF  # reference random.h fixed seed

    # Ray chunking: rays per device-side wavefront chunk (0 = all at once).
    ray_chunk: int = 0

    # Per-wave live-ray compaction block (rays; 0 = off). Power of two,
    # a multiple of packet_size: each bounce, live rays are routed to the
    # front of every block by the gather-free butterfly in accel/reorder.py
    # so late waves hit few dense packets instead of many sparse ones.
    # Applies to the rich packet intersectors (accel='packet'/'tlas').
    wave_compact_group: int = 0
    # Peel bounce 0 out of the compacted bounce scan: the primary wave is
    # all-live, so its butterfly routing is an identity permutation — pure
    # overhead (2 full routings/sample). Bit-identical by construction;
    # only meaningful when wave_compact_group > 0.
    wave_compact_skip_first: bool = True

    # Compute dtype for shading math.
    dtype: str = "float32"

    def __post_init__(self):
        if self.tonemap not in TONEMAPS:
            raise ValueError(f"unknown tonemap {self.tonemap!r}; pick one of {TONEMAPS}")
        if self.aov not in AOVS:
            raise ValueError(f"unknown AOV {self.aov!r}; pick one of {AOVS}")
        if self.accel not in ACCELS:
            raise ValueError(f"unknown accel {self.accel!r}; pick one of {ACCELS}")
        if self.rng not in RNGS:
            raise ValueError(f"unknown rng {self.rng!r}; pick one of {RNGS}")
        if self.max_bounces < 1:
            raise ValueError("max_bounces must be >= 1")
        if self.spp < 1:
            raise ValueError("spp must be >= 1")
        g = self.wave_compact_group
        if g and (g & (g - 1) or g % self.packet_size):
            raise ValueError(
                "wave_compact_group must be a power of two multiple of "
                f"packet_size, got {g}"
            )

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def default_path(platform: str, num_pixels: int, num_tris: int,
                 has_translucent: bool) -> dict:
    """The intersector and compaction a render uses unless its caller names
    them, chosen from what the program can observe: the JAX platform and
    the scene's statistics. Every entry point takes its defaults here.

    Returns RenderConfig fields: {"accel": ..., "wave_compact_group": ...}.
    On the GPU the choice is the fastest of the kept configurations at the
    1080p, 4 spp sphere-grid render (PERF.md); no scene measured so far
    changes it, so the statistics do not enter yet. On the CPU the
    per-ray-stack BVH compiles fastest. Any other platform has no measured
    choice.
    """
    if platform == "gpu":
        # H100, 520K-triangle sphere grid, one 1080p frame: bvh 1.42 s,
        # packet + compaction 38.2 s, packet 70.0 s (PERF.md).
        return {"accel": ACCEL_BVH, "wave_compact_group": 0}
    if platform == "cpu":
        return {"accel": ACCEL_BVH, "wave_compact_group": 0}
    raise ValueError(f"no measured default render path for platform "
                     f"{platform!r} (known: gpu, cpu)")
