"""Counter-based stateless RNG.

The reference threads a mutable 32-bit PRNG state (xorshift/LCG/PCG, see
src/random.h:9-97) through every bounce — with a benign-but-real data race
when OpenMP threads share the static state (cpu_trace.cpp:42). Stateful PRNGs
do not map to XLA's pure-functional tracing, so here every draw is a
pure hash of (seed, pixel, frame, bounce, draw): deterministic, replayable and
shard-stable — a pixel gets the same sample sequence no matter which device
renders it.

Four implementations — the counter-based re-imagining of the reference's
compile-time menu (CPU_RAND_ALGORITHM rand/XorShift/LCG/PCG,
CMakeLists.txt:181-182, random.h:9-97):
  * `fast`: a PCG-style integer hash (a few integer ops per draw). This is the
    spiritual successor of the reference's default PCG (random.h:59-77).
  * `xorshift`: the xorshift32 permutation (random.h:22-34) applied twice to
    the mixed counter.
  * `lcg`: two Numerical-Recipes LCG steps (random.h:36-46), high bits out.
  * `threefry`: `jax.random` with `fold_in`, for auditing the fast path.
All are pure counter hashes; only the output permutation differs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Large odd constants for mixing the counter dimensions (Weyl-style).
# numpy scalars, NOT jnp arrays: a module-level jnp constant would
# initialize the XLA backend at import time, breaking
# jax.distributed.initialize's must-be-first contract (multi-process runs).
# uint32 arithmetic is identical either way.
_K_PIXEL = np.uint32(0x9E3779B9)
_K_FRAME = np.uint32(0x85EBCA6B)
_K_BOUNCE = np.uint32(0xC2B2AE35)
_K_DRAW = np.uint32(0x27D4EB2F)


def _pcg_hash(x: jnp.ndarray) -> jnp.ndarray:
    """PCG output permutation (RXS-M-XS), same family as reference random.h:59."""
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    x = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) * jnp.uint32(277803737)
    return (x >> jnp.uint32(22)) ^ x


def _xorshift_hash(x: jnp.ndarray) -> jnp.ndarray:
    """xorshift32 permutation (reference random.h:22-34), as a counter hash."""
    x = x ^ (x << jnp.uint32(13))
    x = x ^ (x >> jnp.uint32(17))
    return x ^ (x << jnp.uint32(5))


def _lcg_hash(x: jnp.ndarray) -> jnp.ndarray:
    """Numerical-Recipes LCG step (reference random.h:36-46)."""
    return x * jnp.uint32(1664525) + jnp.uint32(1013904223)


_HASHES = {
    "fast": _pcg_hash,
    # One xorshift pass has weak avalanche for counter inputs; two passes
    # (plus the Weyl-mixed counters) decorrelate adjacent pixels/draws.
    "xorshift": lambda x: _xorshift_hash(_xorshift_hash(x)),
    # A pure LCG is affine, and affine maps CANNOT decorrelate counter
    # streams (hash(h + K) == hash(h) + const; the reference's LCG only
    # works because it is sequential per-thread state, random.h:36-46).
    # Counter-based 'lcg' therefore xor-folds the high bits between the
    # two LCG steps — the multiply-xorshift construction (murmur-style)
    # with the reference's NR multiplier as the LCG stage.
    "lcg": lambda x: (lambda y: y ^ (y >> jnp.uint32(16)))(
        _lcg_hash((lambda y: y ^ (y >> jnp.uint32(16)))(_lcg_hash(x)))),
}


def _mix(seed, pixel, frame, bounce, draw, kind="fast"):
    hh = _HASHES[kind]
    h = jnp.uint32(seed) + jnp.uint32(pixel) * _K_PIXEL
    h = hh(h + jnp.uint32(frame) * _K_FRAME)
    h = hh(h + jnp.uint32(bounce) * _K_BOUNCE + jnp.uint32(draw) * _K_DRAW)
    return hh(h)


def uniform_fast(seed, pixel, frame, bounce, draw, dtype=jnp.float32,
                 kind="fast"):
    """Uniform [0, 1) from integer counters. All args broadcast together.

    `pixel` should be the *global* pixel index so sharding never changes the
    sample sequence.
    """
    bits = _mix(seed, pixel, frame, bounce, draw, kind)
    # 24-bit mantissa trick: uniform in [0, 1) with full float32 coverage.
    return (bits >> jnp.uint32(8)).astype(dtype) * dtype(1.0 / 16777216.0)


class RngSpec:
    """Per-render RNG: returns shaped uniform draws keyed by logical counters."""

    def __init__(self, kind: str, seed: int):
        if kind not in ("fast", "xorshift", "lcg", "threefry"):
            raise ValueError(f"unknown rng kind {kind!r}")
        self.kind = kind
        self.seed = seed

    def uniform(self, pixel_idx: jnp.ndarray, frame, bounce, draw) -> jnp.ndarray:
        """Uniform [0,1) shaped like pixel_idx. frame/bounce/draw are scalars."""
        if self.kind in ("fast", "xorshift", "lcg"):
            return uniform_fast(self.seed, pixel_idx, frame, bounce, draw,
                                kind=self.kind)
        key = jax.random.key(self.seed)
        key = jax.random.fold_in(key, frame)
        key = jax.random.fold_in(key, bounce)
        key = jax.random.fold_in(key, draw)
        # fold pixel in vectorized form: use random.bits keyed by the above and
        # hash with pixel index for decorrelation.
        base = jax.random.uniform(key, pixel_idx.shape)
        mixed = uniform_fast(self.seed ^ 0x5BD1E995, pixel_idx, frame, bounce, draw)
        return (base + mixed) % 1.0
