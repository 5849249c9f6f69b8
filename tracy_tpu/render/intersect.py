"""Ray-triangle intersection (wavefront, batched).

Möller–Trumbore with backface culling, matching the reference's semantics
exactly (collision::RayTriangle, src/collision.h:33-74): `det < EPS` culls
(degenerate + backfacing), `u`/`v` tested against EPS and det *before* the
division, `t` must be in (EPS, t_max), barycentrics returned as (u, v)/det.

The formulation is data-parallel in both rays and triangles: a lane-grid
[num_rays_chunk, num_tris_chunk] of independent tests reduced with a min over
the triangle axis, wrapped in a `lax.scan` over triangle chunks so working
sets stay bounded. No recursion, no per-ray loops — elementwise float32
math only (no contraction, so no reduced-precision matmul can enter).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tracy_tpu.core import math as tm

# numpy scalar, not a jnp array: module-level jnp constants initialize the
# XLA backend at import, breaking jax.distributed.initialize (multi-process).
import numpy as _np

FLT_MAX = _np.float32(3.4028235e38)


def inverse_direction(direction: jnp.ndarray) -> jnp.ndarray:
    """1/direction for slab tests, with components below 1e-12 in magnitude
    clamped to 1e-12 of the SAME sign: a tiny negative component must stay
    negative, or the slab interval flips and a box the ray enters through
    its far face is culled. (Avoids IEEE inf, whose 0*inf gives NaN.)"""
    return 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                           jnp.copysign(jnp.float32(1e-12), direction),
                           direction)


class Hit(NamedTuple):
    """SoA hit record (device analogue of reference HitData, common.h:237)."""

    t: jnp.ndarray  # [N] hit distance (FLT_MAX if miss)
    tri: jnp.ndarray  # [N] int32 triangle index (global soup index)
    uv: jnp.ndarray  # [N, 2] barycentric (u, v)
    mask: jnp.ndarray  # [N] bool hit mask


def ray_triangle_grid(
    origin: jnp.ndarray,  # [N, 3]
    direction: jnp.ndarray,  # [N, 3]
    p0: jnp.ndarray,  # [C, 3]
    e1: jnp.ndarray,  # [C, 3] = v1 - v0
    e2: jnp.ndarray,  # [C, 3] = v2 - v0
    t_max: jnp.ndarray,  # [N]
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All-pairs Möller–Trumbore: returns (t [N,C], u [N,C], v [N,C]).

    Missing pairs have t = FLT_MAX. u/v are already divided by det.
    """
    eps = jnp.float32(tm.EPS)
    d = direction[:, None, :]  # [N,1,3]
    pvec = jnp.cross(d, e2[None, :, :])  # [N,C,3]
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)  # [N,C]
    tvec = origin[:, None, :] - p0[None, :, :]  # [N,C,3]
    u = jnp.sum(tvec * pvec, axis=-1)  # [N,C]
    qvec = jnp.cross(tvec, e1[None, :, :])  # [N,C,3]
    v = jnp.sum(d * qvec, axis=-1)  # [N,C]
    t_scaled = jnp.sum(e2[None, :, :] * qvec, axis=-1)  # [N,C]

    inv_det = jnp.where(det > eps, 1.0 / jnp.where(det > eps, det, 1.0), 0.0)
    t = t_scaled * inv_det

    valid = (
        (det > eps)
        & (u >= eps)
        & (u <= det)
        & (v >= eps)
        & (u + v <= det)
        & (t > eps)
        & (t < t_max[:, None])
    )
    t = jnp.where(valid, t, FLT_MAX)
    return t, u * inv_det, v * inv_det


def intersect_bruteforce(
    origin: jnp.ndarray,  # [N, 3]
    direction: jnp.ndarray,  # [N, 3]
    p0: jnp.ndarray,  # [T, 3]
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    t_max: Optional[jnp.ndarray] = None,
    tri_chunk: int = 512,
    active: Optional[jnp.ndarray] = None,
) -> Hit:
    """Closest hit over the whole triangle soup (reference CUDA kernel's
    brute-force strategy, cuda_trace.cu:22-70, INCLUDING its AABB pre-cull
    — the reference slab-tests each mesh's box before its triangles
    (cuda_trace.cu:41-50); here the box rides each scanned CHUNK (the
    natural work unit here, finer than meshes) and a whole-chunk miss
    skips the MT via lax.cond.

    Scans over padded triangle chunks; [N, tri_chunk] live values at a time.
    """
    n = origin.shape[0]
    t_count = p0.shape[0]
    tri_chunk = min(tri_chunk, max(t_count, 1))
    num_chunks = -(-t_count // tri_chunk)
    pad = num_chunks * tri_chunk - t_count

    def pad_tris(x):
        return jnp.pad(x, ((0, pad), (0, 0))).reshape(num_chunks, tri_chunk, 3)

    # Padded triangles are all-zero -> det == 0 -> culled automatically.
    p0c, e1c, e2c = pad_tris(p0), pad_tris(e1), pad_tris(e2)

    # Per-chunk AABBs from the REAL (unpadded) triangles; padded slots
    # contribute inverted boxes that extend nothing.
    big = jnp.asarray(FLT_MAX, p0.dtype)
    vmin = jnp.minimum(p0, jnp.minimum(p0 + e1, p0 + e2))
    vmax = jnp.maximum(p0, jnp.maximum(p0 + e1, p0 + e2))
    cmin = jnp.pad(vmin, ((0, pad), (0, 0)), constant_values=big).reshape(
        num_chunks, tri_chunk, 3).min(axis=1)  # [C, 3]
    cmax = jnp.pad(vmax, ((0, pad), (0, 0)), constant_values=-big).reshape(
        num_chunks, tri_chunk, 3).max(axis=1)

    inv_d = inverse_direction(direction)

    t_max = jnp.full((n,), FLT_MAX) if t_max is None else t_max

    init = Hit(
        t=t_max,
        tri=jnp.zeros((n,), dtype=jnp.int32),
        uv=jnp.zeros((n, 2), dtype=origin.dtype),
        mask=jnp.zeros((n,), dtype=bool),
    )

    def body(carry: Hit, chunk):
        cp0, ce1, ce2, base, blo, bhi = chunk

        def mt(carry):
            t, u, v = ray_triangle_grid(origin, direction, cp0, ce1, ce2,
                                        carry.t)
            best = jnp.argmin(t, axis=-1)  # [N]
            rows = jnp.arange(t.shape[0])
            best_t = t[rows, best]
            improved = best_t < carry.t
            return Hit(
                t=jnp.where(improved, best_t, carry.t),
                tri=jnp.where(improved, base + best.astype(jnp.int32),
                              carry.tri),
                uv=jnp.where(
                    improved[:, None],
                    jnp.stack([u[rows, best], v[rows, best]], axis=-1),
                    carry.uv,
                ),
                mask=carry.mask | improved,
            )

        # Chunk AABB pre-cull (cuda_trace.cu:41-50 semantics, slab test of
        # collision.h:119-136): skip the whole chunk when NO ray's
        # interval reaches its box before the current best t.
        t0 = (blo - origin) * inv_d
        t1 = (bhi - origin) * inv_d
        tmn = jnp.minimum(t0, t1).max(axis=-1)
        tmx = jnp.maximum(t0, t1).min(axis=-1)
        any_hit = jnp.any((tmx >= jnp.maximum(tmn, 1e-8)) & (tmn < carry.t))
        return jax.lax.cond(any_hit, mt, lambda c: c, carry), None

    bases = (jnp.arange(num_chunks, dtype=jnp.int32) * tri_chunk)
    hit, _ = jax.lax.scan(body, init, (p0c, e1c, e2c, bases, cmin, cmax))
    if active is not None:
        hit = hit._replace(mask=hit.mask & active)
    return hit
