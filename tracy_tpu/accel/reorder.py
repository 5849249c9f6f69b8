"""Gather-free wave compaction: route live rays to the front of each block.

After the first bounce, rays scatter and die (sky misses, Russian
roulette): a 1024-ray packet keeps paying full traversal cost for a
handful of incoherent survivors (reference analogue: the thread-divergence
cost of cuda_trace.cu:73-135's per-pixel bounce loop). This module is
stream compaction written with dense algebra only (no gathers or
scatters):

  * each live ray's move distance within its block is the number of dead
    rays before it (exclusive cumsum of the dead mask);
  * the move executes as a log2(group)-stage BUTTERFLY: stage j shifts an
    element down by 2^j iff bit j of its distance is set. For a monotone
    routing (compaction keeps relative order, so current positions stay
    strictly increasing at every stage — see proof in _route) the stages
    are collision-free. Each stage is one static intra-block shift + a
    select: zero gathers, zero matmuls, O(planes * log group) HBM traffic;
  * a `valid` plane travels with the payload so stale copies left behind
    by a move can never source a later move;
  * the intersection results route BACK by running the same stages in
    reverse bit order with up-shifts (the exact inverse permutation).

Block-local compaction (group = a few adjacent 1024-ray packets, i.e. a
few adjacent 32x32 image tiles) preserves ray locality while concentrating
a wave's survivors into fewer dense packets; a fully-dead packet ends its
traversal without visiting a node.

Routing moves bit patterns verbatim (selects, no arithmetic), so the
wrapped intersector is bit-exact per ray vs the unwrapped one (up to
closest-hit ties between equal-t triangles, where packet composition may
legitimately pick either winner).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


# Compaction pays when the traversal cost it saves on sparse waves
# exceeds the butterfly routing it adds, which needs BOTH a high per-packet
# traversal cost (many triangles) AND rays that actually die. Translucent
# materials keep rays alive through every bounce, so a small translucent
# scene still wants compaction. The threshold is the smallest triangle
# count at which compaction paid in a sweep of seeded sphere grids; it
# was calibrated on the previous accelerator and is kept as code only
# (see PERF.md for the GPU default).
COMPACT_MIN_TRIS = 16384


def pick_compact_group(n_rays: int, max_group: int = 262144,
                       max_pad: float = 0.125,
                       num_tris: int | None = None,
                       has_translucent: bool | None = None) -> int:
    """Largest power-of-two compaction group <= max_group whose wave
    padding stays under max_pad; 0 (compaction off) for traversal-light
    OPAQUE scenes when scene statistics are given (see the regime notes
    above — translucent scenes keep rays alive too long to skip it).

    The compactor pads each wave up to a multiple of the group, and every
    padded lane traces as a dead ray. A naive "largest power of two <= n"
    clamp can still nearly double the wave: 640x480 = 307200 rays with
    group 262144 pads to 524288 (+71% dead lanes). Bigger groups compact
    better (deeper routing, denser packets), so take the largest group
    that keeps the pad overhead bounded.
    """
    if (num_tris is not None and num_tris < COMPACT_MIN_TRIS
            and has_translucent is False):
        return 0
    g = max_group
    while g > 2048:
        npad = -(-n_rays // g) * g
        if (npad - n_rays) / n_rays <= max_pad:
            return g
        g //= 2
    return g


def _stage_down(x, valid, dist, shift, group):
    """One butterfly stage, moving flagged elements DOWN by `shift`.

    x: [B, G, C]; valid: [B, G, 1] f32 0/1; dist: [B, G, 1] i32.
    An element moves iff it is valid and bit `shift` of its distance is
    set. Slots vacated without replacement keep a stale copy but lose
    their valid flag; moved-into slots become valid.
    """
    bit = jnp.int32(shift)

    def pull(a, fill):
        # incoming[p] = a[p + shift] (no wraparound: fill at the block end)
        pad = jnp.full_like(a[:, :shift], fill)
        return jnp.concatenate([a[:, shift:], pad], axis=1)

    moving = (valid > 0.5) & ((dist & bit) != 0)  # [B, G, 1] this slot leaves
    inc = pull(moving, False)  # [B, G, 1] True: slot p+shift's element arrives
    x = jnp.where(inc, pull(x, 0.0), x)
    dist = jnp.where(inc, pull(dist, 0), dist)
    valid = jnp.where(inc, 1.0, jnp.where(moving, 0.0, valid))
    return x, valid, dist


def _stage_up(x, valid, dist, shift, group):
    """Inverse butterfly stage: flagged elements move UP by `shift`."""
    bit = jnp.int32(shift)

    def push(a, fill):
        # incoming[p] = a[p - shift]
        pad = jnp.full_like(a[:, :shift], fill)
        return jnp.concatenate([pad, a[:, :-shift]], axis=1)

    moving = (valid > 0.5) & ((dist & bit) != 0)
    inc = push(moving, False)
    x = jnp.where(inc, push(x, 0.0), x)
    dist = jnp.where(inc, push(dist, 0), dist)
    valid = jnp.where(inc, 1.0, jnp.where(moving, 0.0, valid))
    return x, valid, dist


def _route(x, valid, dist, group: int, down: bool):
    """Run all butterfly stages (LSB->MSB down, MSB->LSB up).

    Collision-freedom: with c_i the current position of live element i
    after processing bits < j (c_i = i - (d_i & (2^j - 1))), for i < i'
    we have d_i' - d_i <= i' - i - 1 (distances count dead slots strictly
    before the element, and i itself is live) and (a & m) - (b & m) <= a-b
    for a >= b, m+1 a power of two; hence c_i' - c_i >= 1 at every stage —
    no two live elements ever occupy or move into the same slot.
    """
    stages = []
    s = 1
    while s < group:
        stages.append(s)
        s *= 2
    if not down:
        stages.reverse()
    step = _stage_down if down else _stage_up
    for s in stages:
        x, valid, dist = step(x, valid, dist, s, group)
    return x, valid, dist


def compact_rays(
    origin: jnp.ndarray, direction: jnp.ndarray, active: jnp.ndarray,
    group: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compact live rays to the front of each `group`-ray block.

    N must be a multiple of `group`. Returns (origin_c, direction_c,
    active_c, dist_c [N] i32, valid_c [N,1] f32) — the latter two feed
    `scatter_results` to route intersection outputs back.
    """
    n = origin.shape[0]
    b = n // group
    dead = (~active).astype(jnp.int32).reshape(b, group)
    # exclusive cumsum: dead slots strictly before each position.
    dist = (jnp.cumsum(dead, axis=1) - dead)[..., None]  # [B, G, 1]
    payload = jnp.concatenate([origin, direction], axis=1).reshape(b, group, 6)
    valid = active.astype(jnp.float32).reshape(b, group, 1)
    x, valid_c, dist_c = _route(payload, valid, dist, group, down=True)
    o_c = x[..., 0:3].reshape(n, 3)
    d_c = x[..., 3:6].reshape(n, 3)
    a_c = (valid_c > 0.5).reshape(n)
    return o_c, d_c, a_c, dist_c.reshape(n), valid_c.reshape(n)


def scatter_results(
    planes: jnp.ndarray, dist_c: jnp.ndarray, valid_c: jnp.ndarray,
    group: int,
) -> jnp.ndarray:
    """Route result planes [N, C] from compacted slots back to ray order."""
    n, c = planes.shape
    b = n // group
    x, _, _ = _route(
        planes.reshape(b, group, c),
        valid_c.reshape(b, group, 1),
        dist_c.astype(jnp.int32).reshape(b, group, 1),
        group,
        down=False,
    )
    return x.reshape(n, c)


def compact_intersector(intersect_fn, group: int = 4096,
                        route_tangent: bool = True):
    """Wrap a RICH IntersectFn (returns (Hit, PacketAttrs)) with per-wave
    live-ray compaction. Pads the ray count to a multiple of `group` with
    dead rays (the packet path packs rays into 1024-ray packets, so keep
    group a multiple of the packet size). route_tangent=False skips the tangent
    result planes (they are all-zero when no material has a normal map)."""
    assert group & (group - 1) == 0, "group must be a power of two"

    def wrapped(origin, direction, active):
        from tracy_tpu.accel.packet import PacketAttrs
        from tracy_tpu.render.intersect import FLT_MAX, Hit

        n = origin.shape[0]
        npad = -(-n // group) * group
        if npad != n:
            p = npad - n
            origin = jnp.pad(origin, ((0, p), (0, 0)))
            direction = jnp.pad(direction, ((0, p), (0, 0)),
                                constant_values=1.0)
            active = jnp.pad(active, (0, p))

        o_c, d_c, a_c, dist_c, valid_c = compact_rays(
            origin, direction, active, group
        )
        hit, attrs = intersect_fn(o_c, d_c, a_c)

        planes = [
            hit.t[:, None],
            hit.uv,
            hit.mask.astype(jnp.float32)[:, None],
            attrs.normal,
            attrs.uv,
            attrs.material.astype(jnp.float32)[:, None],
        ]
        if route_tangent:
            planes.append(attrs.tangent)
        r = scatter_results(
            jnp.concatenate(planes, axis=1), dist_c, valid_c, group
        )
        live = active[:n]
        mask = (r[:n, 3] > 0.5) & live
        hit_out = Hit(
            t=jnp.where(mask, r[:n, 0], FLT_MAX),
            tri=jnp.zeros((n,), jnp.int32),
            uv=jnp.where(live[:, None], r[:n, 1:3], 0.0),
            mask=mask,
        )
        attrs_out = PacketAttrs(
            normal=jnp.where(live[:, None], r[:n, 4:7], 0.0),
            tangent=(
                jnp.where(live[:, None], r[:n, 10:13], 0.0)
                if route_tangent else jnp.zeros((n, 3), r.dtype)
            ),
            uv=jnp.where(live[:, None], r[:n, 7:9], 0.0),
            material=jnp.where(
                live, jnp.round(r[:n, 9]), 0.0
            ).astype(jnp.int32),
        )
        return hit_out, attrs_out

    return wrapped


def compact_intersector_slot(intersect_fn, group: int = 4096,
                             route_tangent: bool = True):
    """compact_intersector for SLOT-returning rich intersectors
    ((o, d, act) -> (Hit, PacketAttrs, slot [N] i32)): the winner-slot
    plane rides the route as raw i32 bits (selects move bits verbatim).
    Used by the geometry-training path (diff/gradients.py)."""
    assert group & (group - 1) == 0, "group must be a power of two"

    def wrapped(origin, direction, active):
        from tracy_tpu.accel.packet import PacketAttrs
        from tracy_tpu.render.intersect import FLT_MAX, Hit

        n = origin.shape[0]
        npad = -(-n // group) * group
        if npad != n:
            p = npad - n
            origin = jnp.pad(origin, ((0, p), (0, 0)))
            direction = jnp.pad(direction, ((0, p), (0, 0)),
                                constant_values=1.0)
            active = jnp.pad(active, (0, p))

        o_c, d_c, a_c, dist_c, valid_c = compact_rays(
            origin, direction, active, group
        )
        hit, attrs, slot = intersect_fn(o_c, d_c, a_c)

        slot_bits = jax.lax.bitcast_convert_type(
            slot.astype(jnp.int32), jnp.float32)
        planes = [
            hit.t[:, None],
            hit.uv,
            hit.mask.astype(jnp.float32)[:, None],
            attrs.normal,
            attrs.uv,
            attrs.material.astype(jnp.float32)[:, None],
            slot_bits[:, None],
        ]
        if route_tangent:
            planes.append(attrs.tangent)
        r = scatter_results(
            jnp.concatenate(planes, axis=1), dist_c, valid_c, group
        )
        live = active[:n]
        mask = (r[:n, 3] > 0.5) & live
        hit_out = Hit(
            t=jnp.where(mask, r[:n, 0], FLT_MAX),
            tri=jnp.zeros((n,), jnp.int32),
            uv=jnp.where(live[:, None], r[:n, 1:3], 0.0),
            mask=mask,
        )
        attrs_out = PacketAttrs(
            normal=jnp.where(live[:, None], r[:n, 4:7], 0.0),
            tangent=(
                jnp.where(live[:, None], r[:n, 11:14], 0.0)
                if route_tangent else jnp.zeros((n, 3), r.dtype)
            ),
            uv=jnp.where(live[:, None], r[:n, 7:9], 0.0),
            material=jnp.where(
                live, jnp.round(r[:n, 9]), 0.0
            ).astype(jnp.int32),
        )
        slot_out = jnp.where(
            mask,
            jax.lax.bitcast_convert_type(r[:n, 10], jnp.int32),
            -1,
        )
        return hit_out, attrs_out, slot_out

    return wrapped
