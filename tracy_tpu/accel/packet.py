"""Packet BVH traversal.

Per-packet regularity instead of per-ray irregularity. There are no per-ray
gathers or scatters in the hot path (it was first built for an accelerator
whose XLA backend serialized gathers; on the GPU it competes with the
per-ray-stack tier of accel/bvh.py, see config.default_path):

* a packet = a block of B coherent rays (an image tile / wavefront chunk);
* the packet shares ONE traversal with a SCALAR stack: node ids are scalars,
  so node fetches are `lax.dynamic_slice` at scalar offsets (fast strided
  loads);
* an inner node descends if ANY live ray hits its box (dense [B] slab tests
  + a reduction); children are pushed far-then-near by MIN entry distance
  over the packet's hitting lanes;
* a leaf is a CONTIGUOUS run of <= L triangles fetched with one scalar
  dynamic_slice and tested densely [B, L];
* closest-hit selection uses min + first-match one-hot masked sums instead
  of argmin/row-gathers;
* vertex attributes (normal/tangent/uv/material) are interpolated INSIDE the
  leaf visit from slot-ordered per-corner attribute arrays (dense [B, L]
  weighted sums), so shading needs no triangle/vertex gathers at all.

This is classic SIMD packet tracing (Wald-style; the reference's analogue is
its SSE intersection option, collision.h:204-294) where the "SIMD width" is
the whole packet. Coherent primary rays are near-optimal; divergent bounce
rays visit the union of the packet's nodes but every visit is dense vector
work.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tracy_tpu.core import math as tm
from tracy_tpu.render.intersect import FLT_MAX, Hit, inverse_direction


class PackedBVH(NamedTuple):
    node_bounds: jnp.ndarray  # [Nn, 8] f32: bmin xyz, bmax xyz, pad, pad
    node_meta: jnp.ndarray  # [Nn, 4] i32: (first|left, count, right, pad)
    tri_order: jnp.ndarray  # [Tpad] i32 slot -> original tri id


class PacketAttrs(NamedTuple):
    """Interpolated hit attributes (what integrator.interpolate_hit would
    compute, but produced gather-free inside the traversal)."""

    normal: jnp.ndarray  # [N, 3] interpolated, NOT normalized (ref quirk)
    tangent: jnp.ndarray  # [N, 3]
    uv: jnp.ndarray  # [N, 2] texture coords
    material: jnp.ndarray  # [N] int32


def pack_bvh(host, leaf_size: int) -> PackedBVH:
    import numpy as np

    nb = np.concatenate(
        [host.node_bounds, np.zeros((len(host.node_bounds), 2), np.float32)], axis=1
    )
    nm = np.concatenate(
        [host.node_meta, np.zeros((len(host.node_meta), 1), np.int32)], axis=1
    )
    t = len(host.tri_order)
    pad = np.full((leaf_size,), host.tri_order[-1] if t else 0, np.int32)
    return PackedBVH(
        node_bounds=jnp.asarray(nb),
        node_meta=jnp.asarray(nm),
        tri_order=jnp.asarray(np.concatenate([host.tri_order, pad])),
    )


class _PacketState(NamedTuple):
    stack: jnp.ndarray  # [S] i32
    sp: jnp.ndarray  # [] i32
    t: jnp.ndarray  # [B]
    uv: jnp.ndarray  # [B, 2] barycentric
    mask: jnp.ndarray  # [B]
    normal: jnp.ndarray  # [B, 3]
    tangent: jnp.ndarray  # [B, 3]
    uv0: jnp.ndarray  # [B, 2]
    mat: jnp.ndarray  # [B] f32 (material id as float; exact for < 2^24)
    slot: jnp.ndarray  # [B] f32 winner slot in tri_order space (-1 = none)


def _slab(o, inv_d, bmin, bmax, closest):
    lo = (bmin - o) * inv_d
    hi = (bmax - o) * inv_d
    tmin = jnp.max(jnp.minimum(lo, hi), axis=-1)
    tmax = jnp.min(jnp.maximum(lo, hi), axis=-1)
    hit = (tmax >= jnp.maximum(jnp.float32(tm.EPS), tmin)) & (tmin < closest)
    return hit, tmin


def _traverse_packet(o, d, active, bvh, tri, leaf_size, stack_depth,
                     with_tangent: bool):
    """tri: dict of slot-ordered arrays (p0,e1,e2, per-corner attrs)."""
    b = o.shape[0]
    inv_d = inverse_direction(d)
    eps = jnp.float32(tm.EPS)

    init = _PacketState(
        stack=jnp.zeros((stack_depth,), jnp.int32),
        sp=jnp.any(active).astype(jnp.int32),
        t=jnp.full((b,), FLT_MAX),
        uv=jnp.zeros((b, 2)),
        mask=jnp.zeros((b,), bool),
        normal=jnp.zeros((b, 3)),
        tangent=jnp.zeros((b, 3)),
        uv0=jnp.zeros((b, 2)),
        mat=jnp.zeros((b,)),
        slot=jnp.full((b,), -1.0),
    )

    nb = bvh.node_bounds
    nm = bvh.node_meta

    def cond(s: _PacketState):
        return s.sp > 0

    def body(s: _PacketState) -> _PacketState:
        node = s.stack[s.sp - 1]
        sp = s.sp - 1
        meta = jax.lax.dynamic_slice(nm, (node, 0), (1, 4))[0]
        is_leaf = meta[1] > 0

        def leaf_fn(s, sp):
            first = meta[0]
            count = meta[1]

            def sl(a, width):
                return jax.lax.dynamic_slice(a, (first, 0), (leaf_size, width))

            p0 = sl(tri["p0"], 3)
            e1 = sl(tri["e1"], 3)
            e2 = sl(tri["e2"], 3)

            # Dense Möller–Trumbore [B, L] (collision.h:33-74 semantics).
            dd = d[:, None, :]
            pvec = jnp.cross(dd, e2[None, :, :])
            det = jnp.sum(e1[None, :, :] * pvec, axis=-1)
            tvec = o[:, None, :] - p0[None, :, :]
            uu = jnp.sum(tvec * pvec, axis=-1)
            qvec = jnp.cross(tvec, e1[None, :, :])
            vv = jnp.sum(dd * qvec, axis=-1)
            ts = jnp.sum(e2[None, :, :] * qvec, axis=-1)
            inv_det = jnp.where(det > eps, 1.0 / jnp.where(det > eps, det, 1.0), 0.0)
            tt = ts * inv_det
            lane = jnp.arange(leaf_size, dtype=jnp.int32)[None, :]
            ok = (
                (det > eps) & (uu >= eps) & (uu <= det) & (vv >= eps)
                & (uu + vv <= det) & (tt > eps) & (tt < s.t[:, None])
                & (lane < count) & active[:, None]
            )
            tt = jnp.where(ok, tt, FLT_MAX)

            # min + first-match one-hot (no argmin row-gathers).
            bt = jnp.min(tt, axis=-1)  # [B]
            imp = bt < s.t
            oh = (tt == bt[:, None]) & ok
            oh = oh & (jnp.cumsum(oh.astype(jnp.int32), axis=-1) <= 1)
            ohf = oh.astype(tt.dtype)

            u_bc = jnp.sum(uu * inv_det * ohf, axis=-1)
            v_bc = jnp.sum(vv * inv_det * ohf, axis=-1)
            w_bc = 1.0 - u_bc - v_bc

            def interp3(a0, a1, a2):
                # [L,K] corner attrs -> [B,K] at the winning lane. Explicit
                # multiply-sums, not an einsum: a float32 contraction may run
                # at reduced matmul precision (TF32) on a GPU.
                def pick(a):
                    return jnp.sum(ohf[:, :, None] * a[None, :, :], axis=1)

                return (
                    w_bc[:, None] * pick(a0)
                    + u_bc[:, None] * pick(a1)
                    + v_bc[:, None] * pick(a2)
                )

            n_i = interp3(sl(tri["n0"], 3), sl(tri["n1"], 3), sl(tri["n2"], 3))
            if with_tangent:
                tg_i = interp3(sl(tri["t0"], 3), sl(tri["t1"], 3), sl(tri["t2"], 3))
            else:
                tg_i = s.tangent
            uv_i = interp3(sl(tri["uv0"], 2), sl(tri["uv1"], 2), sl(tri["uv2"], 2))[:, :2]
            mat_i = jnp.sum(sl(tri["mat"], 1)[None, :, 0] * ohf, axis=-1)
            # winner slot id = leaf first + winning lane (one masked sum; the
            # winner-recompute differentiable path maps it via tri_order).
            slot_i = first.astype(tt.dtype) + jnp.sum(
                lane.astype(tt.dtype) * ohf, axis=-1
            )

            impc = imp[:, None]
            return _PacketState(
                stack=s.stack,
                sp=sp,
                t=jnp.where(imp, bt, s.t),
                uv=jnp.where(impc, jnp.stack([u_bc, v_bc], axis=-1), s.uv),
                mask=s.mask | imp,
                normal=jnp.where(impc, n_i, s.normal),
                tangent=jnp.where(impc, tg_i, s.tangent) if with_tangent else s.tangent,
                uv0=jnp.where(impc, uv_i, s.uv0),
                mat=jnp.where(imp, mat_i, s.mat),
                slot=jnp.where(imp, slot_i, s.slot),
            )

        def inner_fn(s, sp):
            left, right = meta[0], meta[2]
            lrow = jax.lax.dynamic_slice(nb, (left, 0), (1, 8))[0]
            rrow = jax.lax.dynamic_slice(nb, (right, 0), (1, 8))[0]
            lhit, lt = _slab(o, inv_d, lrow[0:3], lrow[3:6], s.t)
            rhit, rt = _slab(o, inv_d, rrow[0:3], rrow[3:6], s.t)
            lhit = lhit & active
            rhit = rhit & active
            # ONE batched cross-lane reduction instead of several scalar
            # reductions: min entry distance per child, FLT_MAX when no
            # lane hits.
            packed = jnp.stack(
                [jnp.where(lhit, lt, FLT_MAX), jnp.where(rhit, rt, FLT_MAX)]
            )  # [2, B]
            mins = jnp.min(packed, axis=-1)  # [2]
            l_any = mins[0] < FLT_MAX
            r_any = mins[1] < FLT_MAX
            near_is_left = mins[0] <= mins[1]
            near = jnp.where(near_is_left, left, right)
            far = jnp.where(near_is_left, right, left)
            near_any = jnp.where(near_is_left, l_any, r_any)
            far_any = jnp.where(near_is_left, r_any, l_any)

            stack = s.stack
            idx0 = jnp.minimum(sp, stack_depth - 1)
            stack = jax.lax.dynamic_update_slice(
                stack, jnp.where(far_any, far, stack[idx0])[None], (idx0,)
            )
            sp = sp + far_any.astype(jnp.int32)
            idx1 = jnp.minimum(sp, stack_depth - 1)
            stack = jax.lax.dynamic_update_slice(
                stack, jnp.where(near_any, near, stack[idx1])[None], (idx1,)
            )
            sp = sp + near_any.astype(jnp.int32)
            return s._replace(stack=stack, sp=sp)

        return jax.lax.cond(is_leaf, leaf_fn, inner_fn, s, sp)

    return jax.lax.while_loop(cond, body, init)


def prepare_packet_tri_data(scene, bvh: PackedBVH, with_tangent: bool):
    """Slot-ordered triangle geometry + per-corner attributes, computed with
    jnp gathers from the (possibly traced) scene — use inside jit when
    gradients w.r.t. vertex data are needed. The gathers are per-FRAME (the
    intersector factory runs once per render step), not per-bounce."""
    order = bvh.tri_order
    idx = scene.indices[order]  # [Tpad, 3]
    p0 = scene.vertex_pos[idx[:, 0]]
    p1 = scene.vertex_pos[idx[:, 1]]
    p2 = scene.vertex_pos[idx[:, 2]]
    tri = {
        "p0": p0,
        "e1": p1 - p0,
        "e2": p2 - p0,
        "n0": scene.vertex_normal[idx[:, 0]],
        "n1": scene.vertex_normal[idx[:, 1]],
        "n2": scene.vertex_normal[idx[:, 2]],
        "uv0": scene.vertex_uv[idx[:, 0]],
        "uv1": scene.vertex_uv[idx[:, 1]],
        "uv2": scene.vertex_uv[idx[:, 2]],
        "mat": scene.tri_material[order].astype(p0.dtype)[:, None],
    }
    if with_tangent:
        tri["t0"] = scene.vertex_tangent[idx[:, 0]]
        tri["t1"] = scene.vertex_tangent[idx[:, 1]]
        tri["t2"] = scene.vertex_tangent[idx[:, 2]]
    return tri


def prepare_packet_tri_data_host(scene, bvh: PackedBVH, with_tangent: bool):
    """Same as prepare_packet_tri_data but precomputed with numpy on the host
    (concrete scene). No device gathers at all — the default for pure
    rendering, where vertex-data gradients aren't needed."""
    import numpy as np

    order = np.asarray(bvh.tri_order)
    idx = np.asarray(scene.indices)[order]
    pos = np.asarray(scene.vertex_pos)
    nrm = np.asarray(scene.vertex_normal)
    uv = np.asarray(scene.vertex_uv)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    tri = {
        "p0": jnp.asarray(p0),
        "e1": jnp.asarray(p1 - p0),
        "e2": jnp.asarray(p2 - p0),
        "n0": jnp.asarray(nrm[idx[:, 0]]),
        "n1": jnp.asarray(nrm[idx[:, 1]]),
        "n2": jnp.asarray(nrm[idx[:, 2]]),
        "uv0": jnp.asarray(uv[idx[:, 0]]),
        "uv1": jnp.asarray(uv[idx[:, 1]]),
        "uv2": jnp.asarray(uv[idx[:, 2]]),
        "mat": jnp.asarray(
            np.asarray(scene.tri_material)[order].astype(np.float32)[:, None]
        ),
    }
    if with_tangent:
        tan = np.asarray(scene.vertex_tangent)
        tri["t0"] = jnp.asarray(tan[idx[:, 0]])
        tri["t1"] = jnp.asarray(tan[idx[:, 1]])
        tri["t2"] = jnp.asarray(tan[idx[:, 2]])
    return tri


def intersect_packet(
    origin, direction, tri, bvh: PackedBVH,
    active=None, leaf_size: int = 64, stack_depth: int = 64,
    packet_size: int = 1024, with_tangent: bool = True,
    return_slot: bool = False,
):
    n = origin.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    npad = -(-n // packet_size) * packet_size
    if npad != n:
        pad = npad - n
        origin = jnp.pad(origin, ((0, pad), (0, 0)))
        direction = jnp.pad(direction, ((0, pad), (0, 0)), constant_values=1.0)
        active = jnp.pad(active, (0, pad))
    k = npad // packet_size

    def run(args):
        o, d, act = args
        s = _traverse_packet(o, d, act, bvh, tri, leaf_size, stack_depth,
                             with_tangent)
        return s.t, s.uv, s.mask, s.normal, s.tangent, s.uv0, s.mat, s.slot

    t, uv, mask, nrm, tg, uv0, mat, slot = jax.lax.map(
        run,
        (
            origin.reshape(k, packet_size, 3),
            direction.reshape(k, packet_size, 3),
            active.reshape(k, packet_size),
        ),
    )

    def flat(x):
        return x.reshape((npad,) + x.shape[2:])[:n]

    hit = Hit(
        t=flat(t),
        tri=jnp.zeros((n,), jnp.int32),  # slot ids unused downstream
        uv=flat(uv),
        mask=flat(mask),
    )
    attrs = PacketAttrs(
        normal=flat(nrm),
        tangent=flat(tg),
        uv=flat(uv0),
        material=flat(mat).astype(jnp.int32),
    )
    if return_slot:
        return hit, attrs, jnp.round(flat(slot)).astype(jnp.int32)
    return hit, attrs


def build_packet_bvh(scene, leaf_size: int = 64, max_depth: int = 60,
                     cost_mode: str = "tris"):
    """Host-side build for a SceneArrays; returns (PackedBVH, HostBVH).
    cost_mode='chunks' prices a leaf visit independently of its triangle
    count (see bvh_build)."""
    import numpy as np

    from tracy_tpu.accel.bvh import _build_auto

    pos = np.asarray(scene.vertex_pos, dtype=np.float32)
    idx = np.asarray(scene.indices)
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    host = _build_auto(tri_min, tri_max, leaf_size, max_depth,
                       cost_mode=cost_mode)
    return pack_bvh(host, leaf_size), host


def make_packet_intersector(scene, bvh: PackedBVH, leaf_size: int = 64,
                            stack_depth: int = 64, packet_size: int = 1024,
                            with_tangent: bool = True,
                            differentiable_geometry: bool = False,
                            return_slot: bool = False):
    """Rich IntersectFn: returns (Hit, PacketAttrs). The integrator detects
    the attrs and skips its gather-based interpolate_hit.

    differentiable_geometry=False precomputes slot-ordered triangle data on
    the host (fast; no geometry gradients). True keeps the preparation in
    traced jnp so gradients flow to vertex positions/normals/uvs — used by
    inverse-rendering paths.
    """
    if differentiable_geometry:
        # One traced preparation per factory call (= once per render step /
        # loss evaluation), shared across all bounces.
        tri_data = prepare_packet_tri_data(scene, bvh, with_tangent)
    else:
        tri_data = prepare_packet_tri_data_host(scene, bvh, with_tangent)

    def intersect(origin, direction, act):
        return intersect_packet(
            origin, direction, tri_data, bvh,
            active=act, leaf_size=leaf_size, stack_depth=stack_depth,
            packet_size=packet_size, with_tangent=with_tangent,
            return_slot=return_slot,
        )

    intersect.slot_tri = bvh.tri_order  # slot -> original tri id
    return intersect
