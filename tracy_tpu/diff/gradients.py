"""Differentiable rendering: pixel gradients -> scene parameters.

The reference has no differentiability at all; this is the framework's
north-star capability. The whole light path is
differentiable by construction:

* intersection t/uv are smooth functions of vertex positions
  (Möller–Trumbore in jnp; the discrete closest-hit argmin is effectively
  detached, standard for path-space differentiation);
* BRDF/BTDF attenuation and emission are smooth in the material table and
  texture atlas; discrete specular-vs-diffuse and russian-roulette decisions
  are made on stop_gradient'ed probabilities (detached sampling), keeping the
  estimator unbiased;
* the counter-based RNG makes f(theta +/- h) use identical random numbers, so
  finite-difference checks converge (tests/test_gradients.py).

`TrainableParams` selects which leaves of the scene are optimized (albedo,
roughness, metalness, ior, emissive, translucency, texture atlas, vertices);
`make_train_step` returns a jittable optax update step for inverse rendering.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from tracy_tpu.config import RenderConfig
from tracy_tpu.render.renderer import sample_radiance
from tracy_tpu.scene.scene import SceneArrays


class TrainableParams(NamedTuple):
    """The differentiable leaves of a scene, as one pytree."""

    albedo: jnp.ndarray
    roughness: jnp.ndarray
    metalness: jnp.ndarray
    ior: jnp.ndarray
    emissive: jnp.ndarray
    translucent: jnp.ndarray
    tex_data: jnp.ndarray
    vertex_pos: jnp.ndarray


def extract_params(scene: SceneArrays) -> TrainableParams:
    m = scene.materials
    return TrainableParams(
        albedo=m.albedo,
        roughness=m.roughness,
        metalness=m.metalness,
        ior=m.ior,
        emissive=m.emissive,
        translucent=m.translucent,
        tex_data=scene.tex_data,
        vertex_pos=scene.vertex_pos,
    )


def apply_params(scene: SceneArrays, params: TrainableParams) -> SceneArrays:
    import dataclasses

    materials = dataclasses.replace(
        scene.materials,
        albedo=params.albedo,
        roughness=params.roughness,
        metalness=params.metalness,
        ior=params.ior,
        emissive=params.emissive,
        translucent=params.translucent,
    )
    return dataclasses.replace(
        scene, materials=materials, tex_data=params.tex_data, vertex_pos=params.vertex_pos
    )


class GeometryDiffIntersector:
    """Winner-recompute differentiable intersector.

    The non-differentiable base intersector (the packet traversal) finds
    each ray's winning triangle SLOT; the differentiable outputs (t, barycentric uv, shading
    normal/tangent, texture uv) are then RECOMPUTED in closed form from the
    TRACED scene arrays at that detached winner — Möller–Trumbore partials
    of the winning triangle only, no differentiation through traversal. The
    discrete closest-hit choice is detached (standard in path-space
    differentiation: it changes only on measure-zero visibility
    boundaries), exactly like the brute-force path's detached argmin.

    This replaces round 1's `differentiable_geometry=True` traced-prepare
    path, which could not be reverse-differentiated at all (lax.while_loop
    has no reverse-mode rule) — and its forward pass is the plain render
    traversal.

    Use `bind(traced_scene)` inside the loss so gradients reach the traced
    vertex arrays; `render_loss`/`sample_radiance` callers do this
    automatically via the `bind` duck-type.
    """

    def __init__(self, base, slot_tri, with_tangent: bool, first_base=None):
        self._base = base  # (o, d, act) -> (Hit, PacketAttrs, slot [N] i32)
        self._slot_tri = slot_tri  # [S] i32 slot -> original triangle id
        self._with_tangent = with_tangent
        # Optional uncompacted base for the bounce-0 peel: bind() exposes
        # it as `.first` on the bound fn (render_loss threads it through
        # as trace_paths' first_intersect_fn).
        self._first_base = first_base

    def bind(self, s: SceneArrays):
        slot_tri, with_tangent = self._slot_tri, self._with_tangent
        sg = jax.lax.stop_gradient

        def make_isect(base):
          def isect(o, d, act):
            hit0, attrs0, slot = base(sg(o), sg(d), act)
            hit0 = jax.tree_util.tree_map(sg, hit0)
            attrs0 = jax.tree_util.tree_map(sg, attrs0)
            slot = sg(slot)
            mask = hit0.mask

            tri = slot_tri[jnp.clip(slot, 0, slot_tri.shape[0] - 1)]
            vidx = s.indices[tri]  # [N, 3]
            p0 = s.vertex_pos[vidx[:, 0]]
            p1 = s.vertex_pos[vidx[:, 1]]
            p2 = s.vertex_pos[vidx[:, 2]]
            e1, e2 = p1 - p0, p2 - p0

            # Möller–Trumbore on the winning triangle (collision.h:33-74
            # semantics); misses keep the detached base values.
            pvec = jnp.cross(d, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            safe = mask & (jnp.abs(det) > 1e-12)
            inv_det = jnp.where(safe, 1.0 / jnp.where(safe, det, 1.0), 0.0)
            tvec = o - p0
            u = jnp.sum(tvec * pvec, axis=-1) * inv_det
            qvec = jnp.cross(tvec, e1)
            v = jnp.sum(d * qvec, axis=-1) * inv_det
            t = jnp.sum(e2 * qvec, axis=-1) * inv_det
            t = jnp.where(safe, t, hit0.t)
            u = jnp.where(safe, u, hit0.uv[:, 0])
            v = jnp.where(safe, v, hit0.uv[:, 1])
            w = 1.0 - u - v

            def interp(table, k):
                a0 = table[vidx[:, 0]][:, :k]
                a1 = table[vidx[:, 1]][:, :k]
                a2 = table[vidx[:, 2]][:, :k]
                return (w[:, None] * a0 + u[:, None] * a1 + v[:, None] * a2)

            mc = mask[:, None]
            normal = jnp.where(mc, interp(s.vertex_normal, 3), attrs0.normal)
            uv_t = jnp.where(mc, interp(s.vertex_uv, 2), attrs0.uv)
            tangent = (
                jnp.where(mc, interp(s.vertex_tangent, 3), attrs0.tangent)
                if with_tangent else attrs0.tangent
            )

            hit = hit0._replace(
                t=t,
                tri=jnp.where(mask, tri, 0),
                uv=jnp.stack([u, v], axis=-1),
            )
            attrs = attrs0._replace(normal=normal, tangent=tangent, uv=uv_t)
            return hit, attrs

          return isect

        isect = make_isect(self._base)
        if self._first_base is not None:
            isect.first = make_isect(self._first_base)
        return isect

    def __call__(self, o, d, act):
        """Unbound call: base values only (no geometry gradients)."""
        hit, attrs, _slot = self._base(o, d, act)
        return hit, attrs


def nondiff_intersector(intersect):
    """Make an IntersectFn differentiation-safe with a zero-gradient VJP.

    Why this is CORRECT for material/texture/emissive inverse rendering:
    every gradient those optimizations need flows through the
    intersector's DISCRETE outputs — the material id selects table rows
    (differentiable w.r.t. the table), the hit uv selects texels (nearest
    sampling, differentiable w.r.t. texel VALUES and zero a.e. w.r.t. uv),
    and the shading normal only steers detached sampling decisions. The
    only gradients a zero VJP drops are geometry gradients (vertex
    positions through t/uv/normal), which GeometryDiffIntersector
    recomputes. The backward pass then never enters the traversal loop.
    """
    import numpy as np

    @jax.custom_vjp
    def f(origin, direction, active):
        return intersect(origin, direction, active)

    def fwd(origin, direction, active):
        # No residuals: shapes/dtypes are NOT valid jit residuals, and the
        # ray count is recoverable from the hit-t cotangent in bwd.
        return f(origin, direction, active), None

    def bwd(_res, ct):
        hit_ct = ct[0]
        n = hit_ct.t.shape[0]
        zero = jnp.zeros((n, 3), hit_ct.t.dtype)
        zero_act = np.zeros((n,), jax.dtypes.float0)
        return (zero, zero, zero_act)

    f.defvjp(fwd, bwd)
    return f


def _bvh_slot_base(scene: SceneArrays, cfg: RenderConfig):
    """The per-ray-stack BVH as a slot-returning base for
    GeometryDiffIntersector: (o, d, act) -> (Hit, PacketAttrs, slot), with
    the global triangle id as the slot and only the material filled in
    (the winner recompute supplies normal, tangent and uv)."""
    from tracy_tpu.accel.bvh import build_scene_bvh, make_bvh_intersector
    from tracy_tpu.accel.packet import PacketAttrs

    _host, dev = build_scene_bvh(
        scene, leaf_size=cfg.bvh_leaf_size,
        max_depth=max(cfg.traversal_stack_depth - 4, 8))
    isect = make_bvh_intersector(scene, dev, leaf_size=cfg.bvh_leaf_size,
                                 stack_depth=cfg.traversal_stack_depth)
    tri_material = scene.tri_material

    def base(o, d, act):
        hit = isect(o, d, act)
        zero3 = jnp.zeros(o.shape, o.dtype)
        attrs = PacketAttrs(normal=zero3, tangent=zero3,
                            uv=jnp.zeros(o.shape[:1] + (2,), o.dtype),
                            material=tri_material[hit.tri])
        return hit, attrs, jnp.where(hit.mask, hit.tri, -1)

    base.slot_tri = jnp.arange(scene.indices.shape[0], dtype=jnp.int32)
    return base, isect


def make_training_intersector(scene: SceneArrays, cfg: RenderConfig,
                              needs_geometry_grads: bool):
    """Intersector for inverse rendering on cfg.accel's traversal: the
    per-ray-stack BVH for accel='bvh', the packet traversal otherwise.

    * materials/textures/emissive only (needs_geometry_grads=False): the
      traversal wrapped in a zero-gradient VJP (nondiff_intersector);
    * vertex positions trainable: a GeometryDiffIntersector — the same
      forward traversal, with t/uv/normal gradients recomputed at the
      detached winning triangle (see class docstring).

    For the packet traversal, cfg.wave_compact_group > 0 adds per-wave
    live-ray compaction: the butterfly routing is pure selects, so the loss
    and gradients are the same as without it.
    """
    if cfg.accel == "bvh":
        base, isect = _bvh_slot_base(scene, cfg)
        if needs_geometry_grads:
            return GeometryDiffIntersector(base, base.slot_tri,
                                           with_tangent=True)
        return nondiff_intersector(isect)

    from tracy_tpu.accel.packet import build_packet_bvh, make_packet_intersector
    from tracy_tpu.accel.reorder import (
        compact_intersector, compact_intersector_slot,
    )

    leaf = cfg.packet_leaf_size
    grp = cfg.wave_compact_group
    bvh, _ = build_packet_bvh(scene, leaf_size=leaf)
    if needs_geometry_grads:
        base = make_packet_intersector(scene, bvh, with_tangent=True,
                                       leaf_size=leaf, return_slot=True)
        inner, first = base, None
        if grp > 0:
            inner = compact_intersector_slot(base, grp, route_tangent=True)
            if cfg.wave_compact_skip_first:
                first = base  # bounce-0 peel (all-live wave)
        return GeometryDiffIntersector(inner, base.slot_tri, with_tangent=True,
                                       first_base=first)

    isect = nondiff_intersector(make_packet_intersector(
        scene, bvh, with_tangent=True, leaf_size=leaf))
    if grp > 0:
        raw = isect
        isect = compact_intersector(raw, grp, route_tangent=True)
        if cfg.wave_compact_skip_first:
            isect.first = raw  # bounce-0 peel (all-live wave)
    return isect


def render_loss(
    params: TrainableParams,
    scene: SceneArrays,
    target: jnp.ndarray,  # [H, W, 3] linear radiance target
    cfg: RenderConfig,
    frame: jnp.ndarray,
    intersect_fn=None,
) -> jnp.ndarray:
    """MSE between a rendered frame (spp samples at RNG position `frame`) and
    the target. Differentiable w.r.t. `params`."""
    s = apply_params(scene, params)
    if hasattr(intersect_fn, "bind"):
        # GeometryDiffIntersector: rebind to the traced scene so vertex
        # gradients flow through the winner recompute.
        intersect_fn = intersect_fn.bind(s)
    radiance, _rays = sample_radiance(
        s, cfg, frame, intersect_fn,
        # Bounce-0 compaction peel (bit-identical; see trace_paths).
        first_intersect_fn=getattr(intersect_fn, "first", None),
    )
    return jnp.mean((radiance - target) ** 2)


def make_train_step(scene: SceneArrays, cfg: RenderConfig, optimizer,
                    intersect_fn=None, jit: bool = True,
                    trainable_mask: Optional[TrainableParams] = None):
    """Returns (step_fn, init_opt_state).

    step_fn(params, opt_state, target, frame) -> (params', opt_state', loss)
    is the full inverse-rendering training step: render -> loss -> backprop
    through the bounce loop -> optax update.

    trainable_mask: optional pytree (matching TrainableParams, entries 0/1 or
    bool) selecting which parameters receive updates. Inverse problems are
    heavily under-determined — without a mask, e.g. emissive/metalness can
    compensate for a wrong albedo.
    """

    def step(params: TrainableParams, opt_state, target, frame):
        loss, grads = jax.value_and_grad(render_loss)(
            params, scene, target, cfg, frame, intersect_fn
        )
        if trainable_mask is not None:
            grads = jax.tree_util.tree_map(
                lambda g, m: g * jnp.asarray(m, g.dtype), grads, trainable_mask
            )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax

        params = optax.apply_updates(params, updates)
        if trainable_mask is not None:
            # Keep masked-out params bit-identical (adam eps can still move them).
            base = extract_params(scene)
            params = jax.tree_util.tree_map(
                lambda p, b, m: jnp.where(jnp.asarray(m, bool), p, b),
                params, base, trainable_mask,
            )
        return params, opt_state, loss

    if jit:
        step = jax.jit(step)
    init = optimizer.init(extract_params(scene))
    return step, init
