"""Wavefront path-tracing integrator.

Data-parallel re-design of the reference bounce loop (CpuTrace::Trace,
src/kernels/raytracing/software/cpu_trace.cpp:107-170): instead of a per-pixel
C++ loop with early breaks, ALL rays advance in lock-step through a
`lax.scan` over bounces with masked lanes — dead lanes simply stop
contributing. Semantics matched bounce-for-bounce:

* radiance += emission * throughput on hit; throughput *= attenuation;
* miss -> equirect sky lookup (uv = (atan2(z,x)/2pi, asin(y)/pi) + .5,
  cpu_trace.cpp:149) through the sky material slot 0, then the lane dies;
* russian roulette with p = EPS + max(throughput), survivor reweighted by 1/p
  (cpu_trace.cpp:158-166), applied every bounce when enabled;
* ray accounting = one ray per live lane per bounce iteration
  (cpu_trace.cpp:113-116).

The RR kill decision is detached; radiance stays differentiable w.r.t.
materials, textures and vertices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from tracy_tpu.config import RenderConfig
from tracy_tpu.core import math as tm
from tracy_tpu.core.rng import RngSpec
from tracy_tpu.render import material as mtl
from tracy_tpu.render.intersect import Hit, intersect_bruteforce
from tracy_tpu.render.texture import sample_nearest
from tracy_tpu.scene.scene import SKY_MATERIAL_ID, TEX_EMISSIVE, SceneArrays

# RNG draw ids within a bounce.
DRAW_SPHERE_Z = 0
DRAW_SPHERE_PHI = 1
DRAW_SPECULAR = 2
DRAW_ROULETTE = 3
# Pseudo-bounce id used for the camera jitter draws.
JITTER_BOUNCE = 255

IntersectFn = Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], Hit]
# (origin [N,3], direction [N,3], active [N]) -> Hit


class HitAttributes(NamedTuple):
    point: jnp.ndarray  # [N, 3]
    normal: jnp.ndarray  # [N, 3] interpolated, NOT normalized (reference quirk)
    tangent: jnp.ndarray  # [N, 3] interpolated, NOT normalized
    uv: jnp.ndarray  # [N, 2] texture coords
    material: jnp.ndarray  # [N] int32


def interpolate_hit(scene: SceneArrays, hit: Hit, origin, direction) -> HitAttributes:
    """Barycentric attribute interpolation (cpu_details.cpp:169-182)."""
    idx = scene.indices[hit.tri]  # [N, 3]
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    w = 1.0 - u - v

    def interp(attr):
        return w * attr[idx[:, 0]] + u * attr[idx[:, 1]] + v * attr[idx[:, 2]]

    return HitAttributes(
        point=origin + hit.t[:, None] * direction,
        normal=interp(scene.vertex_normal),
        tangent=interp(scene.vertex_tangent),
        uv=w * scene.vertex_uv[idx[:, 0]]
        + u * scene.vertex_uv[idx[:, 1]]
        + v * scene.vertex_uv[idx[:, 2]],
        material=scene.tri_material[hit.tri],
    )


def sky_emission(scene: SceneArrays, direction: jnp.ndarray) -> jnp.ndarray:
    """Sky radiance for miss lanes via material slot 0 (cpu_trace.cpp:147-156).

    The equirect texture fetch only exists in the graph when the scene has
    textures (static check) — untextured skies are a pure broadcast.
    """
    from tracy_tpu.render.material import scene_has_textures

    m = scene.materials
    const_shape = direction.shape[:-1] + (3,)
    const = jnp.broadcast_to(m.emissive[SKY_MATERIAL_ID], const_shape)
    if not scene_has_textures(scene):
        return const

    d = direction
    uv = jnp.stack(
        [
            jnp.arctan2(d[..., 2], d[..., 0]) / (2.0 * jnp.pi) + 0.5,
            jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0)) / jnp.pi + 0.5,
        ],
        axis=-1,
    )
    tid = m.tex_index[SKY_MATERIAL_ID, TEX_EMISSIVE]
    tids = jnp.full(d.shape[:-1], tid, dtype=jnp.int32)
    texel = sample_nearest(scene.tex_data, scene.tex_table, tids, uv)[..., :3]
    return jnp.where(tid >= 0, texel, const)


class PathState(NamedTuple):
    origin: jnp.ndarray  # [N, 3]
    direction: jnp.ndarray  # [N, 3]
    throughput: jnp.ndarray  # [N, 3]
    radiance: jnp.ndarray  # [N, 3]
    alive: jnp.ndarray  # [N] bool
    ray_count: jnp.ndarray  # [] int32


def trace_paths(
    scene: SceneArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    pixel_idx: jnp.ndarray,  # [N] global pixel ids for the RNG
    sample_key: jnp.ndarray,  # [] or [N] frame/sample counter for the RNG
    cfg: RenderConfig,
    intersect_fn: IntersectFn,
    active0: jnp.ndarray = None,  # [N] bool; None = all live. Dead lanes
    # (tile-padding rows) are never counted and contribute no radiance.
    first_intersect_fn=None,  # optional UNcompacted intersector for bounce
    # 0: the primary wave is all-live (modulo tile-padding rows), so the
    # compaction wrapper's butterfly routing is an identity permutation —
    # pure overhead. When given, bounce 0 is peeled out of the scan and
    # runs through this fn instead; bit-identical by construction.
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Trace N paths; returns (radiance [N, 3], ray_count scalar)."""
    n = origin.shape[0]
    rng = RngSpec(cfg.rng, cfg.seed)

    def rand(bounce, draw):
        return rng.uniform(pixel_idx, sample_key, bounce, draw)

    init = PathState(
        origin=origin,
        direction=direction,
        throughput=jnp.ones((n, 3), dtype=origin.dtype),
        radiance=jnp.zeros((n, 3), dtype=origin.dtype),
        alive=(jnp.ones((n,), dtype=bool) if active0 is None else active0),
        ray_count=jnp.zeros((), dtype=jnp.int32),
    )

    def make_bounce_step(intersect_fn):
      def bounce_step(state: PathState, bounce) -> Tuple[PathState, None]:
        ray_count = state.ray_count + jnp.sum(state.alive, dtype=jnp.int32)

        res = intersect_fn(state.origin, state.direction, state.alive)
        if not isinstance(res, Hit):
            # Rich intersector (packet): attributes already interpolated
            # inside the traversal.
            hit, pa = res
            attrs = HitAttributes(
                point=state.origin + hit.t[:, None] * state.direction,
                normal=pa.normal,
                tangent=pa.tangent,
                uv=pa.uv,
                material=pa.material,
            )
        else:
            hit = res
            attrs = interpolate_hit(scene, hit, state.origin, state.direction)
        hit_mask = hit.mask & state.alive
        miss_mask = state.alive & ~hit.mask
        params = mtl.gather_surface_params(
            scene, attrs.material, attrs.uv, attrs.normal, attrs.tangent
        )
        res = mtl.scatter(
            state.direction,
            attrs.point,
            params,
            rand(bounce, DRAW_SPHERE_Z),
            rand(bounce, DRAW_SPHERE_PHI),
            rand(bounce, DRAW_SPECULAR),
        )

        sky = sky_emission(scene, state.direction)

        emission = jnp.where(hit_mask[:, None], res.emission, 0.0) + jnp.where(
            miss_mask[:, None], sky, 0.0
        )
        radiance = state.radiance + emission * state.throughput
        throughput = jnp.where(
            hit_mask[:, None], state.throughput * res.attenuation, state.throughput
        )

        alive = hit_mask
        if cfg.russian_roulette:
            # Both the kill decision and the 1/p reweight are detached so the
            # RR estimator stays unbiased under differentiation.
            p = jax.lax.stop_gradient(tm.EPS + jnp.max(throughput, axis=-1))
            survive = rand(bounce, DRAW_ROULETTE) <= p
            throughput = jnp.where(
                (alive & survive)[:, None], throughput / jnp.maximum(p[:, None], tm.EPS), throughput
            )
            alive = alive & survive

        new_state = PathState(
            origin=jnp.where(hit_mask[:, None], res.origin, state.origin),
            direction=jnp.where(hit_mask[:, None], res.direction, state.direction),
            throughput=throughput,
            radiance=radiance,
            alive=alive,
            ray_count=ray_count,
        )
        return new_state, None

      return bounce_step

    step = make_bounce_step(intersect_fn)
    start = 0
    if first_intersect_fn is not None:
        init, _ = make_bounce_step(first_intersect_fn)(
            init, jnp.asarray(0, jnp.int32))
        start = 1
    final, _ = jax.lax.scan(
        step, init, jnp.arange(start, cfg.max_bounces, dtype=jnp.int32)
    )
    return final.radiance, final.ray_count


def trace_aov(
    scene: SceneArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    cfg: RenderConfig,
    intersect_fn: IntersectFn,
) -> jnp.ndarray:
    """First-hit AOV views (reference DEBUG_SHOW_*, cpu_trace.cpp:127-137).

    Misses return black (the reference falls through to the sky only in
    beauty mode; AOV shorts-circuit on hit, and we define miss = 0).
    """
    n = origin.shape[0]
    alive = jnp.ones((n,), dtype=bool)
    res = intersect_fn(origin, direction, alive)
    if not isinstance(res, Hit):
        hit, pa = res
        attrs = HitAttributes(
            point=origin + hit.t[:, None] * direction,
            normal=pa.normal,
            tangent=pa.tangent,
            uv=pa.uv,
            material=pa.material,
        )
    else:
        hit = res
        attrs = interpolate_hit(scene, hit, origin, direction)
    params = mtl.gather_surface_params(
        scene, attrs.material, attrs.uv, attrs.normal, attrs.tangent
    )
    mask = hit.mask[:, None]

    if cfg.aov == "basecolor":
        out = params.basecolor
    elif cfg.aov == "normals":
        # .5 * normalize(1 + mat3(view) * shading_normal), cpu_trace.cpp:130
        # (explicit mul-add, not a matmul: see camera.generate_rays)
        v = scene.camera.view[:3, :3]
        n = params.normal
        view_n = n[..., 0:1] * v[:, 0] + n[..., 1:2] * v[:, 1] + n[..., 2:3] * v[:, 2]
        out = 0.5 * tm.normalize(1.0 + view_n)
    elif cfg.aov == "metalness":
        out = jnp.repeat(params.metalness[:, None], 3, axis=-1)
    elif cfg.aov == "roughness":
        out = jnp.repeat(params.roughness[:, None], 3, axis=-1)
    elif cfg.aov == "emissive":
        out = params.emissive
    elif cfg.aov == "depth":
        d = jnp.where(hit.mask, hit.t, 0.0)[:, None]
        out = jnp.repeat(d, 3, axis=-1)
    else:
        raise ValueError(f"not an AOV mode: {cfg.aov}")
    return jnp.where(mask, out, 0.0)


def make_bruteforce_intersector(scene: SceneArrays, tri_chunk: int = 512) -> IntersectFn:
    """Brute-force closest-hit over the global triangle soup.

    Triangle corner gathers happen here, inside the traced computation, so
    gradients flow back into scene.vertex_pos.
    """
    p0, p1, p2 = scene.triangle_vertices()
    e1 = p1 - p0
    e2 = p2 - p0

    def intersect(origin, direction, active):
        return intersect_bruteforce(
            origin, direction, p0, e1, e2, tri_chunk=tri_chunk, active=active
        )

    return intersect
