"""Renderer: jitted progressive render steps over a whole image.

Replaces the reference's frame loop + kernel dispatch (win_raytracer.cpp main
loop -> TracyModule::OnUpdate). One call = one progressive frame (spp samples
per pixel), jit-compiled end-to-end: jittered ray generation, the wavefront
bounce loop, accumulation. MRays/s accounting matches the reference's
definition (one ray per live bounce iteration, win_raytracer.cpp:521-553).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tracy_tpu.config import RenderConfig
from tracy_tpu.core.camera import pixel_samples, pixel_samples_rows
from tracy_tpu.core.rng import RngSpec
from tracy_tpu.render import film
from tracy_tpu.render.integrator import (
    JITTER_BOUNCE,
    make_bruteforce_intersector,
    trace_aov,
    trace_paths,
)
from tracy_tpu.scene.scene import SceneArrays
from tracy_tpu.utils.timer import Timer


class RenderState(NamedTuple):
    """Progressive accumulation state (reference render_data_.output +
    frame_counter_, cpu_details.h)."""

    accum: jnp.ndarray  # [H, W, 3] linear radiance running average
    frame: jnp.ndarray  # [] int32 completed frames


def init_state(cfg: RenderConfig) -> RenderState:
    return RenderState(
        accum=jnp.zeros((cfg.height, cfg.width, 3), dtype=jnp.float32),
        frame=jnp.zeros((), dtype=jnp.int32),
    )


def pick_tile(num_rows: int, w: int) -> Tuple[int, int]:
    """Packet tile shape (th, tw), th*tw = 1024 rays.

    32x32 is the most coherent (square footprint) and stays the default
    whenever its dead-row padding is negligible (<=2% of the band). When a
    row band is far from a 32-multiple — 'data'-sharded images hand each
    shard H/n rows, e.g. 1080/8 = 135 — flatter tiles pad less: pick the
    candidate minimizing pad, preferring taller tiles on ties. Returns
    (0, 0) when no tile width divides w (scanline fallback)."""
    best = (0, 0)
    best_pad = None
    for th, tw in ((32, 32), (16, 64), (8, 128)):
        if w % tw:
            continue
        pad = (-num_rows) % th
        if th == 32 and pad * 50 <= num_rows:  # <=2%: keep the square tile
            return (32, 32)
        if best_pad is None or pad < best_pad:
            best, best_pad = (th, tw), pad
    return best


def sample_radiance_rows(
    scene: SceneArrays,
    cfg: RenderConfig,
    frame: jnp.ndarray,
    intersect_fn=None,
    first_intersect_fn=None,  # uncompacted bounce 0 (see trace_paths)
    row_offset=0,  # traced or static: first image row this shard renders
    num_rows: Optional[int] = None,  # static: rows rendered here
    spp_offset=0,  # traced or static: first sample id this shard renders
    spp_count: Optional[int] = None,  # static: samples rendered here
    total_spp: Optional[int] = None,  # static: global spp (RNG stream stride)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """spp_count jittered samples over a horizontal band of the image.

    Returns (mean radiance [num_rows, W, 3], rays []). Differentiable w.r.t.
    scene arrays. RNG streams are keyed by GLOBAL pixel index and GLOBAL
    sample id, so any row/sample sharding renders the identical image.
    """
    h, w = cfg.height, cfg.width
    num_rows = h if num_rows is None else num_rows
    spp_count = cfg.spp if spp_count is None else spp_count
    total_spp = cfg.spp if total_spp is None else total_spp
    if intersect_fn is None:
        intersect_fn = make_bruteforce_intersector(scene)

    rng = RngSpec(cfg.rng, cfg.seed)

    # Tile the pixel order so each traversal packet covers a compact image
    # tile instead of a thin scanline strip — much smaller BVH footprint per
    # packet. Pure reshape/transpose (zero gathers); untile() restores image
    # order. Tiles hold 1024 rays = one packet. Row bands that are NOT a
    # tile multiple (1080 % 32 = 24: the 1080p headline!) are PADDED with
    # dead rows — otherwise they silently degrade to 1024x1 scanline
    # packets, each with a huge BVH footprint (measured ~10% frame cost at
    # 1080p even before visit-count effects). Pad lanes trace dead: not
    # ray-counted, results discarded. The tile SHAPE adapts to the shard's
    # row count (pick_tile): a 'data'-sharded 1080p image gives each of 8
    # shards 135 rows, which 32-row tiles would pad +18.5%; 8x128 tiles
    # pad +0.7% (the <5% scaling-overhead budget, tests/test_sharding.py).
    tile_h, tile_w = pick_tile(num_rows, w) if cfg.accel in (
        "packet", "tlas") else (0, 0)
    rpad = (-num_rows) % tile_h if tile_h else 0
    rows_r = num_rows + rpad
    rows = row_offset + jnp.arange(rows_r, dtype=jnp.int32)  # global rows
    cols = jnp.arange(w, dtype=jnp.int32)
    pixel_idx = (rows[:, None] * w + cols[None, :]).astype(jnp.uint32)
    live_rows = (
        jnp.broadcast_to(
            (jnp.arange(rows_r, dtype=jnp.int32) < num_rows)[:, None],
            (rows_r, w),
        )
        if rpad
        else None
    )
    use_tiles = tile_h > 0

    def tile_fold(x):  # [R, W, ...] -> [R*W, ...] in tile-major order
        extra = x.shape[2:]
        x = x.reshape((rows_r // tile_h, tile_h, w // tile_w, tile_w) + extra)
        x = jnp.swapaxes(x, 1, 2)
        return x.reshape((rows_r * w,) + extra)

    def tile_unfold(x):  # inverse of tile_fold
        extra = x.shape[1:]
        x = x.reshape((rows_r // tile_h, w // tile_w, tile_h, tile_w) + extra)
        x = jnp.swapaxes(x, 1, 2)
        return x.reshape((rows_r, w) + extra)

    def one_sample(s):
        sample_key = frame.astype(jnp.uint32) * jnp.uint32(total_spp) + s.astype(jnp.uint32)
        ju = rng.uniform(pixel_idx, sample_key, JITTER_BOUNCE, 0)
        jv = rng.uniform(pixel_idx, sample_key, JITTER_BOUNCE, 1)
        ss, tt = pixel_samples_rows(w, h, rows, ju, jv)
        origin, direction = scene.camera.generate_rays(ss, tt)

        if use_tiles:
            origin = tile_fold(origin)
            direction = tile_fold(direction)
            flat_pix = tile_fold(pixel_idx)
            alive0 = tile_fold(live_rows) if rpad else None
        else:
            origin = origin.reshape(-1, 3)
            direction = direction.reshape(-1, 3)
            flat_pix = pixel_idx.reshape(-1)
            alive0 = live_rows.reshape(-1) if rpad else None

        if cfg.aov != "beauty":
            radiance = trace_aov(scene, origin, direction, cfg, intersect_fn)
            rays = jnp.asarray(num_rows * w, dtype=jnp.int32)
        else:
            def run(o, d, pix, act):
                return trace_paths(scene, o, d, pix, sample_key, cfg,
                                   intersect_fn, active0=act,
                                   first_intersect_fn=first_intersect_fn)

            n = origin.shape[0]
            chunk = cfg.ray_chunk
            if 0 < chunk < n and n % chunk == 0:
                k = n // chunk
                act_c = (alive0 if alive0 is not None
                         else jnp.ones((n,), bool)).reshape(k, chunk)
                rad_c, rays_c = jax.lax.map(
                    lambda args: run(*args),
                    (
                        origin.reshape(k, chunk, 3),
                        direction.reshape(k, chunk, 3),
                        flat_pix.reshape(k, chunk),
                        act_c,
                    ),
                )
                radiance, rays = rad_c.reshape(n, 3), jnp.sum(rays_c)
            else:
                radiance, rays = run(origin, direction, flat_pix, alive0)
        if use_tiles:
            return tile_unfold(radiance)[:num_rows], rays
        return radiance.reshape(rows_r, w, 3)[:num_rows], rays

    if spp_count == 1:
        return one_sample(jnp.asarray(spp_offset, jnp.uint32))

    # Sequential running sum instead of lax.map+stack: avoids materializing
    # [spp, H, W, 3].
    def spp_body(i, carry):
        acc, rays = carry
        r, k = one_sample(jnp.asarray(spp_offset, jnp.uint32) + i.astype(jnp.uint32))
        return acc + r, rays + k

    acc, rays = jax.lax.fori_loop(
        0, spp_count,
        spp_body,
        (jnp.zeros((num_rows, w, 3), dtype=jnp.float32), jnp.zeros((), jnp.int32)),
    )
    return acc / spp_count, rays


def sample_radiance(
    scene: SceneArrays,
    cfg: RenderConfig,
    frame: jnp.ndarray,
    intersect_fn=None,
    first_intersect_fn=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One frame of spp jittered samples -> (mean radiance [H,W,3], rays [])."""
    return sample_radiance_rows(scene, cfg, frame, intersect_fn,
                                first_intersect_fn=first_intersect_fn)


def render_step(
    scene: SceneArrays, state: RenderState, cfg: RenderConfig,
    intersect_fn=None, first_intersect_fn=None,
) -> Tuple[RenderState, jnp.ndarray]:
    """One progressive frame: sample, accumulate, bump the frame counter."""
    radiance, rays = sample_radiance(scene, cfg, state.frame, intersect_fn,
                                     first_intersect_fn=first_intersect_fn)
    if cfg.accumulate:
        accum = film.accumulate(state.accum, radiance, state.frame.astype(radiance.dtype))
    else:
        accum = radiance
    return RenderState(accum=accum, frame=state.frame + 1), rays


class Accel(NamedTuple):
    """A built acceleration structure for one scene and config.

    `data` is a pytree of device arrays that crosses the jit boundary as an
    ARGUMENT: closed-over concrete arrays would be embedded as literals in
    the compiled program, which for a mesh of a few hundred thousand
    triangles is tens of MB of constants. `bind(scene, data)` returns the
    IntersectFn inside the trace; `bind_first` (or None) the uncompacted
    bounce-0 intersector (see trace_paths).
    """

    data: object
    bind: Callable
    bind_first: Optional[Callable]


def _has_normal_maps(scene: SceneArrays) -> bool:
    from tracy_tpu.scene.scene import TEX_NORMAL

    return bool((np.asarray(scene.materials.tex_index)[:, TEX_NORMAL] >= 0).any())


def build_accel(scene: SceneArrays, cfg: RenderConfig) -> Accel:
    """Build cfg.accel for a concrete scene on the host (the reference's
    Startup -> ProcessScene boundary, cpu_details.cpp:26-86)."""
    if cfg.accel in ("packet", "tlas"):
        from tracy_tpu.accel.packet import (
            build_packet_bvh, intersect_packet, pack_bvh,
            prepare_packet_tri_data_host,
        )

        # Tangent interpolation only matters when some material has a
        # normal map (static decision from the concrete scene).
        with_tangent = _has_normal_maps(scene)
        leaf = cfg.packet_leaf_size
        depth = cfg.traversal_stack_depth
        if cfg.accel == "tlas":
            from tracy_tpu.accel.tlas import build_two_level

            two = build_two_level(scene, leaf_size=leaf,
                                  max_depth=max(depth - 8, 8))
            bvh = pack_bvh(two.stitched, leaf)
            # The stitched tree can be deeper than any single BLAS (TLAS
            # levels + left-deep multi-object-leaf chains), and the packet
            # traversal's stack clamp silently corrupts pops on overflow —
            # size the traversal stack from the stitched depth.
            depth = max(depth, int(two.stitched.max_depth) + 4)
        else:
            bvh, _host = build_packet_bvh(scene, leaf_size=leaf,
                                          max_depth=max(depth - 4, 8))
        psize = cfg.packet_size
        data = (bvh, prepare_packet_tri_data_host(scene, bvh, with_tangent))

        def bind(sc, acc):
            bvh_a, tri_a = acc
            return lambda o, d, act: intersect_packet(
                o, d, tri_a, bvh_a, active=act, leaf_size=leaf,
                stack_depth=depth, packet_size=psize,
                with_tangent=with_tangent,
            )

        if cfg.wave_compact_group <= 0:
            return Accel(data, bind, None)
        # Per-wave live-ray compaction around the rich packet intersector
        # (bit-exact routing, accel/reorder.py).
        from tracy_tpu.accel.reorder import compact_intersector

        grp = cfg.wave_compact_group

        def bind_compact(sc, acc):
            return compact_intersector(bind(sc, acc), grp,
                                       route_tangent=with_tangent)

        # Bounce 0 is all-live: run it uncompacted (trace_paths peels it;
        # identical results, two routings saved per sample).
        return Accel(data, bind_compact,
                     bind if cfg.wave_compact_skip_first else None)
    if cfg.accel == "bvh":
        from tracy_tpu.accel.bvh import build_scene_bvh, make_bvh_intersector

        _host, dev = build_scene_bvh(
            scene, leaf_size=cfg.bvh_leaf_size,
            max_depth=max(cfg.traversal_stack_depth - 4, 8),
        )
        leaf, depth = cfg.bvh_leaf_size, cfg.traversal_stack_depth
        return Accel(dev, lambda sc, acc: make_bvh_intersector(
            sc, acc, leaf_size=leaf, stack_depth=depth), None)
    return Accel((), lambda sc, acc: make_bruteforce_intersector(sc), None)


class Renderer:
    """Holds a config and jit-compiled step functions.

    Usage:
        r = Renderer(cfg)
        state = r.reset()
        for _ in range(frames): state, rays = r.step(scene, state)
        img = r.display(state)     # tonemapped [H, W, 3] float
    """

    def __init__(self, cfg: RenderConfig, intersector_factory=None):
        self.cfg = cfg
        self.accel: Optional[Accel] = None
        if intersector_factory is not None:
            # Back-compat: factory(scene) -> IntersectFn (closure-based).
            self.accel = Accel((), lambda sc, acc: intersector_factory(sc),
                               None)
        self._jit_step = jax.jit(self._step_impl, donate_argnums=(1,))
        self._jit_steps = jax.jit(self._steps_impl, donate_argnums=(1,),
                                  static_argnums=(3,))
        self.timer = Timer()
        self.total_rays = 0.0

    def _ensure_accel(self, scene: SceneArrays):
        """Build the acceleration structure once per renderer."""
        if self.accel is None:
            self.accel = build_accel(scene, self.cfg)

    def _intersectors(self, scene: SceneArrays, data):
        a = self.accel
        first = a.bind_first(scene, data) if a.bind_first else None
        return a.bind(scene, data), first

    def _step_impl(self, scene: SceneArrays, state: RenderState, data):
        isect, first = self._intersectors(scene, data)
        return render_step(scene, state, self.cfg, isect,
                           first_intersect_fn=first)

    def _steps_impl(self, scene: SceneArrays, state: RenderState, data,
                    num_steps: int):
        """`num_steps` progressive frames inside ONE device program: the
        per-dispatch overhead amortizes across frames."""
        isect, first = self._intersectors(scene, data)

        def body(_, carry):
            st, rays = carry
            st2, r = render_step(scene, st, self.cfg, isect,
                                 first_intersect_fn=first)
            return st2, rays + r

        return jax.lax.fori_loop(
            0, num_steps, body, (state, jnp.zeros((), jnp.int32))
        )

    def reset(self) -> RenderState:
        self.total_rays = 0.0
        self.timer.reset()
        return init_state(self.cfg)

    def step(self, scene: SceneArrays, state: RenderState):
        self._ensure_accel(scene)
        self.timer.begin()
        state, rays = self._jit_step(scene, state, self.accel.data)
        state.accum.block_until_ready()
        self.timer.end()
        self.total_rays += float(rays)
        return state, rays

    def step_many(self, scene: SceneArrays, state: RenderState, num_steps: int):
        """num_steps progressive frames in one device dispatch."""
        self._ensure_accel(scene)
        self.timer.begin()
        state, rays = self._jit_steps(scene, state, self.accel.data,
                                      num_steps)
        state.accum.block_until_ready()
        self.timer.end()
        self.total_rays += float(rays)
        return state, rays

    def render_progressive(self, scene: SceneArrays, frames: int,
                           state: Optional[RenderState] = None,
                           steps_per_dispatch: int = 4):
        """Run `frames` progressive steps; returns the final state.

        Prefer spp=1 configs with more frames: the sample axis then
        advances via the frame counter (statistically identical) and each
        step stays a single well-tested device program.
        """
        state = init_state(self.cfg) if state is None else state
        done = 0
        while done < frames:
            k = min(steps_per_dispatch, frames - done)
            state, _ = self.step_many(scene, state, k)
            done += k
        return state

    def display(self, state: RenderState) -> np.ndarray:
        return np.asarray(film.tonemap(state.accum, self.cfg))

    def display_u8(self, state: RenderState) -> np.ndarray:
        return np.asarray(film.to_u8(film.tonemap(state.accum, self.cfg)))

    @property
    def mrays_per_sec(self) -> float:
        t = self.timer.total
        return (self.total_rays / 1e6) / t if t > 0 else 0.0
