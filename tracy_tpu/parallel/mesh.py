"""Multi-chip rendering and training over a jax.sharding.Mesh.

The reference's entire parallelism story is OpenMP threads over pixels plus
one CUDA kernel launch (SURVEY.md §2.7) — single process, single node, no
communication backend. This framework scales the same workload across a
device mesh:

  axes ('data', 'sample'):
    * 'data'   — image rows sharded across devices (the DP axis; pixels are
                 the batch of a renderer);
    * 'sample' — samples-per-pixel sharded across devices (the SP axis; spp is
                 the "sequence" dimension of a Monte Carlo renderer —
                 embarrassingly parallel, reduced with a mean).

Scene arrays (triangles, BVH, materials, textures) are REPLICATED — the
analogue of the reference's one-shot cudaMemcpy scene upload
(cuda_trace.cu:262-309) — because path-tracing gathers touch the whole scene
per bounce; sharding them would turn every gather into a collective. For
scenes larger than device memory, shard the sample axis only and stream
triangles.

Collectives used: pmean over 'sample' for radiance, psum over both axes for
ray counters and (through AD of shard_map) for parameter gradients. The
devices of one host are joined all to all, so the mesh shape follows the
algorithm (how rows and samples divide), not a topology. There is no
analogue of tp/pp/ep here: a path tracer has no layer pipeline or experts;
DP(pixels) x SP(spp) covers the machine. RNG streams are keyed by global
pixel/sample ids, so ANY mesh shape renders the same image: bit-identical
with rows sharded, equal up to float summation order with samples sharded
(tests/test_sharding.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from tracy_tpu.config import RenderConfig
from tracy_tpu.render import film
from tracy_tpu.render.renderer import Accel, RenderState, sample_radiance_rows
from tracy_tpu.scene.scene import SceneArrays


def make_render_mesh(
    n_data: Optional[int] = None,
    n_sample: int = 1,
    devices=None,
) -> Mesh:
    """('data', 'sample') mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_sample
    if n_data * n_sample != n:
        raise ValueError(f"mesh {n_data}x{n_sample} != {n} devices")
    import numpy as np

    dev_array = np.asarray(devices).reshape(n_data, n_sample)
    return Mesh(dev_array, ("data", "sample"))


def replicate_scene(scene: SceneArrays, mesh: Mesh) -> SceneArrays:
    return jax.device_put(scene, NamedSharding(mesh, P()))


def _check_divisible(cfg: RenderConfig, mesh: Mesh):
    nd = mesh.shape["data"]
    ns = mesh.shape["sample"]
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by data axis {nd}")
    if cfg.spp % ns != 0:
        raise ValueError(f"spp {cfg.spp} not divisible by sample axis {ns}")
    return nd, ns


def make_sharded_render_step(cfg: RenderConfig, mesh: Mesh, intersect_fn=None,
                             first_intersect_fn=None, accel: Accel = None):
    """(scene, state) -> (state', rays) with rows sharded over 'data' and
    spp over 'sample'. Bit-identical to the single-device render.

    accel: a built acceleration structure (renderer.build_accel); its
    arrays are replicated over the mesh and cross the jit boundary as
    arguments. Without it, intersect_fn (default: brute force) and the
    optional uncompacted bounce-0 first_intersect_fn are used."""
    nd, ns = _check_divisible(cfg, mesh)
    rows_per = cfg.height // nd
    spp_per = cfg.spp // ns
    data = () if accel is None else jax.device_put(
        accel.data, NamedSharding(mesh, P()))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("data", None, None), P(), P()),
        out_specs=(P("data", None, None), P()),
        check_vma=False,
    )
    def step_shard(scene, accum_rows, frame, data):
        isect, first = intersect_fn, first_intersect_fn
        if accel is not None:
            isect = accel.bind(scene, data)
            first = accel.bind_first(scene, data) if accel.bind_first else None
        di = jax.lax.axis_index("data")
        si = jax.lax.axis_index("sample")
        radiance, rays = sample_radiance_rows(
            scene,
            cfg,
            frame,
            isect,
            first_intersect_fn=first,
            row_offset=di * rows_per,
            num_rows=rows_per,
            spp_offset=si * spp_per,
            spp_count=spp_per,
            total_spp=cfg.spp,
        )
        radiance = jax.lax.pmean(radiance, "sample")
        rays = jax.lax.psum(rays, ("data", "sample"))
        if cfg.accumulate:
            accum = film.accumulate(accum_rows, radiance, frame.astype(radiance.dtype))
        else:
            accum = radiance
        return accum, rays

    @jax.jit
    def step_jit(scene: SceneArrays, state: RenderState, data):
        accum, rays = step_shard(scene, state.accum, state.frame, data)
        return RenderState(accum=accum, frame=state.frame + 1), rays

    def step(scene: SceneArrays, state: RenderState):
        return step_jit(scene, state, data)

    return step


def make_sharded_train_step(
    scene: SceneArrays, cfg: RenderConfig, mesh: Mesh, optimizer,
    intersect_fn=None, trainable_mask=None,
):
    """Full multi-chip inverse-rendering training step.

    Forward: shard_map render (rows over 'data', spp over 'sample').
    Backward: jax.grad through the shard_map — XLA inserts the psum of
    parameter gradients over both mesh axes (the renderer's analogue of DP
    gradient all-reduce). Returns (step_fn, init_opt_state).
    """
    import optax

    from tracy_tpu.diff.gradients import TrainableParams, apply_params, extract_params

    nd, ns = _check_divisible(cfg, mesh)
    rows_per = cfg.height // nd
    spp_per = cfg.spp // ns

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None, None), P()),
        out_specs=P("data", None, None),
        check_vma=False,
    )
    def render_rows(params, scene_in, target_rows, frame):
        di = jax.lax.axis_index("data")
        si = jax.lax.axis_index("sample")
        s = apply_params(scene_in, params)
        radiance, _rays = sample_radiance_rows(
            s,
            cfg,
            frame,
            intersect_fn,
            row_offset=di * rows_per,
            num_rows=rows_per,
            spp_offset=si * spp_per,
            spp_count=spp_per,
            total_spp=cfg.spp,
        )
        return jax.lax.pmean(radiance, "sample")

    def loss_fn(params, scene_in, target, frame):
        radiance = render_rows(params, scene_in, target, frame)
        return jnp.mean((radiance - target) ** 2)

    def step(params, opt_state, target, frame):
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, target, frame)
        if trainable_mask is not None:
            grads = jax.tree_util.tree_map(
                lambda g, m: g * jnp.asarray(m, g.dtype), grads, trainable_mask
            )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    init = optimizer.init(extract_params(scene))
    return jax.jit(step), init
