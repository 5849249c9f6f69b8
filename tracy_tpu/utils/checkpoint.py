"""Checkpoint/resume for progressive renders and inverse-rendering runs.

The reference has NO persistence at all — accumulation state lives in RAM/GL
textures and dies on exit or camera cut (SURVEY.md §5). Here the render state
(accumulated radiance + frame counter) and the FULL training state (params +
optimizer moments + step) round-trip through npz files, so long progressive
renders and optimizations survive restarts and resume exactly: the
counter-based RNG continues the stream deterministically from the saved
frame index.

Elasticity: checkpoints are mesh-agnostic. The accum image and the RNG
streams are keyed by GLOBAL pixel/sample ids (parallel/mesh.py), so a state
saved under one `jax.sharding.Mesh` shape restores onto ANY other shape —
including a single device — and continues bit-identically
(tests/test_elastic.py). That is the failure-recovery story: lose half
the devices, restore the last checkpoint on what remains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tracy_tpu.render.renderer import RenderState


def save_render_state(path: str, state: RenderState):
    np.savez(path, accum=np.asarray(state.accum), frame=np.asarray(state.frame))


def load_render_state(path: str, mesh=None) -> RenderState:
    """Restore a render state; with `mesh`, place accum rows sharded over
    the 'data' axis (the sharded step's input layout) — the mesh shape does
    NOT need to match the one the checkpoint was written under."""
    data = np.load(path)
    accum = jnp.asarray(data["accum"])
    frame = jnp.asarray(data["frame"], jnp.int32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        accum = jax.device_put(accum, NamedSharding(mesh, P("data", None, None)))
        frame = jax.device_put(frame, NamedSharding(mesh, P()))
    return RenderState(accum=accum, frame=frame)


def save_params(path: str, params):
    """Save a TrainableParams (or any flat NamedTuple of arrays)."""
    np.savez(path, **{k: np.asarray(v) for k, v in params._asdict().items()})


def load_params(path: str, cls):
    data = np.load(path)
    return cls(**{k: jnp.asarray(data[k]) for k in data.files})


def save_pytree(path: str, tree):
    """Save ANY pytree of arrays (e.g. an optax optimizer state) as npz.

    The treedef is not serialized — load with `load_pytree(path, like=...)`
    where `like` is a structurally identical tree (e.g. optimizer.init(params)
    rebuilt at startup)."""
    leaves = jax.tree_util.tree_leaves(tree)
    np.savez(path, **{f"leaf{i}": np.asarray(v) for i, v in enumerate(leaves)})


def load_pytree(path: str, like):
    """Restore a pytree saved by save_pytree into the structure of `like`."""
    data = np.load(path)
    treedef = jax.tree_util.tree_structure(like)
    like_leaves = jax.tree_util.tree_leaves(like)
    if len(data.files) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, structure expects "
            f"{len(like_leaves)}"
        )
    leaves = [
        jnp.asarray(data[f"leaf{i}"], np.asarray(l).dtype)
        for i, l in enumerate(like_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_train_state(path: str, params, opt_state, step: int):
    """Full inverse-rendering state: params + optimizer moments + step.

    Without the optimizer moments a resumed Adam run diverges from the
    uninterrupted one; with them resume is bit-identical
    (tests/test_elastic.py::test_train_resume_bit_identical)."""
    blobs = {f"p_{k}": np.asarray(v) for k, v in params._asdict().items()}
    for i, v in enumerate(jax.tree_util.tree_leaves(opt_state)):
        blobs[f"o_leaf{i}"] = np.asarray(v)
    blobs["step"] = np.asarray(step, np.int64)
    np.savez(path, **blobs)


def load_train_state(path: str, params_cls, opt_like):
    """Restore (params, opt_state, step). `opt_like` is a structurally
    identical optimizer state (optimizer.init(params) at startup)."""
    data = np.load(path)
    params = params_cls(**{
        k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("p_")
    })
    treedef = jax.tree_util.tree_structure(opt_like)
    like_leaves = jax.tree_util.tree_leaves(opt_like)
    leaves = [
        jnp.asarray(data[f"o_leaf{i}"], np.asarray(l).dtype)
        for i, l in enumerate(like_leaves)
    ]
    opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    return params, opt_state, int(data["step"])
