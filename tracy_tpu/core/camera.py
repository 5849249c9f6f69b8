"""Camera: view/projection matrices and batched inverse-VP ray generation.

Mirrors the reference camera (src/camera.h:11-85): rays are generated by
un-projecting the NDC point (s, t, 1)*2-1 through inverse(projection @ view)
— not the classic lower-left-corner method. znear/zfar default to .1/10000
(camera.h:37).

Here the camera is a small pytree of arrays so it can live inside a
jitted render step, and `generate_rays` is batched over an arbitrary number of
(s, t) samples at once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tracy_tpu.core import math as tm


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Camera:
    """Pinhole camera as a pytree: eye position + inverse view-projection."""

    eye: jnp.ndarray  # [3]
    inv_view_projection: jnp.ndarray  # [4, 4]
    view: jnp.ndarray  # [4, 4]
    projection: jnp.ndarray  # [4, 4]

    def tree_flatten(self):
        return (self.eye, self.inv_view_projection, self.view, self.projection), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction -------------------------------------------------------

    @classmethod
    def setup(
        cls,
        eye,
        center,
        up,
        fov_degrees: float,
        aspect_ratio: float,
        znear: float = 0.1,
        zfar: float = 10000.0,
        dtype=jnp.float32,
    ) -> "Camera":
        """Build from lookAt parameters, like reference Camera::Setup."""
        view = tm.look_at(eye, center, up)
        proj = tm.perspective(tm.radians(fov_degrees), aspect_ratio, znear, zfar)
        inv_vp = np.linalg.inv(proj @ view)
        return cls(
            eye=jnp.asarray(eye, dtype=dtype),
            inv_view_projection=jnp.asarray(inv_vp, dtype=dtype),
            view=jnp.asarray(view, dtype=dtype),
            projection=jnp.asarray(proj, dtype=dtype),
        )

    # -- ray generation ------------------------------------------------------

    def generate_rays(self, s, t) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched version of reference Camera::GetRayFrom (camera.h:28-35).

        Args:
          s, t: arrays of identical shape [...] with values in [0, 1].

        Returns:
          (origins [..., 3], directions [..., 3]); directions are normalized.
        """
        ndc = jnp.stack([s, t, jnp.ones_like(s)], axis=-1) * 2.0 - 1.0  # [..., 3]
        p = jnp.concatenate([ndc, jnp.ones_like(ndc[..., :1])], axis=-1)  # [..., 4]
        # Explicit mul-add instead of `p @ M.T`: an accelerator may run a
        # float32 matmul at reduced precision (TF32 or bf16 passes) by
        # default, and the homogeneous w component cancels catastrophically
        # (-> inf/NaN directions). Elementwise f32 math is exact and just as
        # fast at this size.
        m = self.inv_view_projection
        world = (
            p[..., 0:1] * m[:, 0]
            + p[..., 1:2] * m[:, 1]
            + p[..., 2:3] * m[:, 2]
            + p[..., 3:4] * m[:, 3]
        )  # [..., 4]
        world = world[..., :3] / world[..., 3:4]
        direction = tm.normalize(world - self.eye)
        origin = jnp.broadcast_to(self.eye, direction.shape)
        return origin, direction


def pixel_samples(width: int, height: int, jitter_u, jitter_v):
    """(s, t) sample coordinates for every pixel, matching the reference loop.

    The reference computes u=(x+rand)/w, v=(y+rand)/h with y=0 the *bottom*
    display row (Win32 bottom-up DIB; cpu_trace.cpp:60-61). Our images use
    row 0 = top, so v flips: a pixel at image row r uses v=(height-1-r+rand)/h.

    Args:
      jitter_u/jitter_v: [height, width] jitters in [0, 1).

    Returns: (s, t) each [height, width].
    """
    x = jnp.arange(width, dtype=jitter_u.dtype)[None, :]
    r = jnp.arange(height, dtype=jitter_v.dtype)[:, None]
    y = (height - 1) - r  # display row (bottom-up) from image row (top-down)
    s = (x + jitter_u) / width
    t = (y + jitter_v) / height
    return jnp.broadcast_to(s, (height, width)), jnp.broadcast_to(t, (height, width))


def pixel_samples_rows(width: int, height: int, rows, jitter_u, jitter_v):
    """pixel_samples for an arbitrary band of global image rows.

    Args:
      rows: [R] global image row indices (traced OK — used for sharding).
      jitter_u/jitter_v: [R, width] jitters in [0, 1).

    Returns: (s, t) each [R, width].
    """
    r = rows.astype(jitter_v.dtype)[:, None]
    x = jnp.arange(width, dtype=jitter_u.dtype)[None, :]
    y = (height - 1) - r
    s = (x + jitter_u) / width
    t = (y + jitter_v) / height
    shape = (jitter_u.shape[0], width)
    return jnp.broadcast_to(s, shape), jnp.broadcast_to(t, shape)
