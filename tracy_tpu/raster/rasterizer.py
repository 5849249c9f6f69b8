"""Software rasterizer — raster-preview capability parity.

Data-parallel re-design of the reference CPU rasterizer (src/kernels/raster/cpu/
cpu_render.cpp:17-253), which uses the inverse-vertex-matrix homogeneous
edge-function method (Olano-Greer): per triangle, build the 3x3 matrix of
raster-space (x, y, w) columns, cull when det >= 0, invert, rows become edge
functions; 1/w and z interpolate linearly in screen space; attributes are
perspective-correct via (sample . (Minv @ attr)) * w. The top-left-ish
tie-break rules of TriangleEval (cpu_render.cpp:22-43) are reproduced.

Where the reference loops every triangle over every pixel under OpenMP
(O(tris x pixels) per frame), this version runs the same math as a
`lax.scan` over triangle chunks with an [pixels, chunk] lane grid and a
running (depth, winner) carry — depth resolve first, ONE shade per pixel
afterwards (the reference shades every passing fragment).

The fragment shader matches FS (cpu_render.cpp:79-96): albedo (or the AOV
debug views). The y-flip of SetPixel(x, h - y) is matched by construction.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from tracy_tpu.config import RenderConfig
from tracy_tpu.core import math as tm
from tracy_tpu.scene.scene import SceneArrays

# numpy scalar, not a jnp array: module-level jnp constants initialize the
# XLA backend at import, breaking jax.distributed.initialize (multi-process).
import numpy as _np

FLT_MAX = _np.float32(3.4028235e38)


def _det3(m):
    """Determinant of [..., 3, 3]."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _inv3(m, det):
    """Adjugate/det inverse of [..., 3, 3] (elementwise: exact in float32)."""
    adj = jnp.stack(
        [
            jnp.stack(
                [
                    m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1],
                    m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2],
                    m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1],
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2],
                    m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0],
                    m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2],
                ],
                axis=-1,
            ),
            jnp.stack(
                [
                    m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0],
                    m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1],
                    m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0],
                ],
                axis=-1,
            ),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _transform4(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] points through a [4,4] matrix -> [..., 4] (f32 mul-adds)."""
    return (
        p[..., 0:1] * m[:, 0] + p[..., 1:2] * m[:, 1] + p[..., 2:3] * m[:, 2] + m[:, 3]
    )


def _triangle_setup(scene: SceneArrays, width: int, height: int):
    """Per-triangle raster quantities, [T, ...]."""
    mvp = jnp.matmul(scene.camera.projection, scene.camera.view,
                     precision=jax.lax.Precision.HIGHEST)  # [4,4]
    idx = scene.indices
    corners = [scene.vertex_pos[idx[:, c]] for c in range(3)]  # 3x [T, 3]
    clip = [_transform4(mvp.astype(jnp.float32), p) for p in corners]  # 3x [T, 4]

    # Raster(v) = (w*(x+wc)/2, h*(wc-y)/2, z, wc)  (cpu_render.cpp:17-20)
    def raster(v):
        return jnp.stack(
            [
                width * (v[..., 0] + v[..., 3]) * 0.5,
                height * (v[..., 3] - v[..., 1]) * 0.5,
            ],
            axis=-1,
        )

    rast = [raster(v) for v in clip]  # 3x [T, 2]

    # Vertex matrix COLUMNS are the x', y', w vectors (cpu_render.cpp:151-156
    # constructs cc::mat3 from column vectors): m[i][j] with rows i = vertex,
    # columns j = (x', y', w). With this orientation rows of M^-1 are the
    # edge functions and M^-1 @ (1,1,1) interpolates exactly 1/w.
    m = jnp.stack(
        [
            jnp.stack([rast[0][..., 0], rast[1][..., 0], rast[2][..., 0]], axis=-1),
            jnp.stack([rast[0][..., 1], rast[1][..., 1], rast[2][..., 1]], axis=-1),
            jnp.stack([clip[0][..., 3], clip[1][..., 3], clip[2][..., 3]], axis=-1),
        ],
        axis=-1,
    )  # [T, 3(vertex), 3(x'/y'/w)] -> transpose of the row form
    det = _det3(m)
    front = det < 0.0  # det<0 => front-facing (cpu_render.cpp:158-160)
    safe_det = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    minv = _inv3(m, safe_det)  # [T, 3, 3]

    # Edge functions: COLUMNS of Minv (glm operator[] = column; the
    # reference's `vertex_matrix[i]` after inverse, cpu_render.cpp:166-171),
    # normalized by |a|+|b|.
    minv_t = jnp.swapaxes(minv, -1, -2)
    norm = jnp.abs(minv_t[..., 0]) + jnp.abs(minv_t[..., 1])
    edges = minv_t / jnp.maximum(norm[..., None], 1e-30)  # [T, 3(edge), 3]

    ones = jnp.ones((idx.shape[0], 3), clip[0].dtype)
    c_vec = jnp.einsum("tij,tj->ti", minv, ones, precision=jax.lax.Precision.HIGHEST)  # 1/w interpolator [T, 3]
    zs = jnp.stack([clip[0][..., 2], clip[1][..., 2], clip[2][..., 2]], axis=-1)
    z_vec = jnp.einsum("tij,tj->ti", minv, zs, precision=jax.lax.Precision.HIGHEST)  # z interpolator [T, 3]

    return edges, c_vec, z_vec, minv, front


def _edge_inside(e, value):
    """TriangleEval tie-break rules, vectorized (cpu_render.cpp:22-43).
    e: [..., 3] edge coefficients (a, b, c); value = a*x + b*y + c."""
    a = e[..., 0]
    b = e[..., 1]
    return (value > 0.0) | (
        (value == 0.0) & ((a > 0.0) | ((a == 0.0) & (b >= 0.0)))
    )


def render_raster(scene: SceneArrays, cfg: RenderConfig, tri_chunk: int = 64,
                  shaded: bool = False) -> jnp.ndarray:
    """Rasterize to a float image [H, W, 3] in [0, 1]. jit-compiled.

    shaded=False mirrors the CPU raster kernel's FS (albedo only,
    cpu_render.cpp:94). shaded=True mirrors the OpenGL kernel's ubershader
    (opengl_render.cpp:98-176): textured mix(baseColor, 0, metalness)/pi
    diffuse + emissive, normal mapping, and the equirect sky pass as the
    background (opengl_render.cpp:178-231).
    """
    return _render_raster_jit(scene, cfg, tri_chunk, shaded)


import functools


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _render_raster_jit(scene: SceneArrays, cfg: RenderConfig, tri_chunk: int,
                       shaded: bool):
    w, h = cfg.width, cfg.height
    t_count = scene.indices.shape[0]
    edges, c_vec, z_vec, minv, front = _triangle_setup(scene, w, h)

    # Pixel sample grid: centers (x+.5, y+.5), y is the rasterizer's row
    # (flipped at present time by SetPixel(x, h-y)).
    xs = jnp.arange(w, dtype=jnp.float32) + 0.5
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5
    px = jnp.tile(xs[None, :], (h, 1)).reshape(-1)  # [P]
    py = jnp.tile(ys[:, None], (1, w)).reshape(-1)

    num_chunks = -(-t_count // tri_chunk)
    pad = num_chunks * tri_chunk - t_count

    def pad_to(x):
        cfgpad = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfgpad).reshape((num_chunks, tri_chunk) + x.shape[1:])

    edges_c, cvec_c, zvec_c, front_c = (
        pad_to(edges), pad_to(c_vec), pad_to(z_vec),
        pad_to(front.astype(jnp.int32)),
    )
    base_c = jnp.arange(num_chunks, dtype=jnp.int32) * tri_chunk

    def body(carry, chunk):
        zbuf, winner = carry
        e, cv, zv, fr, base = chunk

        # Edge values for all (pixel, tri) pairs: [P, C] per edge row.
        def ev(row):
            return (
                e[None, :, row, 0] * px[:, None]
                + e[None, :, row, 1] * py[:, None]
                + e[None, :, row, 2]
            )

        inside = (
            _edge_inside(e[None, :, 0, :], ev(0))
            & _edge_inside(e[None, :, 1, :], ev(1))
            & _edge_inside(e[None, :, 2, :], ev(2))
            & (fr[None, :] > 0)
        )

        one_over_w = (
            cv[None, :, 0] * px[:, None] + cv[None, :, 1] * py[:, None] + cv[None, :, 2]
        )
        z_over_w = (
            zv[None, :, 0] * px[:, None] + zv[None, :, 1] * py[:, None] + zv[None, :, 2]
        )
        z = z_over_w / jnp.where(jnp.abs(one_over_w) > 1e-30, one_over_w, 1.0)
        z = jnp.where(inside, z, FLT_MAX)

        best = jnp.argmin(z, axis=-1)  # [P]
        rows = jnp.arange(z.shape[0])
        best_z = z[rows, best]
        # Reference depth test is z <= depth; non-covered lanes carry FLT_MAX
        # and must never win.
        better = (best_z <= zbuf) & (best_z < FLT_MAX)
        return (
            jnp.where(better, best_z, zbuf),
            jnp.where(better, base + best.astype(jnp.int32), winner),
        ), None

    init = (jnp.full((h * w,), FLT_MAX), jnp.full((h * w,), -1, jnp.int32))
    (zbuf, winner), _ = jax.lax.scan(
        body, init, (edges_c, cvec_c, zvec_c, front_c, base_c)
    )

    hit = winner >= 0
    tri = jnp.maximum(winner, 0)

    # Perspective-correct attribute interpolation for the winning triangle:
    # attr = (sample . (Minv @ attr_corners)) * w  (cpu_render.cpp:237-240).
    sample = jnp.stack([px, py, jnp.ones_like(px)], axis=-1)  # [P, 3]
    mi = minv[tri]  # [P, 3, 3]
    cw = c_vec[tri]
    one_over_w = jnp.sum(cw * sample, axis=-1)
    frag_w = 1.0 / jnp.where(jnp.abs(one_over_w) > 1e-30, one_over_w, 1.0)

    idx = scene.indices[tri]  # [P, 3]

    def interp(attr):  # attr: [V, K] -> [P, K]
        corners = jnp.stack([attr[idx[:, 0]], attr[idx[:, 1]], attr[idx[:, 2]]], axis=-1)
        # [P, K, 3] @ Minv: p_vec = Minv @ corners per component
        pv = jnp.einsum("pij,pkj->pki", mi, corners, precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum("pki,pi->pk", pv, sample,
                          precision=jax.lax.Precision.HIGHEST) * frag_w[:, None]

    from tracy_tpu.render.material import gather_surface_params, material_table_lookup

    mat_id = scene.tri_material[tri]
    albedo, rough_tab, metal_tab, _ior, emis_tab, _tr, _tex = material_table_lookup(
        scene.materials, mat_id
    )

    aov = cfg.aov
    if aov == "normals":
        n = tm.normalize(interp(scene.vertex_normal))
        color = n * 0.5 + 0.5
    elif aov == "metalness":
        color = jnp.repeat(metal_tab[:, None], 3, axis=-1)
    elif aov == "roughness":
        color = jnp.repeat(rough_tab[:, None], 3, axis=-1)
    elif aov == "emissive":
        color = emis_tab
    elif aov == "depth":
        color = jnp.repeat(jnp.where(hit, zbuf, 0.0)[:, None], 3, axis=-1)
    elif shaded:
        # OpenGL ubershader: textured diffuse/pi + emissive
        # (opengl_render.cpp:134-160).
        params = gather_surface_params(
            scene, mat_id, interp(scene.vertex_uv)[:, :2],
            interp(scene.vertex_normal), interp(scene.vertex_tangent),
            tex_filter="bilinear",
        )
        diffuse = params.basecolor * (1.0 - params.metalness[:, None])
        color = diffuse / jnp.pi + params.emissive
    else:  # beauty/basecolor: FS returns albedo (cpu_render.cpp:94)
        color = albedo

    if shaded and aov not in ("depth",):
        # Sky background pass: equirect emissive sampled by the un-projected
        # view ray (opengl_render.cpp:178-231).
        from tracy_tpu.render.integrator import sky_emission

        sgrid, tgrid = jnp.meshgrid(
            (jnp.arange(w) + 0.5) / w, 1.0 - (jnp.arange(h) + 0.5) / h
        )
        _o, view_dir = scene.camera.generate_rays(sgrid.reshape(-1), tgrid.reshape(-1))
        background = sky_emission(scene, view_dir)
        color = jnp.where(hit[:, None], color, background)
    else:
        color = jnp.where(hit[:, None], color, 0.0)
    # Raster row 0 is already the top of the view (y' = h*(w_c - y_clip)/2,
    # so y_ndc=+1 -> y'=0), which matches our image convention; the
    # reference's SetPixel(x, h - y) merely undoes its bottom-up bitmap.
    return jnp.clip(color, 0.0, 1.0).reshape(h, w, 3)
