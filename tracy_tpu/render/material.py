"""Material evaluation and scatter — the Unreal-ish BRDF/BTDF.

Vectorized, branch-free, differentiable re-design of reference
Material::Scatter (src/material.h:210-268) and the textured parameter getters
(material.h:164-203). Semantics matched:

* spec direction = lerp(reflect, normal + unit_sphere_sample, roughness);
* BRDF: specular chance = lerp(lerp(.1, 1, metalness), 1,
  (1-roughness) * schlick(-VdotN, 1)); specular color = lerp(0.85, basecolor,
  metalness); diffuse = cosine-ish `normal + unit sphere` with attenuation
  basecolor;
* BTDF (translucent > EPS): inside test via VdotN > EPS, Snell cosine, eta
  swap, refracted dir lerped to the diffuse sample by roughness, Schlick
  probability choosing specular vs transmitted, attenuation basecolor;
* scattered origin offset by 0.001 * direction (kRayOffset);
* normal mapping through the interpolated (unnormalized, reference quirk)
  tangent frame (material.h:188-203).

Deliberate divergence: on total internal reflection the reference computes a
NaN Schlick cosine (C++ sqrt of a negative) whose comparison always picks the
transmitted branch with a degenerate zero direction; we clamp the cosine to 0
so TIR rays reflect speculatively — physically correct and NaN-free, which
differentiability requires.

Differentiability: the discrete specular-vs-diffuse decision is made on
`stop_gradient`ed probabilities (detached sampling); attenuation/emission stay
differentiable w.r.t. the material table and textures.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tracy_tpu.core import math as tm
from tracy_tpu.render.texture import sample_bilinear, sample_nearest
from tracy_tpu.scene.scene import (
    TEX_BASECOLOR,
    TEX_EMISSIVE,
    TEX_METALNESS,
    TEX_NORMAL,
    TEX_ROUGHNESS,
)

RAY_OFFSET = 1.0e-3  # kRayOffset, material.h:213
EPS = tm.EPS


class SurfaceParams(NamedTuple):
    """Per-lane material parameters after texture fetches."""

    basecolor: jnp.ndarray  # [N, 3]
    roughness: jnp.ndarray  # [N]
    metalness: jnp.ndarray  # [N]
    ior: jnp.ndarray  # [N]
    emissive: jnp.ndarray  # [N, 3]
    translucent: jnp.ndarray  # [N]
    normal: jnp.ndarray  # [N, 3] (normal-mapped shading normal)


def schlick(cos, ref_idx):
    """material.h:137-142."""
    r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos) ** 5


def random_on_unit_sphere(r1, r2):
    """material.h:144-157 — z/phi mapping; r1 -> z, r2 -> phi (draw order)."""
    z = 2.0 * r1 - 1.0
    phi = 2.0 * jnp.pi * r2
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def material_table_lookup(materials, mat_id):
    """Fetch material-table rows for [N] ids.

    A plain row gather: exact, and cheap on a GPU. (A one-hot contraction
    would run as a float32 matrix product, which a GPU may execute in TF32
    and round the table to ~3 decimal digits.) Ids outside the table are
    clamped into it; such lanes are misses, which the caller masks.

    Returns (albedo, roughness, metalness, ior, emissive, translucent,
    tex_index[N,5] int32).
    """
    m = materials

    def pick(tab):  # [M] or [M, K]
        return jnp.take(tab, mat_id, axis=0, mode="clip")

    return (
        pick(m.albedo),
        pick(m.roughness),
        pick(m.metalness),
        pick(m.ior),
        pick(m.emissive),
        pick(m.translucent),
        pick(m.tex_index).astype(jnp.int32),
    )


def scene_has_textures(scene) -> bool:
    """Static (shape-based) check: the atlas placeholder is a single texel."""
    return scene.tex_data.shape[0] > 1


def gather_surface_params(scene, mat_id, uv, shading_normal, tangent,
                          tex_filter: str = "nearest") -> SurfaceParams:
    """Textured parameter getters (material.h:164-203), vectorized.

    mat_id: [N] int32; uv: [N,2]; shading_normal/tangent: [N,3] interpolated
    (tangent intentionally unnormalized — reference quirk). Material table
    rows come from a one-hot contraction (gather-free); texture fetches only
    exist in the graph when the scene actually has textures (static check).

    tex_filter: 'nearest' for the path tracers (Texture::GetPixel,
    texture.h:50-57); 'bilinear' for the raster preview (the GL kernel's
    GL_LINEAR filter, opengl_render.cpp:476-480).
    """
    albedo, rough, metal, ior, emis, transl, tex = material_table_lookup(
        scene.materials, mat_id
    )

    if not scene_has_textures(scene):
        return SurfaceParams(
            basecolor=albedo,
            roughness=rough,
            metalness=metal,
            ior=ior,
            emissive=emis,
            translucent=transl,
            normal=shading_normal,
        )

    sampler = sample_bilinear if tex_filter == "bilinear" else sample_nearest

    def fetch(slot):
        tid = tex[..., slot]
        rgba = sampler(scene.tex_data, scene.tex_table, tid, uv)
        return tid >= 0, rgba

    has_bc, bc = fetch(TEX_BASECOLOR)
    has_r, r = fetch(TEX_ROUGHNESS)
    has_m, mt = fetch(TEX_METALNESS)
    has_e, em = fetch(TEX_EMISSIVE)
    has_n, nm = fetch(TEX_NORMAL)

    basecolor = jnp.where(has_bc[:, None], bc[..., :3], albedo)
    roughness = jnp.where(has_r, r[..., 0], rough)
    metalness = jnp.where(has_m, mt[..., 0], metal)
    emissive = jnp.where(has_e[:, None], em[..., :3], emis)

    # Normal mapping (material.h:189-203): tbn = [bitangent, tangent, normal]
    # columns with bitangent = cross(N, normalize(T - dot(T,N)N)) and the raw
    # interpolated T in the matrix itself.
    n_tex = nm[..., :3] * 2.0 - 1.0
    t_ortho = tm.normalize(tangent - tm.dot(tangent, shading_normal) * shading_normal)
    bitangent = tm.cross(shading_normal, t_ortho)
    mapped = tm.normalize(
        bitangent * n_tex[..., 0:1] + tangent * n_tex[..., 1:2] + shading_normal * n_tex[..., 2:3]
    )
    normal = jnp.where(has_n[:, None], mapped, shading_normal)

    return SurfaceParams(
        basecolor=basecolor,
        roughness=roughness,
        metalness=metalness,
        ior=ior,
        emissive=emissive,
        translucent=transl,
        normal=normal,
    )


class ScatterResult(NamedTuple):
    origin: jnp.ndarray  # [N, 3]
    direction: jnp.ndarray  # [N, 3]
    attenuation: jnp.ndarray  # [N, 3]
    emission: jnp.ndarray  # [N, 3]


def scatter(
    ray_dir: jnp.ndarray,  # [N, 3] incoming (normalized)
    hit_point: jnp.ndarray,  # [N, 3]
    params: SurfaceParams,
    u_sphere_z: jnp.ndarray,  # [N] uniform draw
    u_sphere_phi: jnp.ndarray,  # [N]
    u_spec: jnp.ndarray,  # [N] specular-decision draw
) -> ScatterResult:
    """Branch-free Material::Scatter over all lanes at once."""
    normal = params.normal
    roughness = params.roughness[:, None]
    v_dot_n = tm.dot(ray_dir, normal)  # [N, 1]

    sphere = random_on_unit_sphere(u_sphere_z, u_sphere_phi)
    scattered = normal + sphere
    reflected = tm.reflect(ray_dir, normal)
    specular = tm.lerp(reflected, scattered, roughness)

    # ---- BTDF branch values (material.h:236-249) ----
    inside = v_dot_n[..., 0] > EPS
    ior = params.ior
    cos_in = jnp.sqrt(
        jnp.maximum(1.0 - ior**2 * (1.0 - v_dot_n[..., 0] ** 2), 0.0)
    )  # clamped: TIR -> 0 -> schlick = 1 -> always specular (see module doc)
    cosine = jnp.where(inside, cos_in, -v_dot_n[..., 0])
    eta = jnp.where(inside, ior, 1.0 / jnp.maximum(ior, 1e-8))
    refracted = tm.refract(ray_dir, normal, eta[:, None])
    transmitted = tm.lerp(refracted, scattered, roughness)
    btdf_spec_chance = schlick(cosine, eta)
    btdf_is_spec = u_spec < jax.lax.stop_gradient(btdf_spec_chance)
    btdf_dir = jnp.where(btdf_is_spec[:, None], specular, transmitted)
    btdf_atten = params.basecolor

    # ---- BRDF branch values (material.h:250-261) ----
    metalness = params.metalness[:, None]
    specularcolor = tm.lerp(jnp.full_like(params.basecolor, 0.85), params.basecolor, metalness)
    mat_spec_chance = 0.1 + (1.0 - 0.1) * params.metalness
    fresnel = (1.0 - params.roughness) * schlick(-v_dot_n[..., 0], 1.0)
    spec_chance = mat_spec_chance + (1.0 - mat_spec_chance) * fresnel
    brdf_is_spec = u_spec < jax.lax.stop_gradient(spec_chance)
    brdf_dir = jnp.where(brdf_is_spec[:, None], specular, scattered)
    brdf_atten = jnp.where(brdf_is_spec[:, None], specularcolor, params.basecolor)

    translucent = params.translucent[:, None] > EPS
    direction = tm.normalize(jnp.where(translucent, btdf_dir, brdf_dir))
    attenuation = jnp.where(translucent, btdf_atten, brdf_atten)

    origin = hit_point + RAY_OFFSET * direction
    return ScatterResult(
        origin=origin,
        direction=direction,
        attenuation=attenuation,
        emission=params.emissive,
    )
