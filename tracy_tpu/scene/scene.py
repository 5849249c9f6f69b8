"""Scene container: host-side builder -> flat device-side SoA pytree.

The reference Scene (src/scene.h:17-87) owns a camera, vector<Mesh>,
vector<Material> (slot 0 reserved for the sky material, scene.h:21) and
vector<Texture>. Here the scene is ONE pytree of flat arrays — a
global triangle soup with a shared vertex buffer, a material parameter table
(SoA), a flat texture atlas and the camera — so the whole thing is a single
static-shaped jit argument, differentiable end-to-end (gradients flow into
`vertex_pos`, the material table and `tex_data`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tracy_tpu.core.camera import Camera
from tracy_tpu.scene import tessellate
from tracy_tpu.scene.hostmesh import HostMesh
from tracy_tpu.scene.textures import TextureAtlas
from tracy_tpu.utils.log import log

# Material slot 0 is the sky, like reference scene.h:21 / Scene::SKY_MATERIAL_ID.
SKY_MATERIAL_ID = 0

# Texture slot order matches reference Material::TextureID (material.h:17).
TEX_BASECOLOR, TEX_NORMAL, TEX_ROUGHNESS, TEX_METALNESS, TEX_EMISSIVE = range(5)
NUM_TEX_SLOTS = 5


@dataclasses.dataclass
class HostMaterial:
    """Host-side material record (reference Material, material.h:103-117).

    `emissive` is stored premultiplied by albedo exactly like the reference
    constructor (`emissive_{ in_emissive * in_color }`, material.h:24).
    """

    albedo: np.ndarray
    roughness: float = 1.0
    metalness: float = 0.0
    ior: float = 1.0
    emissive_multiplier: float = 0.0
    translucency: float = 0.0
    textures: np.ndarray = None  # [5] int, -1 = unset

    def __post_init__(self):
        self.albedo = np.asarray(self.albedo, dtype=np.float64).reshape(3)
        if self.textures is None:
            self.textures = np.full((NUM_TEX_SLOTS,), -1, dtype=np.int32)

    @property
    def emissive(self) -> np.ndarray:
        return self.emissive_multiplier * self.albedo


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MaterialTable:
    """SoA material parameters on device."""

    albedo: jnp.ndarray  # [M, 3]
    roughness: jnp.ndarray  # [M]
    metalness: jnp.ndarray  # [M]
    ior: jnp.ndarray  # [M]
    emissive: jnp.ndarray  # [M, 3] (premultiplied)
    translucent: jnp.ndarray  # [M]
    tex_index: jnp.ndarray  # [M, 5] int32, -1 = none

    def tree_flatten(self):
        return (
            self.albedo,
            self.roughness,
            self.metalness,
            self.ior,
            self.emissive,
            self.translucent,
            self.tex_index,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SceneArrays:
    """The complete scene as a device pytree (global triangle soup)."""

    vertex_pos: jnp.ndarray  # [V, 3]
    vertex_normal: jnp.ndarray  # [V, 3]
    vertex_uv: jnp.ndarray  # [V, 2]
    vertex_tangent: jnp.ndarray  # [V, 3]
    indices: jnp.ndarray  # [T, 3] int32
    tri_material: jnp.ndarray  # [T] int32
    materials: MaterialTable
    tex_data: jnp.ndarray  # [P, 4] float32 atlas
    tex_table: jnp.ndarray  # [K, 4] int32 (offset, width, height, 0)
    camera: Camera

    # Static metadata (aux data — not traced).
    width: int = 640
    height: int = 480
    name: str = ""
    # Per-object contiguous ranges into the global soup: ((start, count),
    # ...) over triangles and vertices — the object structure the two-level
    # TLAS/BLAS build needs (reference keeps vector<Mesh>, scene.h:67).
    object_tri_ranges: tuple = ()
    object_vert_ranges: tuple = ()

    def tree_flatten(self):
        children = (
            self.vertex_pos,
            self.vertex_normal,
            self.vertex_uv,
            self.vertex_tangent,
            self.indices,
            self.tri_material,
            self.materials,
            self.tex_data,
            self.tex_table,
            self.camera,
        )
        aux = (self.width, self.height, self.name,
               self.object_tri_ranges, self.object_vert_ranges)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, width=aux[0], height=aux[1], name=aux[2],
                   object_tri_ranges=aux[3], object_vert_ranges=aux[4])

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertex_pos.shape[0]

    def triangle_vertices(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """Gather the three corner positions of every triangle: 3x [T, 3].

        Done on device inside the jitted step so gradients flow back into the
        shared `vertex_pos` buffer.
        """
        return (
            self.vertex_pos[self.indices[:, 0]],
            self.vertex_pos[self.indices[:, 1]],
            self.vertex_pos[self.indices[:, 2]],
        )


class SceneBuilder:
    """Host-side scene assembly with the reference Scene's API surface
    (Scene::AddSphere/AddBox/AddTriangle/AddMesh/AddTexture, scene.h:24-32)."""

    def __init__(self, width: int = 640, height: int = 480, name: str = ""):
        self.width = width
        self.height = height
        self.name = name
        self.meshes: List[HostMesh] = []
        # Slot 0 = sky (default: black emissive), like the reference.
        self.materials: List[HostMaterial] = [HostMaterial(albedo=np.zeros(3))]
        self.atlas = TextureAtlas()
        self.camera_params = dict(
            eye=(0.0, 0.0, 1.0), center=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0), fov_degrees=60.0
        )

    # -- camera --------------------------------------------------------------

    def set_camera(self, eye, center, up, fov_degrees: float):
        self.camera_params = dict(eye=eye, center=center, up=up, fov_degrees=fov_degrees)
        return self

    # -- materials & textures ------------------------------------------------

    def add_material(self, albedo, roughness=1.0, metalness=0.0, ior=1.0,
                     emissive=0.0, translucency=0.0) -> int:
        self.materials.append(
            HostMaterial(albedo, roughness, metalness, ior, emissive, translucency)
        )
        return len(self.materials) - 1

    def add_texture(self, image: np.ndarray, srgb: bool = False) -> int:
        return self.atlas.add(image, srgb=srgb)

    def set_material_texture(self, material_id: int, slot: int, texture_id: int):
        self.materials[material_id].textures[slot] = texture_id
        return self

    def set_sky_color(self, albedo):
        """SKY constant: Material(albedo, 0, 0, 0, 1) per scene.cpp:368."""
        sky = HostMaterial(albedo, roughness=0.0, metalness=0.0, ior=0.0,
                           emissive_multiplier=1.0)
        sky.textures = self.materials[SKY_MATERIAL_ID].textures
        self.materials[SKY_MATERIAL_ID] = sky
        return self

    def set_sky_texture(self, texture_id: int):
        self.materials[SKY_MATERIAL_ID].textures[TEX_EMISSIVE] = texture_id
        return self

    # -- geometry ------------------------------------------------------------

    def _add(self, mesh: HostMesh, material_id: int) -> HostMesh:
        mesh.material_id = material_id
        self.meshes.append(mesh)
        return mesh

    def add_sphere(self, center, radius, material_id: int, steps: int = 32) -> HostMesh:
        return self._add(tessellate.sphere(center, radius, steps), material_id)

    def add_box(self, bottom, top, material_id: int, transform=None) -> HostMesh:
        return self._add(tessellate.box(bottom, top, transform), material_id)

    def add_triangle(self, v1, v2, v3, material_id: int) -> HostMesh:
        return self._add(tessellate.triangle(v1, v2, v3), material_id)

    def add_mesh(self, mesh: HostMesh, material_id: int, transform=None,
                 compute_normals: bool = False) -> HostMesh:
        """Mirrors Scene::AddMesh (scene.cpp:224-229): transform, bbox, then
        (optionally) flat normals, then tangents."""
        if transform is not None:
            mesh.transform(transform)
        mesh.compute_bounding_box()
        if compute_normals:
            mesh.compute_normals()
        mesh.compute_tangents()
        return self._add(mesh, material_id)

    # -- stats ---------------------------------------------------------------

    @property
    def num_objects(self) -> int:
        return len(self.meshes)

    @property
    def num_triangles(self) -> int:
        return sum(m.num_triangles for m in self.meshes)

    @property
    def has_translucent(self) -> bool:
        """Any BTDF material (rays refract through and survive RR for all
        bounces — drives the compaction regime, accel/reorder.py)."""
        return any(m.translucency > 0.0 for m in self.materials)

    # -- build ---------------------------------------------------------------

    def build(self, dtype=jnp.float32) -> SceneArrays:
        tri_ranges, vert_ranges = [], []
        if self.meshes:
            pos, nrm, uv, tan, idx, mat = [], [], [], [], [], []
            voffset = 0
            toffset = 0
            for m in self.meshes:
                if m.tangents is None:
                    m.compute_tangents()
                pos.append(m.positions)
                nrm.append(m.normals)
                uv.append(m.uvs)
                tan.append(m.tangents)
                idx.append(m.indices.astype(np.int64) + voffset)
                mid = m.material_id if m.material_id >= 0 else 0
                mat.append(np.full((m.num_triangles,), mid, dtype=np.int32))
                tri_ranges.append((toffset, m.num_triangles))
                vert_ranges.append((voffset, m.num_vertices))
                voffset += m.num_vertices
                toffset += m.num_triangles
            pos = np.concatenate(pos)
            nrm = np.concatenate(nrm)
            uv = np.concatenate(uv)
            tan = np.concatenate(tan)
            idx = np.concatenate(idx).astype(np.int32)
            mat = np.concatenate(mat)
        else:
            # Degenerate placeholder triangle keeps shapes non-empty.
            pos = np.zeros((3, 3))
            nrm = np.tile(np.array([[0.0, 0.0, 1.0]]), (3, 1))
            uv = np.zeros((3, 2))
            tan = np.tile(np.array([[1.0, 0.0, 0.0]]), (3, 1))
            idx = np.array([[0, 1, 2]], dtype=np.int32)
            mat = np.zeros((1,), dtype=np.int32)

        mats = self.materials
        table = MaterialTable(
            albedo=jnp.asarray(np.stack([m.albedo for m in mats]), dtype=dtype),
            roughness=jnp.asarray([m.roughness for m in mats], dtype=dtype),
            metalness=jnp.asarray([m.metalness for m in mats], dtype=dtype),
            ior=jnp.asarray([m.ior for m in mats], dtype=dtype),
            emissive=jnp.asarray(np.stack([m.emissive for m in mats]), dtype=dtype),
            translucent=jnp.asarray([m.translucency for m in mats], dtype=dtype),
            tex_index=jnp.asarray(np.stack([m.textures for m in mats]), dtype=jnp.int32),
        )

        tex_data, tex_table = self.atlas.pack()

        camera = Camera.setup(
            eye=self.camera_params["eye"],
            center=self.camera_params["center"],
            up=self.camera_params["up"],
            fov_degrees=self.camera_params["fov_degrees"],
            aspect_ratio=float(self.width) / float(max(self.height, 1)),
            dtype=dtype,
        )

        log(
            "scene '%s': %d objects, %d tris, %d verts, %d materials, %d textures"
            % (self.name, self.num_objects, len(idx), len(pos), len(mats), len(self.atlas))
        )

        return SceneArrays(
            vertex_pos=jnp.asarray(pos, dtype=dtype),
            vertex_normal=jnp.asarray(nrm, dtype=dtype),
            vertex_uv=jnp.asarray(uv, dtype=dtype),
            vertex_tangent=jnp.asarray(tan, dtype=dtype),
            indices=jnp.asarray(idx),
            tri_material=jnp.asarray(mat),
            materials=table,
            tex_data=jnp.asarray(tex_data),
            tex_table=jnp.asarray(tex_table),
            camera=camera,
            width=self.width,
            height=self.height,
            name=self.name,
            object_tri_ranges=tuple(tri_ranges),
            object_vert_ranges=tuple(vert_ranges),
        )
