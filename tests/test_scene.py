import numpy as np
import pytest

from tracy_tpu.scene import tessellate
from tracy_tpu.scene.hostmesh import HostMesh
from tracy_tpu.scene.scene import SceneBuilder, SKY_MATERIAL_ID
from tracy_tpu.scene.scn_parser import default_scene, load_scene


def test_sphere_tessellation_matches_reference_counts():
    # Reference AddSphere with steps=32: 32*32 quads * 4 verts (scene.cpp:50-131).
    m = tessellate.sphere((0, 0, 0), 1.0, steps=32)
    assert m.num_vertices == 32 * 32 * 4
    # tris: top row 32, bottom row 32, middle rows (32-2)*32*2
    assert m.num_triangles == 32 + 32 + (32 - 2) * 32 * 2


def test_sphere_on_surface_and_normals():
    c, r = np.array([1.0, 2.0, 3.0]), 2.5
    m = tessellate.sphere(c, r, steps=16)
    d = np.linalg.norm(m.positions - c, axis=-1)
    np.testing.assert_allclose(d, r, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(m.normals, axis=-1), 1.0, rtol=1e-6)
    # Normals point outward.
    outward = np.sum((m.positions - c) * m.normals, axis=-1)
    assert (outward > 0).all()


def test_sphere_winding_ccw_from_outside():
    """Cross(e1,e2) should point outward (backface culling relies on this)."""
    m = tessellate.sphere((0, 0, 0), 1.0, steps=8)
    v0 = m.positions[m.indices[:, 0]]
    v1 = m.positions[m.indices[:, 1]]
    v2 = m.positions[m.indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    centers = (v0 + v1 + v2) / 3
    # Non-degenerate faces should face outward.
    area = np.linalg.norm(fn, axis=-1)
    ok = area > 1e-9
    assert (np.sum(fn[ok] * centers[ok], axis=-1) > 0).all()


def test_box_tessellation():
    m = tessellate.box((0, 0, 0), (1, 2, 3))
    assert m.num_vertices == 24
    assert m.num_triangles == 12
    np.testing.assert_allclose(m.aabb_min, [0, 0, 0])
    np.testing.assert_allclose(m.aabb_max, [1, 2, 3])
    # All face normals unit, axis-aligned.
    assert set(np.abs(m.normals).sum(axis=-1)) == {1.0}


def test_box_outward_normals_and_winding():
    m = tessellate.box((-1, -1, -1), (1, 1, 1))
    v0 = m.positions[m.indices[:, 0]]
    v1 = m.positions[m.indices[:, 1]]
    v2 = m.positions[m.indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    centers = (v0 + v1 + v2) / 3
    assert (np.sum(fn * centers, axis=-1) > 0).all()
    # Geometric winding normal agrees with stored vertex normal.
    stored = m.normals[m.indices[:, 0]]
    cos = np.sum(fn * stored, axis=-1) / np.linalg.norm(fn, axis=-1)
    np.testing.assert_allclose(cos, 1.0, atol=1e-6)


def test_triangle_flat_normal():
    m = tessellate.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 3, atol=1e-12)


def test_mesh_transform_normals():
    m = tessellate.box((0, 0, 0), (1, 1, 1))
    from tracy_tpu.core import math as tm

    m.transform(tm.scale((2.0, 1.0, 1.0)))
    np.testing.assert_allclose(np.linalg.norm(m.normals, axis=-1), 1.0, rtol=1e-6)
    assert m.positions[:, 0].max() == 2.0


def test_compute_normals_last_face_wins():
    # Two faces sharing vertices 1,2 with opposite normals; last face wins.
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 1]], dtype=float)
    idx = np.array([[0, 1, 2], [2, 1, 3]])
    m = HostMesh(pos, idx).compute_normals()
    f2 = np.cross(pos[1] - pos[2], pos[3] - pos[2])
    f2 = f2 / np.linalg.norm(f2)
    np.testing.assert_allclose(m.normals[1], f2, atol=1e-12)
    np.testing.assert_allclose(m.normals[2], f2, atol=1e-12)


def test_builder_material_slot0_is_sky():
    b = SceneBuilder()
    mid = b.add_material((1, 0, 0), 0.5, 0.0)
    assert mid == 1
    b.set_sky_color((2.0, 3.0, 4.0))
    scene = b.build()
    np.testing.assert_allclose(np.asarray(scene.materials.emissive[SKY_MATERIAL_ID]), [2, 3, 4])


def test_builder_emissive_premultiplied():
    b = SceneBuilder()
    mid = b.add_material((0.5, 0.25, 1.0), 0, 0, 1.0, emissive=4.0)
    scene = b.build()
    np.testing.assert_allclose(np.asarray(scene.materials.emissive[mid]), [2.0, 1.0, 4.0])


def test_builder_concatenation():
    b = default_scene()
    scene = b.build()
    assert scene.num_triangles == b.num_triangles
    assert int(scene.indices.max()) < scene.num_vertices
    assert scene.tri_material.shape[0] == scene.num_triangles


@pytest.mark.parametrize(
    "name,objects",
    [("cornell.scn", 8), ("furnace.scn", 1), ("testtree.scn", 4)],
)
def test_parse_reference_scenes(scene_file, name, objects):
    b = load_scene(scene_file(name))
    assert b.num_objects == objects


def test_parse_cornell_details(scene_file):
    # The in-repo copy renders at 256x256 (the goldens' size; the
    # reference's own file says 800x800).
    b = load_scene(scene_file("cornell"))
    assert b.width == 256 and b.height == 256
    assert b.name == "Cornell"
    # 4 MTL + sky slot.
    assert len(b.materials) == 5
    # Light material: emissive = 15 * (1,1,1).
    np.testing.assert_allclose(b.materials[1].emissive, [15, 15, 15])
    scene = b.build()
    assert scene.num_triangles == 8 * 12


@pytest.mark.slow
def test_bunny_scene_loads_and_builds(scene_file):
    """bunny.scn: 70K-tri OBJ + jade translucent material + BVH build."""
    b = load_scene(scene_file("bunny"))
    assert b.num_triangles > 60000
    jade = b.materials[3]
    assert jade.translucency == 1.0 and jade.ior == 1.5
    scene = b.build()
    from tracy_tpu.accel.packet import build_packet_bvh

    bvh, host = build_packet_bvh(scene, leaf_size=64)
    assert host.max_depth < 40


def test_parse_spheres_scene_with_missing_sky(scene_file):
    # spheres.scn's data/sky.hdr resolves to tests/goldens/data/sky.hdr.
    b = load_scene(scene_file("spheres"))
    assert b.num_objects == 25
    assert len(b.materials) == 26
    assert len(b.atlas) == 1  # the HDR sky
    mats = b.materials
    # Translucency IOR sweep row.
    assert mats[25].translucency == 1.0 and mats[25].ior == 2.0
