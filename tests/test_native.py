"""Native C++ components vs their numpy/python reference implementations."""

import numpy as np
import pytest

from tracy_tpu.utils.native import get_native_lib

native_available = get_native_lib() is not None
needs_native = pytest.mark.skipif(not native_available, reason="native lib unavailable")


def _random_tris(n, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    return (base + rng.normal(scale=0.4, size=(n, 3, 3))).astype(np.float32)


@needs_native
@pytest.mark.parametrize("n,seed", [(16, 0), (1000, 1), (20000, 2)])
@pytest.mark.parametrize("cost_mode,leaf_size", [("tris", 8),
                                                 ("chunks", 128)])
def test_native_bvh_matches_numpy(n, seed, cost_mode, leaf_size):
    from tracy_tpu.accel.bvh_build import build_bvh
    from tracy_tpu.accel.native import build_bvh_native

    tris = _random_tris(n, seed)
    tmin, tmax = tris.min(axis=1), tris.max(axis=1)
    ref = build_bvh(tmin, tmax, leaf_size=leaf_size, cost_mode=cost_mode)
    nat = build_bvh_native(tmin, tmax, leaf_size=leaf_size,
                           cost_mode=cost_mode)
    # Identical structure: the algorithms are written to match exactly.
    assert nat.num_nodes == ref.num_nodes
    np.testing.assert_array_equal(nat.node_meta, ref.node_meta)
    np.testing.assert_array_equal(nat.tri_order, ref.tri_order)
    np.testing.assert_allclose(nat.node_bounds, ref.node_bounds, rtol=1e-6)
    assert nat.max_depth == ref.max_depth


@needs_native
def test_native_bvh_traversal_agrees_with_bruteforce():
    import jax.numpy as jnp

    from tracy_tpu.accel.bvh import device_bvh, intersect_bvh
    from tracy_tpu.accel.native import build_bvh_native
    from tracy_tpu.render.intersect import intersect_bruteforce

    tris = _random_tris(3000, seed=5)
    tmin, tmax = tris.min(axis=1), tris.max(axis=1)
    host = build_bvh_native(tmin, tmax, leaf_size=8)
    bvh = device_bvh(host, leaf_size=8)

    rng = np.random.default_rng(11)
    o = jnp.asarray(rng.uniform(-8, 8, size=(128, 3)).astype(np.float32))
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = jnp.asarray(d)

    p0 = jnp.asarray(tris[:, 0])
    e1 = jnp.asarray(tris[:, 1] - tris[:, 0])
    e2 = jnp.asarray(tris[:, 2] - tris[:, 0])
    brute = intersect_bruteforce(o, d, p0, e1, e2)

    order = np.asarray(bvh.tri_order)
    hb = intersect_bvh(
        o, d,
        jnp.asarray(tris[order][:, 0]),
        jnp.asarray(tris[order][:, 1] - tris[order][:, 0]),
        jnp.asarray(tris[order][:, 2] - tris[order][:, 0]),
        bvh, leaf_size=8,
    )
    np.testing.assert_array_equal(np.asarray(brute.mask), np.asarray(hb.mask))
    m = np.asarray(brute.mask)
    np.testing.assert_allclose(np.asarray(brute.t)[m], np.asarray(hb.t)[m], rtol=1e-6)


def _write_obj(path, seed=0):
    """A small seeded OBJ: two named shapes, one with normals and uvs and a
    quad face (fan-triangulated), one with positions only."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, size=(12, 3))
    vn = rng.normal(size=(6, 3))
    vt = rng.uniform(0, 1, size=(6, 2))
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in vn]
    lines += [f"vt {x:.6f} {y:.6f}" for x, y in vt]
    lines += ["o first", "f 1/1/1 2/2/2 3/3/3", "f 3/3/3 2/2/2 4/4/4 5/5/5",
              "f 5/6/6 6/5/5 1/1/1",
              "o second", "f 7 8 9", "f 9 10 11 12", "f 8 10 12"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@needs_native
def test_native_obj_loader_matches_python(tmp_path):
    from tracy_tpu.scene.objloader import load_obj
    from tracy_tpu.scene.objloader_native import load_obj_native

    path = _write_obj(tmp_path / "seeded.obj")
    ref = load_obj(path)
    nat = load_obj_native(path)
    assert len(ref) == len(nat) == 2
    for a, b in zip(ref, nat):
        np.testing.assert_allclose(a.positions, b.positions, rtol=1e-6)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert a.has_normals == b.has_normals
        if a.has_normals:
            np.testing.assert_allclose(a.normals, b.normals, rtol=1e-6)
        if a.uvs is not None:
            np.testing.assert_allclose(a.uvs, b.uvs, rtol=1e-6)
