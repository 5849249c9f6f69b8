"""What the GPU port rests on, checked on the CPU: the platform's default
render path, exact material lookups, matmul precision, the compile-cache
location, the standard-library PNG writer, the seeded large scene, and that
nothing of the previous accelerator's kernels is left to reach."""

import os
import re
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.config import ACCELS, RenderConfig, default_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- default_path ------------------------------------------------------------

@pytest.mark.parametrize("num_pixels,num_tris,translucent", [
    (1920 * 1080, 520076, False),  # the large sphere grid
    (256 * 256, 96, False),  # cornell
    (320 * 240, 13973, True),  # random: small and translucent
])
def test_default_path_gpu(num_pixels, num_tris, translucent):
    path = default_path("gpu", num_pixels, num_tris, translucent)
    assert path == {"accel": "bvh", "wave_compact_group": 0}
    RenderConfig(**path)  # valid config fields


def test_default_path_cpu():
    path = default_path("cpu", 640 * 480, 3980, False)
    assert path == {"accel": "bvh", "wave_compact_group": 0}
    assert path["accel"] in ACCELS


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron", ""])
def test_default_path_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no measured default"):
        default_path(platform, 100, 100, False)


def test_cli_config_follows_default_path(tmp_path):
    """render_cli takes accel and compaction from default_path unless
    -accel/-compact name them."""
    from tracy_tpu.apps import render_cli
    from tracy_tpu.render import renderer

    seen = []
    orig = renderer.Renderer.__init__

    def spy(self, cfg, *a, **kw):
        seen.append(cfg)
        orig(self, cfg, *a, **kw)

    renderer.Renderer.__init__ = spy
    try:
        for extra in ([], ["-accel", "packet", "-compact", "1024"]):
            assert render_cli.main(["-width", "32", "-height", "32",
                                    "-frames", "1",
                                    "-out", str(tmp_path / "o.ppm")]
                                   + extra) == 0
    finally:
        renderer.Renderer.__init__ = orig
    assert (seen[0].accel, seen[0].wave_compact_group) == ("bvh", 0)
    assert (seen[1].accel, seen[1].wave_compact_group) == ("packet", 1024)


# -- material lookup ---------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "furnace", "testtree", "spheres",
                                  "random", "default"])
def test_material_lookup_bitwise_exact(scene_file, name):
    from tracy_tpu.render.material import material_table_lookup
    from tracy_tpu.scene.scn_parser import default_scene, load_scene

    b = default_scene(8, 8) if name == "default" else load_scene(
        scene_file(name))
    m = b.build().materials
    ids = jnp.arange(m.albedo.shape[0], dtype=jnp.int32)
    out = jax.jit(material_table_lookup)(m, ids)
    tables = (m.albedo, m.roughness, m.metalness, m.ior, m.emissive,
              m.translucent, m.tex_index)
    for got, want in zip(out, tables):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_material_lookup_clamps_out_of_range_ids():
    from tracy_tpu.render.material import material_table_lookup
    from tracy_tpu.scene.scn_parser import default_scene

    m = default_scene(8, 8).build().materials
    n = m.albedo.shape[0]
    albedo = material_table_lookup(m, jnp.asarray([-1, n, n + 5]))[0]
    assert np.isfinite(np.asarray(albedo)).all()
    np.testing.assert_array_equal(np.asarray(albedo[1]),
                                  np.asarray(m.albedo[n - 1]))


def _dot_generals(jaxpr):
    """Every dot_general equation in a closed jaxpr, sub-jaxprs included."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn)
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _default_precision(eqn):
    p = eqn.params.get("precision")
    if p is None:
        return True
    return any(x in (None, jax.lax.Precision.DEFAULT)
               for x in (p if isinstance(p, tuple) else (p,)))


def test_shading_has_no_default_precision_dot():
    """A float32 contraction at default precision may run in TF32 on a GPU:
    the material lookup and shading must contain none."""
    from tracy_tpu.render.material import gather_surface_params
    from tracy_tpu.scene.scn_parser import load_scene

    scene = load_scene(os.path.join(REPO, "tests", "goldens", "scn",
                                    "spheres.scn")).build()
    n = 16
    jx = jax.make_jaxpr(lambda s, mid, uv, nrm: gather_surface_params(
        s, mid, uv, nrm, nrm))(scene, jnp.zeros(n, jnp.int32),
                               jnp.zeros((n, 2)), jnp.ones((n, 3)))
    assert not [e for e in _dot_generals(jx) if _default_precision(e)]


def test_raster_contractions_ask_for_highest_precision():
    from tracy_tpu.raster.rasterizer import render_raster
    from tracy_tpu.scene.scn_parser import default_scene

    scene = default_scene(16, 16).build()
    cfg = RenderConfig(width=16, height=16, tonemap="none")
    jx = jax.make_jaxpr(lambda s: render_raster(s, cfg, shaded=True))(scene)
    dots = _dot_generals(jx)
    assert dots, "expected the 1/w and attribute interpolation einsums"
    assert not [e for e in dots if _default_precision(e)]


# -- compile cache -----------------------------------------------------------

def test_compile_cache_respects_env(monkeypatch, tmp_path):
    from tracy_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    from tracy_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.setup_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_other_cache_dir_in_code():
    """Only utils/compile_cache.py names a compilation cache directory."""
    hits = []
    for path in _python_files():
        with open(path) as f:
            text = f.read()
        if "jax_compilation_cache_dir" in text and not path.endswith(
                os.path.join("utils", "compile_cache.py")) and not path.endswith(
                "test_gpu_path.py"):
            hits.append(path)
    assert hits == []


# -- PNG ---------------------------------------------------------------------

def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for what encode_png writes (filter 0 rows)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            c = {2: 3, 6: 4}[ctype]
            assert depth == 8
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (16, 9, 4)])
def test_png_round_trip(shape):
    from tracy_tpu.utils.image_io import encode_png

    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(_decode_png(encode_png(img)), img)


def test_save_image_png_readable_by_pil(tmp_path):
    from PIL import Image

    from tracy_tpu.utils.image_io import save_image

    img = np.linspace(0, 1, 24 * 32 * 3, dtype=np.float32).reshape(24, 32, 3)
    path = str(tmp_path / "x.png")
    save_image(img, path)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(
        back, np.clip(img * 255.99, 0, 255).astype(np.uint8))


def test_png_rejects_gray():
    from tracy_tpu.utils.image_io import encode_png

    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))


# -- seeded scene ------------------------------------------------------------

def test_sphere_grid_is_seeded():
    from tracy_tpu.scene.procedural import sphere_grid

    a = sphere_grid(32, 24, num_spheres=4, steps=8, seed=1).build()
    b = sphere_grid(32, 24, num_spheres=4, steps=8, seed=1).build()
    c = sphere_grid(32, 24, num_spheres=4, steps=8, seed=2).build()
    np.testing.assert_array_equal(np.asarray(a.vertex_pos),
                                  np.asarray(b.vertex_pos))
    assert not np.array_equal(np.asarray(a.vertex_pos),
                              np.asarray(c.vertex_pos))
    assert a.num_triangles == c.num_triangles


def test_sphere_grid_full_size_statistics():
    from tracy_tpu.scene.procedural import sphere_grid

    b = sphere_grid(1920, 1080)
    assert b.num_triangles == 520076
    assert not b.has_translucent


# -- slab inverse ------------------------------------------------------------

def test_inverse_direction_keeps_sign():
    from tracy_tpu.render.intersect import inverse_direction

    d = jnp.asarray([[-1e-14, 1e-14, -0.5], [-0.0, 0.0, 2.0]], jnp.float32)
    inv = np.asarray(inverse_direction(d))
    np.testing.assert_array_equal(np.sign(inv), [[-1, 1, -1], [-1, 1, 1]])
    np.testing.assert_allclose(np.abs(inv[0, :2]), 1e12, rtol=1e-6)
    np.testing.assert_allclose(inv[:, 2], [-2.0, 0.5])


def test_bruteforce_tiny_negative_component_hits():
    """Rays whose direction has a tiny negative x component (below the
    1e-12 clamp) still find the triangle ahead of them."""
    from tracy_tpu.render.intersect import intersect_bruteforce

    # One triangle in the plane z=-4, facing +z, spanning x in [-8, 0].
    v0 = jnp.asarray([[0.0, -8.0, -4.0]])
    v1 = jnp.asarray([[0.0, 8.0, -4.0]])
    v2 = jnp.asarray([[-8.0, 0.0, -4.0]])
    o = jnp.asarray([[-1.0, 0.0, 0.0], [-3.0, 1.0, 0.0]])
    d = jnp.asarray([[-1e-14, 0.0, -1.0], [-1e-13, 0.0, -1.0]])
    hit = intersect_bruteforce(o, d, v0, v1 - v0, v2 - v0)
    np.testing.assert_array_equal(np.asarray(hit.mask), [True, True])
    np.testing.assert_allclose(np.asarray(hit.t), [4.0, 4.0], rtol=1e-6)


# -- nothing left of the previous accelerator ----------------------------------

def _python_files():
    roots = [os.path.join(REPO, "tracy_tpu"), os.path.join(REPO, "tests")]
    files = [os.path.join(REPO, f) for f in ("bench.py", "chip_smoke.py",
                                             "__graft_entry__.py")]
    files += [os.path.join(REPO, "tools", "path_sweep.py")]
    for root in roots:
        for dirpath, _, names in os.walk(root):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    return files


# The previous accelerator's name, assembled so that a text search of the
# tree for it does not land on this guard.
_OLD = "t" + "pu"


@pytest.mark.parametrize("pattern", [
    r"jax\.experimental\.pallas\." + _OLD + r"|pallas\s+import\s+" + _OLD,
    r"xla_" + _OLD + "_",
    r"use_" + "pallas|" + "pallas" + "_",
])
def test_no_previous_accelerator_kernels(pattern):
    me = os.path.abspath(__file__)
    hits = []
    for path in _python_files():
        if os.path.abspath(path) == me:
            continue
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{path}:{i}: {line.strip()}")
    assert hits == []
