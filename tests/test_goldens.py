"""Golden-image regression tests.

Small deterministic renders compared against checked-in references
(tests/goldens/*.npy). The counter-based RNG makes CPU renders exactly
reproducible; tolerances absorb cross-platform libm differences. Regenerate
with:  python tests/test_goldens.py --regen
"""

import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

CASES = {
    "default_pt": dict(kind="pt", scene="default", size=(48, 36), frames=2, spp=2),
    "cornell_pt": dict(kind="pt", scene="cornell", size=(48, 48), frames=2, spp=2),
    "furnace_pt": dict(kind="pt", scene="furnace", size=(48, 36), frames=2, spp=2),
    "trimesh_raster": dict(kind="raster", scene="trimesh", size=(64, 48)),
    "helmet_raster_gl": dict(kind="raster-gl", scene="helmet", size=(64, 48)),
}


SCENE_DIR = os.path.join(GOLDEN_DIR, "scn")
# Scenes whose meshes or textures the repository does not hold.
ASSET_SCENES = ("helmet", "trimesh")


def _render(case):
    from tracy_tpu.config import RenderConfig
    from tracy_tpu.scene.scn_parser import default_scene, load_scene

    w, h = case["size"]
    if case["scene"] == "default":
        builder = default_scene(w, h)
    else:
        if case["scene"] in ASSET_SCENES:
            pytest.skip(f"{case['scene']}.scn needs mesh/texture assets "
                        "the repository does not hold")
        builder = load_scene(os.path.join(SCENE_DIR, f"{case['scene']}.scn"))
        builder.width, builder.height = w, h
    scene = builder.build()

    if case["kind"] in ("raster", "raster-gl"):
        from tracy_tpu.raster import render_raster

        cfg = RenderConfig(width=w, height=h, tonemap="none")
        return np.asarray(
            render_raster(scene, cfg, shaded=case["kind"] == "raster-gl")
        )

    from tracy_tpu.render.renderer import Renderer, init_state

    cfg = RenderConfig(width=w, height=h, spp=case["spp"], max_bounces=3,
                       tonemap="none", accel="packet")
    r = Renderer(cfg)
    st = init_state(cfg)
    for _ in range(case["frames"]):
        st, _ = r.step(scene, st)
    return np.asarray(st.accum)


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npy")
    if not os.path.exists(path):
        pytest.skip(f"golden missing: {path} (run --regen)")
    img = _render(CASES[name])
    ref = np.load(path)
    assert img.shape == ref.shape
    # Mean absolute error tight; individual pixels may vary with libm.
    mae = np.abs(img - ref).mean()
    assert mae < 5e-3, f"{name}: golden MAE {mae}"
    frac_off = (np.abs(img - ref).max(axis=-1) > 0.05).mean()
    assert frac_off < 0.01, f"{name}: {frac_off:.3%} pixels off"


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for name, case in CASES.items():
            img = _render(case)
            np.save(os.path.join(GOLDEN_DIR, f"{name}.npy"), img)
            print(f"wrote {name}: {img.shape} mean={img.mean():.4f}")
