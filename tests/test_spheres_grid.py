"""spheres.scn — the reference's 5x5 BRDF validation grid (README.md:21-29):
rows sweep metal roughness, metal->dielectric, dielectric roughness,
translucency roughness, and translucency IOR. Renders small and checks the
rows are materially distinct (the full-BRDF integration test)."""

import numpy as np
import pytest

from tracy_tpu.config import RenderConfig
from tracy_tpu.render.renderer import Renderer, init_state
from tracy_tpu.scene.scn_parser import load_scene


@pytest.mark.slow
def test_spheres_grid_renders_distinct_rows(scene_file):
    b = load_scene(scene_file("spheres"))
    b.width, b.height = 96, 72
    scene = b.build()
    cfg = RenderConfig(width=96, height=72, spp=4, max_bounces=4,
                       tonemap="none", accel="packet")
    r = Renderer(cfg)
    st = init_state(cfg)
    for _ in range(2):
        st, _ = r.step(scene, st)
    img = np.asarray(st.accum)
    assert np.isfinite(img).all()

    # The 25 spheres sit on a 5x5 grid (world x in [-1,1], y in [-0.5,1.5],
    # camera at (0,.5,3.5) fov 45). Sample a patch at each sphere's center
    # projection; rows must not be all identical.
    # Rough projection: the grid spans most of the frame center.
    h, w = img.shape[:2]
    row_means = []
    for i in range(5):
        y = int(h * (0.18 + 0.16 * i))
        strip = img[max(y - 3, 0):y + 3, w // 4: 3 * w // 4]
        row_means.append(strip.mean(axis=(0, 1)))
    row_means = np.asarray(row_means)

    # Dielectric-red rows must be red-dominant; metal rows must not be.
    red_ratio = row_means[:, 0] / (row_means[:, 1:].mean(axis=-1) + 1e-6)
    assert red_ratio.max() > 1.5  # some row is the red dielectric sweep
    # Rows differ overall (the sweep actually sweeps).
    assert np.std(row_means, axis=0).max() > 0.02
