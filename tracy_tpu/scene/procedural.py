"""Seeded procedural scenes that need no asset files.

`sphere_grid` is the large-mesh scene: the default scene (a floor, a sky
and three materials) plus a square grid of tessellated UV spheres. At the
default 64 spheres of 64 steps it holds about 520K triangles, seen from
outside the grid. The seed jitters each sphere's centre and picks its
material, so two seeds give two scenes with the same statistics.
"""

from __future__ import annotations

import numpy as np

from tracy_tpu.scene.scn_parser import default_scene


def sphere_grid(width: int, height: int, num_spheres: int = 64,
                steps: int = 64, seed: int = 0):
    """SceneBuilder of `num_spheres` UV spheres (`steps` rings and
    segments each) on a square grid of 2.5 spacing above the default
    scene's floor."""
    rng = np.random.default_rng(seed)
    b = default_scene(width, height)
    b.set_camera(eye=(0.0, 5.0, 14.0), center=(0.0, 0.5, 0.0),
                 up=(0.0, 1.0, 0.0), fov_degrees=60.0)
    g = int(np.ceil(np.sqrt(num_spheres)))
    jitter = rng.uniform(-0.25, 0.25, size=(num_spheres, 2))
    mats = rng.integers(1, 4, size=num_spheres)
    for i in range(num_spheres):
        b.add_sphere((i % g * 2.5 - g + jitter[i, 0], 0.5,
                      i // g * 2.5 - g + jitter[i, 1]), 1.0, int(mats[i]),
                     steps=steps)
    return b
