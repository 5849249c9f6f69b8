"""Every kept intersector tier against brute force (accel='none') on every
in-repo scene, at the hit level: the same rays (primary plus one scattered
bounce, tracy_tpu.utils.parity.primary_and_bounce_rays) must hit the same
surfaces at the same distances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracy_tpu.config import RenderConfig
from tracy_tpu.render.integrator import make_bruteforce_intersector
from tracy_tpu.render.renderer import build_accel
from tracy_tpu.scene.procedural import sphere_grid
from tracy_tpu.scene.scn_parser import load_scene
from tracy_tpu.utils import parity

W, H, N = 32, 24, 512

TIERS = {
    "bvh": dict(accel="bvh"),
    "packet": dict(accel="packet"),
    "packet-compact": dict(accel="packet", wave_compact_group=1024),
    "tlas": dict(accel="tlas"),
}
SCENES = ("cornell", "furnace", "testtree", "spheres", "random", "spheregrid")


@pytest.fixture(scope="module")
def scenes(scene_file):
    cache = {}

    def get(name):
        if name not in cache:
            if name == "spheregrid":
                b = sphere_grid(W, H, num_spheres=4, steps=12)
            else:
                b = load_scene(scene_file(name))
                b.width, b.height = W, H
            scene = b.build()
            o, d, _ = parity.primary_and_bounce_rays(scene, W, H, N, seed=3)
            ref = make_bruteforce_intersector(scene)(o, d, jnp.ones(N, bool))
            cache[name] = (scene, o, d, parity.hit_materials(scene, ref))
        return cache[name]

    return get


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("name", SCENES)
def test_tier_matches_bruteforce(scenes, name, tier):
    scene, o, d, (ref, ref_mat) = scenes(name)
    cfg = RenderConfig(width=W, height=H, **TIERS[tier])
    accel = build_accel(scene, cfg)
    isect = jax.jit(lambda sc, data, o, d: accel.bind(sc, data)(
        o, d, jnp.ones(o.shape[:1], bool)))
    hit, mat = parity.hit_materials(scene, isect(scene, accel.data, o, d))

    m_ref, m = np.asarray(ref.mask), np.asarray(hit.mask)
    assert m_ref.any()
    np.testing.assert_array_equal(m, m_ref)
    np.testing.assert_allclose(np.asarray(hit.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    # Coplanar faces of touching boxes (cornell, random) are exact ties at
    # one t; brute force keeps the lower triangle index, a tree the first
    # one it visits, so a tie may name either face's material.
    mismatch = (np.asarray(mat)[m] != np.asarray(ref_mat)[m]).mean()
    assert mismatch <= 0.005, mismatch
