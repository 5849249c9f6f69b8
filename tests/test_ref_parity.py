"""Statistical parity against REAL reference renders (see
tracy_tpu/utils/parity.py for the goldens, the metrics and the tolerance
table). Scenes that need mesh or texture assets the repository does not
hold (trimesh, bunny, dragon, helmet) skip with a reason.
"""

import os

import pytest

from tracy_tpu.config import RenderConfig
from tracy_tpu.render import film
from tracy_tpu.render.renderer import Renderer, init_state
from tracy_tpu.scene.scn_parser import load_scene
from tracy_tpu.utils import parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "goldens")


def render_ours(name, frames, flip=True):
    """Render the golden's scene at its native size on the test backend
    and return it in linear radiance on the goldens' grid.

    Uses the per-ray-stack 'bvh' tier (fastest on CPU); hit-level agreement
    of every tier with brute force is asserted in test_tiers.py, so parity
    here covers the shared physics (materials, RNG, sky, accumulation)."""
    # The sky.hdr these scenes name resolves under tests/goldens/data.
    b = load_scene(os.path.join(parity.SCENE_DIR, f"{name}.scn"),
                   data_root=DATA)
    scene = b.build()
    cfg = RenderConfig(width=b.width, height=b.height, spp=1, accel="bvh")
    r = Renderer(cfg)
    st = init_state(cfg)
    st = r.render_progressive(scene, frames, state=st, steps_per_dispatch=frames)
    return parity.ours_linear(film.tonemap(st.accum, cfg), flip=flip)


def compare(name, frames, mean_tol, p95_tol, max_tol, flip=True):
    """All tolerances in LINEAR radiance units (sky white = 1.0)."""
    ref = parity.load_golden(name)
    ours = render_ours(name, frames, flip=flip)
    return parity.check_parity(
        name, ref, ours, parity.Tolerance(frames, mean_tol, p95_tol, max_tol))


def _needs_assets(name):
    pytest.skip(f"{name}.scn needs mesh/texture assets the repository "
                "does not hold")


def test_furnace_parity():
    compare("furnace", *parity.TOLERANCES["furnace"])


def test_cornell_parity():
    compare("cornell", *parity.TOLERANCES["cornell"])


def test_testtree_parity():
    compare("testtree", *parity.TOLERANCES["testtree"])


def test_spheres_parity():
    compare("spheres", *parity.TOLERANCES["spheres"])


@pytest.mark.slow
def test_trimesh_parity():
    _needs_assets("trimesh")


@pytest.mark.slow
def test_bunny_parity():
    _needs_assets("bunny")


@pytest.mark.slow
def test_dragon_parity():
    _needs_assets("dragon")


@pytest.mark.slow
def test_helmet_parity():
    _needs_assets("helmet")


@pytest.mark.slow
def test_random_parity():
    compare("random", frames=24, mean_tol=0.02, p95_tol=0.06, max_tol=0.3)
