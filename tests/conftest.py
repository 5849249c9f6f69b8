"""Test env: force an 8-device virtual CPU mesh before JAX initializes.

Multi-device sharding is validated on this virtual mesh
(xla_force_host_platform_device_count); behaviour on the GPU is covered by
chip_smoke.py, which runs there.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

SCENE_DIR = os.path.join(REPO, "tests", "goldens", "scn")
# Scenes whose meshes or textures the repository does not hold.
ASSET_SCENES = ("bunny", "dragon", "helmet", "trimesh")


@pytest.fixture(scope="session")
def scene_file():
    """scene_file(name) -> path of the in-repo `name`.scn. Skips the calling
    test for a scene that needs mesh or texture assets (decided when the
    test runs, so every worker collects the same tests)."""

    def get(name: str) -> str:
        name = name[:-4] if name.endswith(".scn") else name
        if name in ASSET_SCENES:
            pytest.skip(f"{name}.scn needs mesh/texture assets the "
                        "repository does not hold")
        return os.path.join(SCENE_DIR, f"{name}.scn")

    return get
