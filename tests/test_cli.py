"""CLI smoke tests through the real process boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def run_cli(args, timeout=420):
    return subprocess.run(
        [sys.executable, "-m", "tracy_tpu.apps.render_cli"] + args,
        env=ENV, capture_output=True, text=True, timeout=timeout, cwd="/tmp",
    )


@pytest.mark.slow
def test_cli_pt_default_scene(tmp_path):
    out = str(tmp_path / "out.png")
    res = run_cli(["-cpu", "-width", "64", "-height", "48", "-frames", "2",
                   "-out", out])
    assert res.returncode == 0, res.stderr[-1500:]
    assert "MRays/s" in res.stderr
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (48, 64, 3)
    assert img.std() > 1


@pytest.mark.slow
def test_cli_raster_scene(tmp_path):
    out = str(tmp_path / "raster.ppm")
    res = run_cli(["-cpu", "-kernel", "raster", "-scene",
                   os.path.join(REPO, "tests", "goldens", "scn",
                                "testtree.scn"), "-out", out])
    assert res.returncode == 0, res.stderr[-1500:]
    assert os.path.exists(out)
    with open(out, "rb") as f:
        assert f.read(2) == b"P6"


def test_cli_bad_kernel():
    res = run_cli(["-kernel", "bogus"], timeout=60)
    assert res.returncode != 0
    assert "invalid choice" in res.stderr
