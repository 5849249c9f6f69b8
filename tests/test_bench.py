"""bench.py and chip_smoke.py are device measurements: with no GPU they exit
non-zero and print no result line (a CPU number is not a device metric)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, script)],
        env=env, capture_output=True, text=True, timeout=300,
    )


def _json_lines(stdout):
    out = []
    for ln in stdout.splitlines():
        try:
            out.append(json.loads(ln))
        except ValueError:
            pass
    return out


def test_bench_json_contract():
    res = _run_on_cpu("bench.py")
    assert res.returncode != 0
    assert _json_lines(res.stdout) == []
    assert "needs a GPU" in res.stderr


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_chip_smoke_fails_without_gpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")] + args,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert _json_lines(res.stdout) == []
    assert "needs a GPU" in res.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert _json_lines(res.stdout) == []
