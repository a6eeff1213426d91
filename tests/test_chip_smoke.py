"""chip_smoke.py refuses to report without a GPU (CPU tier)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script_dir, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py"), *args],
        cwd=script_dir, env=env, capture_output=True, text=True, timeout=300,
    )


def test_refuses_cpu_backend():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and r.stdout.strip() == ""
    assert "no GPU" in r.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_four_chip_option_needs_four_devices():
    r = _run(REPO, "--chips", "4")
    assert r.returncode != 0 and '"ok"' not in r.stdout
