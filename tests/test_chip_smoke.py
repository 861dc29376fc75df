"""chip_smoke.py refuses to run without a GPU: no CPU fallback, no ok
line, a non-zero exit."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_on_cpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
