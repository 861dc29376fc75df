"""DOUBLE_PRECISION (x64) solo runs and the offline-tracer CLI path."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = """
NIGLOBAL = 10
NJGLOBAL = 10
NK = 3
LENLON = 500.0
LENLAT = 500.0
MAXIMUM_DEPTH = 1000.0
TOPO_CONFIG = bowl
F_0 = 1.0e-4
DT = 600.0
ENABLE_THERMODYNAMICS = True
EQN_OF_STATE = WRIGHT
T_REF = 10.0
T_RANGE = 8.0
DOUBLE_PRECISION = True
DAYMAX = 0.05
"""


def test_double_precision_solo_run(tmp_path):
    """DOUBLE_PRECISION=True integrates in f64: the resting-basin mass is
    conserved to ~1e-15 relative (the reference's verification-grade
    fidelity; SURVEY.md §4 machine-precision ocean.stats oracle)."""
    rd = tmp_path / "x64"
    rd.mkdir()
    (rd / "MOM_input").write_text(CFG)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "mom6_tpu.drivers.solo",
                        str(rd)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=560)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in (rd / "ocean.stats").read_text().splitlines()
             if not ln.startswith("#")]
    masses = [float(ln.split("Mass")[1].split(",")[0]) for ln in lines]
    rel = (max(masses) - min(masses)) / masses[0]
    assert rel < 1e-13, rel


def test_offline_transport_cli(tmp_path):
    """Online run archives interval transports; the --offline pass
    re-advects tracers with them and conserves total salt to advection
    tolerance (MOM_offline_main role)."""
    rd = tmp_path / "off"
    rd.mkdir()
    (rd / "MOM_input").write_text(CFG.replace(
        "DOUBLE_PRECISION = True",
        "OFFLINE_TRANSPORT_FILE = transports.nc") + "WIND_CONFIG = gyres\n"
        "TAU0 = 0.1\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "mom6_tpu.drivers.solo",
                        str(rd)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=560)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(rd / "transports.nc")
    r2 = subprocess.run([sys.executable, "-m", "mom6_tpu.drivers.solo",
                         str(rd), "--offline", "transports.nc"],
                        env=env, cwd=REPO, capture_output=True, text=True,
                        timeout=560)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert os.path.exists(rd / "offline_tracers.nc")
    # salt content stays within advective conservation tolerance
    import re
    svals = [float(m) for m in re.findall(r"S\*V (\S+)", r2.stdout)]
    assert len(svals) >= 2
    assert abs(svals[-1] - svals[0]) < 2e-3 * abs(svals[0])
