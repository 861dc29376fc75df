"""Hierarchical timers, callTree logging and the MAXCPU graceful stop."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_timer_tree_and_report():
    import time as _t
    from mom6_tpu.framework import timers
    timers.reset()
    with timers.timer("outer"):
        with timers.timer("inner"):
            _t.sleep(0.01)
        with timers.timer("inner"):
            _t.sleep(0.01)
    rep = timers.report()
    assert "outer" in rep and "inner" in rep
    m = re.search(r"inner\s+([0-9.]+)s\s+(\d+) calls", rep)
    assert m and int(m.group(2)) == 2
    assert float(m.group(1)) >= 0.02


def test_calltree_verbosity(capsys):
    from mom6_tpu.framework import timers
    timers.set_calltree_verbosity(2)
    timers.callTree_enter("step_mom()")
    timers.callTree_waypoint("dynamics done")
    timers.callTree_leave("step_mom()")
    timers.set_calltree_verbosity(0)
    out = capsys.readouterr().out
    assert "> step_mom()" in out and ">> dynamics done" in out


CFG = """
NIGLOBAL = 12
NJGLOBAL = 12
NK = 3
LENLON = 500.0
LENLAT = 500.0
MAXIMUM_DEPTH = 1000.0
TOPO_CONFIG = flat
F_0 = 1.0e-4
DT = 600.0
ENABLE_THERMODYNAMICS = False
DAYMAX = 5.0
MAXCPU = 0.001
"""


def test_maxcpu_graceful_stop(tmp_path):
    """A tiny wall budget stops the run after the first segment, still
    writing ocean.stats, the restart and the timer report."""
    rd = tmp_path / "run"
    rd.mkdir()
    (rd / "MOM_input").write_text(CFG)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "mom6_tpu.drivers.solo",
                        str(rd)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=560)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MAXCPU" in r.stdout
    assert os.path.exists(rd / "MOM.res.nc")
    cputime = (rd / "ocean.cputime").read_text()
    assert "Total" in cputime and "ocean dynamics+thermo" in cputime
    # stopped early: far fewer stats lines than the 20 a full run writes
    lines = [ln for ln in (rd / "ocean.stats").read_text().splitlines()
             if not ln.startswith("#")]
    assert len(lines) < 10


def test_controlled_forcing_pulls_sst_to_target(tmp_path):
    """CONTROLLED_FORCING: the P+I heat-flux feedback pulls a warm bias
    toward the target SST (apply_ctrl_forcing role)."""
    cfg = """
NIGLOBAL = 8
NJGLOBAL = 8
NK = 4
LENLON = 400.0
LENLAT = 400.0
MAXIMUM_DEPTH = 400.0
TOPO_CONFIG = flat
F_0 = 1.0e-4
DT = 1800.0
DT_THERM = 3600.0
ENABLE_THERMODYNAMICS = True
EQN_OF_STATE = WRIGHT
T_REF = 14.0
T_RANGE = 0.0
CONTROLLED_FORCING = True
CTRL_SST_TARGET = 10.0
CTRL_FORCE_HEAT_RATE = 2000.0
CTRL_FORCE_INTEGRAL_PERIOD = 864000.0
DAYMAX = 8.0
"""
    rd = tmp_path / "run"
    rd.mkdir()
    (rd / "MOM_input").write_text(cfg)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "mom6_tpu.drivers.solo",
                        str(rd)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=560)
    assert r.returncode == 0, r.stderr[-2000:]
    from mom6_tpu.io.netcdf import read_nc
    import numpy as np
    res = read_nc(str(rd / "MOM.res.nc"))
    sst = np.asarray(res["T"], np.float64)[0]
    # started at 14.0 with a 10.0 target: the controller cools the SST
    assert sst.mean() < 13.5, sst.mean()
