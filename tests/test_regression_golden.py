"""Golden-file regression gate — the tc-config answer-checking role of the
reference's .testing suite (SURVEY.md §4): short runs of the shipped
configurations must reproduce stored ocean.stats-level numbers.

Regenerate intentionally with:
    UPDATE_GOLDEN=1 python -m pytest tests/test_regression_golden.py
(and commit the new tests/golden.json with an explanation of the physics
change that moved the answers).
"""

import json
import os

import numpy as np
import jax

from mom6_tpu.framework.config import ParamFile
from mom6_tpu.drivers.config_driver import build_model_from_params
from mom6_tpu.core.mom import step_mom
from mom6_tpu.diagnostics.sum_output import compute_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden.json")

CASES = {
    # tc-style ladder: adiabatic layered, full-physics over topography, rho,
    # and the real-continents tripolar global (mosaic grid + file topo +
    # TRIPOLAR_N fold exchanges in every lateral stencil)
    "double_gyre": ("configs/double_gyre", 6),
    "benchmark": ("configs/benchmark", 4),
    "rho_basin": ("configs/rho_basin", 4),
    "global_2deg": ("configs/global_2deg", 3),
}


def run_case(rundir, n_cycles):
    pf = ParamFile([os.path.join(REPO, rundir, "MOM_input")])
    st = build_model_from_params(pf)
    cyc = jax.jit(lambda s: step_mom(s, st.forcing, st.grid, st.vgrid,
                                     st.params))
    s = st.state
    for _ in range(n_cycles):
        s = cyc(s)
    stats = compute_stats(s, st.grid, st.vgrid, st.params.dyn.dt)
    return {k: float(v) for k, v in stats.items()}


def test_golden_regression():
    results = {name: run_case(rd, n) for name, (rd, n) in CASES.items()}
    if os.environ.get("UPDATE_GOLDEN") == "1" or not os.path.exists(GOLDEN):
        with open(GOLDEN, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
            f.write("\n")
        return
    with open(GOLDEN) as f:
        golden = json.load(f)
    for name, got in results.items():
        want = golden[name]
        # mass to near machine precision; energies to a loose f32-run
        # tolerance (reassociation under compiler changes)
        assert abs(got["mass"] - want["mass"]) <= 1e-6 * abs(want["mass"]), \
            (name, "mass", got["mass"], want["mass"])
        for key in ("KE", "APE"):
            scale = max(abs(want[key]), 1e-3)
            assert abs(got[key] - want[key]) <= 5e-3 * scale, \
                (name, key, got[key], want[key])


def test_golden_regression_x64():
    """Verification-grade golden gate: the same three configs run in
    FLOAT64 (subprocess with JAX_ENABLE_X64, the solo --x64 path's
    environment) must reproduce tests/golden_x64.json to near machine
    precision — mass to 1e-12 relative, KE/APE to 1e-9 relative.  This
    is the closest executable analogue of the reference's
    answer-matching ocean.stats oracle (.testing/README.rst:283-296,
    MOM_sum_output.F90:223-233): in f64 there is no reassociation
    headroom to hide a physics change behind.

    Regenerate intentionally with UPDATE_GOLDEN=1 (documents the
    physics change in the commit that moves the numbers)."""
    import subprocess
    import sys

    helper = r'''
import json, os, sys
sys.path.insert(0, %r)
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from mom6_tpu.framework.config import ParamFile
from mom6_tpu.drivers.config_driver import build_model_from_params
from mom6_tpu.core.mom import step_mom
from mom6_tpu.diagnostics.sum_output import compute_stats
out = {}
for name, (rd, n) in %r:
    pf = ParamFile([os.path.join(%r, rd, "MOM_input")])
    st = build_model_from_params(pf, dtype=jnp.float64)
    cyc = jax.jit(lambda s, m=st: step_mom(s, m.forcing, m.grid,
                                           m.vgrid, m.params))
    s = st.state
    for _ in range(n):
        s = cyc(s)
    stats = compute_stats(s, st.grid, st.vgrid, st.params.dyn.dt)
    out[name] = {k: float(v) for k, v in stats.items()}
print("GOLDEN64:" + json.dumps(out, sort_keys=True))
'''
    code = helper % (REPO, sorted(CASES.items()), REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("GOLDEN64:")][-1]
    results = json.loads(line[len("GOLDEN64:"):])

    path = os.path.join(REPO, "tests", "golden_x64.json")
    if os.environ.get("UPDATE_GOLDEN") == "1" or not os.path.exists(path):
        with open(path, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
            f.write("\n")
        return
    with open(path) as f:
        golden = json.load(f)
    for name, got in results.items():
        want = golden[name]
        assert abs(got["mass"] - want["mass"]) \
            <= 1e-12 * abs(want["mass"]), (name, "mass")
        for key in ("KE", "APE"):
            scale = max(abs(want[key]), 1e-6)
            assert abs(got[key] - want[key]) <= 1e-9 * scale, \
                (name, key, got[key], want[key])
