"""Conservation-audit closure gates (ocean.stats Salt/Heat + net-input
drift; write_energy's audit half, MOM_sum_output.F90:321-1100).

A closed basin forced by FIXED surface heat and salt fluxes must satisfy
  (total change since start) == (time-integrated net input)
for mass (zero input), salt and heat — in float64 to near machine
precision (the SURVEY §4 machine-precision oracle applied to budgets),
and in float32 to f32 accumulation tolerance.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r'''
import json, sys
sys.path.insert(0, %r)
import jax
%s
import jax.numpy as jnp
import numpy as np
from mom6_tpu.core.mom import Forcing, MOMParams, step_mom
from mom6_tpu.core.dynamics_split_rk2 import DynParams, MechForcing
from mom6_tpu.core.barotropic import BTParams, set_dtbt
from mom6_tpu.core.state import init_state_resting
from mom6_tpu.grid.grid import build_cartesian_grid
from mom6_tpu.grid.vertical import build_layered_vgrid
from mom6_tpu.physics.vertical.diabatic import (BuoyancyForcing,
                                                DiabaticParams)
from mom6_tpu.ale.ale import ALEParams, ZSTAR
from mom6_tpu.diagnostics.sum_output import BudgetAudit, compute_stats

NX, NY, NZ, DEPTH = 12, 10, 6, 2000.0
dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
# grid metrics must match the state precision: f32 areaT/IareaT in an
# x64 run make continuity's h update and the tracer advection's
# div(uhtr) reconstruction round differently (~6e-8 relative), which
# shows up as a systematic heat leak ~1000x machine roundoff
G = build_cartesian_grid(NX, NY, 240.0, 200.0, max_depth=DEPTH,
                         dtype=dtype)
GV = build_layered_vgrid(NZ, dtype=dtype)
state = init_state_resting(G, GV, [DEPTH / NZ] * NZ, dtype=dtype)
z = jnp.cumsum(state.h, axis=0) - 0.5 * state.h
state = state.replace(T=(14.0 - 8.0 * z / DEPTH).astype(dtype),
                      S=jnp.full(state.h.shape, 35.0, dtype))
dt = 1800.0
nstep, _ = set_dtbt(G, GV, DEPTH, dt)
params = MOMParams(
    dyn=DynParams(dt=dt, bt=BTParams(nstep=nstep, nfilter=2), kv=1e-4),
    thermo_enabled=True, eos_name="WRIGHT",
    diabatic=DiabaticParams(boundary_layer_scheme="NONE", cp=3992.0,
                            use_shear_mixing=False),
    ale=ALEParams(mode=ZSTAR, dz_nominal=tuple([DEPTH / NZ] * NZ)),
    n_dyn_per_thermo=2)
# fixed, spatially-varying fluxes: heat into the west half, salt out of
# a central band, a gentle wind
x = np.arange(NX); y = np.arange(NY)
qmap = np.where(x[None, :] < NX // 2, 220.0, -80.0) * np.ones((NY, NX))
smap = np.where((y[:, None] > 2) & (y[:, None] < 7), -2.0e-6, 1.0e-6) \
    * np.ones((NY, NX))
taux = 0.05 * np.sin(np.pi * y / (NY - 1))[:, None] * np.ones((NY, NX))
forcing = Forcing(
    mech=MechForcing(taux=jnp.asarray(taux, dtype)),
    buoy=BuoyancyForcing(heat_flux=jnp.asarray(qmap, dtype),
                         salt_flux=jnp.asarray(smap, dtype)))

cp = params.diabatic.cp
s0 = compute_stats(state, G, GV, dt, cp=cp)
audit = BudgetAudit(s0, cp=cp)
cyc = jax.jit(lambda s: step_mom(s, forcing, G, GV, params))
n_cyc = %d
for _ in range(n_cyc):
    state = cyc(state)
interval = n_cyc * dt * params.n_dyn_per_thermo
audit.accumulate(forcing, state, G, GV, interval)
s1 = compute_stats(state, G, GV, dt, cp=cp)
d = audit.drift(s1, state=state, G=G)
out = dict(mass0=s0["mass"], mass1=s1["mass"],
           salt0=s0["salt"], salt1=s1["salt"],
           heat0=s0["heat"], heat1=s1["heat"],
           heat_in=audit.heat_in, salt_in=audit.salt_in, **d)
print("BUDGET:" + json.dumps(out))
'''


def _run(x64: bool, n_cyc: int):
    x64_line = 'jax.config.update("jax_enable_x64", True)' if x64 else ''
    code = _RUN % (REPO, x64_line, n_cyc)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("BUDGET:")][-1]
    return json.loads(line[len("BUDGET:"):])


@pytest.mark.slow
def test_budget_closure_x64():
    """10 forced days in float64: salt/heat totals change by exactly the
    integrated inputs; mass by exactly zero (machine-precision audit)."""
    b = _run(True, n_cyc=240)           # 240 cycles x 2 x 1800 s = 10 d
    assert b["mass1"] == pytest.approx(b["mass0"], rel=1e-13)
    # the inputs are real signals, not roundoff
    assert abs(b["heat_in"]) > 1e14 and abs(b["salt_in"]) > 1e5
    assert abs(b["heat_drift"]) < 1e-9 * abs(b["heat_in"]), b
    assert abs(b["salt_drift"]) < 1e-9 * abs(b["salt_in"]), b


def test_budget_closure_f32():
    """Short f32 version.  The audit's resolving power in f32 is set by
    the ulp of the TOTALS (heat ~4e21 J => ulp ~3e14 J), not of the much
    smaller net input, so the gate normalizes against the totals: drift
    under a few f32 ulps of the total content."""
    b = _run(False, n_cyc=24)
    assert b["mass1"] == pytest.approx(b["mass0"], rel=2e-6)
    assert abs(b["heat_drift"]) < 1.5e-6 * abs(b["heat1"]), b
    assert abs(b["salt_drift"]) < 1.5e-6 * abs(b["salt1"]), b
    # and the drift still resolves gross errors: well under the input
    assert abs(b["heat_drift"]) < 0.05 * abs(b["heat_in"]), b
