"""Batch-dimension cost curve: full-physics step time vs registered
passive-tracer count.

The tracer registry stacks every registered tracer into one
(n_tr, nz, ny, nx) batch through the shared advection/diffusion
machinery (reference: per-tracer loops in MOM_tracer_flow_control.F90),
so the marginal cost of a tracer should be far below the cost of the
first: the advective reconstruction is reused and the batch is one more
array dimension.  This tool measures that curve (n_tr in {1, 8, 24}) on the
full-physics benchmark case and writes tools/tracer_batch_results.json.

Run on the real chip:  python tools/bench_tracer_batch.py
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def _setup(n_tracers, nx=240, ny=200, nz=16, dt=1200.0):
    from mom6_tpu.drivers.experiments import thermo_gyre
    from mom6_tpu.physics.lateral.meke import MEKEParams
    from mom6_tpu.physics.lateral.thickness_diffuse import GMParams
    from mom6_tpu.tracers.packages import (CFCPackage, IdealAge,
                                           PseudoSalt, RegionalDyes,
                                           TracerFlowControl)

    G, GV, state, params, forcing = thermo_gyre(
        nx=nx, ny=ny, nz=nz, len_lon_km=4500.0, len_lat_km=3500.0,
        dt=dt, n_dyn_per_thermo=2)
    pkgs = [IdealAge()]
    n_dyes = n_tracers - 1
    if n_tracers >= 4:
        pkgs += [CFCPackage(), PseudoSalt()]
        n_dyes = n_tracers - 4
    if n_dyes > 0:
        lon0 = [5.0 + 2.0 * m for m in range(n_dyes)]
        pkgs.append(RegionalDyes(
            minlon=tuple(lon0), maxlon=tuple(x + 1.5 for x in lon0),
            minlat=(10.0,) * n_dyes, maxlat=(20.0,) * n_dyes))
    tfc = TracerFlowControl(pkgs)
    params = params._replace(
        gm=GMParams(khth=100.0), meke=MEKEParams(), khtr=50.0, tfc=tfc,
        diabatic=params.diabatic._replace(boundary_layer_scheme="KPP",
                                          use_shear_mixing=True))
    state = state.replace(
        E_meke=jnp.zeros((ny, nx), jnp.float32),
        tr=tfc.init_tracers(state.h.shape, jnp.float32))
    return G, GV, state, params, forcing


def _time_step(n_tracers):
    from mom6_tpu.core.mom import step_mom

    G, GV, state, params, forcing = _setup(n_tracers)
    step = jax.jit(lambda s: step_mom(s, forcing, G, GV, params),
                   donate_argnums=0)
    state = step(state)                      # compile + warm
    jax.block_until_ready(state.h)
    t0 = time.perf_counter()
    n_calls = 4
    for _ in range(n_calls):
        state = step(state)
    jax.block_until_ready(state.h)
    return (time.perf_counter() - t0) / n_calls


def main():
    out = {"case": "full-physics 240x200x16 thermo cycle (2 dyn steps)",
           "device": jax.devices()[0].platform, "points": []}
    t1 = None
    for n in (1, 8, 24):
        sec = _time_step(n)
        if t1 is None:
            t1 = sec
        out["points"].append({
            "n_tracers": n, "sec_per_cycle": round(sec, 4),
            "rel_cost_vs_1": round(sec / t1, 3),
            "marginal_ms_per_tracer": round(
                1e3 * (sec - t1) / max(n - 1, 1), 3)})
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tracer_batch_results.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
