"""Pinpoint the global_half_deg DT_THERM blowup: step thermo cycles,
print per-cycle extrema + their locations.

Usage: python tools/blowup_probe.py RUNDIR [N_CYCLES]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    rundir = sys.argv[1]
    n_cycles = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    from mom6_tpu.core.mom import step_mom

    cfgs = [os.path.join(rundir, "MOM_input")]
    ov = os.path.join(rundir, "MOM_override")
    if os.path.exists(ov):
        cfgs.append(ov)
    cwd = os.getcwd()
    os.chdir(rundir)
    try:
        ms = build_model_from_params(ParamFile(cfgs))
    finally:
        os.chdir(cwd)
    G, GV, state, params, forcing = (ms.grid, ms.vgrid, ms.state,
                                     ms.params, ms.forcing)

    step = jax.jit(lambda s: step_mom(s, forcing, G, GV, params))

    @jax.jit
    def extrema(s):
        out = {}
        for name in ("u", "v", "T", "S", "h"):
            f = getattr(s, name)
            a = jnp.abs(jnp.nan_to_num(f, nan=jnp.inf))
            flat = jnp.ravel(a)
            i = jnp.argmax(flat)
            out[name] = (flat[i], i, jnp.any(jnp.isnan(f)))
        out["h_min"] = jnp.min(s.h)
        return out

    shape = state.u.shape
    lat = np.asarray(G.geoLatT) if hasattr(G, "geoLatT") else None

    for c in range(n_cycles):
        state = step(state)
        ex = jax.device_get(extrema(state))
        msg = [f"cycle {c+1:3d}"]
        for name in ("u", "v", "T", "S"):
            val, idx, has_nan = ex[name]
            k, j, i = np.unravel_index(int(idx), shape)
            loc = f"k{k},j{j},i{i}"
            if lat is not None:
                loc += f"(lat{lat[j, i]:.0f})"
            msg.append(f"{name} {float(val):9.3e}@{loc}"
                       + ("NaN!" if bool(has_nan) else ""))
        msg.append(f"h[{float(ex['h_min']):.2e},"
                   f"{float(ex['h'][0]):.2e}]")
        print("  ".join(msg), flush=True)
        if any(bool(ex[n][2]) for n in ("u", "v", "T", "S")):
            print("NaN detected — stopping", flush=True)
            break


if __name__ == "__main__":
    main()
