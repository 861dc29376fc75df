"""Headline benchmark: full-physics ocean model throughput on one chip.

Prints ONE JSON line whose headline metric is the FULL-PHYSICS
benchmark-class case (EOS + KPP boundary layer + GM/MEKE + passive tracer
+ z* ALE regrid/remap, 360x280x32), with an OM4_025-shaped case
(1440x1080x75) and the adiabatic dynamical-core case as additional
entries under "cases".

``vs_baseline`` compares each case against a physics-matched CPU-node
estimate (MOM6 publishes no absolute numbers in-repo; BASELINE.md
"Baseline derivation"):
- full-physics cases vs 1.5e6 gridpoint-steps/s/node, derived from the
  published OM4_025 throughput (~5 SYPD at dt=900 s on ~200 Broadwell
  nodes => 2.4e8 total gps/s => ~1.2e6/node; rounded up to be
  conservative);
- the adiabatic dynamical-core case vs 5e7 gps/s/node (96 cores at
  ~2 us per gridpoint-step for the dyn core alone).
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp

CPU_NODE_DYNCORE_GPS = 5.0e7     # dyn-core-only estimate; see BASELINE.md
CPU_NODE_FULLMODEL_GPS = 1.5e6   # full-model OM4 derivation; see BASELINE.md


def _full_physics_setup(nx, ny, nz, dt, n_dyn_per_thermo=2):
    from mom6_tpu.drivers.experiments import thermo_gyre
    from mom6_tpu.physics.lateral.meke import MEKEParams
    from mom6_tpu.physics.lateral.thickness_diffuse import GMParams
    from mom6_tpu.tracers.packages import IdealAge, TracerFlowControl

    G, GV, state, params, forcing = thermo_gyre(
        nx=nx, ny=ny, nz=nz, len_lon_km=4500.0, len_lat_km=3500.0,
        dt=dt, n_dyn_per_thermo=n_dyn_per_thermo)
    tfc = TracerFlowControl([IdealAge()])
    params = params._replace(
        gm=GMParams(khth=100.0), meke=MEKEParams(), khtr=50.0, tfc=tfc,
        diabatic=params.diabatic._replace(boundary_layer_scheme="KPP",
                                          use_shear_mixing=True))
    state = state.replace(
        E_meke=jnp.zeros((ny, nx), jnp.float32),
        tr=tfc.init_tracers(state.h.shape, jnp.float32),
        # BL/shear momentum viscosity carry (visc%Kv_shear role)
        kv_shear=jnp.zeros((nz + 1, ny, nx), jnp.float32))
    return G, GV, state, params, forcing


def _time_case(step_fn, state, n_warm=1, n_calls=4, steps_per_call=1):
    """Feedback timing: each call consumes the previous call's output
    (the state is donated, so every call does the full step's work)."""
    for _ in range(n_warm):
        state = step_fn(state)
    jax.block_until_ready(state.h)
    t0 = time.perf_counter()
    for _ in range(n_calls):
        state = step_fn(state)
    jax.block_until_ready(state.h)
    return (time.perf_counter() - t0) / (n_calls * steps_per_call)


def _ablation_phases(G, GV, state, params, forcing, base_ms, n_calls=3,
                     budget_s=600.0):
    """Full-physics cost attribution by subsystem ablation: re-time the
    thermo cycle with one subsystem disabled; baseline minus ablated =
    that subsystem's cost INCLUDING its fusion context (separate jits
    lose cross-phase fusion and overstate).  The residual is the
    dynamical core + orchestration.  Each variant recompiles the full
    model, so ``budget_s`` caps the whole sweep — variants past the
    budget report "skipped" rather than overrunning the run's window."""
    from mom6_tpu.ale.ale import ALEParams, LAYER
    from mom6_tpu.core.mom import step_mom
    import numpy as np
    t_start = time.perf_counter()
    host0 = jax.tree_util.tree_map(
        lambda x: np.asarray(jax.device_get(x)), state)
    variants = {
        "bl_scheme": params._replace(diabatic=params.diabatic._replace(
            boundary_layer_scheme="NONE")),
        "shear_mix": params._replace(diabatic=params.diabatic._replace(
            use_shear_mixing=False)),
        "gm_meke": params._replace(gm=None, meke=None),
        "ale_remap": params._replace(ale=ALEParams(mode=LAYER)),
        "tracer_diff": params._replace(khtr=0.0),
        "hor_visc": params._replace(hor_visc=None),
    }
    phases = {}
    residual = base_ms
    for tag, p in variants.items():
        if time.perf_counter() - t_start > budget_s:
            phases[tag] = "skipped"
            continue
        try:
            step = jax.jit(lambda s, _p=p: step_mom(s, forcing, G, GV,
                                                    _p),
                           donate_argnums=0)
            st = jax.tree_util.tree_map(jnp.asarray, host0)
            t = _time_case(step, st, n_calls=n_calls)
            share = max(base_ms - 1e3 * t, 0.0)
            phases[tag] = round(share, 2)
            residual -= share
        except Exception:                        # noqa: BLE001
            phases[tag] = None
    phases["dyn_core_plus_rest"] = round(max(residual, 0.0), 2)
    return phases


def bench_full(nx=360, ny=280, nz=32, dt=1200.0, with_phases=False):
    """Full-physics thermo cycle throughput (one cycle = 2 dyn steps)."""
    import numpy as np
    from mom6_tpu.core.mom import step_mom
    n_per = 2
    G, GV, state, params, forcing = _full_physics_setup(
        nx, ny, nz, dt, n_dyn_per_thermo=n_per)
    host0 = jax.tree_util.tree_map(
        lambda x: np.asarray(jax.device_get(x)), state) \
        if with_phases else None
    step = jax.jit(lambda s: step_mom(s, forcing, G, GV, params),
                   donate_argnums=0)
    sec_per_cycle = _time_case(step, state, n_calls=3)
    gps = nx * ny * nz * n_per / sec_per_cycle
    sypd = (n_per * dt / sec_per_cycle) / 365.0
    out = dict(grid=f"{nx}x{ny}x{nz}", gps=round(gps, 1),
               sypd=round(sypd, 2),
               bt_substeps=params.dyn.bt.nstep, physics="full")
    if with_phases:
        st = jax.tree_util.tree_map(jnp.asarray, host0)
        out["phases_ms"] = _ablation_phases(
            G, GV, st, params, forcing, 1e3 * sec_per_cycle)
        out["cycle_ms"] = round(1e3 * sec_per_cycle, 2)
    return out


def bench_om4_shape(nx=360, ny=270, nz=75, dt=900.0):
    """OM4_025 tile: the 1440x1080x75 grid sharded over a 4x4 mesh gives
    each device this 360x270x75 tile.  Its SYPD is the perfect-scaling
    projection for OM4_025 on 16 devices."""
    try:
        return dict(bench_full(nx, ny, nz, dt), physics="full-om4-tile",
                    note="1/16 tile of 1440x1080x75; SYPD = perfect-"
                         "scaling 16-chip projection")
    except Exception as e:                       # noqa: BLE001
        return dict(grid=f"{nx}x{ny}x{nz}", error=type(e).__name__)


def bench_global():
    """Real-continents GLOBAL tripolar case at half-degree (720x400x32):
    sourced from the configs/global_half_deg run dir (mosaic supergrid +
    file topography + TRIPOLAR_N fold, WRIGHT EOS, KPP, GM, tracer
    diffusion, z* ALE).  This is the OM4-class capability benchmark on
    the REAL grid — fold stencils, land masking and all — not a
    rectangular stand-in.  Grid inputs generate on first use
    (configs/global_half_deg/make_inputs.py)."""
    import os
    import sys

    import numpy as np

    from mom6_tpu.core.mom import step_mom
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    repo = os.path.dirname(os.path.abspath(__file__))
    rundir = os.path.join(repo, "configs", "global_half_deg")
    if not os.path.exists(os.path.join(rundir, "ocean_hgrid.nc")):
        sys.path.insert(0, rundir)
        import make_inputs
        make_inputs.main(rundir)
    cfg = os.path.join(rundir, "MOM_input")
    cwd = os.getcwd()
    os.chdir(rundir)             # GRID_FILE/TOPO_FILE are relative
    try:
        ms = build_model_from_params(ParamFile([cfg]))
    finally:
        os.chdir(cwd)
    p = ms.params
    nz, ny, nx = ms.state.h.shape
    dt = p.dyn.dt
    n_per = p.n_dyn_per_thermo
    host0 = jax.tree_util.tree_map(
        lambda x: np.asarray(jax.device_get(x)), ms.state)
    step = jax.jit(lambda s: step_mom(s, ms.forcing, ms.grid,
                                      ms.vgrid, ms.params),
                   donate_argnums=0)
    sec_per_cycle = _time_case(step, ms.state, n_calls=3)
    wet = float(np.asarray(ms.grid.mask2dT).mean())
    gps = nx * ny * nz * n_per / sec_per_cycle
    sypd = (n_per * dt / sec_per_cycle) / 365.0
    st = jax.tree_util.tree_map(jnp.asarray, host0)
    phases = _ablation_phases(ms.grid, ms.vgrid, st, ms.params,
                              ms.forcing, 1e3 * sec_per_cycle)
    return dict(grid=f"{nx}x{ny}x{nz}", gps=round(gps, 1),
                sypd=round(sypd, 2), ocean_frac=round(wet, 2),
                physics="full-global-tripolar",
                source="configs/global_half_deg",
                cycle_ms=round(1e3 * sec_per_cycle, 2),
                phases_ms=phases)


def _phase_breakdown(G, GV, state, params, forces):
    """Per-phase wall times [us/call] of the dyn-core building blocks on
    the bench state, each jitted separately (attribution tool: separate
    jits lose cross-phase fusion, so the parts exceed the whole — ratios
    between phases are what matters for spotting a regression)."""
    from mom6_tpu.core.barotropic import btstep
    from mom6_tpu.core.continuity_ppm import continuity_ppm
    from mom6_tpu.core.coriolis_adv import coriolis_adv
    from mom6_tpu.core.dynamics_split_rk2 import _visc_setup
    from mom6_tpu.core.pressure_force import (find_eta,
                                              pressure_force_montgomery)
    from mom6_tpu.physics.vertical.vert_friction import vertvisc

    h, u, v = state.h, state.u, state.v
    dt = params.dt
    eta = find_eta(h, G)
    h_u, h_v, cu, cv, vr_u, vr_v = _visc_setup(h, u, v, G, GV, params,
                                               None)
    pf = pressure_force_montgomery(h, G, GV)
    _, uh, vh, _, _ = continuity_ppm(u, v, h, dt, G, GV)
    zs = jnp.zeros_like(u), jnp.zeros_like(v)
    REP = 20

    def t(fn, *args):
        """us per application of ``fn``, measured as REP chained
        applications inside ONE jit (fn returns its next arguments) so
        the per-call dispatch overhead amortizes away; the outer timed
        calls also chain (output feeds the next input)."""
        def chained(a):
            def body(c, _):
                return fn(*c), None
            c, _ = jax.lax.scan(body, a, None, length=REP)
            return c
        f = jax.jit(chained)
        out = f(args)         # compile + warm
        jax.block_until_ready(out)
        n = 4
        t0 = time.perf_counter()
        for _ in range(n):
            out = f(out)
        jax.block_until_ready(out)
        return round(1e6 * (time.perf_counter() - t0) / (n * REP), 1)

    eps = u.dtype.type(1e-30)

    def p_cont(u_, v_, h_):
        h2, uh_, vh_, _, _ = continuity_ppm(u_, v_, h_, dt, G, GV)
        return u_ + eps * uh_, v_ + eps * vh_, h2

    def p_cor(u_, v_):
        cau, cav = coriolis_adv(u_, v_, h, uh, vh, G, GV,
                                scheme=params.coriolis_scheme)
        return u_ + eps * cau, v_ + eps * cav

    def p_pf(h_):
        o = pressure_force_montgomery(h_, G, GV)
        return (h_ + eps * o.eta_PF,)

    def p_bt(u_, v_, eta_):
        o = btstep(u_, v_, eta_, zs[0], zs[1], h, uh, vh, vr_u, vr_v,
                   pf.pbce, pf.eta_PF, dt, G, GV, params.bt,
                   taux=forces.taux, tauy=forces.tauy)
        return (u_ + eps * o.accel_layer_u, v_ + eps * o.accel_layer_v,
                o.eta_out)

    def p_vv(u_):
        return (vertvisc(u_, h_u, cu, dt, tau=forces.taux,
                         rho0=GV.rho0),)

    def p_vs(h_, u_, v_):
        _, _, _, _, vru, vrv = _visc_setup(h_, u_, v_, G, GV, params,
                                           None)
        return h_ + eps * vru, u_ + eps * vru, v_ + eps * vrv

    phases = {
        "continuity_ppm": t(p_cont, u, v, h),
        "coriolis_adv": t(p_cor, u, v),
        "pressure_force": t(p_pf, h),
        "btstep": t(p_bt, u, v, eta),
        "vertvisc": t(p_vv, u),
        "visc_setup": t(p_vs, h, u, v),
    }
    return phases


def bench_adiabatic(nx=360, ny=280, nz=8, dt=1200.0, with_phases=True):
    from mom6_tpu.drivers.experiments import double_gyre
    from mom6_tpu.drivers.solo import make_stepper

    G, GV, state, params, forces = double_gyre(
        nx=nx, ny=ny, nz=nz, len_lon_km=4500.0, len_lat_km=3500.0, dt=dt)
    phases = (_phase_breakdown(G, GV, state, params, forces)
              if with_phases else None)   # before the stepper donates state
    steps_per_call = 10
    stepper = make_stepper(G, GV, params, forces,
                           steps_per_call=steps_per_call)
    sec_per_step = _time_case(stepper, state, n_calls=5,
                              steps_per_call=steps_per_call)
    gps = nx * ny * nz / sec_per_step
    sypd = (dt / sec_per_step) / 365.0
    out = dict(grid=f"{nx}x{ny}x{nz}", gps=round(gps, 1),
               sypd=round(sypd, 2), bt_substeps=params.bt.nstep,
               physics="adiabatic")
    if phases is not None:
        out["phases_us"] = phases
        out["step_us"] = round(1e6 * sec_per_step, 1)
    return out


def _cast_tree(tree, dtype):
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(
                jnp.asarray(x).dtype, jnp.floating):
            return jnp.asarray(x, dtype)
        return x
    return jax.tree_util.tree_map(cast, tree)


def x64_child(mode: str, nx=180, ny=140, nz=32, dt=1200.0):
    """Child entry (bench.py --x64-child f32|f64) run in a CPU
    subprocess: the f64 verification-tier price vs f32 at the same
    shape on the same backend.  Prints one JSON
    line {"gps": ..., "dtype": ...}."""
    if mode == "f64":
        jax.config.update("jax_enable_x64", True)
    from mom6_tpu.core.mom import step_mom
    n_per = 2
    G, GV, state, params, forcing = _full_physics_setup(
        nx, ny, nz, dt, n_dyn_per_thermo=n_per)
    if mode == "f64":
        G = _cast_tree(G, jnp.float64)
        state = _cast_tree(state, jnp.float64)
        forcing = _cast_tree(forcing, jnp.float64)
    step = jax.jit(lambda s: step_mom(s, forcing, G, GV, params),
                   donate_argnums=0)
    sec = _time_case(step, state, n_warm=1, n_calls=2)
    print(json.dumps({"gps": round(nx * ny * nz * n_per / sec, 1),
                      "dtype": mode, "grid": f"{nx}x{ny}x{nz}",
                      "sec_per_cycle": round(sec, 3)}))


def bench_x64():
    """f32 vs f64 full-physics throughput at 180x140x32 on the CPU
    backend (the verification tier).  Returns gps for both, the f64/f32
    price ratio, and the
    CPU-f64 number for honest comparison against the reference's
    f64 CPU baseline."""
    import os
    import subprocess
    import sys
    out = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # the two children are independent CPU processes — run them
    # concurrently (each can spend minutes in XLA:CPU compilation)
    procs = {}
    for mode in ("f32", "f64"):
        procs[mode] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--x64-child", mode],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    for mode, pr in procs.items():
        try:
            stdout, _ = pr.communicate(timeout=1800)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("{")][-1]
            out[mode] = json.loads(line)
        except Exception as e:                   # noqa: BLE001
            pr.kill()
            out[mode] = {"error": type(e).__name__}
    case = dict(grid="180x140x32", physics="full-cpu-verification-tier",
                backend="cpu")
    if "gps" in out.get("f32", {}) and "gps" in out.get("f64", {}):
        case["gps_f32_cpu"] = out["f32"]["gps"]
        case["gps_f64_cpu"] = out["f64"]["gps"]
        case["f64_over_f32_cost"] = round(
            out["f32"]["gps"] / max(out["f64"]["gps"], 1e-9), 2)
    else:
        case["error"] = {k: v.get("error") for k, v in out.items()}
    return case


def bench_om4_envelope():
    """--om4-envelope: the largest OM4_025-style (x, y, 75) full-physics
    tile that compiles AND steps on one device — the demonstrated memory
    footprint behind the 16-device projection.
    Tries tiles in descending size; OOM moves to the next."""
    from mom6_tpu.core.mom import step_mom
    candidates = [(1440, 1080), (1080, 1080), (1080, 810), (720, 1080),
                  (720, 810), (720, 540), (480, 540), (360, 270)]
    results = []
    for (nx, ny) in candidates:
        try:
            n_per = 2
            G, GV, state, params, forcing = _full_physics_setup(
                nx, ny, 75, 900.0, n_dyn_per_thermo=n_per)
            step = jax.jit(lambda s: step_mom(s, forcing, G, GV, params),
                           donate_argnums=0)
            sec = _time_case(step, state, n_warm=1, n_calls=2)
            gps = nx * ny * 75 * n_per / sec
            results.append(dict(grid=f"{nx}x{ny}x75", fits=True,
                                gps=round(gps, 1),
                                sypd=round((n_per * 900.0 / sec) / 365.0,
                                           2)))
            break                   # largest fitting tile found
        except Exception as e:                   # noqa: BLE001
            results.append(dict(grid=f"{nx}x{ny}x75", fits=False,
                                error=type(e).__name__))
    print(json.dumps({"om4_envelope": results}))
    return results


def main():
    from mom6_tpu.framework.compile_cache import enable_compile_cache
    enable_compile_cache()
    full = bench_full(with_phases=True)
    om4 = bench_om4_shape()
    try:
        glob = bench_global()
    except Exception as e:                       # noqa: BLE001
        glob = dict(error=type(e).__name__, msg=str(e)[:200])
    adia = bench_adiabatic()
    try:
        x64 = bench_x64()
    except Exception as e:                       # noqa: BLE001
        x64 = dict(error=type(e).__name__)
    for c in (full, om4, glob):
        if "gps" in c:
            c["vs_cpu_node"] = round(c["gps"] / CPU_NODE_FULLMODEL_GPS, 2)
    adia["vs_cpu_node"] = round(adia["gps"] / CPU_NODE_DYNCORE_GPS, 2)
    head = full
    print(json.dumps({
        "metric": (f"full-physics gridpoint-timesteps/s/chip "
                   f"({head['grid']}, KPP+GM/MEKE+tracer+zstar-ALE, "
                   f"{head['bt_substeps']} BT substeps, "
                   f"SYPD={head['sypd']})"),
        "value": head["gps"],
        "unit": "gridpoint-steps/s",
        "vs_baseline": head["vs_cpu_node"],
        "cases": {"full": full, "om4_tile": om4,
                  "global_half_deg": glob, "adiabatic": adia,
                  "x64": x64},
    }))


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 2 and sys.argv[1] == "--x64-child":
        x64_child(sys.argv[2])
    elif len(sys.argv) > 1 and sys.argv[1] == "--om4-envelope":
        bench_om4_envelope()
    else:
        main()
