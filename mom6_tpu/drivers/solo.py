"""Ocean-only driver.

Analogue of MOM6's solo driver (reference:
config_src/drivers/solo_driver/MOM_driver.F90:457-530): owns the run
segment loop, compiles the step function once, and writes the energy
statistics file.  The inner loop over ``steps_per_call`` baroclinic steps is
a ``lax.scan`` inside one jitted call, so the host only sees the state at
the diagnostics cadence.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from mom6_tpu.core.dynamics_split_rk2 import (DynParams, MechForcing,
                                              step_dynamics_split_rk2)
from mom6_tpu.diagnostics.sum_output import StatsWriter, compute_stats

__all__ = ["run_segment", "make_stepper"]


def make_stepper(G, GV, params: DynParams, forces: MechForcing,
                 steps_per_call: int = 1) -> Callable:
    """A jitted function advancing the state ``steps_per_call`` steps."""

    def many_steps(state):
        def body(s, _):
            return step_dynamics_split_rk2(s, forces, G, GV, params), None
        # modest unroll lets XLA fuse across adjacent steps
        state, _ = jax.lax.scan(body, state, None, length=steps_per_call,
                                unroll=min(4, steps_per_call))
        return state

    return jax.jit(many_steps, donate_argnums=0)


def make_mom_stepper(G, GV, params, forcing, cycles_per_call: int = 1):
    """Jitted thermo-cycle stepper for the full model (step_mom)."""
    from mom6_tpu.core.mom import step_mom

    def many(state):
        def body(s, _):
            return step_mom(s, forcing, G, GV, params), None
        state, _ = jax.lax.scan(body, state, None, length=cycles_per_call)
        return state

    return jax.jit(many, donate_argnums=0)


def make_ke_budget_fn(G, GV, params):
    """Jitted (state, forcing) -> KE term dict for the diag_table KE
    budget; compiled once and reused across posts."""
    from mom6_tpu.core.mom import dyn_accel_diag
    from mom6_tpu.diagnostics.diagnostics import ke_budget

    def f(state, forcing):
        s2, accel = dyn_accel_diag(state, forcing, G, GV, params)
        return ke_budget(state, s2, accel, G, params.dyn.dt)

    return jax.jit(f)


def make_tend_fn(G, GV, params):
    """Jitted (state, forcing) -> per-process content-tendency dict for
    the diag_table tendency tier (step_mom's collect_tend capture);
    compiled once, reused across posts (diag-cadence, like the KE
    budget: one extra thermo cycle from the posted state)."""
    from mom6_tpu.core.mom import step_mom

    def f(state, forcing):
        return step_mom(state, forcing, G, GV, params,
                        collect_tend=True)[1]

    return jax.jit(f)


def _post_table_diags(dm, state, G, GV, params, forcing, ke_budget_fn,
                      tend_fn=None):
    """Post every diag_table-requested field the model can serve, via
    the diagnostic catalog (mom6_tpu/diagnostics/catalog.py: the
    OM4-standard field set incl. CMOR aliases); tracers resolve by
    their registry names.  Shared intermediates (surface state, Kd,
    wave speeds, KE budget) are computed once per post through the
    catalog's lazy DiagContext."""
    import numpy as np

    from mom6_tpu.diagnostics.catalog import DiagContext, serve
    eos = None
    if params.thermo_enabled:
        from mom6_tpu.eos import get_eos
        eos = get_eos(params.eos_name)
    dm.update_remap_grids(jax.device_get(state.h),
                          T=None if state.T is None
                          else jax.device_get(state.T),
                          S=None if state.S is None
                          else jax.device_get(state.S),
                          GV=GV, eos=eos)
    ctx = DiagContext(state, G, GV, params, forcing=forcing, eos=eos,
                      ke_budget_fn=ke_budget_fn, tend_fn=tend_fn)
    for key, hid in list(dm._by_name.items()):
        module, name = key.split(".", 1)
        base = name
        for sfx in ("_z", "_rho", "_sigma"):
            if name.endswith(sfx):
                base = name[: -len(sfx)]
        if state.tr is not None and base in state.tr:
            arr = jax.device_get(state.tr[base])
        else:
            arr = serve(base, ctx)
        if arr is not None:
            dm.post_data(hid, np.asarray(arr))


def _set_diag_axes(dm, G, cal, start_time):
    """Attach CF axes to the diag mediator: geographic cell centers and
    the run's calendar/time-units strings (diag files then carry Time /
    geolat / geolon coordinates instead of anonymous dims)."""
    import numpy as np

    from mom6_tpu.framework import time_manager as tm
    y, mo, d, h, mi, s = tm.get_date(cal, start_time)
    units = (f"days since {y:04d}-{mo:02d}-{d:02d} "
             f"{h:02d}:{mi:02d}:{s:02d}")
    dm.set_axes(geolat=np.asarray(G.geoLatT), geolon=np.asarray(G.geoLonT),
                time_units=units,
                calendar=tm.calendar_name(cal).lower())


def main(argv=None):
    """Command-line solo driver (program MOM6 analogue,
    config_src/drivers/solo_driver/MOM_driver.F90:1): reads MOM_input
    (+ MOM_override) from a run directory, integrates, writes ocean.stats,
    MOM_parameter_doc and a restart file."""
    import argparse

    from mom6_tpu.core.mom import step_mom
    from mom6_tpu.diagnostics.sum_output import (StatsWriter, compute_stats,
                                                 format_stats_line)
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    from mom6_tpu.framework.restart import RestartRegistry

    ap = argparse.ArgumentParser(prog="mom6_tpu.drivers.solo")
    ap.add_argument("rundir", help="directory containing MOM_input")
    ap.add_argument("--days", type=float, default=None,
                    help="override DAYMAX")
    ap.add_argument("--restart-in", default=None)
    ap.add_argument("--offline", default=None, metavar="ARCHIVE",
                    help="offline tracer mode: advance tracers with the "
                    "stored transports in ARCHIVE (written by a prior "
                    "online run with OFFLINE_TRANSPORT_FILE), without "
                    "re-running the dynamics (step_offline; "
                    "MOM.F90 step_offline:1983)")
    args = ap.parse_args(argv)

    from mom6_tpu.framework.compile_cache import enable_compile_cache
    enable_compile_cache()
    import os
    paths = [os.path.join(args.rundir, "MOM_input")]
    ov = os.path.join(args.rundir, "MOM_override")
    if os.path.exists(ov):
        paths.append(ov)
    pf = ParamFile(paths)
    # DOUBLE_PRECISION: run the whole model in float64 — the reference's
    # native precision, for machine-precision ocean.stats verification
    # against it (SURVEY.md §4).
    dtype = jnp.float32
    if pf.get("DOUBLE_PRECISION", bool, default=False, module="MOM",
              desc="Integrate in float64 (CPU verification mode)"):
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64
    # generated-input run dirs (e.g. configs/global_half_deg): large grid
    # mosaics ship as a make_inputs.py generator instead of committed
    # netCDF; build them on first use
    mk = os.path.join(args.rundir, "make_inputs.py")
    gfile = pf.get("GRID_FILE", str, default="ocean_hgrid.nc",
                   module="MOM_grid_init") \
        if pf.get("GRID_CONFIG", str, default="cartesian",
                  module="MOM_grid_init") == "mosaic" else None
    if gfile and os.path.exists(mk) \
            and not os.path.exists(os.path.join(args.rundir, gfile)):
        import subprocess
        import sys as _sys

        import mom6_tpu as _pkg
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        env = dict(os.environ, MOM6_TPU_REPO=repo_root,
                   PYTHONPATH=repo_root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        print(f"generating grid inputs via {mk} ...")
        subprocess.run([_sys.executable, mk, args.rundir], check=True,
                       env=env)
    setup = build_model_from_params(pf, dtype=dtype, doc_dir=args.rundir)
    G, GV, state, params, forcing = (setup.grid, setup.vgrid, setup.state,
                                     setup.params, setup.forcing)
    days = pf.get("DAYMAX", float, default=1.0, units="days",
                  module="MOM_driver")
    if args.days is not None:
        days = args.days
    dt_cycle = params.dyn.dt * params.n_dyn_per_thermo
    n_cycles = max(1, int(round(days * 86400.0 / dt_cycle)))
    # ENERGYSAVEDAYS sets the ocean.stats cadence
    # (MOM_sum_output.F90:223-233); fall back to ~20 statements per run.
    esd = pf.get("ENERGYSAVEDAYS", float, default=0.0, units="days",
                 module="MOM_sum_output",
                 desc="Interval between ocean.stats energy statements")
    if esd > 0.0:
        stats_every = min(n_cycles,
                          max(1, int(round(esd * 86400.0 / dt_cycle))))
    else:
        stats_every = max(1, n_cycles // 20)

    reg = RestartRegistry()
    fields = ["h", "u", "v", "uh", "vh", "uhtr", "vhtr"]
    if params.thermo_enabled:
        fields += ["T", "S"]
        if (params.diabatic.boundary_layer_scheme in ("KPP", "EPBL")
                or params.diabatic.use_shear_mixing):
            # the BL/shear momentum viscosity carried to the next
            # cycle's vert_friction (the reference's "Kv_shear" restart,
            # MOM_set_viscosity.F90 set_visc_register_restarts)
            fields += ["kv_shear"]
    if params.dyn.scheme.upper() == "RK2B":
        # the RK2b u_av/u_inst correction pair (register_restart_pair,
        # MOM_dynamics_split_RK2b.F90)
        fields += ["du_av_inst", "dv_av_inst"]
    reg.register_state_attrs(fields)
    reg.lock()

    # --- calendar / model dates (FMS time_manager + the solo driver's
    # ocean_solo.res segment protocol, MOM_driver.F90:225-300) ---------
    from mom6_tpu.framework import time_manager as tm
    cal = tm.calendar_from_name(
        pf.get("CALENDAR", str, default="NO_CALENDAR", module="MOM_driver",
               desc="Calendar: NO_CALENDAR, THIRTY_DAY, JULIAN, "
               "GREGORIAN or NOLEAP"))
    d_init = [int(v) for v in pf.get_list(
        "START_DATE", default=[1, 1, 1, 0, 0, 0], module="MOM_driver",
        desc="Model start date: year,month,day,hour,minute,second")]
    start_time = tm.set_date(cal, *d_init[:6])
    seg_start = start_time
    solo_res = os.path.join(args.rundir, "ocean_solo.res")
    if os.path.exists(solo_res):
        # segment start fixed by the previous segment's stamp
        cal, start_time, seg_start = tm.read_ocean_solo_res(solo_res)

    t0 = float(seg_start.total_seconds() - start_time.total_seconds())
    if args.restart_in:
        state, t0, _ = reg.restore_state(args.restart_in, state)

    if args.offline:
        return _run_offline(args, setup, pf, dt_cycle, stats_every)

    # online transport archiving for later offline-tracer runs
    # (the accumulated uhtr/vhtr + start/end thicknesses per interval
    # that MOM_offline_main.F90 reads back)
    archive_file = pf.get(
        "OFFLINE_TRANSPORT_FILE", str, default="", module="MOM",
        desc="If set, archive per-segment transports for offline mode")
    arc_rec = {"h_start": [], "h_end": [], "uhtr": [], "vhtr": []} \
        if archive_file else None

    provider = setup.forcing_provider

    # controlled forcing (MOM_controlled_forcing apply_ctrl_forcing):
    # P+I flux corrections toward an SST/SSS climatology, updated per
    # segment and fed through the forcing-as-jit-argument path
    ctrl = None
    if params.thermo_enabled and pf.get(
            "CONTROLLED_FORCING", bool, default=False,
            module="MOM_controlled_forcing",
            desc="P+I surface-flux feedback toward climatology"):
        import numpy as np

        from mom6_tpu.framework.controlled_forcing import ControlledForcing
        tgt = forcing.buoy.t_restore
        if tgt is not None:
            sst_t = np.asarray(jax.device_get(tgt), np.float64)
        else:
            sst_t = np.full((G.ny, G.nx), pf.get(
                "CTRL_SST_TARGET", float, default=10.0, units="degC",
                module="MOM_controlled_forcing"))
        ctrl = ControlledForcing(
            sst_t,
            sss_target=np.full((G.ny, G.nx), pf.get(
                "CTRL_SSS_TARGET", float, default=35.0, units="ppt",
                module="MOM_controlled_forcing")),
            lam_heat=pf.get("CTRL_FORCE_HEAT_RATE", float, default=0.0,
                            units="W m-2 K-1",
                            module="MOM_controlled_forcing"),
            lam_prec=pf.get("CTRL_FORCE_PREC_RATE", float, default=0.0,
                            module="MOM_controlled_forcing"),
            lam_int_period=pf.get("CTRL_FORCE_INTEGRAL_PERIOD", float,
                                  default=0.0, units="s",
                                  module="MOM_controlled_forcing"))
        if provider is None:
            _base_forcing = forcing
            provider = lambda t: _base_forcing    # noqa: E731

    def build_stepper(params):
        if provider is None:
            return make_mom_stepper(G, GV, params, forcing,
                                    cycles_per_call=stats_every)
        # file-driven forcing: re-evaluated each segment (set_forcing per
        # dt_forcing, MOM_driver.F90:457-481); passing the forcing arrays
        # as a jit argument keeps one compilation across segments
        def _many(state, f):
            def body(s, _):
                return step_mom(s, f, G, GV, params), None
            state, _ = jax.lax.scan(body, state, None, length=stats_every)
            return state
        return jax.jit(_many, donate_argnums=0)

    stepper = build_stepper(params)

    # dynamic barotropic substep reset (the DTBT_RESET_PERIOD role:
    # set_dtbt is re-called as the stratification evolves,
    # MOM_dynamics_split_RK2.F90:661-668 / MOM_barotropic.F90:3509).  A
    # changed substep count swaps in a stepper recompiled for the new
    # static nstep (cached per nstep by jit / the persistent XLA cache).
    dtbt_reset_period = pf.get(
        "DTBT_RESET_PERIOD", float, default=-1.0, units="s",
        module="MOM", desc="Period between dtbt recalculations; 0 every "
        "segment, <0 never")
    dtbt_fn = None
    if params.unsplit is None and dtbt_reset_period >= 0.0:
        from mom6_tpu.core.barotropic import dtbt_max_from_state
        from mom6_tpu.core.pressure_force import (pressure_force_fv,
                                                  pressure_force_montgomery)
        dtbt_frac = abs(pf.get("DTBT", float, default=-0.98, module="MOM"))

        def _dtbt(state):
            if params.thermo_enabled:
                from mom6_tpu.eos import get_eos
                out = pressure_force_fv(state.h, state.T, state.S, G, GV,
                                        get_eos(params.eos_name))
            else:
                out = pressure_force_montgomery(state.h, G, GV)
            return dtbt_max_from_state(state.h, out.pbce, G,
                                       params.dyn.bt.bebt)
        dtbt_fn = jax.jit(_dtbt)
    t_last_reset = t0
    writer = StatsWriter(os.path.join(args.rundir, "ocean.stats"))
    # conservation audit: accumulated net mass/salt/heat inputs and the
    # drift of the totals against them (write_energy's net-input half,
    # MOM_sum_output.F90:321-1100), reported per stats line
    from mom6_tpu.diagnostics.sum_output import BudgetAudit
    cp_audit = params.diabatic.cp if params.thermo_enabled else 3991.87
    # f32 production runs: ocean.stats sums inside jit via fixed_point_sum
    # (bitwise layout-invariant, stays on device; round-2 verdict item 7).
    # x64 verification runs keep the host f64 EFP oracle.
    stats_jit = None
    if state.h.dtype == jnp.float32:
        from mom6_tpu.diagnostics.sum_output import compute_stats_jit
        stats_jit = jax.jit(
            lambda s: compute_stats_jit(s, G, GV, params.dyn.dt,
                                        cp=cp_audit))
    # the audit baseline must come from the SAME summation path as the
    # per-line stats (f32 fixed-point vs host f64 EFP differ at ~4e-8
    # relative, which would masquerade as day-one drift)
    if stats_jit is not None:
        stats0 = {k: float(v) for k, v in stats_jit(state).items()}
    else:
        stats0 = compute_stats(state, G, GV, params.dyn.dt, cp=cp_audit)
    audit = BudgetAudit(stats0, cp=cp_audit, state0=state, G=G)

    # gridded diagnostics through the mediator; a diag_table file in the
    # run directory selects fields/reductions/files (FMS diag_table
    # semantics, framework/_Diagnostics.dox); otherwise a default set of
    # time means is written
    from mom6_tpu.framework.diag_mediator import DiagMediator
    import numpy as np
    dt_path = os.path.join(args.rundir, "diag_table")
    use_table = os.path.exists(dt_path)
    nz = state.h.shape[0]
    z_targets = np.asarray(params.ale.dz_nominal) \
        if (params.ale is not None and params.ale.dz_nominal is not None) \
        else np.full(nz, float(np.max(np.asarray(G.bathyT))) / nz)
    rho_targets = None
    if params.thermo_enabled and GV.Rlay is not None:
        rho_targets = np.asarray(GV.Rlay, np.float64)   # layer targets
    if use_table:
        dm = DiagMediator.from_diag_table(
            dt_path, z_targets=z_targets, rho_targets=rho_targets,
            nz_sigma=nz, areaT=np.asarray(G.areaT))
        diag_ids, id_ssh = {}, None
        ke_budget_fn = make_ke_budget_fn(G, GV, params) if any(
            d.name.startswith("KE_") or d.name == "dKE_dt"
            for d in dm._diags.values()) else None
        # no-silent-misses contract: every requested field must resolve
        # in the catalog (unknown names are a hard error with a hint);
        # known-but-unservable fields are rejected loudly with the
        # config reason (the register_diag_field<0 path of the ref)
        from mom6_tpu.diagnostics.catalog import (rejection_reason,
                                                  resolve)
        tr_names = set(state.tr or ())
        rejected = {}
        bases = []
        for d in list(dm._diags.values()):
            base = d.name
            for sfx in ("_z", "_rho", "_sigma"):
                if base.endswith(sfx):
                    base = base[: -len(sfx)]
            if base in tr_names:
                continue
            entry = resolve(base)     # raises KeyError on unknown names
            bases.append((d, base, entry))
        # tendency capture: compiled only when the table asks for it
        tend_fn = None
        if params.thermo_enabled \
                and params.diabatic.boundary_layer_scheme != "BULKML" \
                and any(e.needs in ("tend", "tend_frazil")
                        for _, _, e in bases):
            tend_fn = make_tend_fn(G, GV, params)
        for d, base, entry in bases:
            if not d.units:
                d.units = entry.units
            if not d.longname:
                d.longname = entry.long_name
            if entry.stagger in ("u", "v", "q"):
                d.stagger = entry.stagger
            why = rejection_reason(base, state, params, forcing=forcing,
                                   has_ke_budget=ke_budget_fn
                                   is not None,
                                   has_tend=tend_fn is not None)
            if why:
                rejected[d.name] = why
        if rejected:
            print("diag_table fields rejected under this configuration:")
            for nm, why in sorted(rejected.items()):
                print(f"  {nm}: {why}")
            with open(os.path.join(args.rundir,
                                   "diag_rejected"), "w") as fh:
                for nm, why in sorted(rejected.items()):
                    fh.write(f"{nm}: {why}\n")
    else:
        dm = DiagMediator(z_targets=z_targets)
        diag_ids = {}
        diag_fields = ["h", "u", "v"] + (["T", "S"]
                                         if params.thermo_enabled else [])
        for name in diag_fields:
            diag_ids[name] = dm.register_diag_field("ocean_model", name,
                                                    time_avg=True)
        id_ssh = dm.register_diag_field("ocean_model", "SSH", units="m")
        ke_budget_fn = None
        tend_fn = None

    # MAXCPU graceful stop (write_cputime's MAXCPU projection,
    # config_src/infra/FMS2/../MOM_write_cputime.F90 role): if the next
    # segment is projected to exceed the budget, stop cleanly with a
    # restart instead of being killed mid-segment.
    maxcpu = pf.get("MAXCPU", float, default=-1.0, units="wall s",
                    module="MOM", desc="Wall-clock budget; <0 no limit")
    # sanitizer: per-segment NaN surveillance of the whole state pytree
    # (the DEBUG init-to-NaN/checksum role; framework/sanitize.py)
    debug_nans = pf.get("DEBUG_CHECK_NANS", bool, default=False,
                        module="MOM", desc="Stop with a per-field "
                        "report if the state goes non-finite")
    from mom6_tpu.framework.timers import report as timer_report
    from mom6_tpu.framework.timers import reset as timer_reset
    from mom6_tpu.framework.timers import timer
    timer_reset()    # per-run clock tree (multiple runs per process)
    start = time.time()
    seg_wall = 0.0
    n_done = 0
    for c in range(n_cycles // stats_every):
        t_seg = time.perf_counter()
        if arc_rec is not None:
            h_pre = np.asarray(jax.device_get(state.h))
            uhtr_pre = np.asarray(jax.device_get(state.uhtr))
            vhtr_pre = np.asarray(jax.device_get(state.vhtr))
        with timer("ocean dynamics+thermo") as t_step:
            t_step_before = t_step.seconds
            if provider is None:
                state = stepper(state)
            else:
                t_mid = t0 + (c + 0.5) * stats_every * dt_cycle
                f_seg = provider(t_mid)
                if ctrl is not None:
                    from mom6_tpu.diagnostics.diagnostics import \
                        extract_surface_state
                    sfc = extract_surface_state(state, G, GV)
                    h_adj, fw_adj = ctrl.update(
                        jax.device_get(sfc.sst), jax.device_get(sfc.sss),
                        stats_every * dt_cycle)
                    b = f_seg.buoy
                    hf = b.heat_flux if b.heat_flux is not None else 0.0
                    b = b._replace(heat_flux=hf + jnp.asarray(
                        h_adj, state.h.dtype))
                    if fw_adj is not None:
                        fw = b.fw_flux if b.fw_flux is not None else 0.0
                        b = b._replace(fw_flux=fw + jnp.asarray(
                            fw_adj, state.h.dtype))
                    f_seg = f_seg._replace(buoy=b)
                state = stepper(state, f_seg)
            jax.block_until_ready(state.h)
        if debug_nans:
            from mom6_tpu.framework.sanitize import check_finite_state
            check_finite_state(
                state, G, step=(c + 1) * stats_every,
                fatal_path=os.path.join(args.rundir, "FATAL_NANS"))
        if arc_rec is not None:
            arc_rec["h_start"].append(h_pre)
            arc_rec["h_end"].append(np.asarray(jax.device_get(state.h)))
            arc_rec["uhtr"].append(
                np.asarray(jax.device_get(state.uhtr)) - uhtr_pre)
            arc_rec["vhtr"].append(
                np.asarray(jax.device_get(state.vhtr)) - vhtr_pre)
        step = (c + 1) * stats_every
        t_now = t0 + step * dt_cycle
        if dtbt_fn is not None and \
                t_now - t_last_reset >= dtbt_reset_period:
            t_last_reset = t_now
            dtbt_max = float(dtbt_fn(state))
            nstep_new = max(1, int(np.ceil(
                params.dyn.dt / (dtbt_frac * dtbt_max))))
            bt = params.dyn.bt
            if nstep_new != bt.nstep:
                print(f"set_dtbt: nstep {bt.nstep} -> {nstep_new} "
                      f"(dtbt_max {dtbt_max:.1f} s)")
                bt = bt._replace(nstep=nstep_new,
                                 nfilter=max(1, nstep_new // 8))
                params = params._replace(
                    dyn=params.dyn._replace(bt=bt))
                stepper = build_stepper(params)
        tdays = t_now / 86400.0
        with timer("ocean.stats"):
            if stats_jit is not None:
                s = {k: float(v) for k, v in stats_jit(state).items()}
            else:
                s = compute_stats(state, G, GV, params.dyn.dt,
                                  cp=cp_audit)
            # net-input accumulation + drift statement (conservation
            # audit); restoring fluxes are estimated at the segment
            # endpoint state
            f_used = f_seg if provider is not None else forcing
            audit.accumulate(f_used, state, G, GV,
                             stats_every * dt_cycle)
            s.update(audit.drift(s, state=state, G=G))
            if params.tfc is not None and state.tr is not None:
                # per-tracer global stocks on the stats line
                # (call_tracer_stocks -> MOM_sum_output)
                from mom6_tpu.diagnostics.sum_output import tracer_stocks
                s.update(tracer_stocks(
                    jax.device_get(state.tr), jax.device_get(state.h),
                    G, names=params.tfc.registry.names))
            writer.write(step, tdays, s)
        print(format_stats_line(step, tdays, s))
        # the first segment's time includes compiling the stepper
        print(f"segment {c + 1}: {stats_every} cycles stepped in "
              f"{t_step.seconds - t_step_before:.4f} s")
        with timer("diag mediator"):
            if use_table:
                f_now = provider(t_mid) if provider is not None else forcing
                _post_table_diags(dm, state, G, GV, params, f_now,
                                  ke_budget_fn, tend_fn=tend_fn)
            else:
                for name in diag_fields:
                    dm.post_data(diag_ids[name],
                                 jax.device_get(getattr(state, name)))
                dm.post_data(id_ssh,
                             np.asarray(jax.device_get(state.h)).sum(0)
                             - np.asarray(jax.device_get(G.bathyT)))
        n_done = step
        seg_wall = time.perf_counter() - t_seg
        if maxcpu > 0.0 and \
                (time.time() - start) + 1.5 * seg_wall > maxcpu:
            print(f"MAXCPU: projected to exceed {maxcpu:.0f} s wall "
                  f"budget; stopping after {n_done} of {n_cycles} steps "
                  "and writing the restart")
            break
    if use_table:
        dm.flush_all(args.rundir, time_seconds=t0 + n_cycles * dt_cycle)
    else:
        dm.flush(os.path.join(args.rundir, "ocean_diags.nc"),
                 time_seconds=t0 + n_cycles * dt_cycle)
    elapsed = time.time() - start
    if arc_rec is not None and arc_rec["uhtr"]:
        from mom6_tpu.io.netcdf import NCWriter
        w = NCWriter(os.path.join(args.rundir, archive_file),
                     global_attrs={"interval_seconds":
                                   float(stats_every * dt_cycle)})
        for k, recs in arc_rec.items():
            w.write_static(k, np.stack(recs))
        w.close()
    io_layout = pf.get_list("IO_LAYOUT", default=[1, 1], module="MOM")
    reg.save_restart(os.path.join(args.rundir, "MOM.res.nc"), state,
                     time_seconds=t0 + n_cycles * dt_cycle, step=n_cycles,
                     io_layout=tuple(int(v) for v in io_layout[:2]))
    # date-stamped segment bookkeeping (write_ocean_solo_res +
    # time_stamp.out + FMS-stamped restart name, MOM_driver.F90:606-680).
    # Written under RESTART/ as the reference does; continuing a segment
    # means copying RESTART/ocean_solo.res into the next run directory.
    t_end = start_time.add_seconds(t0 + (n_done or n_cycles) * dt_cycle)
    res_dir = os.path.join(args.rundir, "RESTART")
    os.makedirs(res_dir, exist_ok=True)
    tm.write_ocean_solo_res(os.path.join(res_dir, "ocean_solo.res"),
                            cal, start_time, t_end)
    tm.write_time_stamp(args.rundir, cal, seg_start, t_end)
    if cal != tm.NO_CALENDAR:
        stamped = os.path.join(res_dir,
                               tm.date_stamp(cal, t_end) + ".MOM.res.nc")
        if not os.path.exists(stamped):
            os.link(os.path.join(args.rundir, "MOM.res.nc"), stamped)
    # chksum_diag-style fingerprint of the final state (the second half of
    # the regression oracle, SURVEY.md §4)
    from mom6_tpu.framework.checksums import chksum_line
    with open(os.path.join(args.rundir, "chksum_diag"), "w") as f:
        for name in fields:
            val = getattr(state, name)
            if val is not None:
                f.write(chksum_line(name, jax.device_get(val)) + "\n")
    steps_run = n_done if n_done else n_cycles
    days = steps_run * dt_cycle / 86400.0   # actual integrated time
    sypd = (steps_run * dt_cycle / max(elapsed, 1e-9)) / 365.0
    # ocean.cputime log (MOM_write_cputime role): cumulative cpu/wall
    # seconds per model day for perf monitoring across segments
    import resource
    cpu = resource.getrusage(resource.RUSAGE_SELF).ru_utime
    with open(os.path.join(args.rundir, "ocean.cputime"), "a") as f:
        f.write(f"{days:12.4f} days  wall {elapsed:10.2f} s  "
                f"cpu {cpu:10.2f} s  SYPD {sypd:8.2f}\n")
        f.write(timer_report(min_frac=0.001) + "\n")
    print(f"run complete: {days} days in {elapsed:.1f}s ({sypd:.1f} SYPD)")
    unused = pf.unused_params()
    if unused:
        print("WARNING: unused parameters:", ", ".join(unused))
    return state


def _run_offline(args, setup, pf, dt_cycle, stats_every):
    """Offline tracer transport from an archived online run (the
    step_offline path, MOM.F90:1983 -> MOM_offline_main.F90): advect
    the initialized T/S plus an ideal-age tracer with the STORED
    interval transports, and report per-interval tracer totals."""
    import os

    import numpy as np

    from mom6_tpu.io.netcdf import read_nc
    from mom6_tpu.tracers.offline import OfflineFields, step_offline

    G, state = setup.grid, setup.state
    arc_path = args.offline if os.path.isabs(args.offline) \
        else os.path.join(args.rundir, args.offline)
    # NetCDF-3 stores big-endian; convert to native for jax
    arc = {k: np.asarray(v, np.float32) for k, v in read_nc(arc_path).items()
           if np.ndim(v)}
    n_rec = arc["uhtr"].shape[0]
    dt_rec = stats_every * dt_cycle

    names = ["T", "S", "ideal_age"]
    tr = jnp.stack([state.T, state.S, jnp.zeros_like(state.T)])
    h = jnp.asarray(arc["h_start"][0])
    area = np.asarray(G.areaT, np.float64)
    print(f"offline: {n_rec} intervals of {dt_rec:.0f} s from {arc_path}")
    for r in range(n_rec):
        fields = OfflineFields(
            h_start=jnp.asarray(arc["h_start"][r]),
            h_end=jnp.asarray(arc["h_end"][r]),
            uhtr=jnp.asarray(arc["uhtr"][r]),
            vhtr=jnp.asarray(arc["vhtr"][r]))
        tr = tr.at[2].add(dt_rec / (365.0 * 86400.0))   # age source [yr]
        tr, h = step_offline(tr, fields, dt_rec, G)
        tots = [float((np.asarray(tr[i], np.float64)
                       * np.asarray(h, np.float64) * area).sum())
                for i in range(len(names))]
        print(f"  rec {r + 1:3d}: " + "  ".join(
            f"{n}*V {v:.6e}" for n, v in zip(names, tots)))
    from mom6_tpu.io.netcdf import NCWriter
    w = NCWriter(os.path.join(args.rundir, "offline_tracers.nc"))
    for i, n in enumerate(names):
        w.write_static(n, np.asarray(tr[i]))
    w.write_static("h", np.asarray(h))
    w.close()
    return tr


def run_segment(state, G, GV, params: DynParams, forces: MechForcing, *,
                n_steps: int, stats_interval: int = 10,
                stats_path: Optional[str] = None, verbose: bool = False):
    """Run ``n_steps`` baroclinic steps, writing stats every interval."""
    stepper = make_stepper(G, GV, params, forces,
                           steps_per_call=stats_interval)
    writer = StatsWriter(stats_path) if stats_path else None
    n_calls = n_steps // stats_interval
    t0 = time.time()
    for c in range(n_calls):
        state = stepper(state)
        step = (c + 1) * stats_interval
        jax.block_until_ready(state.h)
        s = compute_stats(state, G, GV, params.dt)
        tdays = step * params.dt / 86400.0
        if writer:
            writer.write(step, tdays, s)
        if verbose:
            from mom6_tpu.diagnostics.sum_output import format_stats_line
            print(format_stats_line(step, tdays, s))
    elapsed = time.time() - t0
    return state, elapsed


if __name__ == "__main__":
    main()
