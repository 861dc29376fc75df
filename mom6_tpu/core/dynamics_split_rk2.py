"""Split barotropic/baroclinic RK2 time stepping.

Re-design of MOM6's step_MOM_dyn_split_RK2 (reference:
src/core/MOM_dynamics_split_RK2.F90:294; call sequence documented in
SURVEY.md §3.3).  The whole step — predictor, barotropic subcycles,
corrector, implicit viscosity, continuity — is one pure jittable function
``state -> state`` with no host round-trips.

Sequence (mirroring the reference's):
  predictor:  PF(h) ; CorAd(u, h, uh_prev) ; visc coefficients & remnants ;
              continuity fluxes of (u,h) ; btstep ; up = u + be*dt*accel ;
              implicit vertvisc(up) ; continuity -> hp matched to uhbt_av
  corrector:  PF(hp) ; CorAd(up, hp, uh_pred) ; btstep ; u_new = u + dt*accel ;
              vertvisc(u_new) ; final continuity -> h_new, transports

``be`` is the predictor step fraction (MOM6 BE, default 0.6): accelerations
for the corrector are evaluated at t + be*dt.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from mom6_tpu.core.barotropic import BTParams, btstep
from mom6_tpu.core.continuity_ppm import continuity_ppm
from mom6_tpu.core.coriolis_adv import SADOURNY75_ENERGY, coriolis_adv
from mom6_tpu.core.pressure_force import find_eta, pressure_force_montgomery
from mom6_tpu.core.state import OceanState
from mom6_tpu.framework.stencil import im1, ip1, jm1, jp1
from mom6_tpu.physics.vertical.vert_friction import (gl90_coupling,
                                                     limit_velocity, vertvisc,
                                                     vertvisc_coef,
                                                     vertvisc_remnant)

__all__ = ["DynParams", "MechForcing", "AccelDiag",
           "step_dynamics_split_rk2", "step_dynamics_split_rk2b"]


class AccelDiag(NamedTuple):
    """Corrector-stage acceleration diagnostics (the accel_diag_ptrs of
    MOM_variables.F90, filled at MOM_dynamics_split_RK2.F90:836-1009),
    consumed by the KE term budget (MOM_diagnostics.F90)."""
    PFu: jnp.ndarray
    PFv: jnp.ndarray
    CAu: jnp.ndarray
    CAv: jnp.ndarray
    diffu: jnp.ndarray          # horizontal viscosity accel
    diffv: jnp.ndarray
    u_bt_accel: jnp.ndarray     # barotropic correction accel
    v_bt_accel: jnp.ndarray
    du_dt_visc: jnp.ndarray     # implicit vertical friction accel
    dv_dt_visc: jnp.ndarray


class DynParams(NamedTuple):
    dt: float                    # baroclinic time step [s]
    bt: BTParams                 # barotropic solver parameters
    be: float = 0.6              # predictor fraction (MOM6 BE)
    kv: float = 1e-4             # background vertical viscosity [m2 s-1]
    # GL90 interfacial viscosity (Greatbatch & Lamb 1990; the TWA form of
    # GM): kappa>0 selects nu = kappa f^2/N^2 via 1/N^2 = h/g'; alpha>0
    # the depth-independent form (find_coupling_coef_gl90,
    # MOM_vert_friction.F90:428)
    kappa_gl90: float = 0.0      # [m2 s-1]
    alpha_gl90: float = 0.0      # [m2]
    hbbl_gl90: float = 5.0       # bottom taper scale [m]
    bottom_drag: float = 0.0     # linear bottom drag piston velocity [m s-1]
    cdrag: float = 0.0           # quadratic bottom drag coefficient
    coriolis_scheme: str = SADOURNY75_ENERGY
    continuity_monotonic: bool = False
    # damp velocities at faces whose thinner neighbor is massless (vanished
    # layers below topography in ALE mode): such momentum is meaningless
    # and otherwise leaks into massive layers via the KE gradient
    massless_h: float = 1e-3     # [m]; 0 disables
    # "RK2" steps the instantaneous velocities (MOM_dynamics_split_RK2.F90);
    # "RK2B" steps the TIME-FILTERED velocities, reconstructing the
    # instantaneous ones from the stored 2-D barotropic corrections
    # du_av_inst (MOM_dynamics_split_RK2b.F90; see
    # step_dynamics_split_rk2b)
    scheme: str = "RK2"
    x_first: bool = True         # FIRST_DIRECTION of the split sweeps


class MechForcing(NamedTuple):
    taux: Optional[jnp.ndarray] = None   # (ny, nx) zonal wind stress [Pa]
    tauy: Optional[jnp.ndarray] = None
    p_surf: Optional[jnp.ndarray] = None  # surface pressure [Pa] (ice/atmos)
    u10: Optional[jnp.ndarray] = None     # 10-m wind speed [m s-1] (waves)
    # coupler wave imports (mom_cap.F90:873-877 Sw_lamult/Sw_pstokes):
    # a mixing-enhancement multiplier, or (nb, ny, nx) partitioned
    # surface Stokes drift driving the SURFBANDS Langmuir closure
    lamult: Optional[jnp.ndarray] = None
    pstokes_x: Optional[jnp.ndarray] = None
    pstokes_y: Optional[jnp.ndarray] = None
    # sea-ice/ice-shelf rigidity at T points [m3 s-1] — the coupler's
    # divergence-damping coefficient, consumed by the barotropic
    # solver's dynamic surface pressure (DYNAMIC_SURFACE_PRESSURE)
    rigidity_ice: Optional[jnp.ndarray] = None


def _face_thickness(h, G):
    kh = "h" if getattr(G, "fold_north", False) else None
    h_u = 0.5 * (h + ip1(h)) * G.mask2dCu
    h_v = 0.5 * (h + jp1(h, kh)) * G.mask2dCv
    return h_u, h_v


def _massless_ramp(h, G, h0: float):
    """Per-face factors ~1 where both neighbors have mass, ~0 where the
    thinner neighbor is vanished."""
    kh = "h" if getattr(G, "fold_north", False) else None
    hu = jnp.minimum(h, ip1(h))
    hv = jnp.minimum(h, jp1(h, kh))
    return hu / (hu + h0), hv / (hv + h0)


def _visc_setup(h, u, v, G, GV, p: "DynParams", bbl_piston,
                kv_int=None):
    """Face thicknesses, implicit-viscosity tridiagonal couplings and the
    viscous remnants over dt (vertvisc_coef + vertvisc_remnant,
    MOM_vert_friction.F90), shared by the RK2 and RK2b steppers.  ``u``/
    ``v`` supply the near-bottom speed for the quadratic drag law.
    ``kv_int``: optional boundary-layer/shear interface viscosity at h
    points ((nz+1, ny, nx), the visc%Kv_shear of MOM_set_viscosity),
    averaged to the faces and added to the background coupling — this
    is what spreads wind momentum over the mixed layer
    (find_coupling_coef, MOM_vert_friction.F90:1756)."""
    h_u, h_v = _face_thickness(h, G)
    # near-bottom speed for the quadratic drag law, averaged over the
    # deepest ~10 m of ACTUAL water — over topography layer nz is often a
    # vanished sliver with no velocity, and sampling it alone makes the
    # quadratic drag blind to the real near-bottom flow
    def _bot_avg(w, hf):
        z_fb = jnp.cumsum(hf[::-1], axis=0)[::-1]
        ov = jnp.minimum(z_fb, 10.0) - jnp.minimum(z_fb - hf, 10.0)
        return (jnp.sum(w * ov, axis=0)
                / jnp.maximum(jnp.sum(ov, axis=0), 1e-3))
    u_bot = _bot_avg(u, h_u)
    v_bot = _bot_avg(v, h_v)
    drag_u = bbl_piston[0] if bbl_piston is not None else p.bottom_drag
    drag_v = bbl_piston[1] if bbl_piston is not None else p.bottom_drag
    cdrag_eff = 0.0 if bbl_piston is not None else p.cdrag
    agl_u = agl_v = None
    if p.kappa_gl90 > 0.0 or p.alpha_gl90 > 0.0:
        f_u = 0.5 * (G.CoriolisBu + jm1(G.CoriolisBu))
        f_v = 0.5 * (G.CoriolisBu + im1(G.CoriolisBu))
        agl_u = gl90_coupling(h_u, f_u ** 2, GV.g_prime,
                              kappa_gl90=p.kappa_gl90,
                              alpha_gl90=p.alpha_gl90,
                              hbbl_gl90=p.hbbl_gl90)
        agl_v = gl90_coupling(h_v, f_v ** 2, GV.g_prime,
                              kappa_gl90=p.kappa_gl90,
                              alpha_gl90=p.alpha_gl90,
                              hbbl_gl90=p.hbbl_gl90)
    if kv_int is not None:
        # interior interfaces of the BL/shear viscosity, averaged to the
        # faces and converted to couplings a = Kv/dz (find_coupling_coef)
        kh = "h" if getattr(G, "fold_north", False) else None
        kv_c = kv_int[1:-1]
        kv_u = 0.5 * (kv_c + ip1(kv_c))
        kv_v = 0.5 * (kv_c + jp1(kv_c, kh))
        dz_u = jnp.maximum(0.5 * (h_u[:-1] + h_u[1:]), 1e-3)
        dz_v = jnp.maximum(0.5 * (h_v[:-1] + h_v[1:]), 1e-3)
        a_kv_u = kv_u / dz_u
        a_kv_v = kv_v / dz_v
        agl_u = a_kv_u if agl_u is None else agl_u + a_kv_u
        agl_v = a_kv_v if agl_v is None else agl_v + a_kv_v
    cu = vertvisc_coef(h_u, p.kv, bottom_drag=drag_u,
                       u_bot=u_bot, cdrag=cdrag_eff, a_gl90=agl_u)
    cv = vertvisc_coef(h_v, p.kv, bottom_drag=drag_v,
                       u_bot=v_bot, cdrag=cdrag_eff, a_gl90=agl_v)
    visc_rem_u = vertvisc_remnant(h_u, cu, p.dt)
    visc_rem_v = vertvisc_remnant(h_v, cv, p.dt)
    return h_u, h_v, cu, cv, visc_rem_u, visc_rem_v


def step_dynamics_split_rk2(state: OceanState, forces: MechForcing,
                            G, GV, p: DynParams, *,
                            pf_fn=None, hv_fn=None, por=None,
                            bbl_piston=None, obc=None, kv_int=None,
                            return_accel: bool = False):
    """``pf_fn(h, state) -> PressureForceOut`` overrides the default
    Montgomery pressure force (used for the FV/EOS thermo path);
    ``hv_fn(u, v, h) -> (diffu, diffv)`` adds lateral friction
    (horizontal_viscosity at MOM_dynamics_split_RK2.F90:886);
    ``por``: optional (por_u, por_v) per-layer fractional open face
    widths from the porous-barrier parameterization, applied in every
    continuity call (MOM_porous_barriers.F90 role);
    ``bbl_piston``: optional (r_u, r_v) BBL bottom-drag piston velocities
    [m s-1] from set_viscous_BBL (kv_bbl/bbl_thick), replacing the scalar
    ``p.bottom_drag`` in the implicit vertical friction."""
    if p.scheme.upper() == "RK2B":
        return step_dynamics_split_rk2b(state, forces, G, GV, p,
                                        pf_fn=pf_fn, hv_fn=hv_fn, por=por,
                                        bbl_piston=bbl_piston, obc=obc,
                                        kv_int=kv_int,
                                        return_accel=return_accel)
    dt = p.dt
    dt_pred = p.be * dt
    h, u, v = state.h, state.u, state.v
    eta = find_eta(h, G)
    por_u, por_v = por if por is not None else (None, None)
    if pf_fn is None:
        pf_fn = lambda hh, st: pressure_force_montgomery(hh, G, GV)

    # ---- shared setup ------------------------------------------------------
    h_u, h_v, cu, cv, visc_rem_u, visc_rem_v = _visc_setup(
        h, u, v, G, GV, p, bbl_piston, kv_int)

    # continuity fluxes of the initial state (for btstep's uhbt0)
    _, uh_in, vh_in, _, _ = continuity_ppm(
        u, v, h, dt, G, GV, monotonic=p.continuity_monotonic,
        x_first=p.x_first, por_u=por_u, por_v=por_v)

    # nonlinear barotropic transport response curves (set_BT_cont role)
    bt_cont = None
    if p.bt.use_bt_cont:
        from mom6_tpu.core.continuity_ppm import set_bt_cont
        bt_cont = set_bt_cont(h, dt, G, GV,
                              monotonic=p.continuity_monotonic)

    # ---- predictor -----------------------------------------------------------
    pf = pf_fn(h, state)
    cau, cav = coriolis_adv(u, v, h, state.uh, state.vh, G, GV,
                            scheme=p.coriolis_scheme)
    diffu = diffv = 0.0
    if hv_fn is not None:
        diffu, diffv = hv_fn(u, v, h)
    u_bc = (cau + pf.PFu + diffu) * G.mask2dCu
    v_bc = (cav + pf.PFv + diffv) * G.mask2dCv

    # the predictor covers only be*dt, so it needs proportionally fewer
    # substeps at the same dtbt (the reference's nstep = CEILING(dt/dtbt),
    # MOM_barotropic.F90:796 — evaluated per btstep call); running the
    # full count shortened dtbt instead, costing ~1/be more BT work
    import math
    nstep_pred = max(1, math.ceil(p.be * p.bt.nstep))
    nfilt_pred = max(1, round(p.bt.nfilter * nstep_pred / p.bt.nstep))
    bt_pred = p.bt._replace(nstep=nstep_pred, nfilter=nfilt_pred)
    bt1 = btstep(u, v, eta, u_bc, v_bc, h, uh_in, vh_in,
                 visc_rem_u, visc_rem_v, pf.pbce, pf.eta_PF,
                 dt_pred, G, GV, bt_pred, taux=forces.taux,
                 tauy=forces.tauy,
                 x_first=p.x_first, bt_cont=bt_cont, obc=obc,
                 rigidity_ice=forces.rigidity_ice)

    up = (u + dt_pred * (u_bc + bt1.accel_layer_u)) * G.mask2dCu
    vp = (v + dt_pred * (v_bc + bt1.accel_layer_v)) * G.mask2dCv
    up = vertvisc(up, h_u, cu, dt_pred,
                  tau=forces.taux, rho0=GV.rho0) * G.mask2dCu
    vp = vertvisc(vp, h_v, cv, dt_pred,
                  tau=forces.tauy, rho0=GV.rho0) * G.mask2dCv
    # CFL truncation after the viscous solve (vertvisc_limit_vel,
    # MOM_vert_friction.F90:2929) — numerical-fault containment
    up, vp, _ = limit_velocity(up, vp, dt_pred, G)
    if p.massless_h > 0.0:
        ru, rv = _massless_ramp(h, G, p.massless_h)
        up, vp = up * ru, vp * rv

    hp, uh_p, vh_p, up_adj, vp_adj = continuity_ppm(
        up, vp, h, dt_pred, G, GV,
        uhbt=bt1.uhbt_av, vhbt=bt1.vhbt_av,
        visc_rem_u=visc_rem_u, visc_rem_v=visc_rem_v,
        monotonic=p.continuity_monotonic, x_first=p.x_first,
        por_u=por_u, por_v=por_v)

    # ---- corrector ------------------------------------------------------------
    pf2 = pf_fn(hp, state)
    uc, vc = up_adj, vp_adj
    cau2, cav2 = coriolis_adv(uc, vc, hp, uh_p, vh_p, G, GV,
                              scheme=p.coriolis_scheme)
    if hv_fn is not None:
        diffu, diffv = hv_fn(uc, vc, hp)
    u_bc2 = (cau2 + pf2.PFu + diffu) * G.mask2dCu
    v_bc2 = (cav2 + pf2.PFv + diffv) * G.mask2dCv

    bt2 = btstep(u, v, eta, u_bc2, v_bc2, h, uh_in, vh_in,
                 visc_rem_u, visc_rem_v, pf2.pbce, pf2.eta_PF,
                 dt, G, GV, p.bt, taux=forces.taux, tauy=forces.tauy,
                 x_first=p.x_first, bt_cont=bt_cont, obc=obc,
                 rigidity_ice=forces.rigidity_ice)

    u_pre_visc = (u + dt * (u_bc2 + bt2.accel_layer_u)) * G.mask2dCu
    v_pre_visc = (v + dt * (v_bc2 + bt2.accel_layer_v)) * G.mask2dCv
    u_new = vertvisc(u_pre_visc, h_u, cu, dt,
                     tau=forces.taux, rho0=GV.rho0) * G.mask2dCu
    v_new = vertvisc(v_pre_visc, h_v, cv, dt,
                     tau=forces.tauy, rho0=GV.rho0) * G.mask2dCv
    accel = None
    if return_accel:
        accel = AccelDiag(
            PFu=pf2.PFu * G.mask2dCu, PFv=pf2.PFv * G.mask2dCv,
            CAu=cau2 * G.mask2dCu, CAv=cav2 * G.mask2dCv,
            diffu=diffu * jnp.ones_like(u), diffv=diffv * jnp.ones_like(v),
            u_bt_accel=bt2.accel_layer_u * G.mask2dCu,
            v_bt_accel=bt2.accel_layer_v * G.mask2dCv,
            du_dt_visc=(u_new - u_pre_visc) / dt,
            dv_dt_visc=(v_new - v_pre_visc) / dt)
    # replace the vertical mean with the time-FILTERED barotropic velocity
    # (the u_av construction of MOM_dynamics_split_RK2.F90:125 — "layer
    # velocity with vertical mean replaced by the time-mean barotropic
    # velocity").  Without this, the raw unfiltered barotropic mode rides
    # along in the prognostic u and beats against the barotropic solver's
    # own estimate, a slow split-consistency leak that e-folds resting
    # basins over topography in days (Hallberg & Adcroft 2009).
    tot_hu = jnp.maximum(jnp.sum(h_u, axis=0), 1e-10)
    tot_hv = jnp.maximum(jnp.sum(h_v, axis=0), 1e-10)
    ubar = jnp.sum(h_u * u_new, axis=0) / tot_hu
    vbar = jnp.sum(h_v * v_new, axis=0) / tot_hv
    u_new = (u_new + (bt2.ubt_av - ubar)[None]) * G.mask2dCu
    v_new = (v_new + (bt2.vbt_av - vbar)[None]) * G.mask2dCv
    u_new, v_new, _ = limit_velocity(u_new, v_new, dt, G)
    if p.massless_h > 0.0:
        ru, rv = _massless_ramp(h, G, p.massless_h)
        u_new, v_new = u_new * ru, v_new * rv

    # the flux adjustment only modifies the transports; the prognostic
    # velocities stay u_new (as in the reference's final continuity call)
    h_new, uh, vh, _, _ = continuity_ppm(
        u_new, v_new, h, dt, G, GV,
        uhbt=bt2.uhbt_av, vhbt=bt2.vhbt_av,
        visc_rem_u=visc_rem_u, visc_rem_v=visc_rem_v,
        monotonic=p.continuity_monotonic, x_first=p.x_first,
        por_u=por_u, por_v=por_v)

    uhtr = state.uhtr + dt * uh if state.uhtr is not None else None
    vhtr = state.vhtr + dt * vh if state.vhtr is not None else None

    out = state.replace(h=h_new, u=u_new, v=v_new, uh=uh, vh=vh,
                        uhtr=uhtr, vhtr=vhtr)
    return (out, accel) if return_accel else out


def step_dynamics_split_rk2b(state: OceanState, forces: MechForcing,
                             G, GV, p: DynParams, *,
                             pf_fn=None, hv_fn=None, por=None,
                             bbl_piston=None, obc=None, kv_int=None,
                             return_accel: bool = False):
    """Split RK2b: the variant that time-steps the TIME-FILTERED
    velocities (step_MOM_dyn_split_RK2b, reference:
    src/core/MOM_dynamics_split_RK2b.F90:284).

    Differences from :func:`step_dynamics_split_rk2`, mirroring the
    reference:

    * ``state.u``/``state.v`` are the time-filtered velocities u_av
      ("layer velocity with the vertical mean replaced by the time-mean
      barotropic velocity"); the instantaneous velocities are
      reconstructed each step as ``u_inst = u_av - du_av_inst *
      visc_rem_u`` from the stored 2-D corrections (restart pair
      ``du_av_inst``/``dv_av_inst``, ref :701-706).
    * Predictor tendencies (CorAd, hor_visc) are evaluated at u_av with
      time-centred thicknesses h_av = (h + hp)/2 from an initial
      continuity call of (u_av, h) (ref :506-566).
    * The pressure force is evaluated ONCE at the start-of-step h and
      reused in the corrector (the reference recomputes only when
      begw /= 0, ref :827-850; begw = 0 here).
    * Both btstep calls integrate the FULL dt from (u_inst, eta); only
      the predictor velocity update is scaled by be*dt (ref :678-709).
    * Each uhbt-matched continuity call yields the new u_av (the u_cor
      output); the final one also yields du_cor, stored as du_av_inst
      for the next step's reconstruction (ref :1007-1010).
    """
    dt = p.dt
    dt_pred = p.be * dt
    h, u_av, v_av = state.h, state.u, state.v
    eta = find_eta(h, G)
    por_u, por_v = por if por is not None else (None, None)
    if pf_fn is None:
        pf_fn = lambda hh, st: pressure_force_montgomery(hh, G, GV)

    h_u, h_v, cu, cv, visc_rem_u, visc_rem_v = _visc_setup(
        h, u_av, v_av, G, GV, p, bbl_piston, kv_int)

    # reconstruct the instantaneous velocities (ref :701-706)
    du_i = (state.du_av_inst if state.du_av_inst is not None
            else jnp.zeros(u_av.shape[1:], u_av.dtype))
    dv_i = (state.dv_av_inst if state.dv_av_inst is not None
            else jnp.zeros(v_av.shape[1:], v_av.dtype))
    u_inst = (u_av - du_i[None] * visc_rem_u) * G.mask2dCu
    v_inst = (v_av - dv_i[None] * visc_rem_v) * G.mask2dCv

    # transports of the time-filtered velocities drive the predictor
    # Coriolis/advection (ref :506-510)
    hp0, uh0, vh0, _, _ = continuity_ppm(
        u_av, v_av, h, dt, G, GV, monotonic=p.continuity_monotonic,
        x_first=p.x_first, por_u=por_u, por_v=por_v)
    h_av0 = 0.5 * (h + hp0)

    # pressure force at h, shared by both stages (begw = 0)
    pf = pf_fn(h, state)
    cau, cav = coriolis_adv(u_av, v_av, h_av0, uh0, vh0, G, GV,
                            scheme=p.coriolis_scheme)
    diffu = diffv = 0.0
    if hv_fn is not None:
        diffu, diffv = hv_fn(u_av, v_av, h_av0)
    u_bc = (cau + pf.PFu + diffu) * G.mask2dCu
    v_bc = (cav + pf.PFv + diffv) * G.mask2dCv

    # instantaneous-velocity continuity feeds btstep's uhbt0/BT_cont
    # (ref :710-716)
    _, uh_in, vh_in, _, _ = continuity_ppm(
        u_inst, v_inst, h, dt, G, GV, monotonic=p.continuity_monotonic,
        x_first=p.x_first, por_u=por_u, por_v=por_v)
    bt_cont = None
    if p.bt.use_bt_cont:
        from mom6_tpu.core.continuity_ppm import set_bt_cont
        bt_cont = set_bt_cont(h, dt, G, GV,
                              monotonic=p.continuity_monotonic)

    # ---- predictor: btstep over the FULL dt (ref :735-741) ---------------
    bt1 = btstep(u_inst, v_inst, eta, u_bc, v_bc, h, uh_in, vh_in,
                 visc_rem_u, visc_rem_v, pf.pbce, pf.eta_PF,
                 dt, G, GV, p.bt, taux=forces.taux, tauy=forces.tauy,
                 x_first=p.x_first, bt_cont=bt_cont, obc=obc,
                 rigidity_ice=forces.rigidity_ice)

    up = (u_inst + dt_pred * (u_bc + bt1.accel_layer_u)) * G.mask2dCu
    vp = (v_inst + dt_pred * (v_bc + bt1.accel_layer_v)) * G.mask2dCv
    up = vertvisc(up, h_u, cu, dt_pred,
                  tau=forces.taux, rho0=GV.rho0) * G.mask2dCu
    vp = vertvisc(vp, h_v, cv, dt_pred,
                  tau=forces.tauy, rho0=GV.rho0) * G.mask2dCv
    up, vp, _ = limit_velocity(up, vp, dt_pred, G)
    if p.massless_h > 0.0:
        ru, rv = _massless_ramp(h, G, p.massless_h)
        up, vp = up * ru, vp * rv

    # predictor continuity over the FULL dt; the uhbt-matched output
    # velocities are the mid-step time-filtered estimates (ref :781-786)
    hp, uh_p, vh_p, uav_mid, vav_mid = continuity_ppm(
        up, vp, h, dt, G, GV,
        uhbt=bt1.uhbt_av, vhbt=bt1.vhbt_av,
        visc_rem_u=visc_rem_u, visc_rem_v=visc_rem_v,
        monotonic=p.continuity_monotonic, x_first=p.x_first,
        por_u=por_u, por_v=por_v)
    h_av = 0.5 * (h + hp)

    # ---- corrector (ref :870-905) ----------------------------------------
    cau2, cav2 = coriolis_adv(uav_mid, vav_mid, h_av, uh_p, vh_p, G, GV,
                              scheme=p.coriolis_scheme)
    if hv_fn is not None:
        diffu, diffv = hv_fn(uav_mid, vav_mid, h_av)
    u_bc2 = (cau2 + pf.PFu + diffu) * G.mask2dCu
    v_bc2 = (cav2 + pf.PFv + diffv) * G.mask2dCv

    bt2 = btstep(u_inst, v_inst, eta, u_bc2, v_bc2, h, uh_p, vh_p,
                 visc_rem_u, visc_rem_v, pf.pbce, pf.eta_PF,
                 dt, G, GV, p.bt, taux=forces.taux, tauy=forces.tauy,
                 x_first=p.x_first, bt_cont=bt_cont, obc=obc,
                 u_uh0=uav_mid, v_uh0=vav_mid,
                 rigidity_ice=forces.rigidity_ice)

    u_pre_visc = (u_inst + dt * (u_bc2 + bt2.accel_layer_u)) * G.mask2dCu
    v_pre_visc = (v_inst + dt * (v_bc2 + bt2.accel_layer_v)) * G.mask2dCv
    u_new = vertvisc(u_pre_visc, h_u, cu, dt,
                     tau=forces.taux, rho0=GV.rho0) * G.mask2dCu
    v_new = vertvisc(v_pre_visc, h_v, cv, dt,
                     tau=forces.tauy, rho0=GV.rho0) * G.mask2dCv
    u_new, v_new, _ = limit_velocity(u_new, v_new, dt, G)
    if p.massless_h > 0.0:
        ru, rv = _massless_ramp(h, G, p.massless_h)
        u_new, v_new = u_new * ru, v_new * rv
    accel = None
    if return_accel:
        accel = AccelDiag(
            PFu=pf.PFu * G.mask2dCu, PFv=pf.PFv * G.mask2dCv,
            CAu=cau2 * G.mask2dCu, CAv=cav2 * G.mask2dCv,
            diffu=diffu * jnp.ones_like(u_av),
            diffv=diffv * jnp.ones_like(v_av),
            u_bt_accel=bt2.accel_layer_u * G.mask2dCu,
            v_bt_accel=bt2.accel_layer_v * G.mask2dCv,
            du_dt_visc=(u_new - u_pre_visc) / dt,
            dv_dt_visc=(v_new - v_pre_visc) / dt)

    # final continuity: h update + the new time-filtered velocities whose
    # transports match the time-mean barotropic solution, plus the
    # corrections for the next step's u_inst reconstruction (ref :1007-1010)
    h_new, uh, vh, uav_new, vav_new, du_cor, dv_cor = continuity_ppm(
        u_new, v_new, h, dt, G, GV,
        uhbt=bt2.uhbt_av, vhbt=bt2.vhbt_av,
        visc_rem_u=visc_rem_u, visc_rem_v=visc_rem_v,
        monotonic=p.continuity_monotonic, x_first=p.x_first,
        por_u=por_u, por_v=por_v, return_cor=True)
    uav_new = uav_new * G.mask2dCu
    vav_new = vav_new * G.mask2dCv

    uhtr = state.uhtr + dt * uh if state.uhtr is not None else None
    vhtr = state.vhtr + dt * vh if state.vhtr is not None else None

    out = state.replace(h=h_new, u=uav_new, v=vav_new, uh=uh, vh=vh,
                        uhtr=uhtr, vhtr=vhtr,
                        du_av_inst=du_cor * G.mask2dCu,
                        dv_av_inst=dv_cor * G.mask2dCv)
    return (out, accel) if return_accel else out
