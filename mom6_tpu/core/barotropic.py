"""Split-explicit barotropic solver.

Re-design of MOM6's btstep (reference:
src/core/MOM_barotropic.F90: btstep :455, btstep_timeloop :2175,
btloop_eta_predictor :2956, btloop_find_PF :3063, btloop_update_u/v
:3209/:3306, btstep_layer_accel :3432, set_dtbt :3509).

The subcycle is one ``jax.lax.scan`` compiled into the baroclinic step — no
host round trips.  Each substep is a dissipative forward-backward scheme:

  1. eta predictor with current transports (forward);
  2. anomalous pressure force from the ``bebt``-weighted eta;
  3. velocity updates with Coriolis anomalies, alternating u-first/v-first;
  4. eta corrector with the new transports (backward).

MOM6's wide-halo march-inward trick (exchange every ``num_cycles`` substeps)
is unnecessary here: every shift lowers to a GSPMD CollectivePermute and XLA
pipelines them; an explicit shard_map variant with redundant-compute halos is
a planned optimization for pod scale.

The substep averaging uses the reference's filter shapes: a flat-top
eta/velocity window of half-width ``nfilter`` substeps and
reverse-cumulative-sum transport/acceleration weights (see ``_weights``).

Transports use either the linearized form ``uhbt = Datu * ubt + uhbt0``
or, when a ``BTCont`` is supplied, the nonlinear response curves built
from the layer continuity's PPM reconstructions (find_uhbt :4610) —
offset so the curve agrees with the layer-sum transports at the initial
velocities.  A linear + quadratic barotropic bottom drag acts implicitly
inside the subcycle (the lin_drag/bt_drag role).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mom6_tpu.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["BTParams", "BTOut", "btstep", "set_dtbt",
           "dtbt_max_from_state", "btcalc"]


class BTParams(NamedTuple):
    nstep: int            # substeps covering dt (static)
    nfilter: int          # extra filter substeps (static)
    bebt: float = 0.2     # backward weighting of eta in the PF [0..1]
    #                         (the reference default; with the reference
    #                         filter shapes in _weights the 30-day
    #                         resting-basin gate holds at 0.2 — the
    #                         earlier triangular filter needed 0.5).
    dgeo_de: float = 1.0  # over-relaxation of the surface-height geopotential
    use_bt_cont: bool = False   # nonlinear transport response curves
    lin_drag: float = 0.0       # linear barotropic drag piston vel [m s-1]
    cdrag: float = 0.0          # quadratic drag coefficient (BT Rayleigh)
    # scalar self-attraction & loading inside the subcycle: the eta-anomaly
    # PF is scaled by (1 - beta), the SAL_SCALAR_VALUE approximation
    # (MOM_self_attr_load.F90 scalar branch; applied per-substep as the
    # reference's calc_SAL call in btstep)
    sal_scalar: float = 0.0
    # dynamic surface pressure under rigid sea ice / ice shelves
    # (DYNAMIC_SURFACE_PRESSURE, MOM_barotropic.F90:1590-1632,3153-3207):
    # a viscous pressure p = dyn_coef * (eta_pred - eta) damping the
    # divergence of the external mode where the coupler reports ice
    # rigidity
    dynamic_psurf: bool = False
    const_dyn_psurf: float = 0.9    # CONST_DYN_PSURF
    ice_strength_length: float = 1.0e4   # ICE_LENGTH_DYN_PSURF [m]
    dmin_dyn_psurf: float = 1.0e-6  # MIN_DYN_PSURF_AVG depth floor [m]
    # wide-halo (march-inward) subcycle — the production analogue of the
    # reference's widened barotropic halos (BT_HALO_SIZE / BTHALO,
    # MOM_barotropic.F90:2506-2518,5450): each shard carries a
    # ``wide_halo``-cell rim of its neighbors, marches
    # wide_halo // halo_per_substep substeps locally, then refreshes the
    # rim with one ppermute exchange — one collective round per E
    # substeps instead of XLA's CollectivePermute per shift per substep.
    # 0 (default) keeps the GSPMD dense path.  -1 = AUTO: pick the
    # width from the mesh and shard shape at btstep time (off on a
    # single device) — the BTHALO default logic of
    # MOM_barotropic.F90:5450.  Requires ``mesh``.
    wide_halo: int = 0
    halo_per_substep: int = 2   # rim cells consumed per substep (the
    #                             scheme's dependency radius; 2 covers
    #                             the FB substep incl. BT_cont and OBC)
    mesh: object = None         # jax.sharding.Mesh for the shard_map path


def auto_wide_halo(params: "BTParams", grid_shape) -> int:
    """Resolve BT_WIDE_HALO = AUTO (-1): the BTHALO default logic of
    the reference (MOM_barotropic.F90:5450), restated for the
    exchange-amortization tradeoff of the shard_map path.

    Returns 0 (dense GSPMD) on a single device or when the shards are
    too small to carry a useful rim; otherwise a width targeting ~8
    substeps per exchange (W = 8 * halo_per_substep), capped at half
    the smaller shard dimension so the padded rim at most doubles the
    local array."""
    mesh = params.mesh
    if mesh is None:
        return 0
    my = mesh.shape.get("y", 1)
    mx = mesh.shape.get("x", 1)
    if my * mx == 1:
        return 0
    ny, nx = grid_shape[-2:]
    min_shard = min(ny // max(my, 1), nx // max(mx, 1))
    r = max(1, int(params.halo_per_substep))
    w = min(8 * r, (min_shard // 2) // 2 * 2)
    return w if w >= 2 * r else 0


class BTFields(NamedTuple):
    """Every (ny, nx) field the subcycle body reads.  Factored out of
    ``btstep``'s prep so the SAME half-step physics runs either densely
    under GSPMD or inside the wide-halo shard_map rim (explicit pytree:
    shard_map cannot close over sharded arrays).  Optional fields are
    None when the corresponding physics is off."""
    eta_PF: jnp.ndarray
    gtot: jnp.ndarray
    bt_force_u: jnp.ndarray
    bt_force_v: jnp.ndarray
    q_f: jnp.ndarray
    tot_hu: jnp.ndarray
    tot_hv: jnp.ndarray
    cor_ref_u: jnp.ndarray
    cor_ref_v: jnp.ndarray
    rem_u: jnp.ndarray          # per-substep viscous remnant bt_rem
    rem_v: jnp.ndarray
    uhbt0: jnp.ndarray
    vhbt0: jnp.ndarray
    mask_u: jnp.ndarray
    mask_v: jnp.ndarray
    IareaT: jnp.ndarray
    IdxCu: jnp.ndarray
    IdyCv: jnp.ndarray
    Datu: jnp.ndarray = None        # None when use_bt_cont
    Datv: jnp.ndarray = None
    drag_u: jnp.ndarray = None      # implicit BT drag factor | None
    drag_v: jnp.ndarray = None
    btc: object = None              # BTCont | None
    dyn_coef: jnp.ndarray = None    # dynamic surface pressure | None
    # OBC (Flather-in-subcycle) arrays | None
    obc_mask_u: jnp.ndarray = None
    obc_mask_v: jnp.ndarray = None
    obc_mask_cell: jnp.ndarray = None
    obc_sign_u: jnp.ndarray = None
    obc_sign_v: jnp.ndarray = None
    obc_uvel_ext: jnp.ndarray = None
    obc_vvel_ext: jnp.ndarray = None
    obc_eta_ext: jnp.ndarray = None
    # per-face Flather wave speeds (zeroed on SPECIFIED faces, which
    # clamp ubt/vbt to the given inflow with no eta response)
    obc_c_fl_u: jnp.ndarray = None
    obc_c_fl_v: jnp.ndarray = None


def dense_kit(G):
    """Stencil kit for the GSPMD dense path: global rolls with the
    tripolar-fold ghost rows where the grid has one."""
    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    ku = "u" if fold else None
    from mom6_tpu.framework.stencil import jm1_s0
    return dict(ip1=ip1, im1=im1, jm1=jm1,
                jp1_h=lambda a: jp1(a, kh),
                jp1_u=lambda a: jp1(a, ku),
                jm1_s0=lambda a: jm1_s0(a, kh),
                # jm1 of a corner-row quantity (fv_q in cor_u): under a
                # northern fold the j=0 wrap row is the (nonzero) fold
                # row, but the southern boundary of a tripolar grid is
                # a wall — zero it (same reasoning as jm1_s0; without a
                # fold the wrap row is masked-zero already)
                jm1_q=lambda a: jm1_s0(a, kh))


def local_kit():
    """Stencil kit for the shard_map wide-halo path: plain local rolls —
    ALL topology (x periodicity, walls, the tripolar fold) lives in the
    exchanged rim content, so the body itself is translation-only."""
    return dict(ip1=ip1, im1=im1, jm1=jm1,
                jp1_h=lambda a: jp1(a, None),
                jp1_u=lambda a: jp1(a, None),
                jm1_s0=jm1, jm1_q=jm1)


def _make_half_step(F: BTFields, consts: dict, kit: dict):
    """Build the forward-backward substep function from the field pytree
    (the body of the reference's btstep substep loop,
    MOM_barotropic.F90:2505-3300).  Identical physics for the dense and
    wide-halo paths; only the stencil kit differs."""
    dtbt = consts["dtbt"]
    bebt = consts["bebt"]
    dgeo = consts["dgeo"]
    sal_fac = consts["sal_fac"]
    ip1_, im1_ = kit["ip1"], kit["im1"]
    jp1_h, jp1_u, jm1_s0_ = kit["jp1_h"], kit["jp1_u"], kit["jm1_s0"]

    jm1_q = kit["jm1_q"]

    def cor_u(Vw):
        fv_q = F.q_f * 0.5 * (Vw + ip1_(Vw))
        return 0.5 * (fv_q + jm1_q(fv_q))

    def cor_v(Uw):
        fu_q = F.q_f * 0.5 * (Uw + jp1_u(Uw))
        return -0.5 * (fu_q + im1_(fu_q))

    def div_eta(uhbt, vhbt):
        return -F.IareaT * ((uhbt - im1_(uhbt))
                            + (vhbt - jm1_s0_(vhbt)))

    def pf_anom(eta_w):
        ge = F.gtot * (eta_w - F.eta_PF) * (dgeo * sal_fac)
        pfu = -(ip1_(ge) - ge) * F.IdxCu * F.mask_u
        pfv = -(jp1_h(ge) - ge) * F.IdyCv * F.mask_v
        return pfu, pfv

    if consts["use_bt_cont"]:
        from mom6_tpu.core.continuity_ppm import find_uhbt, find_vhbt

        def transports(ubt, vbt):
            return (find_uhbt(ubt, F.btc) + F.uhbt0,
                    find_vhbt(vbt, F.btc) + F.vhbt0)
    else:
        def transports(ubt, vbt):
            return F.Datu * ubt + F.uhbt0, F.Datv * vbt + F.vhbt0

    # exact operation order of the pre-refactor btstep (bit-identical
    # dense path: the x64 golden gates pin it)
    def dragged_u(x):
        x = F.rem_u * x
        return (x * F.drag_u if F.drag_u is not None else x) * F.mask_u

    def dragged_v(x):
        x = F.rem_v * x
        return (x * F.drag_v if F.drag_v is not None else x) * F.mask_v

    if F.obc_mask_u is not None:
        def obc_bt(ubt, vbt, eta):
            eta_u = jnp.where(F.obc_sign_u >= 0.0, eta, ip1_(eta))
            eta_v = jnp.where(F.obc_sign_v >= 0.0, eta, jp1_h(eta))
            u_fl = F.obc_uvel_ext + F.obc_sign_u * F.obc_c_fl_u \
                * (eta_u - F.obc_eta_ext)
            v_fl = F.obc_vvel_ext + F.obc_sign_v * F.obc_c_fl_v \
                * (eta_v - F.obc_eta_ext)
            ubt = ubt * (1.0 - F.obc_mask_u) + F.obc_mask_u * u_fl
            vbt = vbt * (1.0 - F.obc_mask_v) + F.obc_mask_v * v_fl
            return ubt, vbt

        def obc_eta(eta):
            return jnp.where(F.obc_mask_cell > 0.5, F.obc_eta_ext, eta)
    else:
        def obc_bt(ubt, vbt, eta):
            return ubt, vbt

        def obc_eta(eta):
            return eta

    def half_step(ubt, vbt, eta, uhbt, vhbt, u_leads: bool):
        """One forward-backward substep with a STATIC update order —
        the alternating parity is unrolled into pairs by the runner, so
        there is no lax.cond in the hot loop.

        ``uhbt``/``vhbt`` are the transports of the ENTRY velocities,
        carried from the previous substep's exit (bit-identical to
        ``transports(ubt, vbt)``, so recomputing would double the
        transport work)."""
        # 1. eta predictor (forward, with current transports)
        eta_pred = eta + dtbt * div_eta(uhbt, vhbt)
        # 2. pressure force from bebt-weighted eta
        eta_w = (1.0 - bebt) * eta + bebt * eta_pred
        pfu, pfv = pf_anom(eta_w)
        if F.dyn_coef is not None:
            # under-ice viscous surface pressure resisting d(eta)/dt
            # (btloop_add_dyn_PF, MOM_barotropic.F90:3153-3207)
            p_dyn = F.dyn_coef * (eta_pred - eta)
            pfu = pfu - (ip1_(p_dyn) - p_dyn) * F.IdxCu * F.mask_u
            pfv = pfv - (jp1_h(p_dyn) - p_dyn) * F.IdyCv * F.mask_v
        # 3. velocity updates in the prescribed order
        if u_leads:
            cu = cor_u(F.tot_hv * vbt) - F.cor_ref_u
            ubt = dragged_u(ubt + dtbt * (F.bt_force_u + cu + pfu))
            cv = cor_v(F.tot_hu * ubt) - F.cor_ref_v
            vbt = dragged_v(vbt + dtbt * (F.bt_force_v + cv + pfv))
        else:
            cv = cor_v(F.tot_hu * ubt) - F.cor_ref_v
            vbt = dragged_v(vbt + dtbt * (F.bt_force_v + cv + pfv))
            cu = cor_u(F.tot_hv * vbt) - F.cor_ref_u
            ubt = dragged_u(ubt + dtbt * (F.bt_force_u + cu + pfu))
        ubt, vbt = obc_bt(ubt, vbt, eta_w)
        # 4. eta corrector (backward, with the new transports)
        uhbt, vhbt = transports(ubt, vbt)
        eta = obc_eta(eta + dtbt * div_eta(uhbt, vhbt))
        return ubt, vbt, eta, uhbt, vhbt, cu + pfu, cv + pfv

    return half_step


class BTOut(NamedTuple):
    accel_layer_u: jnp.ndarray   # (nz, ny, nx) layer accel from BT [m s-2]
    accel_layer_v: jnp.ndarray
    uhbt_av: jnp.ndarray         # (ny, nx) time-mean BT transport [m3 s-1]
    vhbt_av: jnp.ndarray
    ubt_av: jnp.ndarray          # time-filtered final BT velocity [m s-1]
    vbt_av: jnp.ndarray
    eta_out: jnp.ndarray         # filtered eta at the end of the step [m]
    e_anom: jnp.ndarray          # time-mean eta anomaly vs eta_PF [m]


def set_dtbt(G, GV, max_depth: float, dt: float, cfl: float = 0.7):
    """Barotropic substep count from the external gravity wave CFL
    (analogue of set_dtbt, MOM_barotropic.F90:3509). Host-side, static."""
    wet = np.asarray(G.mask2dT) > 0.5
    if not wet.any():
        wet = np.ones_like(wet)
    # min over WET cells only: land (e.g. the degenerate tripolar pole
    # columns) must not set the global substep count
    dx = float(np.min(np.where(wet, np.asarray(G.dxT), np.inf)))
    dy = float(np.min(np.where(wet, np.asarray(G.dyT), np.inf)))
    cg = np.sqrt(GV.g_earth * max_depth)
    dtbt = cfl * min(dx, dy) / (np.sqrt(2.0) * cg)
    nstep = max(1, int(np.ceil(dt / dtbt)))
    return nstep, dt / nstep


def dtbt_max_from_state(h, pbce, G, bebt: float, dgeo_de: float = 1.0):
    """Maximum stable barotropic substep from the CURRENT state — the
    exact per-cell stability bound of the reference's set_dtbt
    (MOM_barotropic.F90:3570-3627): per cell,

      1/dt^2 = (1+2*bebt)/2 * [ IareaT * sum_faces(gtot_face * Dat_face
               * Idx_face) + sum_corners f^2 ]

    with ``gtot_face`` the pbce column mean weighted by that face's layer
    fractions, minimized over wet cells.  Jittable; returns a scalar.
    The solo driver re-evaluates this as the stratification evolves and
    rebuilds the stepper when the implied substep count changes (the
    DTBT_RESET_PERIOD role)."""
    h_u, h_v, frac_u, frac_v = btcalc(h, G)
    DatIdx_u = G.dyCu * jnp.sum(h_u, axis=0) * G.mask2dCu * G.IdxCu
    DatIdy_v = G.dxCv * jnp.sum(h_v, axis=0) * G.mask2dCv * G.IdyCv
    gtot_E = jnp.sum(pbce * frac_u, axis=0)          # east face of cell i
    gtot_W = jnp.sum(pbce * im1(frac_u), axis=0)
    gtot_N = jnp.sum(pbce * frac_v, axis=0)
    gtot_S = jnp.sum(pbce * jm1(frac_v), axis=0)
    f2 = G.CoriolisBu ** 2
    cor2 = (f2 + im1(jm1(f2))) + (im1(f2) + jm1(f2))
    idt2 = 0.5 * (1.0 + 2.0 * bebt) * (
        G.IareaT * ((gtot_E * DatIdx_u + gtot_W * im1(DatIdx_u))
                    + (gtot_N * DatIdy_v + gtot_S * jm1(DatIdy_v)))
        + cor2)
    idt2_max = jnp.max(jnp.where(G.mask2dT > 0.5, idt2, 0.0))
    return jnp.sqrt(1.0 / jnp.maximum(idt2_max * dgeo_de, 1e-30))


def btcalc(h, G, *, h_u=None, h_v=None):
    """Face thicknesses and layer fractions (btcalc, MOM_barotropic.F90:4360).

    Returns (h_u, h_v, frac_u, frac_v): arithmetic-mean face thicknesses and
    per-layer column fractions at faces."""
    if h_u is None:
        h_u = 0.5 * (h + ip1(h)) * G.mask2dCu
    if h_v is None:
        h_v = 0.5 * (h + jp1(h, "h" if getattr(G, "fold_north", False)
                             else None)) * G.mask2dCv
    tot_u = jnp.maximum(jnp.sum(h_u, axis=0), 1e-30)
    tot_v = jnp.maximum(jnp.sum(h_v, axis=0), 1e-30)
    return h_u, h_v, h_u / tot_u, h_v / tot_v


def _coriolis_u(q, Vw):
    """Sadourny energy-conserving barotropic Coriolis: q = f/D at corners
    acting on depth-weighted meridional flow Vw = D_v * vbt.  The plain
    velocity-mean form (q -> f, Vw -> vbt) is only energy-neutral over a
    FLAT bottom; with varying depth it does net work on slope-trapped
    modes (an energy source with a few-day e-folding in resting basins
    over topography).  This mirrors the reference's depth-weighted
    btstep Coriolis (the q*(D u) structure of MOM_barotropic.F90
    amer/bmer/cmer/dmer weights)."""
    fv_q = q * 0.5 * (Vw + ip1(Vw))
    return 0.5 * (fv_q + jm1(fv_q))


def _coriolis_v(q, Uw, ku=None):
    fu_q = q * 0.5 * (Uw + jp1(Uw, ku))
    return -0.5 * (fu_q + im1(fu_q))


def _weights(nstep: int, nfilter: int, dtype, x_first: bool = True):
    """Per-substep averaging weights and the alternating update-order
    parity (inverted when the rotated frame must lead with the other
    physical direction).

    These are the reference's filter shapes (MOM_barotropic.F90:
    1739-1781, post-20190101 normalization):
    * ``wt_vel``/``wt_eta`` — a flat-top window of half-width
      ``nfilter`` substeps centred on substep ``nstep`` (the linear-ramp
      branch of the reference's dt_filt window is empty when dt_filt is
      an integer multiple of dtbt, as it is here with
      dt_filt = nfilter*dtbt), normalized;
    * ``wt_trans``/``wt_accel`` — the REVERSE CUMULATIVE SUM of the
      eta/vel window, normalized.  This pairing makes the filtered eta
      exactly the initial eta plus dt times the divergence of the
      weight-averaged transports, the split-mode consistency requirement
      of Hallberg & Adcroft (2009).  (wt_accel == wt_trans here because
      wt_vel == wt_eta, as in the reference's default filter.)"""
    n_tot = nstep + nfilter
    n = np.arange(1, n_tot + 1, dtype=np.float64)
    wt_eta = np.where(np.abs(n - nstep) <= nfilter, 1.0, 0.0)
    wt_vel = wt_eta / wt_eta.sum()
    rev = np.cumsum(wt_eta[::-1])[::-1]
    wt_trans = rev / rev.sum()
    parity = (n % 2 == 0) if x_first else (n % 2 == 1)
    return (jnp.asarray(wt_trans, dtype), jnp.asarray(wt_vel, dtype),
            jnp.asarray(parity.astype(np.int32)))


def _acc_add(acc, w_t, w_v, out):
    """Accumulate one substep's weighted contribution to the filtered
    transports/velocities/eta and the time-mean accelerations."""
    ubt, vbt, eta, uhbt, vhbt, uac, vac = out
    return dict(
        uhbt_av=acc["uhbt_av"] + w_t * uhbt,
        vhbt_av=acc["vhbt_av"] + w_t * vhbt,
        ubt_av=acc["ubt_av"] + w_v * ubt,
        vbt_av=acc["vbt_av"] + w_v * vbt,
        eta_av=acc["eta_av"] + w_v * eta,
        u_acc=acc["u_acc"] + w_t * uac,
        v_acc=acc["v_acc"] + w_t * vac,
    )


def _acc_zero(ubt_in, vbt_in, eta_in):
    z2u = jnp.zeros_like(ubt_in)
    z2v = jnp.zeros_like(vbt_in)
    z2h = jnp.zeros_like(eta_in)
    return dict(uhbt_av=z2u, vhbt_av=z2v, ubt_av=z2u, vbt_av=z2v,
                eta_av=z2h, u_acc=z2u, v_acc=z2v)


def _run_subcycle_dense(half_step, evolve0, wt_trans, wt_vel,
                        nstep: int, nfilter: int, first_u_leads: bool):
    """The GSPMD dense subcycle: one lax.scan over substep PAIRS (static
    update order inside each pair — no lax.cond in the hot loop), with a
    trailing odd substep unrolled outside."""
    ubt_in, vbt_in, eta_in, uhbt_0, vhbt_0 = evolve0
    n_tot = nstep + nfilter
    n_pairs = n_tot // 2
    wt_pairs = (wt_trans[:2 * n_pairs].reshape(n_pairs, 2),
                wt_vel[:2 * n_pairs].reshape(n_pairs, 2))

    def pair(carry, wts):
        ubt, vbt, eta, uhbt, vhbt, acc = carry
        w_t, w_v = wts
        o1 = half_step(ubt, vbt, eta, uhbt, vhbt, first_u_leads)
        acc = _acc_add(acc, w_t[0], w_v[0], o1)
        o2 = half_step(o1[0], o1[1], o1[2], o1[3], o1[4],
                       not first_u_leads)
        acc = _acc_add(acc, w_t[1], w_v[1], o2)
        return (o2[0], o2[1], o2[2], o2[3], o2[4], acc), None

    acc0 = _acc_zero(ubt_in, vbt_in, eta_in)
    (ubt_f, vbt_f, eta_f, uhbt_f, vhbt_f, acc), _ = jax.lax.scan(
        pair, (ubt_in, vbt_in, eta_in, uhbt_0, vhbt_0, acc0), wt_pairs,
        unroll=4)
    if n_tot % 2 == 1:
        # trailing odd substep outside the scan; substep n (1-indexed)
        # leads with u iff n is odd, and n_tot is odd here
        o = half_step(ubt_f, vbt_f, eta_f, uhbt_f, vhbt_f, first_u_leads)
        acc = _acc_add(acc, wt_trans[-1], wt_vel[-1], o)
        ubt_f, vbt_f, eta_f = o[0], o[1], o[2]
    return dict(acc, ubt=ubt_f, vbt=vbt_f, eta=eta_f)


def btstep(u_in, v_in, eta_in, bc_accel_u, bc_accel_v, h, uh_in, vh_in,
           visc_rem_u, visc_rem_v, pbce, eta_PF, dt, G, GV, params: BTParams,
           taux=None, tauy=None, x_first: bool = True,
           bt_cont=None, obc=None, u_uh0=None, v_uh0=None,
           rigidity_ice=None) -> BTOut:
    """One barotropic cycle covering a baroclinic step of length ``dt``.

    ``bt_cont``: optional BTCont response curves (set_bt_cont) making the
    barotropic transports consistent with the layer PPM continuity.

    ``obc``: optional OBCParams; Flather radiation is then applied to the
    barotropic velocities INSIDE every substep (apply_velocity_OBCs,
    MOM_barotropic.F90:3639-3825), so the external mode radiates at the
    substep cadence rather than only at the baroclinic step boundary.

    ``rigidity_ice``: optional (ny, nx) T-point ice rigidity map
    [m3 s-1] (the coupler's divergence-damping coefficient); with
    ``params.dynamic_psurf`` it activates the viscous under-ice surface
    pressure.

    ``u_uh0``/``v_uh0``: velocities to pair with ``uh_in``/``vh_in`` for
    the uhbt0 transport-mismatch offset, when the transports were
    evaluated with velocities other than ``u_in`` (the reference's
    separate u_ptr/uh_ptr arguments, MOM_barotropic.F90 btstep; used by
    the RK2b corrector where uh comes from the time-filtered u_av while
    the BT initial velocity is the instantaneous u_inst).  Default:
    ``u_in``."""
    dtype = u_in.dtype
    nstep, nfilter = params.nstep, params.nfilter
    dtbt = dtype.type(dt / nstep)
    bebt = dtype.type(params.bebt)
    dgeo = dtype.type(params.dgeo_de)

    h_u, h_v, frac_u, frac_v = btcalc(h, G)
    tot_hu = jnp.sum(h_u, axis=0)
    tot_hv = jnp.sum(h_v, axis=0)
    Datu = G.dyCu * tot_hu * G.mask2dCu
    Datv = G.dxCv * tot_hv * G.mask2dCv

    # barotropic projections of the 3-D state (btstep_ubt_from_layer)
    wt_u = frac_u * visc_rem_u
    wt_v = frac_v * visc_rem_v
    norm_u = jnp.maximum(jnp.sum(wt_u, axis=0), 1e-30)
    norm_v = jnp.maximum(jnp.sum(wt_v, axis=0), 1e-30)
    ubt_in = jnp.sum(wt_u * u_in, axis=0) / norm_u
    vbt_in = jnp.sum(wt_v * v_in, axis=0) / norm_v

    # layer-sum transport mismatch (uhbt0): makes the BT continuity agree
    # with the layer continuity at the velocities that produced uh_in
    if u_uh0 is None:
        ubt_uh0, vbt_uh0 = ubt_in, vbt_in
    else:
        ubt_uh0 = jnp.sum(wt_u * u_uh0, axis=0) / norm_u
        vbt_uh0 = jnp.sum(wt_v * v_uh0, axis=0) / norm_v
    if params.use_bt_cont and bt_cont is not None:
        from mom6_tpu.core.continuity_ppm import find_uhbt, find_vhbt
        uhbt0 = jnp.sum(uh_in, axis=0) - find_uhbt(ubt_uh0, bt_cont)
        vhbt0 = jnp.sum(vh_in, axis=0) - find_vhbt(vbt_uh0, bt_cont)
    else:
        uhbt0 = jnp.sum(uh_in, axis=0) - Datu * ubt_uh0
        vhbt0 = jnp.sum(vh_in, axis=0) - Datv * vbt_uh0

    # effective column-mean reduced gravity (gtot of btstep; single value per
    # cell here since our pbce is horizontally local)
    frac_h = h / jnp.maximum(jnp.sum(h, axis=0, keepdims=True), 1e-30)
    gtot = jnp.sum(frac_h * pbce, axis=0)

    # depth-mean forcing: baroclinic accelerations (+ wind stress, which the
    # layered equations receive through vertvisc, so the BT solver must see
    # its depth mean explicitly, cf. MOM_barotropic.F90:1280)
    bt_force_u = jnp.sum(wt_u * bc_accel_u, axis=0) / norm_u
    bt_force_v = jnp.sum(wt_v * bc_accel_v, axis=0) / norm_v
    if taux is not None:
        bt_force_u = bt_force_u + taux / (GV.rho0 * jnp.maximum(tot_hu, 1e-10))
    if tauy is not None:
        bt_force_v = bt_force_v + tauy / (GV.rho0 * jnp.maximum(tot_hv, 1e-10))
    bt_force_u = bt_force_u * G.mask2dCu
    bt_force_v = bt_force_v * G.mask2dCv

    # q = f/D at corners; the Coriolis terms act on depth-weighted flow
    # (see _coriolis_u) so they conserve energy over varying topography
    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    kus = "us" if fold else None
    ku = "u" if fold else None
    d_q = 0.25 * (tot_hu + jp1(tot_hu, kus) + tot_hv + ip1(tot_hv))
    q_f = G.CoriolisBu / jnp.maximum(d_q, 1e-3)
    def _uw(ub):
        return tot_hu * ub
    def _vw(vb):
        return tot_hv * vb
    cor_ref_u = _coriolis_u(q_f, _vw(vbt_in))
    cor_ref_v = _coriolis_v(q_f, _uw(ubt_in), ku)

    use_btc = bool(params.use_bt_cont and bt_cont is not None)

    # implicit barotropic drag rate (bt Rayleigh drag; the lin_drag role
    # of MOM_barotropic.F90): r = (lin + cdrag |u0|) / H_face
    # lin_drag may be a scalar or a (ny, nx) piston-velocity map (e.g.
    # the tidal wave drag of physics/lateral/wave_drag.py)
    lin_is_map = jnp.ndim(params.lin_drag) > 0
    if lin_is_map or params.lin_drag > 0.0 or params.cdrag > 0.0:
        if lin_is_map:
            # T-point piston-velocity map -> average to u/v faces (matches
            # wave_drag_accel's face averaging and the reference's
            # face-centered drag)
            lin_u = 0.5 * (params.lin_drag + ip1(params.lin_drag))
            lin_v = 0.5 * (params.lin_drag + jp1(params.lin_drag, kh))
        else:
            lin_u = lin_v = params.lin_drag
        rdrag_u = (lin_u + params.cdrag * jnp.abs(ubt_in)) \
            / jnp.maximum(tot_hu, 1e-3)
        rdrag_v = (lin_v + params.cdrag * jnp.abs(vbt_in)) \
            / jnp.maximum(tot_hv, 1e-3)
        drag_u = 1.0 / (1.0 + dtbt * rdrag_u)
        drag_v = 1.0 / (1.0 + dtbt * rdrag_v)
    else:
        drag_u = drag_v = None

    from mom6_tpu.framework.stencil import jm1_s0

    sal_fac = dtype.type(1.0 - params.sal_scalar)

    # viscous dynamic surface pressure under rigid ice
    # (MOM_barotropic.F90:1590-1632): dyn_coef relates d(eta)/substep to
    # a surface pressure, capped by the gravity-wave stability limit
    dyn_coef = None
    if params.dynamic_psurf and rigidity_ice is not None:
        du_dx = Datu * G.IdxCu
        dv_dy = Datv * G.IdyCv
        open_sum = (du_dx + im1(du_dx)) + (dv_dy + jm1_s0(dv_dy, kh))
        f2 = G.CoriolisBu ** 2
        f2_sum = (f2 + im1(f2)) + (jm1(f2) + im1(jm1(f2)))
        idt_max2 = 0.5 * (dgeo * (1.0 + 2.0 * bebt)) \
            * (G.IareaT * gtot * open_sum + f2_sum)
        h_eff_dx2 = jnp.maximum(
            params.dmin_dyn_psurf * (G.IdxT ** 2 + G.IdyT ** 2),
            G.IareaT * open_sum)
        dyn_coef_max = params.const_dyn_psurf \
            * jnp.maximum(0.0, 1.0 - dtbt ** 2 * idt_max2) \
            / (dtbt ** 2 * h_eff_dx2)
        # T-point rigidity stands in for the 4-face sum (rig_u(I)+
        # rig_u(I-1)+rig_v(J)+rig_v(J-1) ~ 4 rig_T)
        ice_strength = 4.0 * rigidity_ice \
            / (params.ice_strength_length ** 2 * dtbt)
        dyn_coef = jnp.minimum(dyn_coef_max, ice_strength) * G.mask2dT

    wt_trans, wt_vel, _ = _weights(nstep, nfilter, dtype, x_first)

    # per-substep viscous remnant (bt_rem of MOM_barotropic.F90:1486-1510):
    # the layered equations lose momentum to implicit bottom drag /
    # vertical viscosity each baroclinic step (visc_rem_[uv]); the BT
    # trajectory must decay at the matching rate or the transport
    # matching RESURRECTS the dragged depth-mean momentum every step and
    # the external mode feels no bottom drag at all (steady gyres then
    # run drag-free: the Stommel boundary layer never forms).  Applied
    # multiplicatively every substep: bt_rem = (sum frhat*visc_rem)^(1/nstep).
    av_rem_u = jnp.sum(frac_u * visc_rem_u, axis=0)
    av_rem_v = jnp.sum(frac_v * visc_rem_v, axis=0)
    instep = dtype.type(1.0 / max(nstep, 1))
    bt_rem_u = jnp.where(av_rem_u > 0.0,
                         jnp.maximum(av_rem_u, 1e-30) ** instep, 0.0) \
        * G.mask2dCu
    bt_rem_v = jnp.where(av_rem_v > 0.0,
                         jnp.maximum(av_rem_v, 1e-30) ** instep, 0.0) \
        * G.mask2dCv

    # OBC (Flather-in-subcycle) arrays: same face-mask geometry as
    # open_boundary.apply_obc; the eta entering the radiation condition
    # is the INTERIOR-side cell of each boundary face
    obc_fields = dict(obc_mask_u=None, obc_mask_v=None,
                      obc_mask_cell=None, obc_sign_u=None,
                      obc_sign_v=None, obc_uvel_ext=None,
                      obc_vvel_ext=None, obc_eta_ext=None,
                      obc_c_fl_u=None, obc_c_fl_v=None)
    if obc is not None:
        # SPECIFIED faces carry the inflow's depth-mean in uvel_ext and
        # a zeroed wave speed: btstep clamps ubt there (the reference's
        # OBC_SIMPLE segments inside the subcycle,
        # MOM_barotropic.F90 apply_velocity_OBCs)
        c_fl = jnp.sqrt(GV.g_earth / jnp.maximum(G.bathyT, 1.0))
        c_u = c_fl if obc.mask_u_spec is None else \
            c_fl * (1.0 - obc.mask_u_spec)
        c_v = c_fl if obc.mask_v_spec is None else \
            c_fl * (1.0 - obc.mask_v_spec)
        mask_u_all = obc.mask_u if obc.mask_u_spec is None else \
            jnp.clip(obc.mask_u + obc.mask_u_spec, 0.0, 1.0)
        mask_v_all = obc.mask_v if obc.mask_v_spec is None else \
            jnp.clip(obc.mask_v + obc.mask_v_spec, 0.0, 1.0)
        obc_fields = dict(
            obc_mask_u=mask_u_all, obc_mask_v=mask_v_all,
            obc_mask_cell=obc.mask_cell, obc_sign_u=obc.sign_u,
            obc_sign_v=obc.sign_v, obc_uvel_ext=obc.uvel_ext,
            obc_vvel_ext=obc.vvel_ext, obc_eta_ext=obc.eta_ext,
            obc_c_fl_u=c_u, obc_c_fl_v=c_v)

    F = BTFields(
        eta_PF=eta_PF, gtot=gtot, bt_force_u=bt_force_u,
        bt_force_v=bt_force_v, q_f=q_f, tot_hu=tot_hu, tot_hv=tot_hv,
        cor_ref_u=cor_ref_u, cor_ref_v=cor_ref_v,
        rem_u=bt_rem_u, rem_v=bt_rem_v, uhbt0=uhbt0, vhbt0=vhbt0,
        mask_u=G.mask2dCu, mask_v=G.mask2dCv, IareaT=G.IareaT,
        IdxCu=G.IdxCu, IdyCv=G.IdyCv,
        Datu=None if use_btc else Datu, Datv=None if use_btc else Datv,
        drag_u=drag_u, drag_v=drag_v, btc=bt_cont if use_btc else None,
        dyn_coef=dyn_coef, **obc_fields)
    consts = dict(dtbt=dtbt, bebt=bebt, dgeo=dgeo, sal_fac=sal_fac,
                  use_bt_cont=use_btc)

    # substep 1 order (reference's alternating u/v-first with the
    # FIRST_DIRECTION parity); subsequent substeps alternate.  Substep 1
    # leads with u exactly when x_first (see _weights' parity).
    first_u_leads = bool(x_first)
    half_step = _make_half_step(F, consts, dense_kit(G))
    if use_btc:
        from mom6_tpu.core.continuity_ppm import find_uhbt, find_vhbt
        uhbt_0 = find_uhbt(ubt_in, bt_cont) + uhbt0
        vhbt_0 = find_vhbt(vbt_in, bt_cont) + vhbt0
    else:
        uhbt_0 = Datu * ubt_in + uhbt0
        vhbt_0 = Datv * vbt_in + vhbt0

    evolve0 = (ubt_in, vbt_in, eta_in, uhbt_0, vhbt_0)
    w_eff = params.wide_halo
    if w_eff < 0:          # AUTO (BT_WIDE_HALO = -1)
        w_eff = auto_wide_halo(params, eta_in.shape)
    if w_eff > 0 and params.mesh is not None:
        from mom6_tpu.core.bt_widehalo import run_subcycle_widehalo
        carry = run_subcycle_widehalo(
            F, consts, evolve0, wt_trans, wt_vel, nstep, nfilter,
            first_u_leads, params._replace(wide_halo=w_eff), G)
    else:
        carry = _run_subcycle_dense(half_step, evolve0, wt_trans,
                                    wt_vel, nstep, nfilter,
                                    first_u_leads)

    e_anom = dgeo * (carry["eta_av"] - eta_PF)
    # per-layer acceleration (btstep_layer_accel, MOM_barotropic.F90:3432)
    pg = (pbce - gtot[None]) * e_anom[None]
    alu = (carry["u_acc"][None] - (ip1(pg) - pg) * G.IdxCu) * G.mask2dCu
    alv = (carry["v_acc"][None] - (jp1(pg, kh) - pg) * G.IdyCv) \
        * G.mask2dCv

    return BTOut(
        accel_layer_u=alu, accel_layer_v=alv,
        uhbt_av=carry["uhbt_av"], vhbt_av=carry["vhbt_av"],
        ubt_av=carry["ubt_av"], vbt_av=carry["vbt_av"],
        eta_out=carry["eta"], e_anom=e_anom,
    )
