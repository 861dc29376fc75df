"""Finite-volume thickness transport with PPM reconstruction.

Re-design of MOM6's continuity solver (reference:
src/core/MOM_continuity_PPM.F90: continuity_PPM :86, zonal_mass_flux :519,
zonal_flux_adjust :1093, PPM_reconstruction_x :2307, PPM_limit_pos :2578).

Design differences from the Fortran:
* fully vectorized over (nz, ny, nx) with ``jnp.where`` replacing the
  sign-of-u branches — one fused elementwise kernel per sweep;
* the per-face Newton iteration that adjusts layer fluxes to match a target
  barotropic transport (``zonal_flux_adjust``) runs a *fixed* number of
  iterations (jit-friendly; MOM6 iterates to tolerance);
* land/walls enforced by face masks (no loop bounds, no do_I masking).

The scheme is directionally split: an x sweep updates h, then a y sweep acts
on the updated field, exactly as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from mom6_tpu.framework.stencil import (im1, ip1, jm1, jm1_s0, jp1,
                                        jp1_sn)

__all__ = ["continuity_ppm", "zonal_mass_flux", "meridional_mass_flux",
           "ppm_reconstruction_x", "ppm_reconstruction_y",
           "BTCont", "set_bt_cont", "find_uhbt", "find_vhbt"]

# Fixed Newton iterations for the barotropic flux adjustment.  Measured
# on the global_half_deg state with a realistic barotropic perturbation:
# rel err 1.2e-1 after 1, 4.2e-4 after 2, 4.2e-7 (f32 roundoff, identical
# through n=6) after 3 — each extra iteration re-evaluates the full PPM
# flux.
_N_NEWTON = 3


def _ppm_edges(h, hm, hp, mask_m, mask_c, mask_p, h_min, monotonic):
    """Shared PPM edge-value logic given already-shifted neighbors.

    ``hm``/``hp`` are the i-1 / i+1 (or j-+1) neighbor values, ``mask_*`` the
    corresponding wet masks.  Returns (h_W, h_E) ("left"/"right" edges in the
    sweep direction).  Mirrors PPM_reconstruction_* + PPM_limit_pos/CW84.
    """
    # masked neighbors default to the center value
    h_m = mask_m * hm + (1.0 - mask_m) * h
    h_p = mask_p * hp + (1.0 - mask_p) * h

    # 2nd-order slope with Lin (1994) monotonic constraint, zeroed at coasts
    slp = 0.5 * (h_p - h_m)
    dMx = jnp.maximum(jnp.maximum(h_p, h_m), h) - h
    dMn = h - jnp.minimum(jnp.minimum(h_p, h_m), h)
    slp = jnp.sign(slp) * jnp.minimum(jnp.abs(slp), 2.0 * jnp.minimum(dMx, dMn))
    slp = slp * (mask_m * mask_c * mask_p)
    return h_m, h_p, slp


def _ppm_limit_pos(h, h_L, h_R, h_min):
    """Positive-definite limiter (PPM_limit_pos, MOM_continuity_PPM.F90:2578)."""
    curv = 3.0 * ((h_L + h_R) - 2.0 * h)
    dh = h_R - h_L
    # parabola minimum inside the cell and a true (convex-up) minimum
    min_inside = (curv > 0.0) & (jnp.abs(dh) < curv)
    # degenerate thin cell: flatten
    flatten = min_inside & (h <= h_min)
    denom = curv * curv + 3.0 * dh * dh
    needs_scale = min_inside & (~flatten) & (12.0 * curv * (h - h_min) < denom)
    scale = jnp.where(needs_scale, 12.0 * curv * (h - h_min) / jnp.maximum(denom, 1e-30), 1.0)
    h_L2 = h + scale * (h_L - h)
    h_R2 = h + scale * (h_R - h)
    h_L2 = jnp.where(flatten, h, h_L2)
    h_R2 = jnp.where(flatten, h, h_R2)
    return h_L2, h_R2


def _ppm_limit_cw84(h, h_L, h_R):
    """Colella & Woodward (1984) monotonic limiter (PPM_limit_CW84)."""
    not_mono = (h_R - h) * (h - h_L) <= 0.0
    rl_diff = h_R - h_L
    rl_mean = 0.5 * (h_R + h_L)
    fun_fac = 6.0 * rl_diff * (h - rl_mean)
    rl_diff2 = rl_diff * rl_diff
    h_L2 = jnp.where(fun_fac > rl_diff2, 3.0 * h - 2.0 * h_R, h_L)
    h_R2 = jnp.where(fun_fac < -rl_diff2, 3.0 * h - 2.0 * h_L, h_R)
    h_L2 = jnp.where(not_mono, h, h_L2)
    h_R2 = jnp.where(not_mono, h, h_R2)
    return h_L2, h_R2


def _recon_core(h, mask_t, h_min, monotonic, simple_2nd,
                m1_fn, p1_fn, p1_slp_fn):
    """PPM edge reconstruction with the sweep-direction shifts abstracted
    into callables: ``m1_fn``/``p1_fn`` shift toward the minus/plus
    neighbor, ``p1_slp_fn`` is the plus-shift for the SLOPE field (which
    is y-antisymmetric across a tripolar fold, hence a separate kind)."""
    hm, hp = m1_fn(h), p1_fn(h)
    mm, mp = m1_fn(mask_t), p1_fn(mask_t)
    if simple_2nd:
        h_m = mm * hm + (1.0 - mm) * h
        h_p = mp * hp + (1.0 - mp) * h
        return 0.5 * (h_m + h), 0.5 * (h_p + h)
    h_m, h_p, slp = _ppm_edges(h, hm, hp, mm, mask_t, mp, h_min, monotonic)
    one_sixth = 1.0 / 6.0
    h_L = 0.5 * (h_m + h) + one_sixth * (m1_fn(slp) - slp)
    h_R = 0.5 * (h_p + h) + one_sixth * (slp - p1_slp_fn(slp))
    if monotonic:
        return _ppm_limit_cw84(h, h_L, h_R)
    return _ppm_limit_pos(h, h_L, h_R, h_min)


def ppm_reconstruction_x(h, mask_t, h_min=1e-10, monotonic=False,
                         simple_2nd=False):
    """West/east edge values of the PPM fit in x.  (h: (..., ny, nx))."""
    return _recon_core(h, mask_t, h_min, monotonic, simple_2nd,
                       im1, ip1, ip1)


def ppm_reconstruction_y(h, mask_t, h_min=1e-10, monotonic=False,
                         simple_2nd=False, fold=False):
    kh = "h" if fold else None
    return _recon_core(h, mask_t, h_min, monotonic, simple_2nd,
                       jm1, lambda a: jp1(a, kh),
                       lambda a: jp1(a, "dh" if fold else None))


def _flux_pre_core(h, h_L, h_R, face, d_p, d_m, p1_fn, p1_pair_fn):
    """Velocity-independent pieces of the PPM flux, direction-agnostic:
    ``h_L``/``h_R`` are the upstream/downstream edges for positive flow,
    ``d_p``/``d_m`` = dt/dx of the donor cell for positive/negative flow,
    ``p1_pair_fn`` shifts the edge PAIR to the plus neighbor (under a
    tripolar fold the pair SWAPS — the ghost cell's south edge is the
    mirrored donor's north edge)."""
    L_p, R_p = p1_pair_fn(h_L, h_R)
    curv_p = (h_L + h_R) - 2.0 * h
    curv_m = p1_fn(curv_p)
    h_zero = 0.5 * (L_p + h_R)
    return (face, d_p, d_m, h_L, h_R, L_p, R_p, curv_p, curv_m, h_zero)


def _flux_eval_core(w, pre):
    """PPM flux + velocity derivative at velocity ``w`` from prepped
    invariants.  Mirrors zonal_flux_layer / zonal_flux_thickness
    (MOM_continuity_PPM.F90:922-1050): the flux thickness is the exact
    integral of the parabolic reconstruction over the CFL swept region.
    Returns (wh [m3 s-1], dwhdw [m2])."""
    (face, d_p, d_m, h_L, h_R, L_p, R_p, curv_p, curv_m, h_zero) = pre
    # donor cell is the minus cell for w>0, the plus cell for w<0
    cfl_p = w * d_p
    cfl_m = -w * d_m
    h_avg_p = h_R + cfl_p * (0.5 * (h_L - h_R) + curv_p * (cfl_p - 1.5))
    h_avg_m = L_p + cfl_m * (0.5 * (R_p - L_p) + curv_m * (cfl_m - 1.5))
    h_marg_p = h_R + cfl_p * ((h_L - h_R) + 3.0 * curv_p * (cfl_p - 1.0))
    h_marg_m = L_p + cfl_m * ((R_p - L_p) + 3.0 * curv_m * (cfl_m - 1.0))
    h_avg = jnp.where(w > 0.0, h_avg_p, jnp.where(w < 0.0, h_avg_m, h_zero))
    h_marg = jnp.where(w > 0.0, h_marg_p, jnp.where(w < 0.0, h_marg_m, h_zero))
    return face * w * h_avg, face * h_marg


def _zonal_flux_prep(h, h_W, h_E, dt, G, por=None):
    """u-independent pieces of the zonal PPM flux, hoisted out of the
    Newton flux-adjust loop (each iteration would otherwise re-roll the
    reconstruction arrays)."""
    face = G.dyCu * G.mask2dCu
    if por is not None:
        face = face * por
    idx_p = dt * G.IdxT
    idx_m = dt * ip1(G.IdxT)
    return _flux_pre_core(h, h_W, h_E, face, idx_p, idx_m, ip1,
                          lambda l, r: (ip1(l), ip1(r)))


_zonal_flux_eval = _flux_eval_core


def _zonal_flux_layer(u, h, h_W, h_E, dt, G, por=None):
    """Back-compat wrapper: prep + eval in one call."""
    return _zonal_flux_eval(u, _zonal_flux_prep(h, h_W, h_E, dt, G, por))


def _merid_flux_prep(h, h_S, h_N, dt, G, por=None, fold=False):
    """v-independent pieces of the meridional PPM flux (see
    _zonal_flux_prep)."""
    face = G.dxCv * G.mask2dCv
    if por is not None:
        face = face * por
    kh = "h" if fold else None
    idy_p = dt * G.IdyT
    idy_m = dt * jp1(G.IdyT, kh)
    return _flux_pre_core(h, h_S, h_N, face, idy_p, idy_m,
                          lambda a: jp1(a, kh),
                          lambda s, n: jp1_sn(s, n, kh))


_merid_flux_eval = _flux_eval_core


def _meridional_flux_layer(v, h, h_S, h_N, dt, G, por=None, fold=False):
    """Back-compat wrapper: prep + eval in one call."""
    return _merid_flux_eval(v, _merid_flux_prep(h, h_S, h_N, dt, G, por,
                                                fold))


def zonal_mass_flux(u, h, dt, G, *, uhbt: Optional[jnp.ndarray] = None,
                    visc_rem: Optional[jnp.ndarray] = None,
                    monotonic=False, simple_2nd=False, h_min=1e-10,
                    por=None, return_cor: bool = False):
    """Zonal thickness flux; optionally Newton-adjusted so the column sum
    matches a barotropic transport ``uhbt`` (zonal_flux_adjust,
    MOM_continuity_PPM.F90:1093 — here with a fixed iteration count).
    ``return_cor`` appends the 2-D barotropic velocity correction ``du``
    (u_adj = u + du * visc_rem; the du_cor argument of the reference's
    continuity), needed by the RK2b scheme's u_av/u_inst bookkeeping."""
    h_W, h_E = ppm_reconstruction_x(h, G.mask2dT, h_min, monotonic,
                                    simple_2nd)
    pre = _zonal_flux_prep(h, h_W, h_E, dt, G, por)
    uh, duhdu = _zonal_flux_eval(u, pre)

    def eval_at(du, rem):
        return _zonal_flux_eval(u + du * rem, pre)
    if uhbt is None:
        if return_cor:
            return uh, u, jnp.zeros(u.shape[1:], u.dtype)
        return uh, u
    rem = visc_rem if visc_rem is not None else jnp.ones_like(u)

    # physical bound on the correction: the barotropic mismatch can demand
    # unreachable velocities at faces whose layers carry almost no
    # transport capacity (all-thin columns over topography); MOM6 bounds
    # the equivalent search range (zonal_flux_adjust's du_max/du_min)
    du_cap = 0.45 / (dt * jnp.maximum(G.IdxT, 1e-30))

    # one flux+derivative evaluation per iteration (the derivative from the
    # current iterate is reused for the next update — secant-like, same
    # convergence in practice at half the cost); the reconstruction's
    # invariants are prepped/fused ONCE outside the loop
    def newton(_, carry):
        du, uh_cur, duhdu_cur = carry
        err = jnp.sum(uh_cur, axis=0) - uhbt
        denom = jnp.sum(duhdu_cur * rem, axis=0)
        du = du - err / jnp.maximum(denom, 1e-30) * G.mask2dCu
        du = jnp.clip(du, -du_cap, du_cap)
        uh_new, duhdu_new = eval_at(du, rem)
        return du, uh_new, duhdu_new

    du0 = jnp.zeros_like(uhbt)
    du, uh, _ = jax.lax.fori_loop(0, _N_NEWTON, newton, (du0, uh, duhdu))
    if return_cor:
        return uh, u + du * rem, du
    return uh, u + du * rem


def meridional_mass_flux(v, h, dt, G, *, vhbt: Optional[jnp.ndarray] = None,
                         visc_rem: Optional[jnp.ndarray] = None,
                         monotonic=False, simple_2nd=False, h_min=1e-10,
                         por=None, return_cor: bool = False):
    fold = getattr(G, "fold_north", False)
    h_S, h_N = ppm_reconstruction_y(h, G.mask2dT, h_min, monotonic,
                                    simple_2nd, fold=fold)
    pre = _merid_flux_prep(h, h_S, h_N, dt, G, por, fold)
    vh, dvhdv = _merid_flux_eval(v, pre)

    def eval_at(dv, rem):
        return _merid_flux_eval(v + dv * rem, pre)
    if vhbt is None:
        if return_cor:
            return vh, v, jnp.zeros(v.shape[1:], v.dtype)
        return vh, v
    rem = visc_rem if visc_rem is not None else jnp.ones_like(v)

    dv_cap = 0.45 / (dt * jnp.maximum(G.IdyT, 1e-30))

    def newton(_, carry):
        dv, vh_cur, dvhdv_cur = carry
        err = jnp.sum(vh_cur, axis=0) - vhbt
        denom = jnp.sum(dvhdv_cur * rem, axis=0)
        dv = dv - err / jnp.maximum(denom, 1e-30) * G.mask2dCv
        dv = jnp.clip(dv, -dv_cap, dv_cap)
        vh_new, dvhdv_new = eval_at(dv, rem)
        return dv, vh_new, dvhdv_new

    dv0 = jnp.zeros_like(vhbt)
    dv, vh, _ = jax.lax.fori_loop(0, _N_NEWTON, newton, (dv0, vh, dvhdv))
    if return_cor:
        return vh, v + dv * rem, dv
    return vh, v + dv * rem


def continuity_ppm(u, v, h, dt, G, GV, *,
                   uhbt: Optional[jnp.ndarray] = None,
                   vhbt: Optional[jnp.ndarray] = None,
                   visc_rem_u: Optional[jnp.ndarray] = None,
                   visc_rem_v: Optional[jnp.ndarray] = None,
                   monotonic=False, simple_2nd=False, x_first: bool = True,
                   por_u=None, por_v=None, return_cor: bool = False
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                              jnp.ndarray, jnp.ndarray]:
    """Directionally-split thickness update (continuity_PPM,
    MOM_continuity_PPM.F90:86).  ``x_first`` is the FIRST_DIRECTION
    parameter of the reference (adjusted by the rotation machinery so
    quarter-turned runs sweep the same physical direction first).
    Returns (h_new, uh, vh, u_adj, v_adj); with ``return_cor`` also the
    2-D barotropic corrections (du, dv) with u_adj = u + du * visc_rem
    (the du_cor/dv_cor outputs of the reference's continuity, consumed
    by the RK2b scheme's du_av_inst restart fields).
    """
    h_min = GV.angstrom
    fold = getattr(G, "fold_north", False)
    if x_first:
        uh, u_adj, du = zonal_mass_flux(u, h, dt, G, uhbt=uhbt,
                                        visc_rem=visc_rem_u,
                                        monotonic=monotonic,
                                        simple_2nd=simple_2nd, h_min=h_min,
                                        por=por_u, return_cor=True)
        h_x = jnp.maximum(h - dt * G.IareaT * (uh - im1(uh)), h_min)
        vh, v_adj, dv = meridional_mass_flux(v, h_x, dt, G, vhbt=vhbt,
                                             visc_rem=visc_rem_v,
                                             monotonic=monotonic,
                                             simple_2nd=simple_2nd,
                                             h_min=h_min,
                                             por=por_v, return_cor=True)
        h_new = jnp.maximum(
            h_x - dt * G.IareaT * (vh - jm1_s0(vh, fold)), h_min)
    else:
        vh, v_adj, dv = meridional_mass_flux(v, h, dt, G, vhbt=vhbt,
                                             visc_rem=visc_rem_v,
                                             monotonic=monotonic,
                                             simple_2nd=simple_2nd,
                                             h_min=h_min,
                                             por=por_v, return_cor=True)
        h_y = jnp.maximum(
            h - dt * G.IareaT * (vh - jm1_s0(vh, fold)), h_min)
        uh, u_adj, du = zonal_mass_flux(u, h_y, dt, G, uhbt=uhbt,
                                        visc_rem=visc_rem_u,
                                        monotonic=monotonic,
                                        simple_2nd=simple_2nd, h_min=h_min,
                                        por=por_u, return_cor=True)
        h_new = jnp.maximum(h_y - dt * G.IareaT * (uh - im1(uh)), h_min)
    if return_cor:
        return h_new, uh, vh, u_adj, v_adj, du, dv
    return h_new, uh, vh, u_adj, v_adj


class BTCont(NamedTuple):
    """Piecewise transport response curves uhbt(ubt) per face, the
    BT_cont_type of the reference (MOM_continuity_PPM.F90:set_BT_cont;
    consumed by MOM_barotropic.F90:find_uhbt :4610).

    For positive (from-the-west) flow through a u face:
      uhbt(u) = u (FA_W0 + crvW u^2)            for 0 <= u <= uBT_WW
              = (u - uBT_WW) FA_WW + uh(uBT_WW) for u > uBT_WW
    and symmetrically with the E fields for negative flow.  The curves
    are built from the SAME PPM reconstructions as the layer continuity,
    so the barotropic solver's transports saturate exactly where the
    layered transports would (donor cells draining)."""
    FA_u_W0: jnp.ndarray; FA_u_WW: jnp.ndarray
    uBT_WW: jnp.ndarray; uh_crvW: jnp.ndarray
    FA_u_E0: jnp.ndarray; FA_u_EE: jnp.ndarray
    uBT_EE: jnp.ndarray; uh_crvE: jnp.ndarray
    FA_v_S0: jnp.ndarray; FA_v_SS: jnp.ndarray
    vBT_SS: jnp.ndarray; vh_crvS: jnp.ndarray
    FA_v_N0: jnp.ndarray; FA_v_NN: jnp.ndarray
    vBT_NN: jnp.ndarray; vh_crvN: jnp.ndarray


def _curve_params(fa0, fa_mean_cap, fa_marg_cap, u_cap):
    """Cubic-through-origin fit: uh(u) = u (fa0 + crv u^2) matching the
    mean face area at the transition velocity; slope beyond is the
    marginal area there.  crv is clipped so the curve stays monotone."""
    crv = (fa_mean_cap - fa0) / jnp.maximum(u_cap * u_cap, 1e-30)
    crv = jnp.maximum(crv, -fa0 / jnp.maximum(3.0 * u_cap * u_cap, 1e-30))
    return crv, jnp.maximum(fa_marg_cap, 0.0)


def set_bt_cont(h, dt, G, GV, *, cfl_cap: float = 0.5,
                monotonic=False, simple_2nd=False) -> BTCont:
    """Build the transport response curves from the PPM reconstruction
    of ``h`` (the set_BT_cont role).  ``cfl_cap`` is the CFL at which the
    cubic hands over to the linear tail."""
    h_min = GV.angstrom
    h_W, h_E = ppm_reconstruction_x(h, G.mask2dT, h_min, monotonic,
                                    simple_2nd)
    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    h_S, h_N = ppm_reconstruction_y(h, G.mask2dT, h_min, monotonic,
                                    simple_2nd, fold=fold)
    face_u = G.dyCu * G.mask2dCu
    face_v = G.dxCv * G.mask2dCv
    c = cfl_cap

    def mean_marg(h_d, edge, other_edge, cfl):
        """PPM swept mean and marginal thickness at CFL ``cfl`` for a
        donor cell with reconstruction (other_edge .. edge), where
        ``edge`` is the downstream face value."""
        curv = (edge + other_edge) - 2.0 * h_d
        h_avg = edge + cfl * (0.5 * (other_edge - edge)
                              + curv * (cfl - 1.5))
        h_marg = edge + cfl * ((other_edge - edge)
                               + 3.0 * curv * (cfl - 1.0))
        return h_avg, h_marg

    # u faces, positive flow: donor is cell i, downstream edge h_E(i)
    fa_u_w0 = face_u[None] * h_E
    havg, hmarg = mean_marg(h, h_E, h_W, c)
    fa_u_w_mean = face_u[None] * havg
    fa_u_ww = face_u[None] * hmarg
    ubt_ww = c / (dt * G.IdxT)                    # (ny, nx) >= 0
    crv_w, fa_u_ww = _curve_params(fa_u_w0, fa_u_w_mean, fa_u_ww,
                                   ubt_ww[None])
    # u faces, negative flow: donor is cell i+1, downstream edge h_W(i+1)
    fa_u_e0 = face_u[None] * ip1(h_W)
    havg, hmarg = mean_marg(ip1(h), ip1(h_W), ip1(h_E), c)
    fa_u_e_mean = face_u[None] * havg
    fa_u_ee = face_u[None] * hmarg
    ubt_ee = -c / (dt * ip1(G.IdxT))              # <= 0
    crv_e, fa_u_ee = _curve_params(fa_u_e0, fa_u_e_mean, fa_u_ee,
                                   -ubt_ee[None])

    # v faces
    fa_v_s0 = face_v[None] * h_N
    havg, hmarg = mean_marg(h, h_N, h_S, c)
    fa_v_s_mean = face_v[None] * havg
    fa_v_ss = face_v[None] * hmarg
    vbt_ss = c / (dt * G.IdyT)
    crv_s, fa_v_ss = _curve_params(fa_v_s0, fa_v_s_mean, fa_v_ss,
                                   vbt_ss[None])
    jS, jN = jp1_sn(h_S, h_N, kh)
    fa_v_n0 = face_v[None] * jS
    havg, hmarg = mean_marg(jp1(h, kh), jS, jN, c)
    fa_v_n_mean = face_v[None] * havg
    fa_v_nn = face_v[None] * hmarg
    vbt_nn = -c / (dt * jp1(G.IdyT, kh))
    crv_n, fa_v_nn = _curve_params(fa_v_n0, fa_v_n_mean, fa_v_nn,
                                   -vbt_nn[None])

    # column sums: the barotropic curves are the layer sums
    s = lambda a: jnp.sum(a, axis=0)
    b = lambda a2: a2                             # 2-D already
    return BTCont(
        FA_u_W0=s(fa_u_w0), FA_u_WW=s(fa_u_ww), uBT_WW=b(ubt_ww),
        uh_crvW=s(crv_w),
        FA_u_E0=s(fa_u_e0), FA_u_EE=s(fa_u_ee), uBT_EE=b(ubt_ee),
        uh_crvE=s(crv_e),
        FA_v_S0=s(fa_v_s0), FA_v_SS=s(fa_v_ss), vBT_SS=b(vbt_ss),
        vh_crvS=s(crv_s),
        FA_v_N0=s(fa_v_n0), FA_v_NN=s(fa_v_nn), vBT_NN=b(vbt_nn),
        vh_crvN=s(crv_n))


def find_uhbt(u, btc: BTCont):
    """Barotropic zonal transport from the response curves
    (find_uhbt, MOM_barotropic.F90:4610)."""
    uh_ww = btc.uBT_WW * (btc.FA_u_W0 + btc.uh_crvW * btc.uBT_WW ** 2)
    uh_ee = btc.uBT_EE * (btc.FA_u_E0 + btc.uh_crvE * btc.uBT_EE ** 2)
    return jnp.where(
        u > btc.uBT_WW, (u - btc.uBT_WW) * btc.FA_u_WW + uh_ww,
        jnp.where(u >= 0.0, u * (btc.FA_u_W0 + btc.uh_crvW * u * u),
                  jnp.where(u > btc.uBT_EE,
                            u * (btc.FA_u_E0 + btc.uh_crvE * u * u),
                            (u - btc.uBT_EE) * btc.FA_u_EE + uh_ee)))


def find_vhbt(v, btc: BTCont):
    vh_ss = btc.vBT_SS * (btc.FA_v_S0 + btc.vh_crvS * btc.vBT_SS ** 2)
    vh_nn = btc.vBT_NN * (btc.FA_v_N0 + btc.vh_crvN * btc.vBT_NN ** 2)
    return jnp.where(
        v > btc.vBT_SS, (v - btc.vBT_SS) * btc.FA_v_SS + vh_ss,
        jnp.where(v >= 0.0, v * (btc.FA_v_S0 + btc.vh_crvS * v * v),
                  jnp.where(v > btc.vBT_NN,
                            v * (btc.FA_v_N0 + btc.vh_crvN * v * v),
                            (v - btc.vBT_NN) * btc.FA_v_NN + vh_nn)))
