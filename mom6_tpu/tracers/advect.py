"""Monotone directionally-split tracer advection.

Re-design of MOM6's tracer advection (reference:
src/tracer/MOM_tracer_advect.F90: advect_tracer :53, advect_x :355,
advect_y :748; schemes in MOM_tracer_advect_schemes.F90).

Differences from the Fortran:
* tracers are advected as one stacked (n_tracer, nz, ny, nx) array — one
  reconstruction per sweep is shared by every tracer... each tracer needs
  its own reconstruction, but the *flux machinery, masks and thickness
  updates* are shared and the tracer axis is a pure batch dimension;
* instead of the data-dependent ``domore`` sweep loop that iterates until
  the stored transports are exhausted, the transports are split into
  ``n_sub`` equal sub-sweeps with a static count chosen from the advective
  CFL bound (jit-friendly; same monotonicity guarantees);
* schemes: monotone flux-limited PLM and PPM:H3 (3rd-order edge estimates
  with CW84 monotonization, the reference's default) — the flux is the
  exact integral of the reconstruction over the CFL wedge.

Mass consistency: thickness is updated alongside the tracers with the same
transports, so a uniform tracer stays exactly uniform.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mom6_tpu.framework.stencil import (im1, ip1, jm1, jm1_s0, jp1,
                                        jp1_sn)

__all__ = ["advect_tracers", "PLM", "PPM_H3"]

_H_MIN = 1e-10
PLM = "PLM"
PPM_H3 = "PPM:H3"


def _plm_edge_x(T, mask):
    """Limited PLM east/west edge values for an x sweep (batch dims lead)."""
    Tm, Tp = im1(T), ip1(T)
    mm, mp = im1(mask), ip1(mask)
    Tm = mm * Tm + (1.0 - mm) * T
    Tp = mp * Tp + (1.0 - mp) * T
    slp = 0.5 * (Tp - Tm)
    d_p, d_m = Tp - T, T - Tm
    lim = 2.0 * jnp.minimum(jnp.abs(d_p), jnp.abs(d_m))
    slp = jnp.where(d_p * d_m > 0.0,
                    jnp.sign(slp) * jnp.minimum(jnp.abs(slp), lim), 0.0)
    return T - 0.5 * slp, T + 0.5 * slp      # (T_W, T_E)


def _ppmh3_edges(T, mask, shift_m, shift_p):
    """PPM:H3 edge values (3rd-order 3-point estimates, CW84-limited) —
    the reference's default tracer reconstruction
    (MOM_tracer_advect_schemes.F90).  Returns (T_left, T_right) edges in
    the sweep direction."""
    Tm = shift_m(T)
    Tp = shift_p(T)
    mm, mp = shift_m(mask), shift_p(mask)
    Tm = mm * Tm + (1.0 - mm) * T
    Tp = mp * Tp + (1.0 - mp) * T
    one6 = 1.0 / 6.0
    aL = one6 * (5.0 * T + 2.0 * Tm - Tp)
    aR = one6 * (5.0 * T + 2.0 * Tp - Tm)
    # bound by neighbors then monotonize (CW84)
    aL = jnp.clip(aL, jnp.minimum(Tm, T), jnp.maximum(Tm, T))
    aR = jnp.clip(aR, jnp.minimum(Tp, T), jnp.maximum(Tp, T))
    not_mono = (aR - T) * (T - aL) <= 0.0
    diff = aR - aL
    fac = 6.0 * diff * (T - 0.5 * (aR + aL))
    d2 = diff * diff
    aL2 = jnp.where(fac > d2, 3.0 * T - 2.0 * aR, aL)
    aR2 = jnp.where(fac < -d2, 3.0 * T - 2.0 * aL, aR)
    aL2 = jnp.where(not_mono, T, aL2)
    aR2 = jnp.where(not_mono, T, aR2)
    return aL2, aR2


def _plm_edge_y(T, mask, fold=None):
    Tm, Tp = jm1(T), jp1(T, fold)
    mm, mp = jm1(mask), jp1(mask, fold)
    Tm = mm * Tm + (1.0 - mm) * T
    Tp = mp * Tp + (1.0 - mp) * T
    slp = 0.5 * (Tp - Tm)
    d_p, d_m = Tp - T, T - Tm
    lim = 2.0 * jnp.minimum(jnp.abs(d_p), jnp.abs(d_m))
    slp = jnp.where(d_p * d_m > 0.0,
                    jnp.sign(slp) * jnp.minimum(jnp.abs(slp), lim), 0.0)
    return T - 0.5 * slp, T + 0.5 * slp      # (T_S, T_N)


def _limit_outflow_x(uh, vol):
    """Scale face transports by the donor cell's availability so no cell is
    evacuated below 10% of its volume in one sweep (the positivity role of
    the reference's domore iteration, with static control flow).  Critical
    for vanished layers over topography."""
    outflow = jnp.maximum(uh, 0.0) + jnp.maximum(-im1(uh), 0.0)
    r = jnp.minimum(1.0, 0.9 * vol / jnp.maximum(outflow, _H_MIN))
    r_donor = jnp.where(uh > 0.0, r, ip1(r))
    return uh * r_donor


def _limit_outflow_y(vh, vol, fold=None):
    outflow = jnp.maximum(vh, 0.0) + jnp.maximum(-jm1_s0(vh, fold), 0.0)
    r = jnp.minimum(1.0, 0.9 * vol / jnp.maximum(outflow, _H_MIN))
    r_donor = jnp.where(vh > 0.0, r, jp1(r, fold))
    return vh * r_donor


def _sweep_x(T, h, uh, G, scheme=PLM):
    """One x sweep moving volume ``uh`` [m3] with upwind reconstructed
    tracer edges (PLM or PPM:H3).

    ``T``: (n_tr, nz, ny, nx); ``h``: (nz, ny, nx) volume-consistent
    thickness; ``uh`` thickness transport for this sweep [m3]."""
    mask = G.mask2dT
    if scheme == PPM_H3:
        T_W, T_E = _ppmh3_edges(T, mask, im1, ip1)
    else:
        T_W, T_E = _plm_edge_x(T, mask)
    # CFL fraction of the donor cell swept out
    vol = h * G.areaT
    uh = _limit_outflow_x(uh, vol)
    cfl_p = uh / jnp.maximum(vol, _H_MIN)          # u > 0, donor i
    cfl_m = -uh / jnp.maximum(ip1(vol), _H_MIN)    # u < 0, donor i+1
    # mean tracer of the swept region: exact integral of the parabola over
    # the CFL wedge (curv = 0 reduces to the PLM mean)
    curv = (T_W + T_E) - 2.0 * T
    T_up_p = T_E + cfl_p[None] * (0.5 * (T_W - T_E)
                                  + curv * (cfl_p[None] - 1.5))
    cm = cfl_m[None]
    T_up_m = ip1(T_W) + cm * (0.5 * (ip1(T_E) - ip1(T_W))
                              + ip1(curv) * (cm - 1.5))
    T_face = jnp.where(uh[None] > 0.0, T_up_p,
                       jnp.where(uh[None] < 0.0, T_up_m,
                                 0.5 * (T_E + ip1(T_W))))
    flux = uh[None] * T_face                        # [m3 * conc]
    h_new = h - (uh - im1(uh)) * G.IareaT
    h_new = jnp.maximum(h_new, _H_MIN)
    T_new = (T * vol[None] - (flux - im1(flux))) / jnp.maximum(
        h_new * G.areaT, _H_MIN)[None]
    return jnp.where(mask[None, None] > 0.5, T_new, T), h_new


def _sweep_y(T, h, vh, G, scheme=PLM):
    mask = G.mask2dT
    kh = "h" if getattr(G, "fold_north", False) else None
    if scheme == PPM_H3:
        T_S, T_N = _ppmh3_edges(T, mask, jm1, lambda a: jp1(a, kh))
    else:
        T_S, T_N = _plm_edge_y(T, mask, fold=kh)
    vol = h * G.areaT
    vh = _limit_outflow_y(vh, vol, fold=kh)
    cfl_p = vh / jnp.maximum(vol, _H_MIN)
    cfl_m = -vh / jnp.maximum(jp1(vol, kh), _H_MIN)
    curv = (T_S + T_N) - 2.0 * T
    T_up_p = T_N + cfl_p[None] * (0.5 * (T_S - T_N)
                                  + curv * (cfl_p[None] - 1.5))
    cm = cfl_m[None]
    # across the fold the ghost donor's S/N edges swap
    jS, jN = jp1_sn(T_S, T_N, kh)
    T_up_m = jS + cm * (0.5 * (jN - jS) + jp1(curv, kh) * (cm - 1.5))
    T_face = jnp.where(vh[None] > 0.0, T_up_p,
                       jnp.where(vh[None] < 0.0, T_up_m,
                                 0.5 * (T_N + jS)))
    flux = vh[None] * T_face
    h_new = h - (vh - jm1_s0(vh, kh)) * G.IareaT
    h_new = jnp.maximum(h_new, _H_MIN)
    T_new = (T * vol[None] - (flux - jm1_s0(flux, kh))) / jnp.maximum(
        h_new * G.areaT, _H_MIN)[None]
    return jnp.where(mask[None, None] > 0.5, T_new, T), h_new


def advect_tracers(T, h_prev, uhtr, vhtr, G, *, n_sub: int = 2,
                   scheme: str = PPM_H3
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Advect stacked tracers with accumulated transports.

    ``T``: (n_tr, nz, ny, nx) concentrations; ``h_prev``: thicknesses
    *before* the transports were applied; ``uhtr``/``vhtr``: accumulated
    volume transports [m3] (uh*dt sums from continuity).  The transports
    are applied in ``n_sub`` alternating x/y sub-sweeps (static count —
    pick n_sub so each sub-sweep's CFL < 1, cf. the reference's dynamic
    ``domore`` iteration).  Returns (T_new, h_after)."""
    uh_s = uhtr / n_sub
    vh_s = vhtr / n_sub
    h = h_prev

    def body(carry, xy_first):
        T, h = carry

        def xy(ops):
            T, h = ops
            T, h = _sweep_x(T, h, uh_s, G, scheme)
            T, h = _sweep_y(T, h, vh_s, G, scheme)
            return T, h

        def yx(ops):
            T, h = ops
            T, h = _sweep_y(T, h, vh_s, G, scheme)
            T, h = _sweep_x(T, h, uh_s, G, scheme)
            return T, h

        T, h = jax.lax.cond(xy_first, xy, yx, (T, h))
        return (T, h), None

    order = jnp.arange(2 * n_sub) % 2
    (T, h), _ = jax.lax.scan(body, (T, h), order[:n_sub])
    return T, h
