"""Kraus-Turner bulk mixed layer for layered (isopycnal) mode.

Re-design of MOM6's refined bulk mixed layer (reference:
src/parameterizations/vertical/MOM_bulk_mixed_layer.F90: bulkmixedlayer
:168, convective_adjustment :846, find_starting_TKE :1435,
mechanical_entrainment :1646, mixedlayer_detrain_2 :2456; physics per
Niiler & Kraus 1977 / Oberhuber 1993 / Hallberg 2003).

The reference sweeps each column with data-dependent loops (sorted layer
order, running totals, early exits).  Here the same energy budget runs as
ONE ``lax.scan`` over the nz layers with the whole (ny, nx) plane
processed per step — the scan carry holds the running mixed-layer totals
(mass, heat, salt, density, remaining TKE), and partial entrainment of
the terminal layer falls out of a clipped fraction instead of a loop
break:

1.  surface forcing: TKE_mech = mstar * u*^3 * dt; surface buoyancy loss
    drives free convection.
2.  scan downward over layers: an unstable layer (R0 < mixture density)
    is entrained for free and releases potential energy (a fraction
    ``bulk_ri_conv`` of which becomes TKE); a stable layer costs
    dPE = (g/2 rho0) dR0 * htot * dh, paid from the decaying TKE stock
    (exponential decay with e-folding htot * TKE_decay / u*).
3.  the entrained region is homogenised in T/S; non-entrained remnants
    of the old mixed/buffer layers are detrained into the interior
    isopycnal layer whose coordinate-density bracket matches
    (mixedlayer_detrain_2 role), splitting mass between the two
    bracketing layers to conserve both mass and density.

Layer roles follow the reference: layers [0, nkml) are mixed-layer
sublayers, [nkml, nkml+nkbl) are buffer layers, the rest are isopycnal
interior layers with targets ``GV.Rlay``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["BulkMLParams", "bulkmixedlayer"]

_H_EPS = 1e-3


class BulkMLParams(NamedTuple):
    nkml: int = 2               # mixed-layer sublayers (NKML)
    nkbl: int = 2               # buffer layers (NKBL)
    mstar: float = 1.2          # wind-work efficiency (MSTAR)
    bulk_ri_ml: float = 0.8     # efficiency of TKE for entrainment (BULK_RI_ML)
    bulk_ri_conv: float = 0.8   # convective PE -> TKE efficiency
    tke_decay: float = 2.5      # TKE decay per u*/f-ish depth (TKE_DECAY)
    hmix_min: float = 2.0       # minimum mixed layer depth [m] (HMIX_MIN)
    g_accel: float = 9.8


def _scan_entrain(h, r0, T, S, tke0, p: BulkMLParams, g_over_rho0):
    """Downward scan: returns entrained fraction per layer and the final
    ML totals.  tke0: TKE stock available for entrainment [m3 s-2].
    The carry seeds with layer 0 fully entrained (the reference starts
    htot from the topmost layer, MOM_bulk_mixed_layer.F90:1217)."""
    plane = h.shape[1:]
    dtype = h.dtype

    def body(carry, xs):
        htot, ttot, stot, r0tot, tke = carry
        hk, r0k, tk, sk = xs
        rbar = r0tot / jnp.maximum(htot, _H_EPS)
        dr0 = r0k - rbar
        # free convection: unstable layers join for free + release PE
        unstable = dr0 <= 0.0
        # PE released homogenizing two slabs (upper denser):
        # dPE = (g/2rho0) |dR0| htot hk
        pe_rel = (0.5 * g_over_rho0) * jnp.maximum(-dr0, 0.0) * htot * hk
        # energy cost to entrain dh of a stable layer below htot
        # (mechanical_entrainment, MOM_bulk_mixed_layer.F90:1850-1950)
        cost_full = (0.5 * g_over_rho0) * jnp.maximum(dr0, 0.0) * (
            htot * hk)
        # TKE decays over the depth already mixed
        idecay = p.tke_decay / jnp.maximum(
            htot, jnp.maximum(p.hmix_min, _H_EPS))
        frac_mech = jnp.where(cost_full > 0.0,
                              jnp.clip(p.bulk_ri_ml * tke
                                       / jnp.maximum(cost_full, 1e-30),
                                       0.0, 1.0),
                              1.0)
        frac = jnp.where(unstable, 1.0, frac_mech)
        dh = frac * hk
        spent = jnp.where(unstable, 0.0, frac * cost_full / p.bulk_ri_ml)
        tke_new = (tke + p.bulk_ri_conv * pe_rel - spent) * jnp.exp(
            -idecay * dh)
        tke_new = jnp.maximum(tke_new, 0.0)
        carry = (htot + dh, ttot + dh * tk, stot + dh * sk,
                 r0tot + dh * r0k, tke_new)
        return carry, frac

    carry0 = (h[0], h[0] * T[0], h[0] * S[0], h[0] * r0[0], tke0)
    xs = (h[1:], r0[1:], T[1:], S[1:])
    (htot, ttot, stot, r0tot, _), frac = jax.lax.scan(body, carry0, xs)
    frac = jnp.concatenate([jnp.ones((1,) + plane, dtype), frac], axis=0)
    return frac, htot, ttot, stot, r0tot


def _detrain_to_interior(h_left, rcv_left, rcv_targets):
    """Move remnant mixed/buffer water (h_left per layer, coordinate
    density rcv_left) into the interior layers whose targets bracket it,
    split to conserve mass and density (mixedlayer_detrain_2 role).

    Returns (nz_tgt, ny, nx) mass added per interior target layer for
    EACH source layer summed."""
    # rcv_targets: (nt,) increasing
    nt = rcv_targets.shape[0]
    r = jnp.clip(rcv_left, rcv_targets[0], rcv_targets[-1])
    # index of the upper bracket via comparison sum
    idx = jnp.sum((r[None] >= rcv_targets[:, None, None, None]).astype(
        jnp.int32), axis=0) - 1                       # (nsrc, ny, nx)
    idx = jnp.clip(idx, 0, nt - 2)
    r_lo = rcv_targets[idx]
    r_hi = rcv_targets[idx + 1]
    w_hi = jnp.where(r_hi > r_lo, (r - r_lo) / jnp.maximum(r_hi - r_lo,
                                                           1e-12), 0.0)
    w_lo = 1.0 - w_hi
    add = jnp.zeros((nt,) + h_left.shape[1:], h_left.dtype)
    onehot = jax.nn.one_hot(idx, nt, axis=0, dtype=h_left.dtype)
    add = add + jnp.sum(onehot * (w_lo * h_left)[None], axis=1)
    onehot_hi = jax.nn.one_hot(idx + 1, nt, axis=0, dtype=h_left.dtype)
    add = add + jnp.sum(onehot_hi * (w_hi * h_left)[None], axis=1)
    return add


def bulkmixedlayer(h, u, v, T, S, G, GV, eos, dt, ustar,
                   buoy_flux, p: BulkMLParams):
    """One bulk-mixed-layer step.

    ustar: (ny, nx) friction velocity [m s-1];
    buoy_flux: (ny, nx) surface buoyancy flux [m2 s-3], positive =
    buoyancy LOSS (destabilising, e.g. cooling).

    Returns (h_new, T_new, S_new, h_ml) with mass, heat and salt
    conserved per column (tested)."""
    dtype = h.dtype
    nkml, nkbl = p.nkml, p.nkbl
    nkf = nkml + nkbl            # first interior layer
    g_over_rho0 = p.g_accel / GV.rho0
    p_sfc = jnp.zeros((), dtype)
    r0 = eos.density(T, S, p_sfc)          # surface-referenced density

    # --- TKE sources (find_starting_TKE role) ----------------------------
    tke_mech = p.mstar * ustar ** 3 * dt
    # destabilising buoyancy flux does work ~ 0.5*B*h_ml*dt; fold it in as
    # convective credit released near the surface by letting convection in
    # the scan handle layer-by-layer instability, plus the direct surface
    # term over the minimum ML depth
    tke_conv = 0.5 * jnp.maximum(buoy_flux, 0.0) * p.hmix_min * dt
    tke0 = (tke_mech + p.bulk_ri_conv * tke_conv).astype(dtype)

    frac, htot, ttot, stot, _ = _scan_entrain(
        h, r0, T, S, tke0, p, g_over_rho0)

    hml = htot
    t_ml = ttot / jnp.maximum(htot, _H_EPS)
    s_ml = stot / jnp.maximum(htot, _H_EPS)

    # --- rebuild the column ----------------------------------------------
    # remnants: non-entrained parts of every layer keep their properties
    h_rem = (1.0 - frac) * h
    # remnants of the old ML/buffer layers are detrained into interior
    # targets; remnants of interior layers just stay
    rcv = eos.density(T, S, jnp.asarray(2e7, dtype))   # coordinate density
    h_left = h_rem[:nkf]
    rcv_left = rcv[:nkf]
    targets = jnp.asarray(GV.Rlay, dtype)[nkf:]
    add_int = _detrain_to_interior(h_left, rcv_left, targets)
    # heat/salt carried with the detrained mass
    t_add = _detrain_to_interior(h_left * T[:nkf], rcv_left, targets)
    s_add = _detrain_to_interior(h_left * S[:nkf], rcv_left, targets)

    h_int_old = h_rem[nkf:]
    hT_int = h_int_old * T[nkf:] + t_add
    hS_int = h_int_old * S[nkf:] + s_add
    h_int = h_int_old + add_int
    t_int = hT_int / jnp.maximum(h_int, _H_EPS)
    s_int = hS_int / jnp.maximum(h_int, _H_EPS)
    # keep original properties where essentially massless
    keep = h_int > 2.0 * _H_EPS
    t_int = jnp.where(keep, t_int, T[nkf:])
    s_int = jnp.where(keep, s_int, S[nkf:])

    # ML mass spread evenly over the nkml sublayers; buffer layers get the
    # Angstrom remnant
    ang = jnp.asarray(GV.angstrom, dtype)
    h_ml_sub = jnp.maximum(hml / nkml, ang)[None] * jnp.ones(
        (nkml,) + h.shape[1:], dtype)
    h_buf = jnp.full((nkbl,) + h.shape[1:], ang, dtype)
    h_new = jnp.concatenate([h_ml_sub, h_buf, h_int], axis=0)
    T_new = jnp.concatenate([jnp.broadcast_to(t_ml, (nkml,) + h.shape[1:]),
                             jnp.broadcast_to(t_ml, (nkbl,) + h.shape[1:]),
                             t_int], axis=0)
    S_new = jnp.concatenate([jnp.broadcast_to(s_ml, (nkml,) + h.shape[1:]),
                             jnp.broadcast_to(s_ml, (nkbl,) + h.shape[1:]),
                             s_int], axis=0)

    # restore exact column mass (the Angstrom floors add tiny mass; remove
    # it proportionally from the ML sublayers)
    dm = jnp.sum(h_new, axis=0) - jnp.sum(h, axis=0)
    h_new = h_new.at[:nkml].add(-(dm / nkml)[None])
    h_new = jnp.maximum(h_new, 0.5 * ang)

    mask = G.mask2dT[None]
    h_new = jnp.where(mask > 0.5, h_new, h)
    T_new = jnp.where(mask > 0.5, T_new, T)
    S_new = jnp.where(mask > 0.5, S_new, S)
    return h_new, T_new, S_new, hml * G.mask2dT
