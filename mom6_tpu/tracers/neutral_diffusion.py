"""Neutral (epineutral/Redi) tracer diffusion.

Role of MOM6's neutral diffusion (reference:
src/tracer/MOM_neutral_diffusion.F90:619 — polynomial neutral-surface
finding + flux assembly).  This implementation uses the small-slope
rotated-tensor (Redi) form with the Griffies stability split:

* explicit along-layer + cross terms:
    F_x = -K (dT/dx + S_x dT/dz)        at u faces (thickness-weighted)
    F_z = -K (S . grad_h T)             at interfaces (the cross term)
* the remaining K S^2 dT/dz vertical component is returned as an
  interface diffusivity ``kd_redi`` for the IMPLICIT vertical solve
  (tracer_vertdiff), which removes the explicit vertical CFL limit —
  the standard stable decomposition.

Slopes come from the locally-referenced EOS derivatives
(core/isopycnal_slopes.py), magnitude-clipped.  All flux-form =>
conservative; a tracer that is a function of density alone feels (to
truncation) no flux.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mom6_tpu.core.isopycnal_slopes import isopycnal_slopes
from mom6_tpu.framework.stencil import (fold_ghost, im1, ip1, jm1, jm1_s0,
                                        jp1)

__all__ = ["neutral_diffusion", "neutral_diffusion_surfaces"]

_H_EPS = 1e-3


def _interface_density(T, S, h, eos, rho0, p_ref: float):
    """Monotonicized potential density at layer interfaces (nz+1)
    referenced to ``p_ref`` — the column profile whose crossings define
    the neutral-surface positions."""
    p = jnp.full_like(T, p_ref)
    rho_c = rho0 + eos.density(T, S, p, rho_ref=rho0)
    rho_c = jax.lax.cummax(rho_c, axis=0)           # statically stable
    rho_i = 0.5 * (rho_c[:-1] + rho_c[1:])
    return jnp.concatenate([rho_c[:1], rho_i, rho_c[-1:]], axis=0)


def _position_of_density(rho_tgt, rho_i, z_i):
    """Depth in a column (interface density profile rho_i at interface
    depths z_i, both monotone in k) where the density equals rho_tgt —
    piecewise-linear inversion, vectorized over all targets at once
    (the find_neutral_surface_positions search of
    MOM_neutral_diffusion.F90, in dense branchless form).

    rho_tgt: (nt, ny, nx); rho_i/z_i: (nz+1, ny, nx)."""
    r_lo, r_hi = rho_i[:-1], rho_i[1:]              # per segment (nz)
    z_lo, z_hi = z_i[:-1], z_i[1:]
    dr = jnp.maximum(r_hi - r_lo, 1e-12)
    # fraction of each segment lying above the target density
    frac = jnp.clip((rho_tgt[:, None] - r_lo[None]) / dr[None], 0.0, 1.0)
    frac = jnp.where((r_hi - r_lo)[None] < 1e-12,
                     jnp.where(r_lo[None] < rho_tgt[:, None], 1.0, 0.0),
                     frac)
    return jnp.sum((z_hi - z_lo)[None] * frac, axis=1)   # (nt, ny, nx)


def _mean_over_spans(tr, h, z_lo, z_hi):
    """Mean of each tracer over depth spans [z_lo, z_hi) of a column
    with LIMITED-PARABOLIC sub-layer reconstruction (the reference's
    sublayer tracer averages with its parabolic polynomial option,
    MOM_neutral_diffusion NDIFF ... REMAP degree 2; PCM granularity
    leaves O(layer-jump) errors for spans interior to one layer, which
    show up as spurious along-surface fluxes).

    tr: (n_tr, nz, ny, nx); z_lo/z_hi: (ns, ny, nx)."""
    from mom6_tpu.ale.remapping import PPM_H4, reconstruct
    z_i = jnp.concatenate([jnp.zeros_like(h[:1]),
                           jnp.cumsum(h, axis=0)], axis=0)
    c0, c1, c2 = [], [], []
    for i in range(tr.shape[0]):
        a0, a1, a2, _, _ = reconstruct(tr[i], h, PPM_H4)
        c0.append(a0)
        c1.append(a1)
        c2.append(a2)
    c0 = jnp.stack(c0)
    c1 = jnp.stack(c1)                              # (n_tr, nz, ny, nx)
    c2 = jnp.stack(c2)

    def I_at(z):
        # gather-free cumulative integral at depth z (same clip-sum
        # form as ale/remapping.remap_columns_multi):
        # I(z) = sum_k h_k xi (a0 + a1 xi/2 + a2 xi^2/3) with
        # xi = clip((z - z_k)/h_k, 0, 1)
        def body(acc, xs):
            a0_k, a1_k, a2_k, h_k, z_k = xs
            xi = jnp.clip((z - z_k[None]) / jnp.maximum(h_k, _H_EPS)[None],
                          0.0, 1.0)                 # (ns, ny, nx)
            poly = a0_k[:, None] + xi[None] * (
                0.5 * a1_k[:, None] + (1.0 / 3.0) * a2_k[:, None]
                * xi[None])
            return acc + h_k[None, None] * xi[None] * poly, None
        acc0 = jnp.zeros(tr.shape[:1] + z.shape, tr.dtype)
        out, _ = jax.lax.scan(
            body, acc0,
            (jnp.moveaxis(c0, 1, 0), jnp.moveaxis(c1, 1, 0),
             jnp.moveaxis(c2, 1, 0), h, z_i[:-1]))
        return out
    span = jnp.maximum(z_hi - z_lo, 0.0)
    mean = (I_at(z_hi) - I_at(z_lo)) / jnp.maximum(span, _H_EPS)[None]
    return mean, span


def _deposit(F, z_lo, z_hi, h):
    """Distribute per-span fluxes F over the layers of a column by
    depth-overlap fractions (conservative: sum over layers == sum F).

    F: (n_tr, ns, ny, nx) on spans [z_lo, z_hi); returns
    (n_tr, nz, ny, nx)."""
    z_i = jnp.concatenate([jnp.zeros_like(h[:1]),
                           jnp.cumsum(h, axis=0)], axis=0)
    span = jnp.maximum(z_hi - z_lo, _H_EPS)

    def body(carry, args):
        f_k, zl, zh, sp = args
        # overlap of [zl, zh) with every layer [z_i[m], z_i[m+1])
        ov = jnp.maximum(
            jnp.minimum(z_i[1:], zh[None]) - jnp.maximum(z_i[:-1],
                                                         zl[None]), 0.0)
        return carry + f_k[:, None] * (ov / sp[None])[None], None

    out0 = jnp.zeros(F.shape[:1] + h.shape, F.dtype)
    out, _ = jax.lax.scan(
        body, out0,
        (jnp.moveaxis(F, 1, 0), z_lo, z_hi, span))
    return out


def neutral_diffusion_surfaces(tr, h, T, S, G, GV, eos, khtr, dt, *,
                               p_ref: float = 2e7):
    """Neutral-surface tracer diffusion by matched density positions —
    the surface-finding design of MOM_neutral_diffusion.F90 (continuous
    reconstruction): for every face, the local column's interface
    densities are located in the neighbor column by inverting its
    (monotonicized) density profile; tracers are exchanged between the
    local layer and the neighbor's matched sublayer, thickness-weighted
    by the sublayer overlap, and the received flux is deposited into the
    neighbor's layers by depth overlap — exactly conservative, and a
    tracer that is a function of density alone feels no flux by
    construction (matched sublayers have equal tracer).

    Simplification vs the reference: positions use potential density
    referenced to ``p_ref`` (sigma-2 by default) instead of the
    interface-local alpha/beta linearization, and sublayer tracer
    averages are PCM (the reference offers linear/parabolic).
    """
    rho0 = GV.rho0
    rho_i = _interface_density(T, S, h, eos, rho0, p_ref)
    z_i = jnp.concatenate([jnp.zeros_like(h[:1]),
                           jnp.cumsum(h, axis=0)], axis=0)

    def exchange(shift_p, shift_m, face_len, inv_dx, mask):
        """Flux exchange with the +1 neighbor along one axis."""
        rho_nb = shift_p(rho_i)
        z_nb = shift_p(z_i)
        h_nb = shift_p(h)
        tr_nb = shift_p(tr)
        # positions of MY interface densities in the NEIGHBOR column
        zs = _position_of_density(rho_i, rho_nb, z_nb)      # (nz+1,...)
        zs = jax.lax.cummax(zs, axis=0)
        z_lo, z_hi = zs[:-1], zs[1:]
        tr_match, span = _mean_over_spans(tr_nb, h_nb, z_lo, z_hi)
        # sublayer-thickness weight: both my layer and the matched span
        # must carry mass (harmonic mean)
        h_eff = 2.0 * h * span / (h + span + _H_EPS)
        # only the MATCHED fraction of my layer's density range has a
        # neutral connection to the neighbor: where a layer outcrops
        # beyond the neighbor's density range, the position inversion
        # clamps to the neighbor's surface/bottom and would connect
        # un-neutral water — the reference leaves such sublayer portions
        # fluxless (find_neutral_surface_positions' unmatched ends)
        num = jnp.maximum(jnp.minimum(rho_i[1:], rho_nb[-1:])
                          - jnp.maximum(rho_i[:-1], rho_nb[:1]), 0.0)
        den = jnp.maximum(rho_i[1:] - rho_i[:-1], 1e-12)
        w_match = jnp.clip(num / den, 0.0, 1.0)
        F = -khtr * (face_len * inv_dx * mask * h_eff * w_match)[None] \
            * (tr - tr_match)            # flux OUT of me, per layer
        # neighbor receives -F distributed over its layers by overlap
        recv = _deposit(-F, z_lo, z_hi, h_nb)
        recv_here = shift_m(recv)        # pulled back to my cell index
        return F, recv_here

    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None

    def jp1_fold(a):
        return jp1(a, kh)

    def jm1_fold(a):
        # pull the neighbor deposits back: interior rows from the south,
        # the fold row ALSO from its mirror partner across the fold (the
        # top row's jp1-neighbor is the x-mirrored top row); the row-0
        # wrap is a solid southern wall on a tripolar grid
        r = jm1_s0(a, fold)
        if fold:
            r = r.at[..., -1, :].add(fold_ghost(a, "h"))
        return r

    # every cell initiates an exchange with all four neighbors and each
    # face flux counts at HALF weight from each side: a one-sided
    # (east/north-initiated) exchange makes the face flux depend on
    # which column's interfaces define the sublayers, which biases the
    # scheme and breaks mirror symmetry; the two-sided average mimics
    # the reference's union-of-both-columns sublayer set
    # (find_neutral_surface_positions is symmetric in the two columns)
    fe, re_ = exchange(ip1, im1, G.dyCu, G.IdxCu, G.mask2dCu)
    fw, rw = exchange(im1, ip1, im1(G.dyCu), im1(G.IdxCu),
                      im1(G.mask2dCu))
    fn, rn = exchange(jp1_fold, jm1_fold, G.dxCv, G.IdyCv, G.mask2dCv)
    fs, rs = exchange(jm1, jp1, jm1(G.dxCv), jm1(G.IdyCv),
                      jm1_s0(G.mask2dCv, fold))
    vol = jnp.maximum(h * G.areaT, _H_EPS)
    dtr = 0.5 * dt * (((fe + re_) + (fw + rw))
                      + ((fn + rn) + (fs + rs))) / vol[None]
    tr_new = tr + dtr
    return jnp.where(G.mask2dT[None, None] > 0.5, tr_new, tr)


def _ddz_centers(f, h):
    """d(f)/dz at layer centers (z up; index down).  The z axis is -3
    (works for (nz, ny, nx) and stacked (n_tr, nz, ny, nx) arrays; ``h``
    broadcasts against ``f``)."""
    ax = -3

    def up(a):
        return jnp.concatenate(
            [jax.lax.slice_in_dim(a, 0, 1, axis=ax),
             jax.lax.slice_in_dim(a, 0, a.shape[ax] - 1, axis=ax)], axis=ax)

    def dn(a):
        return jnp.concatenate(
            [jax.lax.slice_in_dim(a, 1, a.shape[ax], axis=ax),
             jax.lax.slice_in_dim(a, a.shape[ax] - 1, a.shape[ax],
                                  axis=ax)], axis=ax)

    dz = 0.5 * (up(h) + 2.0 * h + dn(h))
    return (up(f) - dn(f)) / jnp.maximum(dz, _H_EPS)


def neutral_diffusion(tr, h, T, S, G, GV, eos, khtr, dt, *,
                      slope_max: float = 0.01, bld=None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (tr_new, kd_redi).

    ``tr``: stacked tracers (n_tr, nz, ny, nx); ``T``/``S`` set the
    neutral directions; ``khtr`` the epineutral diffusivity [m2 s-1].
    Apply ``kd_redi`` afterwards via tracer_vertdiff.

    ``bld``: optional (ny, nx) boundary-layer depth [m].  When given,
    the neutral slopes taper linearly to zero above the boundary-layer
    base (the NDIFF_INTERIOR_ONLY role of MOM_neutral_diffusion.F90:
    interior_only — the neutral framework is invalid inside the mixed
    layer, where diffusion should be horizontal, so the cross terms
    vanish there and the along-layer flux reduces to the plain
    horizontal Laplacian)."""
    fold = getattr(G, "fold_north", False)
    kh = "h" if fold else None
    sx, sy = isopycnal_slopes(h, T, S, G, GV, eos, slope_max=slope_max)
    if bld is not None:
        # zero above the boundary-layer base, ramping to full neutral
        # rotation over the next 20% of the BLD below it
        z_c = jnp.cumsum(h, axis=0) - 0.5 * h
        bldz = jnp.maximum(bld, _H_EPS)[None]
        ramp = jnp.clip((z_c - bldz) / (0.2 * bldz), 0.0, 1.0)
        sx = sx * 0.5 * (ramp + ip1(ramp))
        sy = sy * 0.5 * (ramp + jp1(ramp, kh))

    # HARMONIC-mean face thicknesses: the flux through a face must vanish
    # with the THINNER neighbor (an arithmetic mean lets a massive layer
    # drive a finite flux into a vanished one, whose tiny volume then
    # receives astronomically wrong tracer values — the reference's
    # neutral-surface fluxes likewise carry no mass through vanished
    # layers)
    h_u = (2.0 * h * ip1(h) / (h + ip1(h) + _H_EPS)) * G.mask2dCu
    h_v = (2.0 * h * jp1(h, kh) / (h + jp1(h, kh) + _H_EPS)) * G.mask2dCv
    vol = jnp.maximum(h * G.areaT, _H_EPS)

    dtr_dz = _ddz_centers(tr, h[None])                  # (n_tr, nz, ny, nx)

    # --- explicit horizontal flux with the slope cross term ---------------
    gx = (ip1(tr) - tr) * G.IdxCu
    dtdz_u = 0.5 * (dtr_dz + ip1(dtr_dz))
    fx = -khtr * (gx + sx[None] * dtdz_u) * (h_u * G.dyCu)[None] \
        * G.mask2dCu
    gy = (jp1(tr, kh) - tr) * G.IdyCv
    dtdz_v = 0.5 * (dtr_dz + jp1(dtr_dz, kh))
    fy = -khtr * (gy + sy[None] * dtdz_v) * (h_v * G.dxCv)[None] \
        * G.mask2dCv

    # --- explicit vertical cross term at interior interfaces --------------
    # S.grad_h(tr) averaged to the interface between layers k-1 and k
    gx_c = 0.5 * (gx + im1(gx))          # at centers
    gy_c = 0.5 * (gy + jm1_s0(gy, fold))
    sx_c = 0.5 * (sx + im1(sx))
    sy_c = 0.5 * (sy + jm1_s0(sy, fold))
    sdot = sx_c[None] * gx_c + sy_c[None] * gy_c       # (n_tr, nz, ...)
    sdot_int = 0.5 * (sdot[:, :-1] + sdot[:, 1:])      # interfaces 1..nz-1
    fz = -khtr * sdot_int * G.areaT[None, None] * G.mask2dT[None, None]
    # gate the cross-interface flux where either bounding layer has
    # vanished (same massless-layer guard as the horizontal faces)
    h_int_min = jnp.minimum(h[:-1], h[1:])
    fz = fz * (h_int_min / (h_int_min + _H_EPS))[None]
    zeros = jnp.zeros_like(fz[:, :1])
    fz_full = jnp.concatenate([zeros, fz, zeros], axis=1)  # (n_tr, nz+1,...)

    div = ((fx - im1(fx)) + (fy - jm1_s0(fy, fold))) \
        + (fz_full[:, :-1] - fz_full[:, 1:])
    tr_new = tr - dt * div / vol[None]
    tr_new = jnp.where(G.mask2dT[None, None] > 0.5, tr_new, tr)

    # --- implicit K S^2 vertical diffusivity ------------------------------
    s2_c = sx_c ** 2 + sy_c ** 2
    s2_int = 0.5 * (s2_c[:-1] + s2_c[1:])
    kd_redi = jnp.concatenate([jnp.zeros_like(h[:1]),
                               khtr * s2_int,
                               jnp.zeros_like(h[:1])], axis=0) \
        * G.mask2dT[None]
    return tr_new, kd_redi