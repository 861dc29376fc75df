"""Conservative 1-D vertical remapping.

Re-design of MOM6's remapping core for whole-array evaluation (reference:
src/ALE/MOM_remapping.F90: remapping_core_h :83-86; schemes :107) and the
reconstruction library (src/ALE/PLM_functions.F90, PPM_functions.F90,
regrid_edge_values.F90).

Algorithm (vectorized over whole (nz, ny, nx) columns, no per-cell loops):

1. reconstruct a piecewise polynomial u_k(xi) in every source cell
   (PCM constant / PLM limited linear / PPM_H4 limited parabola);
2. evaluate the cumulative integral of the reconstruction at every
   target interface as a GATHER-FREE sum over source cells (each cell's
   antiderivative clipped at its own boundaries; see
   remap_columns_multi);
3. difference and divide by target thicknesses.

This is exactly conservative by construction: the integral over the whole
column is I(bottom) for any target grid.  Total source and target column
thicknesses must agree (regridding guarantees this).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["remap_column", "remap_columns_multi", "reconstruct", "PCM",
           "PLM", "PPM_H4", "PPM_IH4", "PPM_H6", "P3M_H4", "PQM_IH4IH3"]

PCM = "PCM"
PLM = "PLM"
PPM_H4 = "PPM_H4"
PPM_IH4 = "PPM_IH4"      # implicit (compact) 4th-order edges, non-uniform
PPM_H6 = "PPM_H6"        # 6th-order explicit edges (uniform weights)
P3M_H4 = "P3M_H4"        # monotone cubic interpolant (interpolation use)
PQM_IH4IH3 = "PQM_IH4IH3"

_EPS = 1e-30


def _plm_slopes(u, h):
    """Monotonic-limited non-uniform PLM slopes (du across the cell)."""
    # neighbor padding: replicate end cells (zero-gradient boundaries)
    u_m = jnp.concatenate([u[:1], u[:-1]], axis=0)
    u_p = jnp.concatenate([u[1:], u[-1:]], axis=0)
    h_m = jnp.concatenate([h[:1], h[:-1]], axis=0)
    h_p = jnp.concatenate([h[1:], h[-1:]], axis=0)
    # centered slope estimate per unit cell (non-uniform weights): the
    # distance between neighbor centers is (h_m + 2h + h_p)/2
    denom = h_m + 2.0 * h + h_p
    slp = 2.0 * h * (u_p - u_m) / jnp.maximum(denom, _EPS)
    # limit: no new extrema (cf. PLM_functions.F90 slope limiting)
    d_p = u_p - u
    d_m = u - u_m
    max_slp = 2.0 * jnp.minimum(jnp.abs(d_p), jnp.abs(d_m))
    slp = jnp.where(d_p * d_m > 0.0,
                    jnp.sign(slp) * jnp.minimum(jnp.abs(slp), max_slp), 0.0)
    return slp


def _edge_values_h4(u, h):
    """4th-order edge value estimates at interior interfaces, 2nd-order at
    the boundaries (explicit scheme in the spirit of
    regrid_edge_values.F90 edge_values_explicit_h4; uniform-grid weights
    applied per-interface — non-uniform weights land with the parity pass).

    Returns (e_top, e_bot): the interface value above/below each cell."""
    nz = u.shape[0]
    u_m2 = jnp.concatenate([u[:1], u[:1], u[:-2]], axis=0) if nz >= 2 else u
    u_m1 = jnp.concatenate([u[:1], u[:-1]], axis=0)
    u_p1 = jnp.concatenate([u[1:], u[-1:]], axis=0)
    # interface k (top of cell k): 7/12(u_{k-1}+u_k) - 1/12(u_{k-2}+u_{k+1})
    e_top = (7.0 / 12.0) * (u_m1 + u) - (1.0 / 12.0) * (u_m2 + u_p1)
    # boundary interfaces: simple averages / extrapolation
    e_top = e_top.at[0].set(u[0] + 0.5 * (u[0] - u_m1[0]))  # == u[0]
    if nz >= 2:
        # the first/last interior interfaces only have 3 usable neighbors:
        # use the 2nd-order mean (exact for linear profiles)
        e_top = e_top.at[1].set(0.5 * (u[0] + u[1]))
        e_top = e_top.at[nz - 1].set(0.5 * (u[nz - 2] + u[nz - 1]))
    e_bot = jnp.concatenate([e_top[1:], u[-1:]], axis=0)
    e_bot = e_bot.at[-1].set(u[-1])
    return e_top, e_bot


def _edge_values_implicit_h4(u, h):
    """Implicit (compact) 4th-order edge values on NON-UNIFORM grids:
    the tridiagonal system  alpha_i e_{i-1} + e_i + beta_i e_{i+1} = rhs_i
    of regrid_edge_values.F90 edge_values_implicit_h4 (post-2019
    coefficients): at the interface between cells of widths h0, h1,

      alpha = h1^2/(h0+h1)^2,  beta = h0^2/(h0+h1)^2,
      rhs = a*u0 + b*u1,  a = 2 alpha (alpha + 2 beta + 3 ab),
                          b = 2 beta (beta + 2 alpha + 3 ab).

    Solved as one batched tridiagonal over the column (interfaces 0..nz
    with Dirichlet cell-mean boundaries).  Returns (e_top, e_bot)."""
    from mom6_tpu.framework.solvers import tridiag_solve
    nz = u.shape[0]
    # floor each layer of the pair to 1% of the pair sum: alpha + beta
    # <= (h0^2+h1^2)/(h0+h1)^2 -> 1 as either layer vanishes, and at 1
    # the Thomas pivot of the tridiagonal hits zero for alternating
    # thin/thick columns (f32 has no headroom); the floor keeps the
    # system strictly diagonally dominant, and vanished layers' edge
    # values are limiter-clipped downstream anyway
    pair = h[:-1] + h[1:] + 1e-30
    h0 = jnp.maximum(h[:-1], 0.01 * pair)
    h1 = jnp.maximum(h[1:], 0.01 * pair)
    i_h2 = 1.0 / (h0 + h1) ** 2
    alpha = h1 * h1 * i_h2
    beta = h0 * h0 * i_h2
    abmix = h0 * h1 * i_h2
    a = 2.0 * alpha * (alpha + 2.0 * beta + 3.0 * abmix)
    b = 2.0 * beta * (beta + 2.0 * alpha + 3.0 * abmix)
    z1 = jnp.zeros_like(u[:1])
    # interfaces 0..nz: rows 1..nz-1 are the compact relations; rows 0
    # and nz pin the boundary edges to a cubic fitted through the 4
    # boundary-adjacent cell averages (the reference's 4x4 Asys solve)
    lo = jnp.concatenate([z1, alpha, z1], axis=0)       # sub-diagonal
    up = jnp.concatenate([z1, beta, z1], axis=0)        # super-diagonal
    di = jnp.ones_like(lo)
    nfit = min(4, nz)
    e_sfc = _boundary_fit(u[:nfit], h[:nfit])
    e_bot = _boundary_fit(u[::-1][:nfit], h[::-1][:nfit])
    rhs = jnp.concatenate([e_sfc[None], a * u[:-1] + b * u[1:],
                           e_bot[None]], axis=0)
    e = tridiag_solve(lo, di, up, rhs)
    return e[:-1], e[1:]


def _boundary_fit(u, h):
    """Value at the outer boundary of a cubic (or lower-degree) polynomial
    whose averages over the ``u.shape[0]`` cells nearest the boundary
    match u (regrid_edge_values.F90's boundary Asys/Bsys solve).  The
    cells are ordered outward-first; returns the value at z=0.

    Conditioning: the Vandermonde-style system is solved in z NORMALIZED
    by the stack depth (raw meters put z^4 ~ 1e12 beyond f32), with
    vanished layers floored to a small fraction of the stack (the
    reference's hNeglect role) so rows stay linearly independent, and a
    cell-mean fallback wherever the solve still degenerates — boundary
    edges are limiter-clipped downstream, so the fallback only costs
    local order."""
    n = u.shape[0]
    total = jnp.sum(h, axis=0, keepdims=True) + 1e-30
    hn = jnp.maximum(h, (1e-3 / n) * total) / total     # normalized, >0
    zi = jnp.concatenate([jnp.zeros_like(hn[:1]),
                          jnp.cumsum(hn, axis=0)], axis=0)
    # constraint rows: mean of z^m over cell j = (z_{j+1}^{m+1} -
    # z_j^{m+1}) / ((m+1) h_j); value at the boundary is coeff of z^0
    rows = []
    for m in range(n):
        rows.append((zi[1:] ** (m + 1) - zi[:-1] ** (m + 1))
                    / ((m + 1) * hn))
    A = jnp.stack(rows, axis=-1)          # (n_cells, ..., n_coeff)
    A = jnp.moveaxis(A, 0, -2)            # (..., n_cells, n_coeff)
    b = jnp.moveaxis(u, 0, -1)[..., None]  # (..., n_cells, 1)
    coef = jnp.linalg.solve(A, b)[..., 0, 0]   # P(0) = c0
    return jnp.where(jnp.isfinite(coef), coef, u[0])


def _edge_values_h6(u, h):
    """6th-order explicit edge values with uniform-grid weights
    (37, -8, 1)/60 (the uniform limit of edge_values_implicit_h6,
    regrid_edge_values.F90:1223; the full non-uniform pentadiagonal
    scheme is approximated here by its uniform-spacing weights, falling
    back to h4 near the boundaries)."""
    nz = u.shape[0]
    if nz < 6:
        return _edge_values_h4(u, h)

    def sh(k):
        """u shifted k cells toward the surface (edge-replicated)."""
        if k > 0:
            return jnp.concatenate([jnp.repeat(u[:1], k, axis=0),
                                    u[:-k]], axis=0)
        if k < 0:
            return jnp.concatenate([u[-k:],
                                    jnp.repeat(u[-1:], -k, axis=0)], axis=0)
        return u
    c1, c2, c3 = 37.0 / 60.0, -8.0 / 60.0, 1.0 / 60.0
    # interface k (top of cell k): stencil u[k-3..k+2]
    e_top = (c1 * (sh(1) + u) + c2 * (sh(2) + sh(-1))
             + c3 * (sh(3) + sh(-2)))
    e4_t, e4_b = _edge_values_h4(u, h)
    # fall back to the h4 estimates within 3 cells of either boundary
    k = jnp.arange(nz).reshape((nz,) + (1,) * (u.ndim - 1))
    interior = (k >= 3) & (k <= nz - 3)
    e_top = jnp.where(interior, e_top, e4_t)
    e_bot = jnp.concatenate([e_top[1:], e4_b[-1:]], axis=0)
    return e_top, e_bot


def _ppm_limit(u, e_l, e_r):
    """Colella & Woodward monotonizing limiter (same math as the continuity
    PPM limiter; see MOM_continuity_PPM.F90:2620 and PPM_functions.F90)."""
    e_l = jnp.clip(e_l, jnp.minimum(jnp.concatenate([u[:1], u[:-1]], 0), u),
                   jnp.maximum(jnp.concatenate([u[:1], u[:-1]], 0), u))
    e_r = jnp.clip(e_r, jnp.minimum(jnp.concatenate([u[1:], u[-1:]], 0), u),
                   jnp.maximum(jnp.concatenate([u[1:], u[-1:]], 0), u))
    not_mono = (e_r - u) * (u - e_l) <= 0.0
    diff = e_r - e_l
    mean = 0.5 * (e_r + e_l)
    fac = 6.0 * diff * (u - mean)
    diff2 = diff * diff
    e_l2 = jnp.where(fac > diff2, 3.0 * u - 2.0 * e_r, e_l)
    e_r2 = jnp.where(fac < -diff2, 3.0 * u - 2.0 * e_l, e_r)
    e_l2 = jnp.where(not_mono, u, e_l2)
    e_r2 = jnp.where(not_mono, u, e_r2)
    return e_l2, e_r2


def _edge_slopes(u, h):
    """Interface slopes du/dz estimated from adjacent cell means
    (the h3 edge-slope role of regrid_edge_slopes.F90, at 2nd order).
    Returns (s_top, s_bot): slope at the top/bottom interface of each
    cell, in physical units [u m-1]."""
    du = u[1:] - u[:-1]
    dz = jnp.maximum(0.5 * (h[:-1] + h[1:]), _EPS)
    s_int = du / dz                              # interior interfaces
    zeros = jnp.zeros_like(u[:1])
    s_top = jnp.concatenate([zeros, s_int], axis=0)
    s_bot = jnp.concatenate([s_int, zeros], axis=0)
    return s_top, s_bot


def _pqm_coeffs(u, h, e_l, e_r, s_l, s_r):
    """White & Adcroft (2008) quartic through (eL, sL) .. (eR, sR) with
    the prescribed cell mean; sigma are slopes in xi units (s * h)."""
    sl = s_l * h
    sr = s_r * h
    r1 = u - e_l - 0.5 * sl
    r2 = e_r - e_l - sl
    r3 = sr - sl
    a0 = e_l
    a1 = sl
    a2 = 30.0 * r1 - 12.0 * r2 + 1.5 * r3
    a3 = -60.0 * r1 + 28.0 * r2 - 4.0 * r3
    a4 = 30.0 * r1 - 15.0 * r2 + 2.5 * r3
    return a0, a1, a2, a3, a4


def reconstruct(u, h, scheme: str):
    """Per-cell polynomial coefficients (c0..c4) of
    u(xi) = c0 + c1 xi + c2 xi^2 + c3 xi^3 + c4 xi^4 on [0, 1]."""
    z = jnp.zeros_like(u)
    if scheme == PCM:
        return u, z, z, z, z
    if scheme == PLM:
        slp = _plm_slopes(u, h)
        return u - 0.5 * slp, slp, z, z, z
    if scheme in (PPM_H4, PPM_IH4, PPM_H6):
        if scheme == PPM_IH4:
            e_l, e_r = _edge_values_implicit_h4(u, h)
        elif scheme == PPM_H6:
            e_l, e_r = _edge_values_h6(u, h)
        else:
            e_l, e_r = _edge_values_h4(u, h)
        e_l, e_r = _ppm_limit(u, e_l, e_r)
        # u(xi) = eL + xi[(eR-eL) + 6(1-xi)(u - (eL+eR)/2)]  (CW84)
        c0 = e_l
        c1 = 6.0 * u - 4.0 * e_l - 2.0 * e_r
        c2 = 3.0 * ((e_l + e_r) - 2.0 * u)
        return c0, c1, c2, z, z
    if scheme == P3M_H4:
        # Monotone piecewise cubic (P3M_functions.F90: build from h4 edge
        # values + limited edge slopes; a3 from the slope constraints).
        # NOTE: P3M interpolates edges/slopes, it does NOT preserve the
        # cell mean — it is the INTERPOLATION scheme used by regridding
        # (regrid_interp INTERPOLATION_P3M_H4), not a remapping scheme.
        e_l, e_r = _edge_values_h4(u, h)
        e_l, e_r = _ppm_limit(u, e_l, e_r)
        s_l, s_r = _edge_slopes(u, h)
        # limit edge slopes by the one-sided slopes (P3M_limiter)
        u_m = jnp.concatenate([u[:1], u[:-1]], axis=0)
        u_p = jnp.concatenate([u[1:], u[-1:]], axis=0)
        hn = jnp.maximum(h, _EPS)
        sig_l = 2.0 * (u - u_m) / hn
        sig_r = 2.0 * (u_p - u) / hn
        s_l = jnp.where(jnp.abs(s_l) > jnp.abs(sig_l), sig_l, s_l)
        s_r = jnp.where(jnp.abs(s_r) > jnp.abs(sig_r), sig_r, s_r)
        # monotonicity of the cubic: its derivative must not change sign
        # inside (0,1); where it would, drop the slope dofs (-> PPM-like)
        u1l, u1r = s_l * h, s_r * h

        def cubic(u1l, u1r):
            a1 = u1l
            a2 = 3.0 * (e_r - e_l) - u1r - 2.0 * u1l
            a3 = u1r + u1l + 2.0 * (e_l - e_r)
            return a1, a2, a3
        a1, a2, a3 = cubic(u1l, u1r)
        # monotone iff the derivative q(xi) = a1 + 2 a2 xi + 3 a3 xi^2
        # keeps one sign on [0,1]: check the endpoints AND the interior
        # vertex (is_cubic_monotonic, P3M_functions.F90); where it fails,
        # drop the slope dofs — the resulting cubic's derivative is
        # 6 (eR-eL) xi (1-xi), monotone by construction (monotonize_cubic
        # fallback)
        q0 = a1
        q1 = a1 + 2.0 * a2 + 3.0 * a3
        xi_v = jnp.where(jnp.abs(a3) > 1e-12,
                         -a2 / (3.0 * a3 + jnp.where(a3 >= 0, 1e-30,
                                                     -1e-30)), 0.5)
        xi_v = jnp.clip(xi_v, 0.0, 1.0)
        qv = a1 + xi_v * (2.0 * a2 + 3.0 * a3 * xi_v)
        non_mono = (q0 * q1 < 0.0) | (q0 * qv < 0.0) | (qv * q1 < 0.0)
        u1l = jnp.where(non_mono, 0.0, u1l)
        u1r = jnp.where(non_mono, 0.0, u1r)
        a1, a2, a3 = cubic(u1l, u1r)
        return e_l, a1, a2, a3, z
    if scheme == PQM_IH4IH3:
        # quartic (White & Adcroft 2008; MOM_remapping.F90 REMAPPING_PQM_IH4IH3
        # role): h4 edge values + interface slopes, monotonized, with a
        # pointwise-bounds fallback to the PPM parabola where the quartic
        # would overshoot.  The EXPLICIT h4 edges are used here: at f32
        # the compact tridiagonal's longer accumulation chain costs more
        # than its non-uniform-grid accuracy gains (use PPM_IH4 for the
        # implicit edge path)
        e_l, e_r = _edge_values_h4(u, h)
        e_l, e_r = _ppm_limit(u, e_l, e_r)
        s_l, s_r = _edge_slopes(u, h)
        # slope limiting: zero where the cell is a local extremum, and
        # sign-consistent with eR-eL
        de = e_r - e_l
        s_l = jnp.where(s_l * de / jnp.maximum(h, _EPS) > 0.0, s_l, 0.0)
        s_r = jnp.where(s_r * de / jnp.maximum(h, _EPS) > 0.0, s_r, 0.0)
        a0, a1, a2, a3, a4 = _pqm_coeffs(u, h, e_l, e_r, s_l, s_r)
        # bounds check at interior sample points; fall back to PPM where
        # the quartic leaves the [min, max](eL, u, eR) envelope
        lo = jnp.minimum(jnp.minimum(e_l, e_r), u)
        hi = jnp.maximum(jnp.maximum(e_l, e_r), u)
        ok = jnp.ones_like(u, dtype=bool)
        for xi in (0.25, 0.5, 0.75):
            val = a0 + xi * (a1 + xi * (a2 + xi * (a3 + xi * a4)))
            ok = ok & (val >= lo - 1e-6 * (hi - lo + 1e-30)) \
                & (val <= hi + 1e-6 * (hi - lo + 1e-30))
        p0 = e_l
        p1 = 6.0 * u - 4.0 * e_l - 2.0 * e_r
        p2 = 3.0 * ((e_l + e_r) - 2.0 * u)
        c0 = jnp.where(ok, a0, p0)
        c1 = jnp.where(ok, a1, p1)
        c2 = jnp.where(ok, a2, p2)
        c3 = jnp.where(ok, a3, 0.0)
        c4 = jnp.where(ok, a4, 0.0)
        return c0, c1, c2, c3, c4
    raise ValueError(f"unknown remapping scheme {scheme}")


def remap_column(u0, h0, h1, scheme: str = PPM_H4):
    """Remap cell averages ``u0`` on thicknesses ``h0`` to grid ``h1``.

    Shapes: (nz0, ...) -> (nz1, ...); trailing dims are batch (ny, nx).
    Assumes sum(h0) == sum(h1) per column (same column depth)."""
    return remap_columns_multi(u0[None], h0, h1, scheme)[0]


def remap_columns_multi(fields, h0, h1, scheme: str = PPM_H4):
    """Remap several fields (nf, nz0, ...) sharing one column geometry.

    The cumulative integral at every target interface is the
    GATHER-FREE sum over source cells

        I(z) = sum_k h_k * P_k( clip((z - z0_k)/h_k, 0, 1) )

    (each cell's antiderivative clipped at its own boundaries), realized
    as a lax.scan over the nz0 source cells with the per-cell position
    fraction computed ONCE and reused by every field: O(nz^2) fused
    elementwise work and no gather.  A gather-based O(nz) evaluation is
    the alternative at large nz."""
    nf = fields.shape[0]
    recon = [reconstruct(fields[i], h0, scheme) for i in range(nf)]
    # antiderivative form: P(xi) = xi*(b0 + xi*(b1 + xi*(b2 + ...)));
    # parabolic schemes carry 3 coefficients, cubics/quartics 5 —
    # trimming the structurally-zero planes saves memory traffic
    npoly = 5 if scheme in (P3M_H4, PQM_IH4IH3) else 3
    scale = (1.0, 0.5, 1.0 / 3.0, 0.25, 0.2)
    coef_f = jnp.stack([jnp.stack([scale[p] * r[p]
                                   for p in range(npoly)])
                        for r in recon])      # (nf, npoly, nz0, ny, nx)

    col_min = jnp.min(fields, axis=1)
    col_max = jnp.max(fields, axis=1)

    coef = jnp.moveaxis(coef_f, 2, 0)        # (nz0, nf, npoly, ny, nx)
    if npoly < 5:
        pad = jnp.zeros_like(coef[:, :, :1])
        coef = jnp.concatenate([coef] + [pad] * (5 - npoly), axis=2)

    z0_top = jnp.concatenate([jnp.zeros_like(h0[:1]),
                              jnp.cumsum(h0, axis=0)[:-1]], axis=0)
    col = jnp.sum(h0, axis=0)
    z1 = jnp.concatenate([jnp.zeros_like(h1[:1]),
                          jnp.cumsum(h1, axis=0)], axis=0)
    z1 = jnp.minimum(z1, col[None])          # (nz1+1, ny, nx)

    def body(acc, xs):
        c_k, h_k, z_k = xs                   # (nf,5,ny,nx), (ny,nx), (ny,nx)
        xi = jnp.clip((z1 - z_k[None]) / jnp.maximum(h_k, _EPS)[None],
                      0.0, 1.0)              # (nz1+1, ny, nx)
        b = c_k[:, :, None]                  # (nf, 5, 1, ny, nx)
        poly = xi * (b[:, 0] + xi * (b[:, 1] + xi * (
            b[:, 2] + xi * (b[:, 3] + xi * b[:, 4]))))
        return acc + h_k[None, None] * poly, None

    acc0 = jnp.zeros((nf,) + z1.shape, fields.dtype)
    i_at_z1, _ = jax.lax.scan(body, acc0, (coef, h0, z0_top), unroll=2)

    u1 = (i_at_z1[:, 1:] - i_at_z1[:, :-1]) \
        / jnp.maximum(h1, _EPS)[None]
    # massless target cells (vanished layers over topography) divide f32
    # roundoff of the cumulative integral by ~0 thickness; bound every
    # output by the source column's range (harmless for conservation —
    # the affected cells carry negligible mass, and the clamp is the
    # monotone bound a valid reconstruction must satisfy anyway)
    return jnp.clip(u1, col_min[:, None], col_max[:, None])
