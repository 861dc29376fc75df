"""Ice-shelf dynamics: the shallow-shelf approximation (SSA).

Re-design of MOM6's ice sheet/shelf dynamics (reference:
src/ice_shelf/MOM_ice_shelf_dynamics.F90: ice_shelf_solve_outer :1427
— Picard iteration on the Glen-law viscosity around a conjugate-gradient
solve of the SSA momentum balance, velocities at B-grid corners;
ice_shelf_advect :1317 for the thickness transport).

Discretization: velocities live at q (corner) points; strain rates are
evaluated at cell centres from corner means; the stress divergence is
the EXACT ADJOINT of the strain operator weighted by (nu H) per cell —
the variational (virtual-work) form, so the linear operator is
symmetric positive semi-definite by construction and plain CG converges
without preconditioning tricks.  Everything is fixed-iteration-count
``lax.scan`` (jit-friendly): an outer Picard loop updating the Glen
viscosity  nu = 0.5 A^(-1/n) eps_e^((1-n)/n)  and an inner CG loop.

Floating shelves: the driving stress is rho_i g (1 - rho_i/rho_w) H
grad(H) (hydrostatic surface slope of a freely floating shelf) and the
calving-front imbalance enters through the same variational form.
Grounded margins / inflow boundaries are Dirichlet (u = 0) via the
corner mask.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mom6_tpu.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["SSAParams", "ssa_solve", "ice_shelf_advect_thickness"]


class SSAParams(NamedTuple):
    glen_a: float = 2.261e-25    # Glen flow-rate factor A [Pa-3 s-1]
    glen_n: float = 3.0
    rho_ice: float = 918.0
    rho_water: float = 1028.0
    g: float = 9.81
    eps_min: float = 1e-13       # strain-rate floor [s-1] (GLEN_EPS_MIN)
    n_picard: int = 8            # nonlinear viscosity iterations
    n_cg: int = 60               # CG iterations per Picard step
    basal_beta: float = 0.0      # linear basal drag [Pa s m-1] (grounded)


def _strains(u, v, G):
    """Cell-centred strain rates from corner velocities."""
    # east/west edge means of the corner field
    def ddx(q):
        e = 0.5 * (q + jm1(q))           # east edge mean at (j, i)
        return (e - im1(e)) * G.IdxT

    def ddy(q):
        n = 0.5 * (q + im1(q))           # north edge mean
        return (n - jm1(n)) * G.IdyT

    return ddx(u), ddy(u), ddx(v), ddy(v)


def _strains_adjoint(fx_ux, fy_uy, fx_vx, fy_vy, G, area):
    """Adjoint of _strains under the area-weighted inner product:
    returns the corner forces (Fu, Fv) such that
    <F, w> = sum_cells area * (fx_ux * w_x + ...)."""
    def ddx_T(f):
        g = f * G.IdxT * area
        e = g - ip1(g)                   # adjoint of edge difference
        return 0.5 * (e + jp1(e))        # adjoint of corner mean

    def ddy_T(f):
        g = f * G.IdyT * area
        n = g - jp1(g)
        return 0.5 * (n + ip1(n))

    fu = ddx_T(fx_ux) + ddy_T(fy_uy)
    fv = ddx_T(fx_vx) + ddy_T(fy_vy)
    return fu, fv


def _apply_ssa(u, v, nu_h, G, mask_q, area, beta_q):
    """A(u, v): the (negative) SSA stress divergence at corners.
    nu_h: cell-centred nu * H [Pa s m]."""
    ux, uy, vx, vy = _strains(u, v, G)
    # SSA membrane stresses per unit area of the cell
    sxx = nu_h * (4.0 * ux + 2.0 * vy)
    syy = nu_h * (4.0 * vy + 2.0 * ux)
    sxy = nu_h * (uy + vx)
    fu, fv = _strains_adjoint(sxx, sxy, sxy, syy, G, area)
    fu = fu + beta_q * u * area
    fv = fv + beta_q * v * area
    return fu * mask_q, fv * mask_q


def _glen_visc(u, v, h, G, p: SSAParams):
    """Vertically integrated Glen viscosity nu*H at cell centres."""
    ux, uy, vx, vy = _strains(u, v, G)
    eps_e2 = (ux * ux + vy * vy + ux * vy
              + 0.25 * (uy + vx) ** 2 + p.eps_min ** 2)
    n = p.glen_n
    nu = 0.5 * p.glen_a ** (-1.0 / n) * eps_e2 ** ((1.0 - n) / (2.0 * n))
    return nu * jnp.maximum(h, 1.0)


def ssa_solve(h, G, p: SSAParams, mask_shelf=None, u0=None, v0=None,
              beta=None):
    """Solve the SSA momentum balance for a floating shelf.

    h: (ny, nx) ice thickness [m]; mask_shelf: 1 where ice is dynamic
    (defaults to h > 1); beta: optional (ny, nx) basal drag for grounded
    parts.  Returns (u, v) at corner points [m s-1]."""
    if getattr(G, "fold_north", False):
        # the SSA stencils here do not carry the tripolar fold's
        # rotated ghost row; silently treating the fold row
        # approximately would corrupt an Arctic shelf (PARITY.md).
        # Antarctic shelves (the reference's use case) never touch the
        # northern fold — run them on a regional/spherical grid.
        raise ValueError(
            "ice-shelf (SSA) dynamics are not fold-wired: a TRIPOLAR_N "
            "grid cannot host dynamic ice shelves at the northern fold; "
            "use a regional grid for the shelf domain")
    dtype = h.dtype
    if mask_shelf is None:
        mask_shelf = (h > 1.0).astype(dtype)
    # corner mask: all four surrounding cells dynamic -> free; Dirichlet 0
    # where the corner touches open water/grounded margin on the UPSTREAM
    # side only would need one-sided forms; round 1 keeps corners free if
    # ANY surrounding cell has ice (natural BC at the front comes from the
    # variational form + driving stress), pinning only all-empty corners.
    m_any = jnp.maximum(jnp.maximum(mask_shelf, ip1(mask_shelf)),
                        jnp.maximum(jp1(mask_shelf), ip1(jp1(mask_shelf))))
    mask_q = m_any * G.mask2dT * ip1(jp1(G.mask2dT))
    area = G.areaT
    gprime = p.rho_ice * p.g * (1.0 - p.rho_ice / p.rho_water)

    # driving stress at corners: the variational form of
    # -integral( rho_i g' H grad(H) . w ): equivalently the adjoint of
    # the gradient acting on 0.5 g' H^2 (membrane form of the floating
    # shelf driving + front pressure imbalance)
    pot = 0.5 * gprime * (h * mask_shelf) ** 2
    tdx, tdy = _strains_adjoint(pot, jnp.zeros_like(pot),
                                jnp.zeros_like(pot), pot, G, area)
    # the adjoint of (w_x + w_y) applied to pot gives +int pot div(w),
    # which is -int grad(pot) . w: the correct RHS sign for A u = tau_d
    tdx = tdx * mask_q
    tdy = tdy * mask_q

    beta_q = jnp.zeros_like(h) if beta is None else beta
    u = jnp.zeros_like(h) if u0 is None else u0
    v = jnp.zeros_like(h) if v0 is None else v0

    # diagonal pinning ONLY at corners with no adjacent shelf ice (where
    # the membrane operator is singular); zero inside the shelf so the
    # regularization exerts no spurious drag on the solution
    m_all = mask_shelf * ip1(mask_shelf) * jp1(mask_shelf) \
        * ip1(jp1(mask_shelf))
    pin = (1.0 - jnp.minimum(m_any, 1.0)) + 0.0 * m_all

    def picard(carry, _):
        u, v = carry
        nu_h = _glen_visc(u, v, h * mask_shelf, G, p) * mask_shelf
        # strong pin on no-ice corners + a relatively tiny global diagonal
        # that breaks the zero-strain checkerboard null modes of corners
        # with a single adjacent ice cell (the ice front) without exerting
        # measurable drag on the resolved flow
        reg = jnp.max(nu_h) * (1e-6 * pin + 3e-11)

        def matvec(x):
            fu, fv = _apply_ssa(x[0], x[1], nu_h, G, mask_q, area,
                                beta_q + reg)
            return jnp.stack([fu, fv])

        # normalize the system so the f32 CG inner products stay in range
        # (nu*H reaches ~1e17 Pa s m; residual squares would overflow)
        bscale = jnp.sqrt(jnp.sum(tdx * tdx + tdy * tdy)) + 1e-30
        b = jnp.stack([tdx, tdy]) / bscale
        x = jnp.stack([u, v]) / bscale
        r = b - matvec(x)
        pvec = r
        rs = jnp.sum(r * r)

        def cg(carry, _):
            x, r, pvec, rs = carry
            ap = matvec(pvec)
            denom = jnp.sum(pvec * ap)
            alpha = rs / jnp.maximum(denom, 1e-30)
            x = x + alpha * pvec
            r = r - alpha * ap
            rs_new = jnp.sum(r * r)
            pvec = r + (rs_new / jnp.maximum(rs, 1e-30)) * pvec
            return (x, r, pvec, rs_new), None

        (x, _, _, _), _ = jax.lax.scan(cg, (x, r, pvec, rs), None,
                                       length=p.n_cg)
        x = x * bscale
        return (x[0] * mask_q, x[1] * mask_q), None

    (u, v), _ = jax.lax.scan(picard, (u, v), None, length=p.n_picard)
    return u, v


def ice_shelf_advect_thickness(h, u, v, dt, G, mask_shelf):
    """h_t = -div(u h): first-order upwind transport of shelf thickness
    with corner velocities averaged to faces (ice_shelf_advect role)."""
    u_f = 0.5 * (u + jm1(u))                       # u at east faces
    v_f = 0.5 * (v + im1(v))                       # v at north faces
    hm = h * mask_shelf
    fx = G.dyCu * (jnp.maximum(u_f, 0.0) * hm
                   + jnp.minimum(u_f, 0.0) * ip1(hm))
    fy = G.dxCv * (jnp.maximum(v_f, 0.0) * hm
                   + jnp.minimum(v_f, 0.0) * jp1(hm))
    div = G.IareaT * ((fx - im1(fx)) + (fy - jm1(fy)))
    return jnp.maximum(h - dt * div, 0.0)
