"""Implicit vertical viscosity (momentum diffusion) and surface/bottom stress.

Analogue of MOM6's MOM_vert_friction (reference:
src/parameterizations/vertical/MOM_vert_friction.F90: vertvisc_coef :1357,
vertvisc :557, vertvisc_remnant :1229): backward-Euler vertical diffusion of
momentum as a batched tridiagonal solve per velocity column, with wind
stress entering the surface layer and a linear (or quadratic) bottom drag
coupling the deepest layer to a motionless bottom.

``visc_rem`` — the fraction of a time-step's worth of barotropic
acceleration a layer retains after viscosity — is obtained by applying the
same implicit operator to a unit velocity profile, exactly the quantity
MOM6's vertvisc_remnant computes, which weights the barotropic projections
and the continuity flux adjustment.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from mom6_tpu.framework.solvers import tridiag_solve

__all__ = ["ViscCoeffs", "gl90_coupling", "vertvisc_coef", "vertvisc",
           "vertvisc_remnant"]

# Thickness floor for the implicit solve [m].  Must be large enough that the
# float32 Thomas recursion stays well conditioned when layers are massless
# (vanished layers / land columns): with a 1e-10 floor the interface
# couplings kv/dz reach ~1e6 and cancel the ~1e-13 h/dt diagonal to exactly
# zero in f32, producing NaNs that masks cannot remove (NaN*0 = NaN).  A 1 mm
# floor keeps couplings <= kv*1e3 and the recursion denominators resolvable.
_H_EPS = 1e-3


class ViscCoeffs(NamedTuple):
    a_above: jnp.ndarray   # (nz, ny, nx) coupling to layer k-1 [m s-1]
    a_below: jnp.ndarray   # (nz, ny, nx) coupling to layer k+1 [m s-1]
    drag_diag: Optional[jnp.ndarray] = None  # bottom-drag piston per layer


def gl90_coupling(h_face, f2, g_prime, *, kappa_gl90: float = 0.0,
                  alpha_gl90: float = 0.0, hbbl_gl90: float = 5.0):
    """Greatbatch & Lamb (1990) interfacial viscosity coupling — the TWA
    equivalent of GM, redistributing momentum vertically with
    nu = kappa_GM f^2 / N^2 (find_coupling_coef_gl90,
    MOM_vert_friction.F90:428-545).  Returns the extra interface
    coupling [m s-1] at interfaces 2..nz (stress-free top/bottom).

    ``f2``: (ny, nx) squared Coriolis parameter at the velocity point.
    ``g_prime``: (nz,) reduced gravities at layer-top interfaces (the
    stacked-shallow-water 1/N^2 = h/g' closure: a = f^2 kappa / g').
    ``alpha_gl90`` > 0 selects the depth-independent form
    a = 2 f^2 alpha / (h_k + h_{k-1}) instead.
    The coupling is tapered to zero within the bottom boundary layer by
    (1 - botfn), botfn = 1/(1 + 0.09 z^6), z = height above bottom in
    units of ``hbbl_gl90``."""
    if alpha_gl90 > 0.0:
        a = 2.0 * f2[None] * alpha_gl90 \
            / jnp.maximum(h_face[:-1] + h_face[1:], _H_EPS)
    else:
        gp = jnp.asarray(g_prime)[1:, None, None]      # interfaces 2..nz
        a = f2[None] * kappa_gl90 / jnp.maximum(gp, 1e-12)
    # height of each interior interface above the bottom
    z_i = jnp.cumsum(h_face[::-1], axis=0)[::-1][1:] / hbbl_gl90
    botfn = 1.0 / (1.0 + 0.09 * z_i ** 6)
    return a * (1.0 - botfn)


def vertvisc_coef(h_face, kv: float, *, bottom_drag: float = 0.0,
                  u_bot: Optional[jnp.ndarray] = None,
                  cdrag: float = 0.0,
                  a_gl90=None) -> ViscCoeffs:
    """Viscous coupling coefficients at a velocity point.

    ``h_face``: (nz, ny, nx) layer thicknesses at the velocity point.
    ``kv``: background vertical viscosity [m2 s-1].
    ``bottom_drag``: linear bottom drag piston velocity r [m s-1].
    ``cdrag``/``u_bot``: quadratic drag c_d*|u_bot| added to r.
    ``a_gl90``: optional extra interface coupling from ``gl90_coupling``.
    """
    dz_int = 0.5 * (h_face[:-1] + h_face[1:])          # interfaces 2..nz
    a_int = kv / jnp.maximum(dz_int, _H_EPS)
    if a_gl90 is not None:
        a_int = a_int + a_gl90
    # f32 conditioning cap, cf. tracers/vert_diff.py: keep coupling/mass
    # ratios resolvable while still locking massless layers to neighbors
    a_cap = 1e4 * jnp.minimum(h_face[:-1], h_face[1:]).clip(_H_EPS) / 3600.0
    a_int = jnp.minimum(a_int, a_cap)
    zeros = jnp.zeros_like(h_face[:1])
    a_above = jnp.concatenate([zeros, a_int], axis=0)  # no stress through surface (explicit wind)
    r = bottom_drag
    if cdrag and u_bot is not None:
        r = bottom_drag + cdrag * jnp.abs(u_bot)
    a_below = jnp.concatenate([a_int, jnp.zeros_like(h_face[:1])], axis=0)
    # distribute the bottom drag over the deepest HBBL metres of ACTUAL
    # water rather than coupling only layer nz to the bottom: over
    # topography the deepest layers are vanished, and drag applied to an
    # empty layer leaves the real near-bottom flow (a thin sliver higher
    # in the stack) completely inviscid — those slivers then accelerate
    # freely along slopes (the 90-day bowl instability).  Counting in
    # cumulative water skips vanished layers automatically (they have
    # ~zero overlap), the set_viscous_BBL placement.
    hbbl = 10.0
    z_top_fb = jnp.cumsum(h_face[::-1], axis=0)[::-1]   # water above bottom
    ov = (jnp.minimum(z_top_fb, hbbl)
          - jnp.minimum(z_top_fb - h_face, hbbl))
    w = ov / jnp.maximum(jnp.sum(ov, axis=0, keepdims=True), _H_EPS)
    drag_diag = r * w
    return ViscCoeffs(a_above, a_below, drag_diag)


def _solve(u_rhs_over_dt, h_face, coeffs: ViscCoeffs, dt: float):
    """Solve (h/dt + A) u_new = rhs for one velocity component."""
    hdt = jnp.maximum(h_face, _H_EPS) / dt
    b = hdt + coeffs.a_above + coeffs.a_below
    if coeffs.drag_diag is not None:
        b = b + coeffs.drag_diag
    a = -coeffs.a_above
    c = jnp.concatenate([-coeffs.a_below[:-1],
                         jnp.zeros_like(coeffs.a_below[:1])], axis=0)
    return tridiag_solve(a, b, c, u_rhs_over_dt)


def vertvisc(u, h_face, coeffs: ViscCoeffs, dt: float,
             tau: Optional[jnp.ndarray] = None, rho0: float = 1035.0):
    """Implicit viscous update of a velocity component; ``tau`` is the
    surface stress [Pa] absorbed by the top layer."""
    hdt = jnp.maximum(h_face, _H_EPS) / dt
    rhs = hdt * u
    if tau is not None:
        sfc = jnp.zeros_like(u).at[0].add(tau / rho0)
        rhs = rhs + sfc
    return _solve(rhs, h_face, coeffs, dt)


def limit_velocity(u, v, dt, G, *, cfl_trunc: float = 0.25):
    """CFL truncation (vertvisc_limit_vel, MOM_vert_friction.F90:2929):
    velocities exceeding ``cfl_trunc`` of the advective CFL are clipped —
    numerical-fault containment, the run continues (SURVEY.md §5.3).

    Returns (u_lim, v_lim, n_trunc) where n_trunc counts clipped points
    (the PointAccel "truncation dossier" hook)."""
    import jax.numpy as jnp
    u_max = cfl_trunc / (dt * jnp.maximum(G.IdxCu, 1e-30))
    v_max = cfl_trunc / (dt * jnp.maximum(G.IdyCv, 1e-30))
    u_lim = jnp.clip(u, -u_max, u_max)
    v_lim = jnp.clip(v, -v_max, v_max)
    n_trunc = (jnp.sum(jnp.abs(u) > u_max).astype(jnp.int32)
               + jnp.sum(jnp.abs(v) > v_max).astype(jnp.int32))
    return u_lim, v_lim, n_trunc


def vertvisc_remnant(h_face, coeffs: ViscCoeffs, dt: float):
    """Fraction of barotropic forcing remaining after implicit viscosity
    (vertvisc_remnant, MOM_vert_friction.F90:1229)."""
    hdt = jnp.maximum(h_face, _H_EPS) / dt
    ones = jnp.ones_like(h_face)
    return jnp.clip(_solve(hdt * ones, h_face, coeffs, dt), 0.0, 1.0)
