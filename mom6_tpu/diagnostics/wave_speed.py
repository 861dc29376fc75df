"""Internal gravity wave speeds (first mode and the N-mode spectrum).

Analogue of MOM6's MOM_wave_speed.F90 (per-column eigen-solve):

* :func:`wave_speed` — the discrete vertical-mode eigenproblem
  ``M w = -(N^2 dz / c^2) w`` (w at interior interfaces, w=0 at
  top/bottom) solved by batched INVERSE ITERATION: each iteration is one
  tridiagonal solve over all columns at once (the whole-array replacement
  for the reference's per-column Sturm-sequence root finder,
  MOM_wave_speed.F90:120-749);
* :func:`wave_speeds` — the N lowest modes + vertical structures via
  the same operator with B-inner-product DEFLATION (the wave_speeds
  entry point of the reference, MOM_wave_speed.F90:750-1556, whose
  root-bracketing loop is replaced by batched deflated inverse
  iteration — internal tides and tidal mixing consume these);
* :func:`wave_speed_wkb` — the WKB estimate ``c1 = (1/pi) int N dz``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mom6_tpu.framework.solvers import tridiag_solve

__all__ = ["wave_speed", "wave_speeds", "wave_speed_wkb"]


def _n2_dz(h, T, S, GV, eos):
    z_int = jnp.cumsum(h, axis=0)[:-1]
    p_int = GV.rho0 * GV.g_earth * z_int
    t_i = 0.5 * (T[:-1] + T[1:])
    s_i = 0.5 * (S[:-1] + S[1:])
    a_t, a_s = eos.density_derivs(t_i, s_i, p_int)
    drho = a_t * (T[1:] - T[:-1]) + a_s * (S[1:] - S[:-1])
    dz = jnp.maximum(0.5 * (h[:-1] + h[1:]), 1e-3)
    n2 = jnp.maximum((GV.g_earth / GV.rho0) * drho / dz, 1e-12)
    return n2, dz


def wave_speed(h, T, S, G, GV, eos, n_iter: int = 10):
    """First-mode internal wave speed c1 (ny, nx) [m s-1] from the
    tridiagonal mode eigenproblem (batched inverse iteration)."""
    n2, dz_int = _n2_dz(h, T, S, GV, eos)        # (nz-1, ny, nx)
    inv_h = 1.0 / jnp.maximum(h, 1e-3)           # (nz, ...)
    # second-difference operator on interior interfaces K=1..nz-1:
    # row K: [1/h_K, -(1/h_K + 1/h_{K+1}), 1/h_{K+1}]
    a = inv_h[:-1]                                # sub-diagonal (w_{K-1})
    c = inv_h[1:]                                 # super-diagonal (w_{K+1})
    b = -(inv_h[:-1] + inv_h[1:])
    # Dirichlet BCs: first row has no sub, last no super
    a = a.at[0].set(0.0)
    c = c.at[-1].set(0.0)
    d_weight = n2 * dz_int                        # the B diagonal

    x = jnp.ones_like(n2)

    def iterate(_, x):
        rhs = d_weight * x
        y = tridiag_solve(a, b, c, rhs)
        norm = jnp.sqrt(jnp.sum(y * y, axis=0, keepdims=True))
        return y / jnp.maximum(norm, 1e-30)

    x = jax.lax.fori_loop(0, n_iter, iterate, x)
    # Rayleigh quotient lambda = (x^T M x)/(x^T B x) = -1/c^2
    x_up = jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], 0)
    x_dn = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], 0)
    mx = a * x_up + b * x + c * x_dn
    lam = jnp.sum(x * mx, axis=0) / jnp.maximum(
        jnp.sum(x * d_weight * x, axis=0), 1e-30)
    c2 = -1.0 / jnp.minimum(lam, -1e-12)
    return jnp.sqrt(jnp.maximum(c2, 0.0)) * G.mask2dT


def wave_speeds(h, T, S, G, GV, eos, n_modes: int = 3, n_iter: int = 16,
                return_structures: bool = False):
    """The ``n_modes`` lowest internal-mode speeds c_n (n_modes, ny, nx)
    [m s-1] and optionally the vertical structures w_n at interior
    interfaces ((n_modes, nz-1, ny, nx), B-orthonormal).

    Deflated inverse iteration on the generalized symmetric problem
    M w = lambda B w (lambda = -1/c^2, B = diag(N^2 dz) > 0): mode m
    iterates x <- M^{-1} B x and B-orthogonalizes against modes < m
    every sweep, so each mode costs n_iter batched tridiagonal solves —
    all columns at once, no per-column root bracketing."""
    n2, dz_int = _n2_dz(h, T, S, GV, eos)        # (nz-1, ny, nx)
    inv_h = 1.0 / jnp.maximum(h, 1e-3)
    a = inv_h[:-1]
    c = inv_h[1:]
    b = -(inv_h[:-1] + inv_h[1:])
    a = a.at[0].set(0.0)
    c = c.at[-1].set(0.0)
    bw = n2 * dz_int                              # B diagonal

    def b_dot(x, y):
        return jnp.sum(x * bw * y, axis=0, keepdims=True)

    modes = []
    speeds = []
    nz1 = n2.shape[0]
    for m in range(n_modes):
        # deterministic start with the expected sign structure of mode m
        # (sin((m+1) pi k/nz)) so the iteration cannot start B-orthogonal
        # to its target
        k = jnp.arange(1, nz1 + 1, dtype=h.dtype)[:, None, None]
        x = jnp.sin((m + 1) * jnp.pi * k / (nz1 + 1)) \
            * jnp.ones_like(n2)

        def iterate(_, x, _modes=tuple(modes)):
            for w in _modes:
                x = x - w * b_dot(w, x)
            y = tridiag_solve(a, b, c, bw * x)
            for w in _modes:
                y = y - w * b_dot(w, y)
            norm = jnp.sqrt(jnp.maximum(b_dot(y, y), 1e-30))
            return y / norm

        x = jax.lax.fori_loop(0, n_iter, iterate, x)
        x_up = jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], 0)
        x_dn = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], 0)
        mx = a * x_up + b * x + c * x_dn
        lam = jnp.sum(x * mx, axis=0) / jnp.maximum(
            jnp.sum(x * bw * x, axis=0), 1e-30)
        c2 = -1.0 / jnp.minimum(lam, -1e-12)
        speeds.append(jnp.sqrt(jnp.maximum(c2, 0.0)) * G.mask2dT)
        modes.append(x)
    cn = jnp.stack(speeds)
    if return_structures:
        return cn, jnp.stack(modes)
    return cn


def wave_speed_wkb(h, T, S, G, GV, eos):
    """First-mode internal wave speed c1 (ny, nx) [m s-1]."""
    z_int = jnp.cumsum(h, axis=0)[:-1]
    p_int = GV.rho0 * GV.g_earth * z_int
    t_i = 0.5 * (T[:-1] + T[1:])
    s_i = 0.5 * (S[:-1] + S[1:])
    a_t, a_s = eos.density_derivs(t_i, s_i, p_int)
    drho = a_t * (T[1:] - T[:-1]) + a_s * (S[1:] - S[:-1])
    dz = jnp.maximum(0.5 * (h[:-1] + h[1:]), 1e-3)
    n2 = jnp.maximum((GV.g_earth / GV.rho0) * drho / dz, 0.0)
    n_int = jnp.sqrt(n2)
    c1 = jnp.sum(n_int * dz, axis=0) / jnp.pi
    return c1 * G.mask2dT
