"""Jackson-Hallberg-Legg shear-driven mixing (quantitative JHL).

Implementation of MOM6's MOM_kappa_shear.F90 (Jackson,
Hallberg & Legg 2008): kappa and the TKE Q co-evolve as the coupled
steady column equations (the reference's non-Newton iteration path,
MOM_kappa_shear.F90:1660-1820, find_kappa_tke), vectorized over all
columns with batched tridiagonal solves:

  TKE:    d/dz[(kappa~ + kappa0) dQ/dz] + (kappa + kappa0) S^2
          - kappa N^2 - (Q - q0) * TKE_decay = 0,
          TKE_decay = sqrt(C_N^2 N^2 + C_S^2 S^2)

  kappa:  d^2(kappa)/dz^2 + K_src - kappa / L_eff^2 = 0,
          K_src = 2 SHEARMIX_RATE sqrt(S^2)
                  (Ri_c S^2 - N^2)/(Ri_c S^2 + FRI_CURVATURE N^2)
                  where N^2 < Ri_c S^2   (:1241),
          1/L_eff^2 = (N^2/LAMBDA^2 + f^2)/Q + 1/L_bdry^2,
          1/L_bdry = 1/dist_top + 1/dist_bottom   (:1043)

with kappa = 0 boundary conditions, the buoyancy sink of the TKE
equation linearized through K_Q = kappa/Q as in the reference, and the
reference's default constants: RINO_CRIT=0.25, SHEARMIX_RATE=0.089,
FRI_CURVATURE=-0.97, LAMBDA=0.82, TKE_N_DECAY_CONST C_N=0.24,
TKE_SHEAR_DECAY_CONST C_S=0.14.

The reference's adaptive dt-subdivision (the tol_dksrc machinery) is
replaced by a fixed outer loop: each outer pass solves the coupled
kappa/TKE system (n_inner fixed-point sweeps) and then implicitly mixes
u/v/T/S over dt/n_outer with the resulting kappa, so the mixing
saturates as the driving shear is consumed — the defining JHL property.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mom6_tpu.framework.solvers import tridiag_solve
from mom6_tpu.framework.stencil import im1, jm1
from mom6_tpu.tracers.vert_diff import tracer_vertdiff

__all__ = ["KappaShearParams", "kappa_shear"]

_H_EPS = 1e-3


class KappaShearParams(NamedTuple):
    ri_crit: float = 0.25         # RINO_CRIT
    shearmix_rate: float = 0.089  # SHEARMIX_RATE
    fri_curvature: float = -0.97  # FRI_CURVATURE
    lam: float = 0.82             # LAMBDA
    c_n: float = 0.24             # TKE_N_DECAY_CONST
    c_s: float = 0.14             # TKE_SHEAR_DECAY_CONST
    kappa_0: float = 1e-7         # KD (background) [m2 s-1]
    tke_bg: float = 0.0           # TKE_BACKGROUND [m2 s-2]
    tke_min: float = 1e-9         # floor on Q [m2 s-2]
    kappa_max: float = 0.1        # [m2 s-1] safety cap
    n_outer: int = 3              # dt subdivisions (profile evolution)
    n_inner: int = 3              # kappa/TKE fixed-point sweeps


def _n2_s2(h, uc, vc, T, S, GV, eos):
    z_int = jnp.cumsum(h, axis=0)[:-1]
    p_int = GV.rho0 * GV.g_earth * z_int
    t_i = 0.5 * (T[:-1] + T[1:])
    s_i = 0.5 * (S[:-1] + S[1:])
    a_t, a_s = eos.density_derivs(t_i, s_i, p_int)
    dz = jnp.maximum(0.5 * (h[:-1] + h[1:]), _H_EPS)
    n2 = (GV.g_earth / GV.rho0) * (a_t * (T[1:] - T[:-1])
                                   + a_s * (S[1:] - S[:-1])) / dz
    du = (uc[:-1] - uc[1:]) / dz
    dv = (vc[:-1] - vc[1:]) / dz
    return jnp.maximum(n2, 0.0), du * du + dv * dv, z_int


def _solve_kappa_tke(h, n2, s2, z_int, f2, col, p: KappaShearParams,
                     kappa, q):
    """n_inner sweeps of the coupled steady kappa/TKE column equations
    on interior interfaces (nz-1, ny, nx)."""
    dz_int = jnp.maximum(0.5 * (h[:-1] + h[1:]), _H_EPS)   # h_Int
    # Idz between adjacent interior interfaces (layer thicknesses 1..nz-2)
    idz = 1.0 / jnp.maximum(h[1:-1], _H_EPS)
    tke_decay = jnp.sqrt(p.c_n ** 2 * n2 + p.c_s ** 2 * s2)
    l_top = z_int
    l_bot = jnp.maximum(col[None] - z_int, _H_EPS)
    i_l2_bdry = (1.0 / jnp.maximum(l_top, _H_EPS)
                 + 1.0 / l_bot) ** 2
    ric = p.ri_crit
    k_src = jnp.where(
        n2 < ric * s2,
        2.0 * p.shearmix_rate * jnp.sqrt(s2)
        * (ric * s2 - n2) / jnp.maximum(ric * s2 + p.fri_curvature * n2,
                                        1e-30),
        0.0)

    def sweep(_, carry):
        kappa, q = carry
        # --- TKE equation (implicit; buoyancy sink via K_Q = kappa/Q)
        k_q = kappa / jnp.maximum(q, p.tke_min)
        # couplings between interior interfaces: aQ_k ~ (mean kappa
        # of the pair + kappa0)/dz of the layer between them
        a_q = (0.5 * (kappa[:-1] + kappa[1:]) + p.kappa_0) * idz
        zero = jnp.zeros_like(a_q[:1])
        sub = -jnp.concatenate([zero, a_q], axis=0)
        sup = -jnp.concatenate([a_q, zero], axis=0)
        diag = dz_int * (tke_decay + n2 * k_q) - sub - sup
        rhs = dz_int * ((kappa + p.kappa_0) * s2
                        + p.tke_bg * tke_decay)
        q = jnp.maximum(tridiag_solve(sub, diag, sup, rhs), p.tke_min)
        # --- kappa equation (implicit decay + unit vertical spreading)
        i_ld2 = (n2 / p.lam ** 2 + f2[None]) / q + i_l2_bdry
        sub_k = -jnp.concatenate([zero, idz], axis=0)
        sup_k = -jnp.concatenate([idz, zero], axis=0)
        diag_k = dz_int * i_ld2 - sub_k - sup_k
        kappa = jnp.clip(tridiag_solve(sub_k, diag_k, sup_k,
                                       dz_int * k_src),
                         0.0, p.kappa_max)
        return kappa, q

    return jax.lax.fori_loop(0, p.n_inner, sweep, (kappa, q))


def kappa_shear(h, u, v, T, S, G, GV, eos,
                p: KappaShearParams = KappaShearParams(), dt: float = 3600.0
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (kappa (nz+1, ny, nx) [m2 s-1], TKE at interfaces)."""
    uc = 0.5 * (u + im1(u))
    vc = 0.5 * (v + jm1(v))
    col = jnp.sum(h, axis=0)
    f_q = G.CoriolisBu
    f2 = 0.25 * ((f_q ** 2 + im1(jm1(f_q ** 2)))
                 + (im1(f_q ** 2) + jm1(f_q ** 2)))
    dt_sub = dt / p.n_outer

    kappa0 = jnp.zeros_like(h[:-1])
    q0 = jnp.full_like(h[:-1], p.tke_min)

    def outer(_, carry):
        uc_m, vc_m, T_m, S_m, kappa, q = carry
        n2, s2, z_int = _n2_s2(h, uc_m, vc_m, T_m, S_m, GV, eos)
        kappa, q = _solve_kappa_tke(h, n2, s2, z_int, f2, col, p,
                                    kappa, q)
        kd = jnp.concatenate([jnp.zeros_like(h[:1]), kappa,
                              jnp.zeros_like(h[:1])], axis=0)
        mixed = tracer_vertdiff(jnp.stack([uc_m, vc_m, T_m, S_m]), h,
                                kd, dt_sub)
        return mixed[0], mixed[1], mixed[2], mixed[3], kappa, q

    _, _, _, _, kappa, q = jax.lax.fori_loop(
        0, p.n_outer, outer, (uc, vc, T, S, kappa0, q0))
    zeros = jnp.zeros_like(h[:1])
    kappa_full = jnp.concatenate([zeros, kappa, zeros], axis=0) \
        * G.mask2dT[None]
    tke_full = jnp.concatenate([zeros, q, zeros], axis=0) \
        * G.mask2dT[None]
    return kappa_full, tke_full
