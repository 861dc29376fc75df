"""Self-attraction and loading (SAL) via spherical harmonics.

Re-design of MOM6's harmonic SAL (reference:
src/parameterizations/lateral/MOM_self_attr_load.F90: calc_SAL, with
calc_love_scaling :136 — eta_sal's degree-n coefficient is the sea level
coefficient times  beta_n = (3 / (2n+1)) (rhoW / rhoE) (1 + k'_n - h'_n);
the spherical harmonic machinery lives in MOM_spherical_harmonics.F90).

Design: the whole transform is two matmuls + an FFT —

  1. rfft over longitude gives the zonal Fourier coefficients
     C_m(lat), S_m(lat) (the grid must be cyclic in x);
  2. per zonal wavenumber m, a precomputed weighted pseudo-inverse
     projects onto associated-Legendre columns (analysis), the diagonal
     Love scaling multiplies each degree, and the Legendre matrix
     synthesizes back — one batched (m, n, lat) einsum each way, at
     full float32 precision (a matrix unit's reduced-precision default,
     such as TF32, would keep only ~3 digits of the transform);
  3. inverse rfft restores longitude.

Because analysis uses the exact discrete pseudo-inverse of the same
Legendre matrix used in synthesis, the basis normalization cancels and
spherical harmonics are exact eigenfunctions of the operator on the
grid (tested).  Love factors (1 + k'_n - h'_n) default to the rigid
Earth value 1 (degrees 0 and 1 excluded); a table can be supplied.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SALHarmonics", "build_sal_harmonics", "calc_sal_harmonic"]

_RHO_EARTH = 5517.0     # mean Earth density [kg m-3] (RHO_SOLID_EARTH)


class SALHarmonics(NamedTuple):
    P: jnp.ndarray       # (m, ny, n) Legendre synthesis columns
    pinv: jnp.ndarray    # (m, n, ny) weighted analysis pseudo-inverse
    beta: jnp.ndarray    # (m, n) Love/degree scaling (0 where padded)
    nmax: int


def _legendre_norm(nmax: int, x: np.ndarray) -> np.ndarray:
    """4pi-normalized associated Legendre P[n, m, j] on x = sin(lat),
    via the standard stable column recursion (Holmes & Featherstone)."""
    nj = x.shape[0]
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    P = np.zeros((nmax + 1, nmax + 1, nj))
    P[0, 0] = 1.0
    for m in range(1, nmax + 1):
        P[m, m] = np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * s * P[m - 1, m - 1]
    for m in range(0, nmax):
        P[m + 1, m] = np.sqrt(2.0 * m + 3.0) * x * P[m, m]
    for m in range(0, nmax + 1):
        for n in range(m + 2, nmax + 1):
            a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = np.sqrt(((2.0 * n + 1.0) * (n - 1.0 + m) * (n - 1.0 - m))
                        / ((2.0 * n - 3.0) * (n * n - m * m)))
            P[n, m] = a * x * P[n - 1, m] - b * P[n - 2, m]
    return P                     # [n, m, j]


def build_sal_harmonics(G, nmax: int = 12, *, rho_water: float = 1035.0,
                        rho_earth: float = _RHO_EARTH,
                        love_factors: Optional[np.ndarray] = None,
                        dtype=jnp.float32) -> SALHarmonics:
    """Precompute the transform matrices for grid ``G`` (host-side init).

    ``love_factors``: optional (nmax+1,) array of (1 + k'_n - h'_n);
    defaults to 1 (rigid earth).  Degrees 0 and 1 are always excluded
    (mass conservation / reference-frame ambiguity)."""
    # the zonal-FFT analysis resolves at most nx//2 wavenumbers and the
    # meridional fit at most ny-1 degrees: cap nmax to the grid
    nmax = min(nmax, int(G.nx) // 2, int(G.ny) - 1)
    lat = np.asarray(G.geoLatT)[:, 0] * np.pi / 180.0
    x = np.sin(lat)
    w = np.maximum(np.cos(lat), 1e-6)            # area weights per row
    Pnm = _legendre_norm(nmax, x)                # (n, m, j)

    love = np.ones(nmax + 1) if love_factors is None \
        else np.asarray(love_factors, np.float64)
    beta_n = (3.0 / (2.0 * np.arange(nmax + 1) + 1.0)) \
        * (rho_water / rho_earth) * love
    beta_n[0] = 0.0
    if nmax >= 1:
        beta_n[1] = 0.0

    M = nmax + 1
    P = np.zeros((M, lat.shape[0], M))
    pinv = np.zeros((M, M, lat.shape[0]))
    beta = np.zeros((M, M))
    for m in range(M):
        cols = [Pnm[n, m] for n in range(m, M)]
        A = np.stack(cols, axis=1)               # (ny, n_modes)
        WA = w[:, None] * A
        gram = A.T @ WA
        # regularize: high degrees are poorly resolved on coarse grids
        gram += 1e-10 * np.eye(gram.shape[0]) * max(np.trace(gram), 1.0)
        Ainv = np.linalg.solve(gram, WA.T)       # (n_modes, ny)
        P[m, :, : M - m] = A
        pinv[m, : M - m, :] = Ainv
        beta[m, : M - m] = beta_n[m:]
    return SALHarmonics(P=jnp.asarray(P, dtype),
                        pinv=jnp.asarray(pinv, dtype),
                        beta=jnp.asarray(beta, dtype), nmax=nmax)


def calc_sal_harmonic(eta, sal: SALHarmonics):
    """eta (ny, nx) -> eta_sal (ny, nx); the calc_SAL role."""
    ny, nx = eta.shape
    F = jnp.fft.rfft(eta.astype(jnp.float32), axis=-1)   # (ny, nx//2+1)
    M = sal.nmax + 1
    Fm = F[:, :M]                                        # (ny, M)
    re = jnp.real(Fm).T                                  # (M, ny)
    im = jnp.imag(Fm).T
    # analysis -> Love scaling -> synthesis, batched over m
    hi = jax.lax.Precision.HIGHEST
    c_re = jnp.einsum("mnj,mj->mn", sal.pinv, re, precision=hi) * sal.beta
    c_im = jnp.einsum("mnj,mj->mn", sal.pinv, im, precision=hi) * sal.beta
    g_re = jnp.einsum("mjn,mn->mj", sal.P, c_re, precision=hi)  # (M, ny)
    g_im = jnp.einsum("mjn,mn->mj", sal.P, c_im, precision=hi)
    Fout = (g_re + 1j * g_im).T                          # (ny, M)
    Ffull = jnp.zeros_like(F).at[:, :M].set(Fout)
    return jnp.fft.irfft(Ffull, n=nx, axis=-1).astype(eta.dtype)
