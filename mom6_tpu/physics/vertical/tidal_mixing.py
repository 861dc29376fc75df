"""Tidal mixing: internal-tide energy input and its vertical deposition.

Re-design of MOM6's tidal mixing pair (reference:
src/parameterizations/vertical/MOM_internal_tide_input.F90:147-170, :563
for the TKE conversion E = min(0.5*kappa_h2_factor*rho0*kappa_itides*
h2*U_tide^2*N_b, TKE_max), and
src/parameterizations/vertical/MOM_tidal_mixing.F90:1040-1400 for the
St Laurent et al. (2002) exponential and Polzin (2009) WKB-stretched
algebraic deposition profiles).

Design: instead of the reference's per-column k-loops with running
remainders (TKE_itidal_rem), both profiles are expressed through their
cumulative "fraction of bottom TKE passing above height z" function F(z):

  St Laurent:  F(z) = Inv_int * exp(-z / zeta),
               Inv_int = 1 / (1 - exp(-H / zeta))
  Polzin 09:   F(z) = Inv_int * z0 / (z0 + z_WKB(z)),
               Inv_int = z0 / H_WKB + 1,
               z_WKB(z) = int_0^z N^2 dz' / mean(N^2)

so the energy deposited in a layer is TKE_bot * (F(z_bot) - F(z_top)),
computed for all layers at once with reversed cumulative sums.  Both
normalizations make the column-integrated deposit exactly TKE_bot
(tested).  The layer energy converts to a diffusivity through
Kd = Gamma * TKE_lay / (dz * (N^2 + Omega^2)) (the TKE_to_Kd role,
MOM_set_diffusivity.F90) and is split half/half onto the bounding
interfaces (MOM_tidal_mixing.F90:1300-1305).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

__all__ = ["TidalMixingParams", "int_tide_input_tke", "tidal_mixing_kd"]

_OMEGA = 7.2921e-5        # Earth rotation [s-1]; N^2 floor in TKE_to_Kd
_H_EPS = 1e-3


class TidalMixingParams(NamedTuple):
    """Defaults follow the reference's documented defaults
    (MOM_tidal_mixing.F90 get_param calls)."""
    profile: str = "STLAURENT_02"       # or "POLZIN_09"
    int_tide_decay_scale: float = 500.0  # zeta [m] (INT_TIDE_DECAY_SCALE)
    mu_itides: float = 0.2               # mixing efficiency Gamma (MU_ITIDES)
    gamma_itides: float = 0.3333         # local dissipation fraction q
    kappa_itides: float = 2.0 * 3.141592653589793 / 1.25e5  # topo wavenumber
    kappa_h2_factor: float = 0.85        # KAPPA_H2_FACTOR
    utide: float = 0.0                   # fallback tidal amplitude [m s-1]
    h2: float = 100.0                    # fallback roughness variance [m2]
    tke_itide_max: float = 1e3           # cap on conversion [W m-2]
    kd_max: float = 50e-4                # cap on the added diffusivity
    bbl_thick: float = 100.0             # bottom layer for N_b average [m]
    # Polzin (2009) constants (NU_POLZIN, NBOTREF_POLZIN, ...)
    nu_polzin: float = 0.0697
    nbotref_polzin: float = 9.61e-4
    polzin_decay_scale_factor: float = 1.0
    polzin_decay_scale_max_factor: float = 1.0
    polzin_min_decay_scale: float = 0.0


def _layer_n2(h, T, S, G, GV, eos):
    """Layer-centred N^2 (nz, ny, nx) from interior interface values."""
    from mom6_tpu.physics.vertical.set_diffusivity import find_n2
    n2_int = find_n2(h, T, S, G, GV, eos)            # (nz-1, ny, nx)
    n2_ext = jnp.concatenate([n2_int[:1], n2_int, n2_int[-1:]], axis=0)
    return 0.5 * (n2_ext[:-1] + n2_ext[1:])


def _bottom_n2(h, n2_lay, p: TidalMixingParams):
    """N^2 averaged over the bottom ``bbl_thick`` metres of each column
    (the find_N2_bottom role, MOM_internal_tide_input.F90:211-344)."""
    # height of layer tops/bottoms above the seafloor
    z_top_fb = jnp.cumsum(h[::-1], axis=0)[::-1]        # top of layer k
    z_bot_fb = z_top_fb - h
    ov = (jnp.minimum(z_top_fb, p.bbl_thick)
          - jnp.minimum(z_bot_fb, p.bbl_thick))
    wsum = jnp.maximum(jnp.sum(ov, axis=0), _H_EPS)
    return jnp.sum(n2_lay * ov, axis=0) / wsum


def int_tide_input_tke(h, T, S, G, GV, eos, p: TidalMixingParams,
                       h2=None, tideamp=None):
    """Barotropic-to-internal tide conversion [W m-2] and bottom N.

    E = min(0.5 * kappa_h2_factor * rho0 * kappa_itides * h2 * U^2 * N_b,
            TKE_max); cf. MOM_internal_tide_input.F90:155, :563."""
    h2 = p.h2 if h2 is None else h2
    tideamp = p.utide if tideamp is None else tideamp
    n2_lay = _layer_n2(h, T, S, G, GV, eos)
    nb = jnp.sqrt(_bottom_n2(h, n2_lay, p))
    coef = 0.5 * p.kappa_h2_factor * GV.rho0 * p.kappa_itides
    tke = jnp.minimum(coef * h2 * tideamp ** 2 * nb, p.tke_itide_max)
    return tke * G.mask2dT, nb


def _deposit_fractions(h, n2_lay, nb, p: TidalMixingParams,
                       h2, tideamp):
    """F(z_bot) - F(z_top) per layer: fraction of the bottom TKE flux
    deposited in each layer, (nz, ny, nx), column sum == 1."""
    dztot = jnp.maximum(jnp.sum(h, axis=0), _H_EPS)
    z_top_fb = jnp.cumsum(h[::-1], axis=0)[::-1]
    z_bot_fb = z_top_fb - h

    prof = p.profile.upper()
    if prof not in ("STLAURENT_02", "POLZIN_09"):
        raise ValueError(f"INT_TIDE_PROFILE={p.profile!r}: expected "
                         "STLAURENT_02 or POLZIN_09")
    if prof == "POLZIN_09":
        n2_meanz = jnp.maximum(jnp.sum(n2_lay * h, axis=0) / dztot, 1e-14)
        # WKB-stretched height above bottom at layer tops/bottoms
        dzwkb = h * n2_lay / n2_meanz[None]
        zw_top = jnp.cumsum(dzwkb[::-1], axis=0)[::-1]
        zw_bot = zw_top - dzwkb
        hwkb = jnp.maximum(zw_top[0], 1e-10)
        # scaled decay height z0 (MOM_tidal_mixing.F90:1157-1173, the
        # answer-date >= 2019 branch): num / denom, capped at
        # max_factor * H
        num = (p.polzin_decay_scale_factor * p.nu_polzin
               * p.nbotref_polzin ** 2) * tideamp
        denom = p.kappa_itides ** 2 * h2 * jnp.maximum(nb, 1e-10) * n2_meanz
        z0s_raw = num / jnp.maximum(denom, 1e-30)
        cap = p.polzin_decay_scale_max_factor * dztot
        z0s = jnp.where((tideamp > 0.0) & (z0s_raw < cap), z0s_raw, cap)
        z0s = jnp.maximum(z0s, p.polzin_min_decay_scale)
        inv_int = z0s / hwkb + 1.0
        f_top = inv_int[None] * z0s[None] / (z0s[None] + zw_top)
        f_bot = inv_int[None] * z0s[None] / (z0s[None] + zw_bot)
        return f_bot - f_top

    # St Laurent et al 2002 exponential (MOM_tidal_mixing.F90:1090-1111,
    # 1268-1279)
    izeta = 1.0 / max(p.int_tide_decay_scale, 1e-6)
    denom = 1.0 - jnp.exp(-izeta * dztot)
    inv_int = jnp.where(denom > 1e-14, 1.0 / jnp.maximum(denom, 1e-14), 1.0)
    f_top = inv_int[None] * jnp.exp(-izeta * z_top_fb)
    f_bot = inv_int[None] * jnp.exp(-izeta * z_bot_fb)
    return f_bot - f_top


def tidal_mixing_kd(h, T, S, G, GV, eos, p: TidalMixingParams,
                    h2=None, tideamp=None,
                    tke_input: Optional[jnp.ndarray] = None):
    """Interface diffusivity (nz+1, ny, nx) [m2 s-1] from tidal dissipation.

    ``tke_input`` overrides the internally computed conversion [W m-2]
    (e.g. to feed a read-in energy-flux climatology)."""
    h2 = p.h2 if h2 is None else h2
    tideamp = p.utide if tideamp is None else tideamp
    n2_lay = _layer_n2(h, T, S, G, GV, eos)
    nb2 = _bottom_n2(h, n2_lay, p)
    nb = jnp.sqrt(nb2)
    if tke_input is None:
        coef = 0.5 * p.kappa_h2_factor * GV.rho0 * p.kappa_itides
        tke_input = jnp.minimum(coef * h2 * tideamp ** 2 * nb,
                                p.tke_itide_max)
    # bottom TKE available for local mixing [m3 s-3]
    # (Mu * Gamma scaling, MOM_tidal_mixing.F90:1240)
    tke_bot = (p.mu_itides * p.gamma_itides) * tke_input / GV.rho0

    frac = _deposit_fractions(h, n2_lay, nb, p, h2, tideamp)
    tke_lay = tke_bot[None] * frac
    # TKE -> Kd: Kd = TKE / (dz * (N^2 + Omega^2)) (TKE_to_Kd role)
    dz = jnp.maximum(h, _H_EPS)
    kd_lay = tke_lay / (dz * (n2_lay + _OMEGA ** 2))
    kd_lay = jnp.clip(kd_lay, 0.0, p.kd_max)
    # half/half to bounding interfaces
    kd_int = jnp.zeros((h.shape[0] + 1,) + h.shape[1:], h.dtype)
    kd_int = kd_int.at[:-1].add(0.5 * kd_lay).at[1:].add(0.5 * kd_lay)
    kd_int = kd_int.at[0].set(0.0).at[-1].set(0.0)
    return kd_int * G.mask2dT[None]
