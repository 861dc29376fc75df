"""Surface wave interface: Stokes drift profiles and Langmuir mixing.

Analogue of MOM6's wave interface (reference:
src/user/MOM_wave_interface.F90):

* ``WaveMethod`` family — LF17 (statistical wind-waves, Li & Fox-Kemper
  2017: :1338-1457), DHH85 (Donelan et al. 1985 spectrum, :1540-1596),
  SURFBANDS (banded surface Stokes drift with analytic layer averages,
  :763-1037) and the empirical u10 fallback (EFACTOR, :-99);
* COARE 3.5 u*→U10 inversion (ust_2_u10_coare3p5, :2045-2121) as a
  fixed-count Newton-style iteration (vectorized, jit-safe);
* surface-layer averaged Stokes drift and the turbulent Langmuir number
  La = sqrt(u*/u_s^SL) with optional shear/wave misalignment
  (get_Langmuir_Number, :1183-1295);
* the convectively modified Langmuir number and m* enhancement used by
  ePBL (mstar_Langmuir, MOM_energetic_PBL.F90:3616-3706) and the
  Li et al. 2016 velocity-scale enhancement used by KPP.

All routines are vectorized over (ny, nx) maps — the reference's
per-column loops become array expressions; the data-dependent COARE
iteration becomes a fixed 20-pass loop (converges in ~2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["WaveParams", "ust_to_u10_coare3p5", "stokes_sl_lf17",
           "dhh85_stokes_profile", "surfband_stokes_profile",
           "sl_average_profile", "langmuir_number", "make_la_fn",
           "convective_langmuir_number", "mstar_lt_enhancement",
           "langmuir_enhancement", "stokes_drift_profile"]

_G = 9.81


class WaveParams(NamedTuple):
    method: str = "LF17"           # LF17 | DHH85 | SURFBANDS | EFACTOR
    # Langmuir-number averaging (LA_DEPTH_RATIO / LA_DEPTH_MIN)
    la_frac_hbl: float = 0.04
    la_hbl_min: float = 0.1        # [m]
    la_min: float = 0.05           # La_min lower bound
    la_stk_backgnd: float = 1e-10  # [m s-1]
    # LF17 / COARE 3.5 constants (set_LF17_wave_params, :614-657)
    nu_air: float = 1.0e-6         # VISCOSITY_AIR [m2 s-1]
    von_kar: float = 0.40          # VON_KARMAN_WAVES
    rho_air: float = 1.225         # RHO_AIR [kg m-3]
    rho_ocn: float = 1035.0        # RHO_SFC_WAVES [kg m-3]
    swh_from_u10sq: float = 0.0246  # WAVE_HEIGHT_SCALE_FACTOR [s2 m-1]
    charnock_min: float = 0.028    # CHARNOCK_MIN
    charnock_slope_u10: float = 0.0017   # CHARNOCK_SLOPE_U10
    charnock_intercept: float = -0.005   # CHARNOCK_0_WIND_INTERCEPT
    # DHH85 spectrum (:234-241)
    wave_age: float = 1.2          # WAVE_AGE
    wave_wind: float = 10.0        # WAVE_WIND [m s-1]
    omega_min: float = 0.1         # [s-1]
    omega_max: float = 10.0        # [s-1]
    n_omega: int = 1000            # spectral bands (static)
    # SURFBANDS: per-band surface Stokes drift and central wavenumbers
    band_stokes_x: tuple = ()      # [m s-1]
    band_stokes_y: tuple = ()
    band_wavenumbers: tuple = ()   # [m-1]
    # ePBL m* enhancement (LT_ENHANCE*/LT_MOD_LAC*, ePBL :4198-4223)
    lt_enhance_coef: float = 0.447
    lt_enhance_exp: float = -1.33
    max_enhance_m: float = 5.0
    lac_mld_ek: float = -0.87      # LT_MOD_LAC1
    lac_mld_ob_stab: float = 0.0   # LT_MOD_LAC2
    lac_mld_ob_un: float = 0.0     # LT_MOD_LAC3
    lac_ek_ob_stab: float = 0.95   # LT_MOD_LAC4
    lac_ek_ob_un: float = 0.95     # LT_MOD_LAC5
    # misalignment between shear and waves (LA_MISALIGNMENT)
    misalignment: bool = False
    # empirical EFACTOR fallback (statistical equilibrium sea from u10)
    us0_per_u10: float = 0.016
    pm_peak_coef: float = 0.877    # PM peak frequency: w_p = coef*g/U10


def _one_minus_exp_x(x):
    """(1 - exp(-x))/x, stable for small x (one_minus_exp_x, :1040-1049)."""
    series = 1.0 - x * (0.5 - x * (1.0 / 6.0 - x / 24.0))
    safe = jnp.where(jnp.abs(x) > 1e-3, x, 1.0)
    return jnp.where(jnp.abs(x) > 1e-3, -jnp.expm1(-safe) / safe, series)


def ust_to_u10_coare3p5(ustar_water, p: WaveParams = WaveParams()):
    """10-m neutral wind from the waterside friction velocity via the
    COARE 3.5 Charnock-roughness relation (ust_2_u10_coare3p5,
    MOM_wave_interface.F90:2045-2121; Edson et al. 2013).

    Fixed 20-pass iteration (reference converges in ~2), vectorized."""
    ust_air = jnp.maximum(ustar_water, 1e-10) * jnp.sqrt(
        p.rho_ocn / p.rho_air)
    z0sm = 0.11 * p.nu_air / ust_air
    i_vonkar = 1.0 / p.von_kar

    def body(_, u10):
        alpha = jnp.minimum(p.charnock_min,
                            p.charnock_slope_u10 * u10
                            + p.charnock_intercept)
        z0 = z0sm + alpha * ust_air ** 2 / _G
        i_sqrt_cd = jnp.abs(jnp.log(z0 * 0.1)) * i_vonkar
        return ust_air * i_sqrt_cd

    u10 = jax.lax.fori_loop(0, 20, body, ust_air * jnp.sqrt(1000.0))
    return u10


def stokes_sl_lf17(ustar, hbl, p: WaveParams = WaveParams()):
    """Surface-layer averaged Stokes drift and Langmuir number from the
    wind alone (get_StokesSL_LiFoxKemper, :1338-1457; Li & Fox-Kemper
    2017 appendix, Phillips-spectrum profile of Breivik et al. 2016).

    ``hbl`` is the averaging depth (positive, already scaled by
    LA_DEPTH_RATIO by the caller).  Returns (us_sl [m s-1], La)."""
    from jax.scipy.special import erfc

    u10 = ust_to_u10_coare3p5(ustar, p)
    ustokes = 0.0162 * u10                     # us_to_u10
    hm0 = p.swh_from_u10sq * u10 ** 2          # significant wave height
    fp = 0.877 * _G / (2.0 * jnp.pi * 1.075 * u10)   # PM peak freq
    fm = 1.296 * fp                            # mean frequency
    # total Stokes transport with the r_loss directional-spread factor
    vstokes = 0.125 * jnp.pi * 0.667 * fm * hm0 ** 2
    kphil = 0.176 * ustokes / jnp.maximum(vstokes, 1e-30)

    z0 = jnp.abs(hbl)
    kz = kphil * z0
    # robust r1/r3/r5 expressions (answer_date >= 20230102 branch)
    r1 = (0.302 - 1.68 * kz) * _one_minus_exp_x(2.0 * kz)
    r3 = (0.1264 + 0.64 * kz) * _one_minus_exp_x(5.12 * kz)
    root_2kz = jnp.sqrt(2.0 * kz)
    rt = jnp.maximum(root_2kz, 1e-3)
    sqrt_pi = jnp.sqrt(jnp.pi)
    r5_big = sqrt_pi * (rt * (-0.84 * erfc(rt) + 0.2 * erfc(1.6 * rt))
                        + 0.1182 * (erfc(1.6 * rt) - erfc(rt)) / rt)
    r5_small = -0.64 * sqrt_pi * root_2kz + (
        -0.14184 + 1.0839648 * root_2kz ** 2)
    r5 = jnp.where(root_2kz > 1e-3, r5_big, r5_small)
    us_sl = ustokes * (0.715 + (r1 + r3) + r5)

    la = jnp.where((ustar > 0.0) & (us_sl > 0.0),
                   jnp.sqrt(jnp.maximum(ustar, 1e-10)
                            / jnp.maximum(us_sl, 1e-30)), 1.0e8)
    return us_sl, la


def dhh85_stokes_profile(z_mid, p: WaveParams = WaveParams()):
    """Stokes drift at depths ``z_mid`` (positive down) by integrating
    the Donelan-Hamilton-Hui 1985 frequency spectrum (DHH85_mid,
    :1540-1596).  The spectrum depends only on wave age/wind, so the
    bands reduce over a static n_omega axis."""
    domega = (p.omega_max - p.omega_min) / p.n_omega
    omega = p.omega_min + (jnp.arange(1, p.n_omega) - 0.5) * domega
    omega_peak = 2.0 * jnp.pi * 0.13 * _G / p.wave_wind
    ann = 0.006 * p.wave_age ** (-0.55)
    snn = 0.08 * (1.0 + 4.0 * p.wave_age ** 3)
    cnn = 1.7 if p.wave_age >= 1.0 else 1.7 - 6.0 * jnp.log10(p.wave_age)
    dnn = jnp.exp(-0.5 * (omega - omega_peak) ** 2
                  / (snn ** 2 * omega_peak ** 2))
    wavespec = (ann * _G ** 2 / (omega_peak * omega ** 4)) * \
        jnp.exp(-(omega_peak / omega) ** 4) * cnn ** dnn
    z = jnp.asarray(z_mid)[..., None]             # broadcast over bands
    stokes = 2.0 * wavespec * omega ** 3 * \
        jnp.exp(-2.0 * omega ** 2 * z / _G) / _G
    return jnp.sum(stokes * domega, axis=-1)


def surfband_stokes_profile(h, stk0, wavenumbers):
    """Layer-averaged Stokes drift from banded surface amplitudes
    (Update_Stokes_Drift SURFBANDS branch, :826-890): for each band the
    average of exp(2kz) over a layer [top, top-thick] is
    exp(2k top) (1-exp(-2k thick))/(2k thick).

    ``h``: (nz, ...) thicknesses; ``stk0``: per-band surface drift —
    scalars, a (nb,) tuple, or a coupler-supplied (nb, ny, nx) map
    (Sw_pstokes import); ``wavenumbers``: per-band central wavenumber.
    Returns (nz, ...)."""
    stk0 = jnp.asarray(stk0, h.dtype)
    if stk0.ndim > 1:          # (nb, ny, nx) -> (ny, nx, nb) for the
        stk0 = jnp.moveaxis(stk0, 0, -1)  # trailing band contraction
    wn = jnp.asarray(wavenumbers, h.dtype)
    top = jnp.concatenate([jnp.zeros_like(h[:1]),
                           jnp.cumsum(h, axis=0)[:-1]], axis=0)
    # (nz, ..., nb)
    twokt = 2.0 * wn * top[..., None]
    twokh = 2.0 * wn * h[..., None]
    cmn = jnp.exp(-twokt) * _one_minus_exp_x(twokh)
    return jnp.sum(stk0 * cmn, axis=-1)


def sl_average_profile(profile, h, avg_depth):
    """Depth-average of a layer profile over the top ``avg_depth`` m with
    partial-cell weighting (Get_SL_Average_Prof, :1460-1504).

    ``profile``/``h``: (nz, ...); ``avg_depth``: (...) positive."""
    bottom = jnp.cumsum(h, axis=0)
    top = bottom - h
    d = jnp.maximum(avg_depth, 1e-10)[None]
    w = jnp.clip(jnp.minimum(bottom, d) - top, 0.0, None)
    total = jnp.minimum(d[0], bottom[-1])
    return jnp.sum(profile * w, axis=0) / jnp.maximum(total, 1e-10)


def _misalignment_factor(us_x_sl, us_y_sl, u, v, h, avg_depth):
    """La divisor sqrt(max(eps, cos(wave_dir - shear_dir))) — the
    LA_MISALIGNMENT option of get_Langmuir_Number (:1224-1247,
    bug-fixed branch: shear direction from the first layer deeper than
    the averaging depth)."""
    z_mid = jnp.cumsum(h, axis=0) - 0.5 * h
    below = z_mid > jnp.maximum(avg_depth, 1e-10)[None]
    below = below.at[0].set(False)
    # first layer index beyond the averaging depth (default: deepest)
    nz = h.shape[0]
    idx = jnp.argmax(below, axis=0)
    idx = jnp.where(jnp.any(below, axis=0), idx, nz - 1)
    du = u[0] - jnp.take_along_axis(u, idx[None], axis=0)[0]
    dv = v[0] - jnp.take_along_axis(v, idx[None], axis=0)[0]
    shear_dir = jnp.arctan2(dv, du)
    wave_dir = jnp.arctan2(us_y_sl, us_x_sl)
    return jnp.sqrt(jnp.maximum(1e-8, jnp.cos(wave_dir - shear_dir)))


def la_from_efactor(lamult, p: WaveParams = WaveParams()):
    """Equivalent Langmuir number for a coupler-provided mixing
    enhancement factor (the Sw_lamult import of mom_cap.F90:873; the
    reference's EFACTOR wave method consumes the wave model's
    multiplier directly).  Inverts the ePBL enhancement law
    1 + c La^e so that mstar_lt_enhancement reproduces ``lamult``
    exactly under the default constants."""
    x = jnp.maximum(lamult - 1.0, 1e-8) / p.lt_enhance_coef
    la = x ** (1.0 / p.lt_enhance_exp)
    return jnp.maximum(la, p.la_min)


def langmuir_number(ustar, hbl=None, p: WaveParams = WaveParams(),
                    u10=None, h=None, u=None, v=None,
                    stk_x=None, stk_y=None, lamult=None):
    """Turbulent Langmuir number La = sqrt(u*/u_s^SL), with the Stokes
    drift averaged over max(LA_DEPTH_RATIO*hbl, LA_DEPTH_MIN)
    (get_Langmuir_Number, :1183-1295).  Dispatch on ``p.method``:

    * LF17 — wind-statistical surface-layer Stokes drift (no profile);
    * DHH85 — spectral profile at layer midpoints, then SL-averaged
      (needs ``h``);
    * SURFBANDS — banded layer-averaged profile (needs ``h`` and band
      data in ``p``); optional shear misalignment (needs ``u``, ``v``);
    * EFACTOR — empirical equilibrium-sea La from u10 alone (the
      round-2 fallback; needs ``u10``).

    Coupler overrides: ``lamult`` (a wave model's mixing-enhancement
    import) short-circuits everything; ``stk_x``/``stk_y`` replace the
    static SURFBANDS band amplitudes with dynamic (nb, ny, nx) maps.
    """
    method = p.method.upper()
    if lamult is not None:
        return la_from_efactor(lamult, p)
    if stk_x is not None:
        method = "SURFBANDS"
    if method == "EFACTOR" or (method != "LF17" and h is None):
        us0 = jnp.maximum(p.us0_per_u10 * u10, 1e-8)
        la = jnp.sqrt(jnp.maximum(ustar, 1e-8) / us0)
        return jnp.maximum(la, p.la_min)
    if hbl is None:
        raise ValueError("langmuir_number: hbl required for " + method)
    d_sl = jnp.maximum(p.la_frac_hbl * hbl, p.la_hbl_min)
    if method == "LF17":
        _, la = stokes_sl_lf17(ustar, d_sl, p)
        return jnp.maximum(la, p.la_min)
    if method == "DHH85":
        z_mid = jnp.cumsum(h, axis=0) - 0.5 * h
        prof = dhh85_stokes_profile(z_mid, p)
        us_sl = sl_average_profile(prof, h, d_sl)
        us_y_sl = jnp.zeros_like(us_sl)
    elif method == "SURFBANDS":
        bx = stk_x if stk_x is not None else p.band_stokes_x
        by = stk_y if stk_y is not None else p.band_stokes_y
        prof_x = surfband_stokes_profile(h, bx, p.band_wavenumbers)
        prof_y = surfband_stokes_profile(h, by, p.band_wavenumbers)
        us_sl = sl_average_profile(prof_x, h, d_sl)
        us_y_sl = sl_average_profile(prof_y, h, d_sl)
    else:
        raise ValueError(f"unknown WAVE_METHOD {p.method}")
    us_mag = jnp.sqrt(us_sl ** 2 + us_y_sl ** 2)
    la = jnp.sqrt(jnp.maximum(ustar, 1e-10)
                  / (us_mag + p.la_stk_backgnd))
    if p.misalignment and u is not None and v is not None:
        la = la / _misalignment_factor(us_sl, us_y_sl, u, v, h, d_sl)
    return jnp.maximum(la, p.la_min)


def make_la_fn(p: WaveParams, ustar, u10=None, h=None, u=None, v=None,
               stk_x=None, stk_y=None, lamult=None):
    """Closure ``la_fn(hbl) -> La`` for the boundary-layer schemes —
    KPP/ePBL evaluate the Langmuir number at their own (iterated)
    boundary-layer depth, as the reference does by calling
    get_Langmuir_Number from inside KPP_compute_BLD / ePBL_column.
    ``stk_x``/``stk_y``/``lamult`` carry coupler wave imports."""
    def la_fn(hbl):
        return langmuir_number(ustar, hbl, p, u10=u10, h=h, u=u, v=v,
                               stk_x=stk_x, stk_y=stk_y, lamult=lamult)
    return la_fn


def convective_langmuir_number(la, bflux, ustar, bld, absf,
                               p: WaveParams = WaveParams()):
    """Langmuir number modified by convection and rotation via
    MLD/Ekman/Obukhov length-scale ratios (mstar_Langmuir,
    MOM_energetic_PBL.F90:3616-3695).  ``bflux`` > 0 stabilizing."""
    max_ratio = 1.0e16
    us = jnp.maximum(ustar, 1e-10)
    i_f = jnp.where(absf > 0.0, 1.0 / jnp.maximum(absf, 1e-20), 0.0)
    ek_ob = jnp.minimum(jnp.abs(bflux * p.von_kar) * i_f / us ** 2,
                        max_ratio)
    mld_ob = jnp.minimum(jnp.abs(bld * bflux * p.von_kar) / us ** 3,
                         max_ratio)
    mld_ek = jnp.minimum(bld * absf / us, max_ratio)
    stab = bflux > 0.0
    ek_ob_stab = jnp.where(stab, ek_ob, 0.0)
    ek_ob_un = jnp.where(stab, 0.0, ek_ob)
    mld_ob_stab = jnp.where(stab, mld_ob, 0.0)
    mld_ob_un = jnp.where(stab, 0.0, mld_ob)
    return la * ((1.0 + jnp.maximum(-0.5, p.lac_mld_ek * mld_ek))
                 + ((p.lac_ek_ob_stab * ek_ob_stab
                     + p.lac_ek_ob_un * ek_ob_un)
                    + (p.lac_mld_ob_stab * mld_ob_stab
                       + p.lac_mld_ob_un * mld_ob_un)))


def mstar_lt_enhancement(la_conv, p: WaveParams = WaveParams()):
    """Multiplicative m* enhancement from the (convectively modified)
    Langmuir number: min(MAX_ENHANCE_M, 1 + c La^e) with c=0.447,
    e=-1.33 (Langmuir_rescale branch, ePBL :3693-3697)."""
    la = jnp.maximum(la_conv, 1e-10)
    return jnp.minimum(p.max_enhance_m,
                       1.0 + p.lt_enhance_coef * la ** p.lt_enhance_exp)


def langmuir_enhancement(la_t):
    """KPP velocity-scale enhancement factor F(La_t), the Li et al. 2016
    fit (MOM_CVMix_KPP's LT_K_ENHANCEMENT / EFactor):
    F = sqrt(1 + (1.5 La)^-2 + (5.4 La)^-4), capped."""
    la = jnp.maximum(la_t, 0.1)
    f = jnp.sqrt(1.0 + (1.5 * la) ** -2 + (5.4 * la) ** -4)
    return jnp.minimum(f, 5.0)


def stokes_drift_profile(u10, z_depth, p: WaveParams = WaveParams()):
    """Monochromatic-equivalent equilibrium-sea Stokes drift magnitude
    at depths ``z_depth`` (positive down) from the 10 m wind — the
    EFACTOR-mode profile: u_s(z) = 0.016 U10 exp(-2 k_p z) with the
    Pierson-Moskowitz peak wavenumber."""
    us0 = p.us0_per_u10 * u10
    w_p = p.pm_peak_coef * _G / jnp.maximum(u10, 0.1)
    k_p = w_p * w_p / _G
    return us0 * jnp.exp(-2.0 * k_p * z_depth)
