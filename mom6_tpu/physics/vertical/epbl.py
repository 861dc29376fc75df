"""Energetically-constrained planetary boundary layer (ePBL).

Re-design of MOM6's energetic_PBL (reference:
src/parameterizations/vertical/MOM_energetic_PBL.F90, Reichl & Hallberg
2018): the boundary-layer depth is set by an integrated TKE budget —
mechanical energy input m* u*^3 (plus the n* fraction of convectively
released energy) is consumed by the potential-energy cost of mixing
against stratification, marching downward until exhausted.

Structure mirrors the reference's, with its data-dependent per-column
loops recast as fixed-count constructs:

* ``find_mstar``: the RH18 m* machinery —
    m*_N = cN1 * M / (1 + M),  M = cN2 exp(cN3 |f| H / u*)   (:3583-3587)
    m*_S = cS1 (max(0,B)^2 H / (u*^5 max(|f|,eps)))^cS2
    m* = (m*_N + m*_S) * convective reduction (:3595-3610), and a
  Langmuir factor; also the fixed-m* and OM4/Ekman schemes;
* a TKE-budget march down the column (lax.scan): mechanical TKE decays
  by exp(-TKE_DECAY h/H) per layer, convective PE release accumulates,
  and each interface consumes the PE cost of mixing across it; the MLD
  is the (fractional) depth where the budget runs dry — replacing the
  reference's data-dependent per-column search;
* the MLD-dependent m* feedback is closed with a FIXED-count outer
  iteration (USE_MLD_ITERATION analogue, default 3 passes);
* diffusivity from the RH18 velocity scale and mixing length (:1527-1545):
    vstar  = vstar_scale_fac * SurfScale * (vstar_surf_fac u* + w*),
    SurfScale = max(0.05, 1 - z/H),  w* = (wstar_ustar_coef max(0,-B) H)^1/3
    mixlen = max(l_min, z_eff vstar / (Ekman_coef |f| z_eff + vstar))
    Kd = vonKar * vstar * mixlen * shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = ["EPBLParams", "epbl_diffusivity", "find_mstar"]

_EPS = 1e-10
_VONKAR = 0.41


class EPBLParams(NamedTuple):
    mstar_scheme: str = "RH18"   # RH18 | FIXED | OM4 (EPBL_MSTAR_SCHEME)
    fixed_mstar: float = 1.2     # MSTAR (fixed scheme)
    # RH18 coefficients (reference defaults :3897-3918)
    rh18_cn1: float = 0.275
    rh18_cn2: float = 8.0
    rh18_cn3: float = -5.0
    rh18_cs1: float = 0.2
    rh18_cs2: float = 0.4
    # OM4/Ekman scheme coefficients
    mstar_coef: float = 0.3      # MSTAR_COEF
    c_ek: float = 0.085          # C_EK
    mstar_cap: float = -1.0      # MSTAR_CAP (<0: none)
    mstar_conv_adj: float = 0.0  # MSTAR_CONV_ADJ
    nstar: float = 0.2           # NSTAR
    tke_decay: float = 2.5       # TKE_DECAY
    wstar_ustar_coef: float = 1.0   # WSTAR_USTAR_COEF
    vstar_scale_fac: float = 1.0    # EPBL_VEL_SCALE_FACTOR
    vstar_surf_fac: float = 1.2     # VSTAR_SURF_FAC
    ekman_scale_coef: float = 1.0   # EKMAN_SCALE_COEF
    mix_len_exp: float = 2.0        # MIX_LEN_EXPONENT
    min_mix_len: float = 0.0        # EPBL_MIN_MIX_LEN
    n_iter: int = 3                 # fixed MLD-feedback iterations
    min_mld: float = 1.0
    kd_max: float = -1.0            # <0: no cap


def find_mstar(bflux, ustar, bld, absf, p: EPBLParams, lang_enh=None):
    """m* (mixing energy / u*^3) — Find_Mstar,
    MOM_energetic_PBL.F90:3519-3615.  ``bflux`` > 0 is stabilizing."""
    us = jnp.maximum(ustar, 1e-10)
    f = jnp.maximum(absf, 1e-20)
    if p.mstar_scheme.upper() == "FIXED":
        mstar = jnp.full_like(us, p.fixed_mstar)
    elif p.mstar_scheme.upper() == "OM4":
        mstar_s = p.mstar_coef * jnp.sqrt(
            jnp.maximum(0.0, bflux) / (us ** 2 * f))
        ratio = us / (f * jnp.maximum(bld, 1e-3))
        mstar_n = jnp.where(ratio > 1.0, p.c_ek * jnp.log(ratio), 0.0)
        mstar = jnp.maximum(mstar_s, jnp.minimum(1.25, mstar_n))
    else:  # RH18
        msn = p.rh18_cn2 * jnp.exp(
            jnp.clip(p.rh18_cn3 * bld * absf / us, -40.0, 0.0))
        mstar_n = (p.rh18_cn1 * msn) / (1.0 + msn)
        # (B^2 bld / (us^5 f))^cs2 computed as (B^2 bld/f)^cs2 / us^2
        # (cs2 = 0.4): us^5 underflows float32 for us ~ 1e-10 and the
        # resulting 0/0 NaN would poison the whole column
        mstar_s = p.rh18_cs1 * (jnp.maximum(0.0, bflux) ** 2 * bld
                                / f) ** p.rh18_cs2 / (us * us)
        mstar = mstar_n + mstar_s
    if p.mstar_cap > 0.0:
        mstar = jnp.minimum(mstar, p.mstar_cap)
    # convective reduction of mechanical mixing (:3595-3610)
    if p.mstar_conv_adj > 0.0:
        t1 = -bld * jnp.minimum(0.0, bflux)
        t2 = 2.0 * mstar * us ** 3
        red = jnp.where(t2 > 0.0,
                        ((1.0 - p.mstar_conv_adj) * t1 + t2) / (t1 + t2),
                        1.0 - p.mstar_conv_adj)
        mstar = mstar * red
    if lang_enh is not None:
        # Langmuir enhancement of the mechanical input (mstar_Langmuir
        # role, simplified to the multiplicative Li et al. 2016 factor)
        mstar = mstar * lang_enh
    return mstar


def _march_mld(h, b_c, e0, conv_rate, p: EPBLParams, mld_guess, dt):
    """TKE-budget march down the column (the layer loop of energetic_PBL,
    vectorized over columns): returns the (fractional) depth where the
    budget is exhausted.  Energies in specific units [m3 s-2].

    ``b_c`` is the layer-center buoyancy [m s-2].  The PE cost of
    entraining layer k under a mixed layer of depth z is priced on the
    buoyancy difference between the CURRENT ML MEAN and that layer,
    cost = 1/2 max(b_ml - b_k, 0) h_k z  (the find_PE_chg structure of
    MOM_energetic_PBL.F90) — NOT on the local interface N^2, which
    vanishes in an already-mixed marginal column and would let the march
    run away one layer per call.  The convective release of the surface
    buoyancy loss mixed over depth z is 1/2 conv_rate z dt (centroid
    factor), accumulated layer by layer."""
    nz = h.shape[0]

    def body(carry, k):
        e_mech, conv, z, bsum = carry
        hk = h[k]
        # mechanical TKE decays across the layer (TKE_decay)
        e_mech = e_mech * jnp.exp(-p.tke_decay * hk
                                  / jnp.maximum(mld_guess, 1e-2))
        # convective PE released by mixing the surface buoyancy loss
        # down through this layer (centroid factor 1/2)
        conv = conv + 0.5 * conv_rate * hk * dt
        # cost of entraining layer k below the ML [0, z)
        b_ml = bsum / jnp.maximum(z, _EPS)
        db = jnp.maximum(b_ml - b_c[k], 0.0)
        cost = jnp.where(z > _EPS, 0.5 * db * hk * z, 0.0)
        avail = e_mech + p.nstar * conv
        frac = jnp.where(cost <= _EPS, 1.0,
                         jnp.clip(avail / jnp.maximum(cost, _EPS),
                                  0.0, 1.0))
        # consume from the mechanical pool first, then the convective one
        used = jnp.minimum(cost, avail)
        from_mech = jnp.minimum(used, e_mech)
        e_mech = e_mech - from_mech
        conv = conv - (used - from_mech) / jnp.maximum(p.nstar, _EPS)
        return (e_mech, conv, z + hk, bsum + b_c[k] * hk), frac

    zeros = jnp.zeros_like(h[0])
    _, fracs = jax.lax.scan(body, (e0, zeros, zeros, zeros),
                            jnp.arange(nz))
    # fracs[k] = penetration into layer k; the surface layer always
    # belongs to the ML, layer k joins to the extent every layer above
    # was fully entrained
    reach = jnp.cumprod(fracs[1:], axis=0)       # for layers 1..nz-1
    return h[0] + jnp.sum(h[1:] * reach, axis=0)


def epbl_diffusivity(h, T, S, G, GV, eos, taux, tauy, heat_flux,
                     p: EPBLParams = EPBLParams(), cp: float = 3991.87,
                     lang_enh=None, dt: float = 3600.0, la_fn=None,
                     waves=None,
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (kd (nz+1,ny,nx) [m2 s-1], mld (ny,nx) [m])."""
    from mom6_tpu.framework.stencil import im1, jm1

    tx = 0.5 * (taux + im1(taux))
    ty = 0.5 * (tauy + jm1(tauy))
    ustar = jnp.sqrt(jnp.sqrt(tx * tx + ty * ty) / GV.rho0)

    # buoyancy flux, positive = stabilizing (surface heating)
    if heat_flux is None:
        bflux = jnp.zeros_like(ustar)
    else:
        drho_dT, _ = eos.density_derivs(T[0], S[0], jnp.zeros_like(T[0]))
        bflux = -(GV.g_earth / GV.rho0) * drho_dT * heat_flux / \
            (GV.rho0 * cp)

    f_q = jnp.abs(G.CoriolisBu)
    absf = 0.25 * ((f_q + im1(jm1(f_q))) + (im1(f_q) + jm1(f_q)))

    # layer-center buoyancy from surface-referenced potential density
    # (anomaly form; the march prices entrainment on ML-mean-vs-layer
    # buoyancy differences — see _march_mld)
    z_int = jnp.cumsum(h, axis=0)
    rho_anom = eos.density(T, S, jnp.zeros_like(T), rho_ref=GV.rho0)
    b_c = -(GV.g_earth / GV.rho0) * rho_anom

    conv_rate = jnp.maximum(0.0, -bflux)      # destabilizing part [m2 s-3]
    col_depth = jnp.sum(h, axis=0)

    # fixed-count MLD/m* feedback iteration (USE_MLD_ITERATION analogue)
    mld = jnp.minimum(0.2 * col_depth, 50.0)
    for _ in range(p.n_iter):
        if la_fn is not None:
            # Langmuir number at this pass's MLD guess, convectively
            # modified, applied as the m* rescale (mstar_Langmuir,
            # MOM_energetic_PBL.F90:3616-3706) — re-evaluated each MLD
            # iteration as the reference does inside ePBL_column
            from mom6_tpu.physics.waves import (
                WaveParams, convective_langmuir_number,
                mstar_lt_enhancement)
            wp = waves if waves is not None else WaveParams()
            la = la_fn(mld)
            la_conv = convective_langmuir_number(la, bflux, ustar, mld,
                                                 absf, wp)
            lang_enh = mstar_lt_enhancement(la_conv, wp)
        mstar = find_mstar(bflux, ustar, mld, absf, p, lang_enh=lang_enh)
        e0 = mstar * ustar ** 3 * dt
        mld = _march_mld(h, b_c, e0, conv_rate, p, mld, dt)
        mld = jnp.clip(mld, p.min_mld, col_depth) * G.mask2dT \
            + p.min_mld * (1.0 - G.mask2dT)

    # --- RH18 diffusivity profile at interfaces --------------------------
    sigma = jnp.clip(z_int / jnp.maximum(mld[None], _EPS), 0.0, 1.0)
    surf_scale = jnp.maximum(0.05, 1.0 - sigma)
    wstar = (p.wstar_ustar_coef * conv_rate
             * jnp.maximum(mld, p.min_mld)) ** (1.0 / 3.0)
    vstar = p.vstar_scale_fac * surf_scale * (
        p.vstar_surf_fac * ustar[None] + wstar[None])
    shape = jnp.maximum(1.0 - sigma, 0.0) ** p.mix_len_exp
    z_eff = z_int * shape + 1e-3
    mixlen = jnp.maximum(
        p.min_mix_len,
        (z_eff * vstar) / (p.ekman_scale_coef * absf[None] * z_eff
                           + jnp.maximum(vstar, _EPS)))
    kd = _VONKAR * vstar * mixlen * (sigma < 1.0)
    if p.kd_max > 0.0:
        kd = jnp.minimum(kd, p.kd_max)
    kd_full = jnp.concatenate([jnp.zeros_like(kd[:1]), kd], axis=0)
    kd_full = kd_full.at[-1].set(0.0)
    return kd_full * G.mask2dT[None], mld
