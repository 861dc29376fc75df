"""Horizontal (lateral) viscosity: Laplacian + biharmonic friction.

Re-design of MOM6's hor_visc (reference:
src/parameterizations/lateral/MOM_hor_visc.F90: horizontal_viscosity :266;
scheme flags :41-78): the stress-tensor formulation on the C-grid with

* horizontal tension  sh_xx = du/dx - dv/dy at h points,
* horizontal shear    sh_xy = dv/dx + du/dy at q points (no-slip via masks),
* Smagorinsky (KH = (C dx)^2 |S|) and/or Leith (KH = C dx^3 |grad zeta|)
  dynamic coefficients plus constant KH/AH,
* biharmonic friction as the same stress operator applied to -del2(u),
* a stability bound on the coefficients (hor_visc's Kh bounds).

Everything is fused elementwise work; the thickness-weighted stress
divergence conserves momentum and vanishes on masked land."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from mom6_tpu.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["HorViscParams", "horizontal_viscosity"]


class HorViscParams(NamedTuple):
    kh: float = 0.0            # constant Laplacian viscosity [m2 s-1]
    ah: float = 0.0            # constant biharmonic viscosity [m4 s-1]
    smag_lap_const: float = 0.0    # Smagorinsky C for Laplacian (~0.15)
    smag_bi_const: float = 0.0     # Smagorinsky C for biharmonic (~0.06)
    leith_lap_const: float = 0.0   # Leith C (~1.0)
    # QG Leith (USE_QG_LEITH_VISC): the Leith vorticity gradient uses the
    # QG (absolute) vorticity zeta + f, capped by the relative-vorticity
    # gradient (the min(grad_vort, grad_vort_qg) of MOM_hor_visc.F90:1141;
    # the reference's full stretching term from VarMix slopes is folded
    # into the planetary-gradient part here)
    use_qg_leith: bool = False
    # anisotropic viscosity (ANISOTROPIC_VISCOSITY / ANISOTROPIC_MODE):
    # an extra Kh_aniso acting only along the direction n, with the
    # reference's 2*n1*n2 / (n1^2-n2^2) direction-tensor algebra
    # (MOM_hor_visc.F90:1216-1290, :1665-1733, align_* :3318)
    kh_aniso: float = 0.0      # [m2 s-1]
    aniso_mode: int = 0        # 0: fixed direction aniso_n; 2: along flow
    aniso_n: tuple = (1.0, 0.0)
    bound_coef: bool = True
    dt: float = 0.0            # needed for the stability bound


def _strains(u, v, G):
    """(sh_xx at h, sh_xy at q) with no-slip land handled by the q mask."""
    ku = "u" if getattr(G, "fold_north", False) else None
    sh_xx = ((u - im1(u)) * G.IdxT - (v - jm1(v)) * G.IdyT) * G.mask2dT
    sh_xy = ((ip1(v) - v) / G.dxBu + (jp1(u, ku) - u) / G.dyBu) \
        * G.mask2dBu
    return sh_xx, sh_xy


def _stress_accel(h, str_xx, str_xy, G):
    """Thickness-weighted divergence of the deviatoric stress tensor.

    h at corners is the HARMONIC mean of the 4 surrounding cells (as the
    reference does): if any neighbor is a vanished layer the corner stress
    carries negligible thickness, so dividing by the (floored) face
    thickness cannot manufacture huge accelerations at thin layers over
    topography."""
    eps = 1e-10
    kh = "h" if getattr(G, "fold_north", False) else None
    jh = jp1(h, kh)
    h_q = 4.0 / (1.0 / (h + eps) + 1.0 / (ip1(h) + eps)
                 + 1.0 / (jh + eps) + 1.0 / (ip1(jh) + eps))
    h_u = jnp.maximum(0.5 * (h + ip1(h)), 1e-3)
    h_v = jnp.maximum(0.5 * (h + jh), 1e-3)
    fx = ((ip1(h * str_xx) - h * str_xx) * G.IdxCu
          + (h_q * str_xy - jm1(h_q * str_xy)) * G.IdyCu)
    # str_xx is rotation-invariant (both tensor indices flip): kind "h"
    fy = (-(jp1(h * str_xx, kh) - h * str_xx) * G.IdyCv
          + (h_q * str_xy - im1(h_q * str_xy)) * G.IdxCv)
    du = fx / h_u * G.mask2dCu
    dv = fy / h_v * G.mask2dCv
    return du, dv


def _coefficients(u, v, sh_xx, sh_xy, G, p: HorViscParams):
    """Dynamic Laplacian/biharmonic coefficients at h and q points."""
    dx2 = G.dxT * G.dyT            # grid area scale
    # |S| at h points: tension local, shear averaged from corners
    sh_xy_h = 0.25 * ((sh_xy + im1(sh_xy)) + (jm1(sh_xy) + im1(jm1(sh_xy))))
    shear_mag = jnp.sqrt(sh_xx * sh_xx + sh_xy_h * sh_xy_h)

    kh = jnp.full_like(sh_xx, p.kh)
    if p.smag_lap_const:
        kh = kh + (p.smag_lap_const ** 2) * dx2 * shear_mag
    if p.leith_lap_const:
        # |grad zeta| at h points
        ku = "u" if getattr(G, "fold_north", False) else None
        zeta = ((ip1(v) - v) / G.dxBu - (jp1(u, ku) - u) / G.dyBu) \
            * G.mask2dBu
        zeta_h = 0.25 * ((zeta + im1(zeta)) + (jm1(zeta) + im1(jm1(zeta))))
        dzx = (zeta_h - im1(zeta_h)) * G.IdxT
        dzy = (zeta_h - jm1(zeta_h)) * G.IdyT
        grad_zeta = jnp.sqrt(dzx * dzx + dzy * dzy)
        if p.use_qg_leith:
            # QG Leith: the gradient of the ABSOLUTE (QG) vorticity
            # zeta + f, capped by the relative gradient so planetary
            # beta cannot dominate in quiescent flow
            # (min(grad_vort, grad_vort_qg), MOM_hor_visc.F90:1141)
            f_q = G.CoriolisBu
            f_h = 0.25 * ((f_q + im1(f_q)) + (jm1(f_q) + im1(jm1(f_q))))
            za = zeta_h + f_h
            dax = (za - im1(za)) * G.IdxT
            day = (za - jm1(za)) * G.IdyT
            grad_qg = jnp.sqrt(dax * dax + day * day)
            grad_zeta = jnp.minimum(grad_zeta, grad_qg)
        kh = kh + (p.leith_lap_const ** 3 / 3.14159 ** 3) * \
            dx2 * jnp.sqrt(dx2) * grad_zeta

    ah = jnp.full_like(sh_xx, p.ah)
    if p.smag_bi_const:
        ah = ah + (p.smag_bi_const ** 2) * dx2 * dx2 * shear_mag

    if p.bound_coef and p.dt > 0.0:
        # explicit diffusion stability: KH < 1/(4 dt (Idx^2+Idy^2))
        denom = G.IdxT ** 2 + G.IdyT ** 2
        kh = jnp.minimum(kh, 0.2 / (p.dt * denom))
        ah = jnp.minimum(ah, 0.2 / (p.dt * denom * denom * 16.0))
    return kh, ah


def _lap_uv(u, v, h, G):
    """Vector Laplacian of (u, v) via the unit-coefficient stress operator."""
    sh_xx, sh_xy = _strains(u, v, G)
    return _stress_accel(h, sh_xx, sh_xy, G)


def horizontal_viscosity(u, v, h, G, p: HorViscParams,
                         ku_backscatter=None, kh_scale=None
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Frictional accelerations (diffu, diffv) [m s-2] on (nz, ny, nx).

    ``ku_backscatter``: optional (ny, nx) NEGATIVE-viscosity amplitude
    from MEKE (MEKE_VISCOSITY_COEFF_KU, MOM_hor_visc.F90's m_leithy /
    MEKE backscatter path): subtracted from the Laplacian coefficient so
    sub-grid eddy energy is returned to the resolved flow; the net
    coefficient is bounded by the explicit stability limit on BOTH
    signs."""
    sh_xx, sh_xy = _strains(u, v, G)
    kh_h, ah_h = _coefficients(u, v, sh_xx, sh_xy, G, p)
    if kh_scale is not None:
        # resolution-function scaling (RESOLN_SCALED_KH,
        # MOM_lateral_mixing_coeffs.F90 Res_fn_h)
        kh_h = kh_h * kh_scale
    if p.kh_aniso > 0.0:
        # direction tensor: s2t = 2 n1 n2 (sin 2theta), c2t = n1^2-n2^2
        if p.aniso_mode == 2:
            # flow-aligned, per layer (dynamic_aniso)
            u_h = 0.5 * (u + im1(u))
            v_h = 0.5 * (v + jm1(v))
            mag2 = jnp.maximum(u_h ** 2 + v_h ** 2, 1e-20)
            s2t_h = 2.0 * u_h * v_h / mag2
            c2t_h = (u_h ** 2 - v_h ** 2) / mag2
            u_q = 0.5 * (u + jp1(u, "u" if kfold else None))
            v_q = 0.5 * (v + ip1(v))
            mag2q = jnp.maximum(u_q ** 2 + v_q ** 2, 1e-20)
            s2t_q = 2.0 * u_q * v_q / mag2q
            c2t_q = (u_q ** 2 - v_q ** 2) / mag2q
        else:
            n1, n2 = p.aniso_n
            inv = 1.0 / max(n1 * n1 + n2 * n2, 1e-20)
            s2t_h = s2t_q = 2.0 * n1 * n2 * inv
            c2t_h = c2t_q = (n1 * n1 - n2 * n2) * inv
    if ku_backscatter is not None:
        kh_h = kh_h - ku_backscatter
        if p.dt > 0.0:
            denom = G.IdxT ** 2 + G.IdyT ** 2
            bound = 0.2 / (p.dt * denom)
            kh_h = jnp.clip(kh_h, -bound, bound)
    kfold = "h" if getattr(G, "fold_north", False) else None
    jkh = jp1(kh_h, kfold)
    kh_q = 0.25 * ((kh_h + ip1(kh_h)) + (jkh + ip1(jkh)))
    if p.kh_aniso > 0.0:
        # tension part at h, shear part at q — each added AFTER the q
        # interpolation so the anisotropy is not smeared isotropic
        # (the reference adds them to the independently-built h and q
        # coefficients, :1219 and :1668)
        kh_h = kh_h + p.kh_aniso * (1.0 - s2t_h ** 2)
        kh_q = kh_q + p.kh_aniso * (s2t_q ** 2)

    diffu = jnp.zeros_like(u)
    diffv = jnp.zeros_like(v)

    str_xx = kh_h * sh_xx
    str_xy = kh_q * sh_xy
    if p.kh_aniso > 0.0:
        # shear part of the anisotropic viscosity into the q stress, plus
        # the tension<->shear cross terms (str_xx :1289, str_xy :1733)
        sh_xy_h = 0.25 * ((sh_xy + im1(sh_xy))
                          + (jm1(sh_xy) + im1(jm1(sh_xy))))
        jxx = jp1(sh_xx, kfold)
        sh_xx_q = 0.25 * ((sh_xx + ip1(sh_xx)) + (jxx + ip1(jxx)))
        str_xx = str_xx - p.kh_aniso * s2t_h * c2t_h * sh_xy_h
        str_xy = str_xy - p.kh_aniso * s2t_q * c2t_q * sh_xx_q
    if p.kh or p.smag_lap_const or p.leith_lap_const or p.kh_aniso \
            or ku_backscatter is not None:
        du, dv = _stress_accel(h, str_xx, str_xy, G)
        diffu = diffu + du
        diffv = diffv + dv

    if p.ah or p.smag_bi_const:
        lap_u, lap_v = _lap_uv(u, v, h, G)
        sh2_xx, sh2_xy = _strains(lap_u, lap_v, G)
        jah = jp1(ah_h, kfold)
        ah_q = 0.25 * ((ah_h + ip1(ah_h)) + (jah + ip1(jah)))
        du, dv = _stress_accel(h, ah_h * sh2_xx, ah_q * sh2_xy, G)
        diffu = diffu - du   # biharmonic: minus the double Laplacian
        diffv = diffv - dv

    return diffu, diffv
