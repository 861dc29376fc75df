"""Coriolis and kinetic-energy-gradient accelerations.

Re-design of MOM6's CorAdCalc (reference:
src/core/MOM_CoriolisAdv.F90:125; scheme flags :34-44): computes the
vortex-force form of momentum advection,

    du/dt +=  q * vh~   - d(KE)/dx
    dv/dt += -q * uh~   - d(KE)/dy

with q the potential vorticity at corner points and uh~/vh~ thickness fluxes
averaged to the corner.  Supported vorticity schemes:

* ``SADOURNY75_ENERGY`` (default) — energy-conserving (Sadourny 1975);
* ``SADOURNY75_ENSTRO`` — enstrophy-conserving;
* ``ARAKAWA_HSU90`` — energy & absolute-enstrophy conserving (Arakawa &
  Hsu 1990), the reference's 4-weight a/b/c/d corner-flux form
  (MOM_CoriolisAdv.F90:523-533, :683-686);
* ``ARAKAWA_LAMB81`` — energy & enstrophy conserving (Arakawa & Lamb
  1981), the 24-point weights plus the ep_u/ep_v pseudo-Coriolis terms
  (:534-541, :719-722, :843-845);
* ``ARAKAWA_LAMB_BLEND`` — AL81 blended toward AH90 and Sadourny energy
  where the corner thicknesses are strongly varying, bounding the
  effective Coriolis amplification by F_eff_max (:543-587).

All branches share one per-cell weight construction: the AH90 weights
are the AL81 weights with AL_wt=0, and Sadourny energy is Sad_wt=1, so
the blend is a pointwise interpolation — branchless and fused.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from mom6_tpu.framework.stencil import (im1, ip1, jm1, jp1,
                                        fold_ghost)

__all__ = ["coriolis_adv", "relative_vorticity", "kinetic_energy"]

SADOURNY75_ENERGY = "SADOURNY75_ENERGY"
ARAKAWA_HSU90 = "ARAKAWA_HSU90"
SADOURNY75_ENSTRO = "SADOURNY75_ENSTRO"
ARAKAWA_LAMB81 = "ARAKAWA_LAMB81"
AL_BLEND = "ARAKAWA_LAMB_BLEND"


def relative_vorticity(u, v, G):
    """Relative vorticity at q (NE corner) points: circulation / area."""
    ku = "u" if getattr(G, "fold_north", False) else None
    dvdx = ip1(v * G.dyCv) - v * G.dyCv
    dudy = jp1(u * G.dxCu, ku) - u * G.dxCu
    return (dvdx - dudy) * G.IareaBu * G.mask2dBu


def kinetic_energy(u, v, G):
    """KE per unit mass at h points (simple 2-point means; MOM6 KE_SCHEME
    KE_ARAKAWA uses area-weighted means — refinement deferred)."""
    u2 = 0.5 * (u * u + im1(u * u))
    v2 = 0.5 * (v * v + jm1(v * v))
    return 0.5 * (u2 + v2)


def _pv_at_q(u, v, h, G, GV):
    """Potential vorticity (f + zeta) / h_q with h_q an area-weighted 4-point
    thickness mean (hArea_q of MOM_CoriolisAdv.F90).  Returns (q, h_q)."""
    rv = relative_vorticity(u, v, G)
    kh = "h" if getattr(G, "fold_north", False) else None
    area_h = G.areaT * G.mask2dT
    ha = h * area_h
    # fold kinds compose only jp1-first (the ghost row then shifts in x)
    harea = ha + ip1(ha) + jp1(ha, kh) + ip1(jp1(ha, kh))
    area4 = (area_h + ip1(area_h) + jp1(area_h, kh)
             + ip1(jp1(area_h, kh)))
    h_q = harea / jnp.maximum(area4, 1e-30)
    return (G.CoriolisBu + rv) / jnp.maximum(h_q, GV.h_subroundoff), h_q


def _abcd_weights(q, al_wt, sad_wt):
    """Per-CELL corner-flux weights (the a/b/c/d of CorAdCalc, expressed
    cell-centrically): at h-cell (j,i) with corner PVs qNE=q, qNW=im1(q),
    qSE=jm1(q), qSW=im1(jm1(q)),

      A_w = Sad/4 qNW + (1-Sad)[(2-AL) qNW + AL qSE + 2(qNE+qSW)]/24

    (the weight a(I-1,j) of the reference, and cyclically for D_w, B, C).
    AL_wt=0, Sad_wt=0 reproduces ARAKAWA_HSU90; AL_wt=1 ARAKAWA_LAMB81;
    the blend interpolates all three (MOM_CoriolisAdv.F90:523-587).
    Returns (A_w, B, C, D_w): a(I,j) = ip1(A_w), d(I,j) = ip1(D_w)."""
    c24 = 1.0 / 24.0
    qNE, qNW = q, im1(q)
    qSE, qSW = jm1(q), im1(jm1(q))
    one_m_sad = 1.0 - sad_wt

    def w(q_main, q_opp, q_pair1, q_pair2):
        return sad_wt * 0.25 * q_main + one_m_sad * c24 * (
            ((2.0 - al_wt) * q_main + al_wt * q_opp)
            + 2.0 * (q_pair1 + q_pair2))

    A_w = w(qNW, qSE, qNE, qSW)
    D_w = w(qSW, qNE, qNW, qSE)
    B = w(qNE, qSW, qNW, qSE)
    C = w(qSE, qNW, qNE, qSW)
    return A_w, B, C, D_w


def _ep_terms(q, al_wt):
    """The Arakawa & Lamb pseudo-Coriolis ep_u/ep_v at h points
    (MOM_CoriolisAdv.F90:540-541), scaled by the blend weight."""
    c24 = 1.0 / 24.0
    d1 = q - im1(jm1(q))        # qNE - qSW
    d2 = im1(q) - jm1(q)        # qNW - qSE
    return al_wt * c24 * (d1 + d2), al_wt * c24 * (-d1 + d2)


def coriolis_adv(u, v, h, uh, vh, G, GV, *,
                 scheme: str = SADOURNY75_ENERGY,
                 f_eff_max_blend: float = 4.0,
                 wt_lin_blend: float = 0.125,
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accelerations (CAu, CAv) from PV flux + KE gradient.

    ``uh``/``vh`` are volume transports [m3 s-1] from continuity.
    """
    q, h_q = _pv_at_q(u, v, h, G, GV)

    if scheme == SADOURNY75_ENERGY:
        # CAu = mean over the 2 adjacent corners of [q * (2pt mean of vh)]
        qvh_q = q * 0.5 * (vh + ip1(vh))          # at q points
        cau = 0.5 * (qvh_q + jm1(qvh_q)) * G.IdxCu
        ku = "u" if getattr(G, "fold_north", False) else None
        quh_q = q * 0.5 * (uh + jp1(uh, ku))
        cav = -0.5 * (quh_q + im1(quh_q)) * G.IdyCv
    elif scheme == SADOURNY75_ENSTRO:
        # q averaged first (enstrophy form): CAu = q_u * vh_u
        q_u = 0.5 * (q + jm1(q))
        vh_u = 0.25 * ((vh + ip1(vh)) + (jm1(vh) + ip1(jm1(vh))))
        cau = q_u * vh_u * G.IdxCu
        ku = "u" if getattr(G, "fold_north", False) else None
        q_v = 0.5 * (q + im1(q))
        juh = jp1(uh, ku)
        uh_v = 0.25 * ((uh + juh) + (im1(uh) + im1(juh)))
        cav = -q_v * uh_v * G.IdyCv
    elif scheme in (ARAKAWA_HSU90, ARAKAWA_LAMB81, AL_BLEND):
        if scheme == ARAKAWA_HSU90:
            al_wt, sad_wt = 0.0, 0.0
        elif scheme == ARAKAWA_LAMB81:
            al_wt, sad_wt = 1.0, 0.0
        else:
            # per-cell blend weights from the ratio of the corner inverse
            # thicknesses (MOM_CoriolisAdv.F90:550-573): AL81 where the
            # corners are uniform, then AH90, then Sadourny energy where
            # the amplification would exceed F_eff_max
            ih = 1.0 / jnp.maximum(h_q, GV.h_subroundoff)
            corners = jnp.stack([ih, im1(ih), jm1(ih), im1(jm1(ih))])
            min_ih = jnp.min(corners, axis=0)
            max_ih = jnp.max(corners, axis=0)
            rat_m1 = jnp.where(max_ih < 1.0e15 * min_ih,
                               max_ih / jnp.maximum(min_ih, 1e-30) - 1.0,
                               1.0e15)
            fe_m2 = f_eff_max_blend - 2.0
            wl = min(max(wt_lin_blend, 1.0e-16), 1.0)
            rat_lin = 1.5 * fe_m2 / wl
            if f_eff_max_blend <= 2.0:
                fe_m2, rat_lin = -1.0, -1.0
            al_wt = jnp.clip(jnp.where(
                rat_m1 <= fe_m2, 1.0,
                3.0 * fe_m2 / jnp.maximum(rat_m1, 1e-30) - 2.0), 0.0, 1.0)
            sad_wt = jnp.where(
                rat_m1 <= 1.5 * fe_m2, 0.0,
                jnp.where(rat_m1 <= rat_lin,
                          1.0 - (1.5 * fe_m2) / jnp.maximum(rat_m1, 1e-30),
                          jnp.where(rat_m1 < 2.0 * rat_lin,
                                    1.0 - (wl / rat_lin)
                                    * (rat_m1 - 2.0 * rat_lin), 1.0)))
            sad_wt = jnp.clip(sad_wt, 0.0, 1.0)
        A_w, B, C, D_w = _abcd_weights(q, al_wt, sad_wt)
        a, d = ip1(A_w), ip1(D_w)
        # CAu(I,j) = a*vh(i+1,J) + b*vh(i,J) + c*vh(i,J-1) + d*vh(i+1,J-1)
        cau = ((a * ip1(vh) + C * jm1(vh))
               + (B * vh + d * ip1(jm1(vh)))) * G.IdxCu
        # CAv(i,J) = -[a(I-1,j)*uh(I-1,j) + c(I,j+1)*uh(I,j+1)
        #              + b(I,j)*uh(I,j) + d(I-1,j+1)*uh(I-1,j+1)]
        fold = getattr(G, "fold_north", False)
        ku = "u" if fold else None
        jC, jD = jp1(C), jp1(D_w)
        if fold:
            # the rotation swaps the cell-corner roles: the ghost cell's
            # SE-corner weight is the mirrored donor's NW weight (C<->A)
            # and SW<->NE (D<->B)
            jC = jC.at[..., -1, :].set(fold_ghost(A_w, "h"))
            jD = jD.at[..., -1, :].set(fold_ghost(B, "h"))
        juh = jp1(uh, ku)
        cav = -((A_w * im1(uh) + jC * juh)
                + (B * uh + jD * im1(juh))) * G.IdyCv
        if scheme != ARAKAWA_HSU90:
            ep_u, ep_v = _ep_terms(q, al_wt)
            kd = "dh" if fold else None
            cau = cau + (ep_u * im1(uh)
                         - ip1(ep_u) * ip1(uh)) * G.IdxCu
            cav = cav + (ep_v * jm1(vh)
                         - jp1(ep_v, kd) * jp1(vh, "v" if fold else None)
                         ) * G.IdyCv
    else:
        raise ValueError(f"unknown Coriolis scheme {scheme}")

    ke = kinetic_energy(u, v, G)
    kh = "h" if getattr(G, "fold_north", False) else None
    cau = (cau - (ip1(ke) - ke) * G.IdxCu) * G.mask2dCu
    cav = (cav - (jp1(ke, kh) - ke) * G.IdyCv) * G.mask2dCv
    return cau, cav
