"""Gent-McWilliams thickness diffusion (interface-height smoothing).

Analogue of MOM6's thickness_diffuse (reference:
src/parameterizations/lateral/MOM_thickness_diffuse.F90:134): the eddy
bolus overturning is expressed as an interface streamfunction
``psi_k = Kgm * S_k`` (S_k = interface-height slope at the velocity
point, magnitude-limited); the layer bolus transport is the streamfunction
difference across the layer,

    uhD_k = dyCu * (psi_k - psi_{k+1}),

which conserves volume exactly per column (psi vanishes at surface and
bottom).  The thickness update is the flux divergence; the same bolus
transports are added to uhtr so tracers are advected by the eddy flow
(as the reference does).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from mom6_tpu.framework.stencil import jm1_s0, im1, ip1, jm1, jp1

__all__ = ["GMParams", "thickness_diffuse"]


class GMParams(NamedTuple):
    khth: float = 10.0            # GM coefficient [m2 s-1]
    slope_max: float = 0.01       # streamfunction slope limit
    use_resolution_fn: bool = False


def thickness_diffuse(h, G, GV, dt, p: GMParams, *, khth_2d=None,
                      T=None, S=None, eos=None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (h_new, uhD, vhD): updated thickness and the bolus volume
    transports [m3 s-1] used for tracer advection.

    In layered (adiabatic) mode the streamfunction slope is the coordinate
    interface slope; with T/S/eos given (ALE mode, where coordinate
    surfaces are flat by construction) it is the NEUTRAL slope, as in the
    reference's ALE path (MOM_thickness_diffuse + MOM_isopycnal_slopes)."""
    kh_f = "h" if getattr(G, "fold_north", False) else None
    kh = jnp.asarray(p.khth, h.dtype)
    if khth_2d is not None:
        kh = khth_2d

    if T is not None and eos is not None:
        from mom6_tpu.core.isopycnal_slopes import isopycnal_slopes
        sx_l, sy_l = isopycnal_slopes(h, T, S, G, GV, eos,
                                      slope_max=p.slope_max)
        # slopes at interior interfaces: mean of bounding layers
        sx = 0.5 * (sx_l[:-1] + sx_l[1:])
        sy = 0.5 * (sy_l[:-1] + sy_l[1:])
    else:
        # interface heights, positive up, interfaces 1..nz-1 interior
        csum_below = jnp.cumsum(h[::-1], axis=0)[::-1]
        e = csum_below - G.bathyT[None]      # top interface of each layer
        e_int = e[1:]                        # interior interfaces (nz-1)
        sx = jnp.clip((ip1(e_int) - e_int) * G.IdxCu,
                      -p.slope_max, p.slope_max)
        sy = jnp.clip((jp1(e_int, kh_f) - e_int) * G.IdyCv,
                      -p.slope_max, p.slope_max)

    kh_u = 0.5 * (kh + ip1(kh)) if jnp.ndim(kh) else kh
    kh_v = 0.5 * (kh + jp1(kh, kh_f)) if jnp.ndim(kh) else kh
    psi_u = kh_u * sx * G.mask2dCu           # [m2 s-1] streamfunction
    psi_v = kh_v * sy * G.mask2dCv

    # taper the streamfunction to zero at interfaces bounded by vanished
    # layers (the reference's bounded/limited streamfunction near
    # topography, MOM_thickness_diffuse.F90 hN2 weighting): over a slope
    # in ALE mode the vanished layers hold stale T/S whose clipped
    # "neutral slopes" flap sign and pump gravity waves — the interface
    # must carry no bolus transport where either bounding layer on
    # either side is massless
    h0 = 4.0 * GV.angstrom + 0.5             # [m]
    h_ab, h_bl = h[:-1], h[1:]               # bounding layers, iface 1..nz-1
    hmin_u = jnp.minimum(jnp.minimum(h_ab, ip1(h_ab)),
                         jnp.minimum(h_bl, ip1(h_bl)))
    hmin_v = jnp.minimum(jnp.minimum(h_ab, jp1(h_ab, kh_f)),
                         jnp.minimum(h_bl, jp1(h_bl, kh_f)))
    psi_u = psi_u * (hmin_u * hmin_u) / (hmin_u * hmin_u + h0 * h0)
    psi_v = psi_v * (hmin_v * hmin_v) / (hmin_v * hmin_v + h0 * h0)

    zero = jnp.zeros_like(psi_u[:1])
    psi_u_full = jnp.concatenate([zero, psi_u, zero], axis=0)  # nz+1 ifaces
    zero_v = jnp.zeros_like(psi_v[:1])
    psi_v_full = jnp.concatenate([zero_v, psi_v, zero_v], axis=0)

    # bolus transports per layer (conserve column volume by construction)
    uhd = G.dyCu * (psi_u_full[1:] - psi_u_full[:-1]) * G.mask2dCu
    vhd = G.dxCv * (psi_v_full[1:] - psi_v_full[:-1]) * G.mask2dCv

    # streamfunction limiting (role of the reference's bounded
    # streamfunction): scale back transports that would evacuate a thin
    # layer within dt — vital for vanished layers over topography
    vol = h * G.areaT
    out_u = jnp.maximum(uhd, 0.0) + jnp.maximum(-im1(uhd), 0.0)
    out_v = jnp.maximum(vhd, 0.0) \
        + jnp.maximum(-jm1_s0(vhd, kh_f), 0.0)
    r = jnp.minimum(1.0, 0.25 * vol / jnp.maximum(dt * (out_u + out_v),
                                                  1e-30))
    uhd = uhd * jnp.where(uhd > 0.0, r, ip1(r))
    vhd = vhd * jnp.where(vhd > 0.0, r, jp1(r, kh_f))

    h_new = h - dt * G.IareaT * ((uhd - im1(uhd))
                                 + (vhd - jm1_s0(vhd, kh_f)))
    h_new = jnp.maximum(h_new, GV.angstrom)
    return h_new, uhd, vhd
