"""Ice-shelf / ocean coupling: pressure, melt fluxes, and IC trimming.

Analogue of the coupling half of MOM6's ice shelf (reference:
src/ice_shelf/MOM_ice_shelf.F90 — ``add_shelf_pressure`` at :1103,
``add_shelf_flux`` at :1135 — and the under-shelf initial-condition
trimming of src/initialization/MOM_state_initialization.F90:1250
``trim_for_ice`` / ``cut_off_column_top``).  The melt thermodynamics
itself lives in :mod:`mom6_tpu.physics.ice_shelf` (Holland & Jenkins
three-equation balance, solved in closed form); this module owns the
*wiring* into the ocean step:

* ``press_ice = frac_shelf * g * mass_shelf`` added to the surface
  pressure the pressure force sees (ref :1121);
* surface fluxes intercepted under the shelf (shortwave/heat/salt/FW
  scaled by the open fraction) and replaced by the melt-driven heat,
  salt and water fluxes (ref :1203-1230);
* wind stress attenuated by the shelf area fraction at faces
  (ref ``frac_shelf_u/v``, :1042-1055);
* columns trimmed at init so the ocean top sits at the hydrostatic
  depth displaced by the shelf mass (ref ``trim_for_ice``).

Everything is elementwise or a cumulative sum over the (small) vertical
axis — no halos, no iteration — so it fuses into the surrounding step
under jit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from mom6_tpu.framework.stencil import ip1, jp1
from mom6_tpu.physics.ice_shelf import IceShelfParams, three_equation_melt

__all__ = ["ShelfCoupling", "apply_shelf_coupling", "shelf_melt_fluxes",
           "trim_columns_for_p_surf"]


class ShelfCoupling(NamedTuple):
    """Static ice-shelf description + melt parameters (the data-override
    / ``override_shelf_movement`` mode of MOM_ice_shelf.F90: prescribed
    shelf mass, thermodynamics active)."""
    mass_shelf: jnp.ndarray          # (ny, nx) ice mass per area [kg m-2]
    frac_shelf_h: jnp.ndarray        # (ny, nx) shelf area fraction, 0..1
    melt: IceShelfParams = IceShelfParams()
    flux_factor: float = 1.0         # SHELF_FLUX_FACTOR (dial melt fluxes)
    # exchange-velocity model: gamma_T = gamma_t (constant), or when
    # ustar_dependent, gamma_T = gam_t_star * ustar_shelf with
    # ustar_shelf = sqrt(cdrag (u_ml^2 + utide^2)) (ref shelf_calc_flux's
    # velocity-dependent option)
    ustar_dependent: bool = False
    gam_t_star: float = 0.02         # nondim Gamma_T when ustar-dependent
    cdrag_shelf: float = 2.5e-3
    utide: float = 0.0               # background tidal speed [m s-1]


def shelf_melt_fluxes(T_top, S_top, shelf: ShelfCoupling, g_earth: float,
                      u_ml=None) -> Tuple[jnp.ndarray, jnp.ndarray,
                                          jnp.ndarray, jnp.ndarray]:
    """Melt rate and ocean-side fluxes under the shelf.

    Returns ``(melt [m ice s-1], heat [W m-2, +into ocean],
    salt [ppt m s-1], water [m s-1 fresh water])`` — all already masked
    by ``frac_shelf_h > 0`` (zero in the open ocean).
    """
    p_base = g_earth * shelf.mass_shelf      # interface pressure [Pa]
    mp = shelf.melt
    if shelf.ustar_dependent:
        u2 = shelf.utide ** 2 if u_ml is None else u_ml ** 2 + \
            shelf.utide ** 2
        ustar = jnp.sqrt(shelf.cdrag_shelf * u2)
        gam_t = shelf.gam_t_star * jnp.maximum(ustar, 1e-6)
        # keep the reference's ~35:1 heat:salt exchange ratio
        gam_s = gam_t * (mp.gamma_s / mp.gamma_t)
        mp = mp._replace(gamma_t=gam_t, gamma_s=gam_s)
    melt, heat, salt = three_equation_melt(T_top, S_top, p_base, mp)
    under = shelf.frac_shelf_h > 0.0
    melt = jnp.where(under, melt, 0.0)
    heat = jnp.where(under, heat, 0.0)
    salt = jnp.where(under, salt, 0.0)
    # melt water entering the ocean, in fresh-water meters (the lprec
    # replacement of ref :1216-1222): m' rho_i/rho_w converts back
    water = melt * (mp.rho_i / mp.rho_w) if not shelf.ustar_dependent \
        else melt * (shelf.melt.rho_i / shelf.melt.rho_w)
    water = jnp.where(under, water, 0.0)
    return melt, heat, salt, water


def apply_shelf_coupling(state, forcing, G, GV, shelf: ShelfCoupling):
    """Returns ``(forcing', melt_rate)`` with the shelf's pressure and
    melt fluxes folded into the surface forcing (add_shelf_pressure +
    add_shelf_flux, MOM_ice_shelf.F90:1103,1135)."""
    frac = shelf.frac_shelf_h
    open_frac = jnp.maximum(0.0, 1.0 - frac)
    press_ice = frac * (GV.g_earth * shelf.mass_shelf)   # ref :1121

    # --- surface pressure ------------------------------------------------
    mech = forcing.mech
    p_surf = press_ice if mech.p_surf is None else mech.p_surf + press_ice

    # --- wind stress intercepted by the shelf at faces (frac_shelf_u/v,
    # ref :1042-1055: area-mean of the two neighbors) ----------------------
    frac_u = jnp.minimum(1.0, 0.5 * (frac + ip1(frac)))
    frac_v = jnp.minimum(1.0, 0.5 * (frac + jp1(frac)))
    taux = mech.taux if mech.taux is None else mech.taux * (1.0 - frac_u)
    tauy = mech.tauy if mech.tauy is None else mech.tauy * (1.0 - frac_v)
    u10 = mech.u10 if mech.u10 is None else mech.u10 * open_frac
    mech = mech._replace(taux=taux, tauy=tauy, p_surf=p_surf, u10=u10)

    # --- melt thermodynamics on the top (under-shelf) layer ---------------
    buoy = forcing.buoy
    if state.T is not None:
        u_ml = None
        if shelf.ustar_dependent and state.u is not None:
            # mixed-layer speed under the shelf from the top layer
            u_c = 0.5 * (state.u[0] + ip1(state.u[0]))
            v_c = 0.5 * (state.v[0] + jp1(state.v[0]))
            u_ml = jnp.sqrt(u_c * u_c + v_c * v_c)
        melt, heat, salt, water = shelf_melt_fluxes(
            state.T[0], state.S[0], shelf, GV.g_earth, u_ml=u_ml)
        ff = shelf.flux_factor
        # replace intercepted fluxes with shelf fluxes (ref :1203-1230)
        def mix(old, shelf_flux):
            if old is None:
                return frac * ff * shelf_flux
            return open_frac * old + frac * ff * shelf_flux
        heat_new = mix(buoy.heat_flux, heat)
        salt_new = mix(buoy.salt_flux, salt)
        fw_new = mix(buoy.fw_flux, water)
        sw_new = None if buoy.sw_flux is None else open_frac * buoy.sw_flux
        buoy = buoy._replace(heat_flux=heat_new, salt_flux=salt_new,
                             fw_flux=fw_new, sw_flux=sw_new)
    else:
        melt = jnp.zeros_like(frac)

    return forcing._replace(mech=mech, buoy=buoy), melt


def trim_columns_for_p_surf(h, T, S, rho, p_surf, g_earth: float,
                            min_thickness: float = 1e-10):
    """Remove mass from the top of each column until the removed weight
    balances ``p_surf`` (TRIM_IC_FOR_P_SURF; ``trim_for_ice`` →
    ``cut_off_column_top``, MOM_state_initialization.F90:1250).

    ``rho`` is the in-situ-ish density per layer [kg m-3] used to convert
    thickness to weight; layer T/S are kept (the PCM limit of the
    reference's optional remapping).  Pure cumulative sums — vectorized
    over all columns at once, no per-column iteration.
    """
    # interface pressure accumulated from the top: P_k = g sum rho h
    dp = g_earth * rho * h                       # per-layer weight [Pa]
    p_int = jnp.concatenate([jnp.zeros_like(dp[:1]),
                             jnp.cumsum(dp, axis=0)], axis=0)
    # fraction of each layer that survives below the cut at p = p_surf:
    # 1 where the layer is entirely below, 0 entirely above, linear in
    # the straddling layer (exact mass removal)
    keep = jnp.clip((p_int[1:] - p_surf[None]) / jnp.maximum(dp, 1e-30),
                    0.0, 1.0)
    h_new = jnp.maximum(h * keep, min_thickness)
    return h_new, T, S
