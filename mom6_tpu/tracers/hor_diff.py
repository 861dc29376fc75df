"""Along-layer horizontal tracer diffusion.

Analogue of MOM6's tracer_hordiff (reference:
src/tracer/MOM_tracer_hor_diff.F90:119): subcycled Laplacian diffusion of
tracers along layers with thickness-weighted fluxes.  Neutral diffusion
lives in tracers/neutral_diffusion.py, boundary-layer diffusion in
tracers/hor_bnd_diffusion.py; step_mom picks per the config flags and
applies the Visbeck/resolution/passivity KHTR scalings before calling
here (core/mom.py).

Design: fixed subcycle count from the diffusive CFL (static), tracer
axis batched, flux form guarantees conservation."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mom6_tpu.framework.stencil import im1, ip1, jm1_s0, jp1

__all__ = ["tracer_hordiff"]


def tracer_hordiff(T, h, khtr, dt, G, *, n_sub: int = 1):
    """Diffuse stacked tracers (n_tr, nz, ny, nx) with diffusivity
    ``khtr`` [m2 s-1] (scalar or (ny, nx))."""
    kh = jnp.asarray(khtr, T.dtype)
    if kh.ndim == 0:
        kh = jnp.broadcast_to(kh, (G.ny, G.nx))
    dt_sub = dt / n_sub

    # HARMONIC face thickness: next to an Angstrom-thin (vanished) layer
    # the arithmetic mean would carry a half-thick flux into a near-zero
    # volume — div/vol ~ 1e8 per step.  The harmonic mean makes the flux
    # scale with the THIN side, as the reference's thickness weighting
    # does (MOM_tracer_hor_diff.F90:119).
    eps = 1e-10
    fold = getattr(G, "fold_north", False)
    kf = "h" if fold else None
    jh = jp1(h, kf)
    h_u = 2.0 * h * ip1(h) / (h + ip1(h) + eps) * G.mask2dCu
    h_v = 2.0 * h * jh / (h + jh + eps) * G.mask2dCv
    kh_u = 0.5 * (kh + ip1(kh))
    kh_v = 0.5 * (kh + jp1(kh, kf))
    # transport coefficients [m3 s-1]
    coef_u = kh_u * G.dyCu * G.IdxCu * h_u * G.mask2dCu
    coef_v = kh_v * G.dxCv * G.IdyCv * h_v * G.mask2dCv
    vol = jnp.maximum(h * G.areaT, 1e-10)
    # per-face stability clamp: no face may exchange more than ~1/5 of
    # the smaller neighbor volume per subcycle
    cap = 0.2 / dt_sub
    coef_u = jnp.minimum(coef_u, cap * jnp.minimum(vol, ip1(vol)))
    coef_v = jnp.minimum(coef_v, cap * jnp.minimum(vol, jp1(vol, kf)))

    def sub(_, T):
        fx = coef_u[None] * (ip1(T) - T)
        fy = coef_v[None] * (jp1(T, kf) - T)
        div = (fx - im1(fx)) + (fy - jm1_s0(fy, fold))
        return T + dt_sub * div / vol[None]

    return jax.lax.fori_loop(0, n_sub, sub, T)
