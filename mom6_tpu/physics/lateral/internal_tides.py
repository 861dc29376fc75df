"""Low-mode internal tide propagation (energy-density ray tracing).

Re-design of MOM6's MOM_internal_tides.F90 (propagate_int_tide
:236, refraction via propagate_corner/teleport machinery, itidal_lowmode
losses): the internal-tide energy density En(angle, y, x) per vertical
mode propagates horizontally at the group speed along a discretized set
of ray directions, refracts as the mode speed varies, and loses energy
to background decay and wave drag; the loss field feeds the lowmode term
of tidal mixing.

Where the reference pushes energy between angular bins with per-cell
corner transports and a halo "teleport" pass, everything here is
flux-form upwind advection, vectorized over the whole
(n_angle, ny, nx) block at once:

* spatial propagation: upwind fluxes with velocity
  (cg cos(th_a), cg sin(th_a)) per angle, where the group speed is
  cg = cn sqrt(max(0, 1 - f^2/w^2)) for mode speed cn and frequency w;
* refraction: upwind transport in the (periodic) angle dimension with
  the ray-theory turning rate  dth/dt = sin(th) dc/dx - cos(th) dc/dy;
* forcing: a (1 - q_local) share of the barotropic-to-internal-tide
  conversion enters isotropically across angles;
* losses: a uniform background decay rate plus a quadratic (Froude-like)
  saturation drag; the column loss [W m-2] is returned for the
  tidal-mixing lowmode deposition.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from mom6_tpu.framework.stencil import im1, ip1, jm1, jp1

__all__ = ["InternalTidesParams", "init_int_tide_energy",
           "step_internal_tides"]


class InternalTidesParams(NamedTuple):
    n_angle: int = 8                 # angular bins (INTERNAL_TIDE_ANGLES)
    # frequencies [s-1] and their shares of the conversion energy
    # (INTERNAL_TIDE_FREQS of the reference; default M2 only — add K1/S2
    # etc. via config ENERGIZED_ANGULAR_FREQS)
    freqs: tuple = (1.4052e-4,)
    freq_frac: tuple = (1.0,)
    n_mode: int = 1                  # vertical modes (INTERNAL_TIDE_MODES);
    #                                   mode-m speed = cn / m (WKB), input
    #                                   partitioned as 1/m^2
    q_local: float = 0.3333          # locally dissipated fraction (Gamma)
    decay_rate: float = 0.0          # uniform background loss [s-1]
    drag_coef: float = 1e-4          # quadratic saturation drag [m-1]-ish
    cg_max: float = 4.0              # group-speed cap [m s-1]
    en_check: float = 1e-20          # negative-energy floor

    @property
    def freq(self):                  # first (M2) frequency, legacy name
        return self.freqs[0]


def init_int_tide_energy(p: InternalTidesParams, ny: int, nx: int,
                         dtype=jnp.float32):
    """Zero energy density [J m-2 per bin] — one propagating field per
    frequency and vertical mode (the En(:,:,:,fr,m) of
    MOM_internal_tides.F90).  Shape (n_freq, n_mode, n_angle, ny, nx),
    squeezed to (n_angle, ny, nx) for the single-frequency single-mode
    default (the round-1 interface)."""
    if len(p.freqs) == 1 and p.n_mode == 1:
        return jnp.zeros((p.n_angle, ny, nx), dtype)
    return jnp.zeros((len(p.freqs), p.n_mode, p.n_angle, ny, nx), dtype)


def step_internal_tides(En, tke_input, cn, G, GV, dt,
                        p: InternalTidesParams):
    """Advance the energy density one step.

    En: (n_angle, ny, nx) [J m-2/bin]; tke_input: (ny, nx) [W m-2]
    barotropic conversion; cn: (ny, nx) first-mode speed [m s-1] (the
    WKB cn/m scaling fills higher modes) OR (n_mode, ny, nx) exact
    modal speeds from diagnostics.wave_speed.wave_speeds (the
    reference's wave_speeds feed, MOM_wave_speed.F90:750).

    Returns (En_new, loss) with loss the column dissipation [W m-2]
    available to tidal mixing's lowmode deposition.

    ``En`` may be (n_angle, ny, nx) (legacy single freq/mode) or the
    full (n_freq, n_mode, n_angle, ny, nx); every frequency and mode
    propagates with its own group speed and sub-inertial cutoff, all in
    one vectorized update."""
    legacy = En.ndim == 3
    if legacy:
        En = En[None, None]
    nf, nm, na = En.shape[:3]
    dtype = En.dtype

    # tripolar northern fold: the ghost row above the top edge is the
    # 180-degree-rotated top row — x-mirrored AND with the propagation
    # angle rotated by pi (bin a -> a + na/2), since directions rotate
    # with the grid (framework/stencil.py jp1 handles scalars; the angle
    # dimension is what makes this field special)
    fold = getattr(G, "fold_north", False)
    if fold and na % 2:
        raise ValueError("TRIPOLAR_N internal tides need an even "
                         "number of angle bins")

    def jp1_f(a):
        r = jnp.roll(a, -1, axis=-2)
        if not fold:
            return r
        g = a[..., -1, ::-1]             # (..., n_angle(or 1), nx)
        if g.shape[-2] > 1:              # real angle axis: rotate by pi
            g = jnp.roll(g, g.shape[-2] // 2, axis=-2)
        return r.at[..., -1, :].set(g)
    # direction tables with EXACT dihedral symmetry: assemble all four
    # quadrants from the first by sign flips, so that reflection
    # (th -> pi - th) and the fold's rotation (th -> th + pi) map table
    # entries to exact negatives/copies — numerically-evaluated
    # cos(pi - th) differs from -cos(th) by an ulp, which would make
    # mirror-symmetric wave fields drift asymmetric
    th_np = 2.0 * np.pi * (np.arange(na) + 0.5) / na
    if na % 4 == 0:
        q = na // 4
        cq = np.cos(th_np[:q])
        sq = np.sin(th_np[:q])
        cos_np = np.concatenate([cq, -cq[::-1], -cq, cq[::-1]])
        sin_np = np.concatenate([sq, sq[::-1], -sq, -sq[::-1]])
    else:
        cos_np, sin_np = np.cos(th_np), np.sin(th_np)
    cos_t = jnp.asarray(cos_np, dtype)[:, None, None]   # (na, 1, 1)
    sin_t = jnp.asarray(sin_np, dtype)[:, None, None]

    f2 = G.CoriolisBu ** 2
    # pairwise grouping: each inner pair is an E/W corner pair that the
    # x-mirror swaps (commutative, so bitwise-invariant); left-to-right
    # association would round differently at mirrored points
    f2_h = 0.25 * ((f2 + im1(f2)) + (jm1(f2) + im1(jm1(f2))))
    freqs = jnp.asarray(p.freqs[:nf], dtype).reshape(nf, 1, 1, 1, 1)
    sub = jnp.maximum(1.0 - f2_h[None, None, None] / freqs ** 2, 0.0)
    inv_m = (1.0 / jnp.arange(1, nm + 1, dtype=dtype)
             ).reshape(1, nm, 1, 1, 1)
    if cn.ndim == 3:
        # exact modal speeds (n_mode, ny, nx) from wave_speeds
        cn_m = cn[None, :nm, None]
        grid_shape = cn.shape[1:]
    else:
        # legacy WKB scaling cn_m = cn / m from the first-mode speed
        cn_m = cn[None, None, None] * inv_m
        grid_shape = cn.shape
    cg = jnp.minimum(cn_m * jnp.sqrt(sub),
                     p.cg_max) * G.mask2dT      # (nf, nm, na(1), ny, nx)
    cg = jnp.broadcast_to(cg, (nf, nm, 1) + grid_shape)

    # --- forcing: (1-q_local) of the conversion, isotropic over bins,
    # split over frequencies by freq_frac and modes as 1/m^2 ------------
    ffrac = jnp.asarray((p.freq_frac + (1.0,) * nf)[:nf], dtype)
    ffrac = (ffrac / jnp.sum(ffrac)).reshape(nf, 1, 1, 1, 1)
    mfrac = inv_m ** 2
    mfrac = mfrac / jnp.sum(mfrac)
    En = En + (dt * (1.0 - p.q_local) / na) * ffrac * mfrac \
        * tke_input[None, None, None]

    # --- refraction (ray turning as c varies) --------------------------
    dcdx = (ip1(cg) - im1(cg)) * (0.5 * G.IdxT)
    dcdy = (jp1_f(cg) - jm1(cg)) * (0.5 * G.IdyT)
    rate = sin_t * dcdx - cos_t * dcdy
    # angle axis is -3 for the vectorized field
    En = _refract_axis(En, rate, dt, axis=-3)

    # --- propagation (upwind, per angle) -------------------------------
    cg_u = 0.5 * (cg + ip1(cg)) * G.mask2dCu
    cg_v = 0.5 * (cg + jp1_f(cg)) * G.mask2dCv
    cgx = cos_t * cg_u
    cgy = sin_t * cg_v
    face_x = G.dyCu * G.mask2dCu
    flux = face_x * (jnp.maximum(cgx, 0.0) * En
                     + jnp.minimum(cgx, 0.0) * ip1(En))
    div = G.IareaT * (flux - im1(flux))
    face_y = G.dxCv * G.mask2dCv
    flux = face_y * (jnp.maximum(cgy, 0.0) * En
                     + jnp.minimum(cgy, 0.0) * jp1_f(En))
    flux_s = jm1(flux)
    if fold:
        # the row-0 wrap would read the (wet) fold faces; the southern
        # boundary of a tripolar grid is a wall
        flux_s = flux_s.at[..., 0, :].set(0.0)
    div = div + G.IareaT * (flux - flux_s)
    En = jnp.maximum(En - dt * div, 0.0)

    # --- losses ---------------------------------------------------------
    e_tot = jnp.sum(En, axis=(0, 1, 2))
    # quadratic saturation: rate grows with the energy itself (Froude-like
    # capping of large E), plus the uniform background
    rate_loss = p.decay_rate + p.drag_coef * jnp.sqrt(
        jnp.maximum(e_tot, 0.0) / GV.rho0)
    damp = 1.0 / (1.0 + dt * rate_loss)
    En_new = En * damp
    loss = jnp.sum(En - En_new, axis=(0, 1, 2)) / dt     # [W m-2]
    En_new = En_new * G.mask2dT
    if legacy:
        En_new = En_new[0, 0]
    return En_new, loss * G.mask2dT


def _refract_axis(E, rate, dt, axis: int):
    """Periodic upwind transport along ``axis`` (the angle dimension).

    The face velocity between bins a and a+1 is the MEAN of the two
    bins' turning rates: using the left bin's rate alone biases the
    transport toward one angular direction and breaks the scheme's
    reflection equivariance (a mirror-symmetric wave field would
    de-symmetrize at O(dth) per step)."""
    na = E.shape[axis]
    dth = 2.0 * np.pi / na
    w = jnp.clip(rate * dt / dth, -1.0, 1.0)
    w_face = 0.5 * (w + jnp.roll(w, -1, axis=axis))
    flux = jnp.maximum(w_face, 0.0) * E \
        + jnp.minimum(w_face, 0.0) * jnp.roll(E, -1, axis=axis)
    return E - (flux - jnp.roll(flux, 1, axis=axis))
