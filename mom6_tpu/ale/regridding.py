"""Target-grid generation for the ALE vertical coordinate.

Analogue of MOM6's regridding (reference:
src/ALE/MOM_regridding.F90: regridding_main :133-144; coordinate modes in
src/ALE/regrid_consts.F90:13-22 and coord_zlike/sigma/rho.F90).

Implemented modes:
* ``ZSTAR``  — stretched geopotential: interface k sits at
               e_k = eta - z*_k * (D + eta) / D (collapses over topography);
* ``SIGMA``  — terrain following: e_k = eta - sigma_k * (D + eta);
* ``RHO``    — target isopycnals (interpolate the column's density profile
               onto prescribed Rlay targets);
* ``HYCOM1`` — hybrid: isopycnal interface positions pushed down to at
               least a nominal z* grid (coord_hycom.F90:build_hycom1_column);
* ``ADAPTIVE`` — interfaces relax toward neutral-density flatness with a
               smoothing grid diffusion (coord_adapt.F90:build_adapt_column);
* ``HYBGEN`` — HYCOM's hybrid generator: relax toward isopycnal targets
               at rate qhybrlx with a minimum z-spacing profile
               (MOM_hybgen_regrid.F90);
* ``LAYER``  — no regridding (pure layered mode).

All modes return new thicknesses h_new with the same column sums as the
input (required by the conservative remap), built with branchless clipping
against the bathymetry.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["build_sigma_shelf_zstar_grid", "build_zstar_grid",
           "build_sigma_grid", "build_rho_grid", "hybgen_unmix",
           "build_hycom1_grid", "build_adaptive_grid", "build_hybgen_grid",
           "AdaptParams", "uniform_dz_profile"]


def uniform_dz_profile(nz: int, max_depth: float) -> np.ndarray:
    return np.full(nz, max_depth / nz)


def build_zstar_grid(h, bathy, dz_nominal, min_thickness: float = 1e-10):
    """New z* thicknesses for columns with current thickness ``h``.

    ``dz_nominal``: (nz,) nominal layer thicknesses summing to max depth.
    Interfaces of the z* grid: z_k = -cum(dz_nominal); stretched by the
    column's (D + eta)/D and clipped to the bottom.
    """
    dz = jnp.asarray(dz_nominal, h.dtype)
    depth_nom = jnp.sum(dz)
    col = jnp.sum(h, axis=0)                      # D + eta
    d = jnp.minimum(bathy, depth_nom)
    # nominal interface depths (positive down), shape (nz+1, 1, 1)
    z_nom = jnp.concatenate([jnp.zeros((1,), h.dtype), jnp.cumsum(dz)])
    z_nom = z_nom[:, None, None]
    # interface positions measured from the free surface downward (top = 0,
    # bottom = col): z*_k stretched by (D+eta)/D, clipped at the bottom
    stretch = col / jnp.maximum(d, 1e-10)
    z = jnp.minimum(z_nom * stretch, col[None])
    h_new = jnp.maximum(z[1:] - z[:-1], min_thickness)
    # renormalize so the column sum is preserved exactly despite the floor
    scale = col / jnp.maximum(jnp.sum(h_new, axis=0), 1e-30)
    return h_new * scale[None]


def build_sigma_grid(h, sigma_fractions=None, nz: int = None,
                     min_thickness: float = 1e-10):
    """Terrain-following grid: fixed fractions of the local column."""
    col = jnp.sum(h, axis=0)
    if sigma_fractions is None:
        nz = nz or h.shape[0]
        frac = jnp.full((nz,), 1.0 / nz, h.dtype)
    else:
        frac = jnp.asarray(sigma_fractions, h.dtype)
    return jnp.maximum(frac[:, None, None] * col[None], min_thickness)


def build_sigma_shelf_zstar_grid(h, bathy, dz_nominal, shelf_depth,
                                 min_thickness: float = 1e-10):
    """SIGMA_SHELF_ZSTAR (regridding_main's mode of that name): pure
    terrain-following sigma where the water column is shallower than
    ``shelf_depth`` (ice-shelf cavities / shelves, where z* layers would
    pinch against the topography), pure z* in the deep ocean, blended
    linearly over the next ``shelf_depth`` of depth so the interfaces
    stay continuous across the transition."""
    z_sig = build_sigma_grid(h, nz=len(dz_nominal),
                             min_thickness=min_thickness)
    z_str = build_zstar_grid(h, bathy, dz_nominal, min_thickness)
    col = jnp.sum(h, axis=0)
    w_sig = jnp.clip((2.0 * shelf_depth - col) / jnp.maximum(
        shelf_depth, 1e-3), 0.0, 1.0)        # 1 below shelf_depth,
    #                                           0 beyond 2*shelf_depth
    h_new = w_sig[None] * z_sig + (1.0 - w_sig[None]) * z_str
    scale = col / jnp.maximum(jnp.sum(h_new, axis=0), 1e-30)
    return jnp.maximum(h_new * scale[None], min_thickness)


def build_rho_grid(h, T, S, GV, eos, rho_targets, *,
                   min_thickness: float = 1e-10, p_ref: float = 2e7):
    """Isopycnal-target grid (RHO mode of regridding_main; coord_rho.F90):
    interface k moves to the depth where the column's (monotonicized)
    potential density referenced to ``p_ref`` equals the target interface
    density 0.5*(Rlay[k-1] + Rlay[k]).

    Piecewise-linear inversion of the (rho, z) profile with the same
    branchless fractional-segment machinery as the remap core; interfaces
    clamp to [0, column depth] so column sums are preserved exactly."""
    import jax

    rho_t = jnp.asarray(rho_targets, h.dtype)
    nz = rho_t.shape[0]            # output layer count = target count
    rho_int_t = 0.5 * (rho_t[:-1] + rho_t[1:])          # (nz-1,) targets

    z_c = jnp.cumsum(h, axis=0) - 0.5 * h               # center depths
    rho_c = GV.rho0 + eos.density(T, S, jnp.full_like(T, p_ref),
                                  rho_ref=GV.rho0)
    rho_mono = jax.lax.cummax(rho_c, axis=0)            # enforce stability

    col = jnp.sum(h, axis=0)
    # invert rho(z): for each target, z = interpolated crossing depth
    r_lo = jnp.concatenate([rho_mono[:1], rho_mono[:-1]], 0)
    z_lo = jnp.concatenate([jnp.zeros_like(z_c[:1]), z_c[:-1]], 0)
    seg = z_c - z_lo

    def depth_of(rho_target):
        frac = jnp.clip((rho_target - r_lo)
                        / jnp.maximum(rho_mono - r_lo, 1e-12), 0.0, 1.0)
        frac = jnp.where(rho_mono - r_lo < 1e-12,
                         jnp.where(r_lo < rho_target, 1.0, 0.0), frac)
        return jnp.sum(seg * frac, axis=0)

    z_int = jnp.stack([depth_of(rho_int_t[k]) for k in range(nz - 1)])
    z_int = jnp.clip(z_int, 0.0, col[None])
    # enforce monotone interfaces
    z_int = jax.lax.cummax(z_int, axis=0)
    z_full = jnp.concatenate([jnp.zeros_like(col[None]), z_int,
                              col[None]], axis=0)
    h_new = jnp.maximum(z_full[1:] - z_full[:-1], min_thickness)
    scale = col / jnp.maximum(jnp.sum(h_new, axis=0), 1e-30)
    return h_new * scale[None]


def build_hycom1_grid(h, T, S, GV, eos, rho_targets, dz_nominal, *,
                      min_thickness: float = 1e-10, p_ref: float = 2e7):
    """HYCOM1 hybrid coordinate (coord_hycom.F90:build_hycom1_column):
    place interfaces at the isopycnal target positions (same inversion as
    RHO mode), then sweep down enforcing that each interface is at least
    as deep as the nominal stretched-z* grid:
        z_k = min( max(z_rho_k, z*_k), bottom )
    so the upper ocean stays z-like at the prescribed resolution while
    the stratified interior follows isopycnals."""
    import jax

    dz = jnp.asarray(dz_nominal, h.dtype)
    col = jnp.sum(h, axis=0)
    h_rho = build_rho_grid(h, T, S, GV, eos, rho_targets,
                           min_thickness=min_thickness, p_ref=p_ref)
    z_rho = jnp.cumsum(h_rho, axis=0)                    # (nz, ny, nx)
    # nominal z* interfaces, stretched by the column height over the
    # nominal total (reference: stretching = z_col(nz+1)/depth)
    z_nom = jnp.cumsum(dz)[:, None, None] * (
        col / jnp.maximum(jnp.sum(dz), 1e-30))[None]
    z_int = jnp.minimum(jnp.maximum(z_rho[:-1], z_nom[:-1]), col[None])
    z_int = jax.lax.cummax(z_int, axis=0)
    z_full = jnp.concatenate([jnp.zeros_like(col[None]), z_int,
                              col[None]], axis=0)
    h_new = jnp.maximum(z_full[1:] - z_full[:-1], min_thickness)
    scale = col / jnp.maximum(jnp.sum(h_new, axis=0), 1e-30)
    return h_new * scale[None]


class AdaptParams:
    """Static adaptive-coordinate constants (MOM_regridding.F90:676-692
    defaults)."""
    def __init__(self, time_ratio=0.1, zoom_depth=200.0, zoom_coeff=0.2,
                 buoy_coeff=0.8, alpha=1.0, drho0=0.5, do_min=False):
        self.time_ratio = time_ratio
        self.zoom_depth = zoom_depth
        self.zoom_coeff = zoom_coeff
        self.buoy_coeff = buoy_coeff
        self.alpha = alpha
        self.drho0 = drho0
        self.do_min = do_min


def build_adaptive_grid(h, T, S, G, GV, eos, p: AdaptParams = None, *,
                        dz_nominal=None, min_thickness: float = 1e-10):
    """ADAPTIVE coordinate (coord_adapt.F90:build_adapt_column):

    1. each interior interface moves toward horizontal neutral-density
       flatness: dh = del2(sigma) * hbar / (drho/dz), where del2 is the
       4-neighbour horizontal Laplacian of interface density, limited to
       half the upwind layer thickness times ``alpha``;
    2. interface positions are smoothed by an implicit vertical grid
       diffusion whose diffusivity combines near-surface zooming,
       stratification attraction, and a uniform background;
    3. optionally (do_min) interfaces are pushed down to a nominal z*
       floor.

    All columns solve at once: the horizontal stencil is roll-based and
    the implicit smoothing reuses the framework Thomas solver."""
    import jax

    from mom6_tpu.framework.solvers import tridiag_solve
    from mom6_tpu.framework.stencil import im1, ip1, jm1, jp1

    if p is None:
        p = AdaptParams()
    nz = h.shape[0]
    dtype = h.dtype
    col = jnp.sum(h, axis=0)
    z = jnp.concatenate([jnp.zeros_like(col[None]),
                         jnp.cumsum(h, axis=0)], axis=0)   # (nz+1,) down

    # interface T/S (mean of bounding layers; ends copy the end layers)
    tI = jnp.concatenate([T[:1], 0.5 * (T[:-1] + T[1:]), T[-1:]], axis=0)
    sI = jnp.concatenate([S[:1], 0.5 * (S[:-1] + S[1:]), S[-1:]], axis=0)
    p0 = jnp.zeros((), dtype)
    a_full, b_full = eos.density_derivs(tI, sI, p0)        # (nz+1, ny, nx)

    # horizontal Laplacian of interface density via masked neighbour sums
    def contrib(shift, face_mask):
        dT = shift(tI) - tI
        dS = shift(sI) - sI
        return face_mask[None] * (a_full * dT + b_full * dS)

    # face masks: east/west use mask2dCu at the cell's faces, north/south
    # mask2dCv; a land neighbour contributes nothing
    mCu, mCv = G.mask2dCu, G.mask2dCv
    del2 = (contrib(ip1, mCu) + contrib(im1, im1(mCu))
            + contrib(jp1, mCv) + contrib(jm1, jm1(mCv)))

    # vertical density jump across each interior interface
    drho_v = a_full[1:-1] * (T[1:] - T[:-1]) + b_full[1:-1] * (S[1:] - S[:-1])
    hbar = 0.5 * (h[:-1] + h[1:])
    dh = del2[1:-1] * hbar / jnp.maximum(drho_v, 1e-10)
    # limit: no more than alpha/2 of the upwind layer, Nyquist-safe
    h_up = jnp.where(dh > 0, h[1:], h[:-1])
    dh = jnp.sign(dh) * jnp.minimum(jnp.abs(dh), 0.5 * h_up) * (0.5 * p.alpha)
    z_next = z.at[1:-1].add(dh)

    # grid diffusivity per layer (coord_adapt.F90:1040-1060 analogue)
    drdz = jnp.maximum(
        (0.5 * (a_full[:-1] + a_full[1:]) * (tI[1:] - tI[:-1])
         + 0.5 * (b_full[:-1] + b_full[1:]) * (sI[1:] - sI[:-1]))
        / jnp.maximum(z_next[1:] - z_next[:-1], 1e-6), 0.0)
    z_mid = 0.5 * (z_next[:-1] + z_next[1:])
    depth = jnp.maximum(col, 1.0)[None]
    k_grid = (p.time_ratio * nz ** 2 * depth) * (
        p.zoom_coeff / (p.zoom_depth + z_mid)
        + p.buoy_coeff * drdz / p.drho0
        + max(1.0 - p.zoom_coeff - p.buoy_coeff, 0.0) / depth)

    # implicit smoothing of interior interfaces (Dirichlet ends):
    # (1 + kG[k-1] + kG[k]) z_k - kG[k-1] z_{k-1} - kG[k] z_{k+1} = rhs_k
    kg_up = k_grid[:-1]          # couples interface k to k-1 (layer above)
    kg_dn = k_grid[1:]           # couples interface k to k+1
    b_diag = 1.0 + kg_up + kg_dn
    rhs = z_next[1:-1]
    # fold the fixed boundary interfaces into the RHS
    rhs = rhs.at[0].add(kg_up[0] * z_next[0])
    rhs = rhs.at[-1].add(kg_dn[-1] * z_next[-1])
    a_sub = -kg_up.at[0].set(0.0)
    c_sup = -kg_dn.at[-1].set(0.0)
    z_int = tridiag_solve(a_sub, b_diag, c_sup, rhs)

    if p.do_min and dz_nominal is not None:
        dz = jnp.asarray(dz_nominal, dtype)
        z_nom = jnp.cumsum(dz)[:-1, None, None] * (
            col / jnp.maximum(jnp.sum(dz), 1e-30))[None]
        z_int = jnp.maximum(z_int, z_nom)

    z_int = jnp.clip(z_int, 0.0, col[None])
    z_int = jax.lax.cummax(z_int, axis=0)
    z_full = jnp.concatenate([jnp.zeros_like(col[None]), z_int,
                              col[None]], axis=0)
    h_new = jnp.maximum(z_full[1:] - z_full[:-1], min_thickness)
    scale = col / jnp.maximum(jnp.sum(h_new, axis=0), 1e-30)
    return h_new * scale[None]


def build_hybgen_grid(h, T, S, GV, eos, rho_targets, dz_min_profile, *,
                      qhybrlx: float = 0.25, min_thickness: float = 1e-10,
                      p_ref: float = 2e7):
    """HYBGEN hybrid-coordinate generator (HYCOM's hybgen; reference:
    src/ALE/MOM_hybgen_regrid.F90 — the HYBGEN_RELAX_PERIOD / qhybrlx
    relaxation :175-180 and the dp0k minimum z-layer profile :133).

    Unlike HYCOM1 (which jumps straight to the isopycnal-target
    positions), hybgen RELAXES each interface a fraction ``qhybrlx`` of
    the way toward its isopycnal position per regrid call, then enforces
    the minimum z-spacing profile ``dz_min_profile`` downward from the
    surface.  This keeps regridding from shocking the state when the
    coordinate and the stratification disagree."""
    import jax

    dz0 = jnp.asarray(dz_min_profile, h.dtype)
    col = jnp.sum(h, axis=0)
    z_old = jnp.cumsum(h, axis=0)                 # interfaces 1..nz
    h_rho = build_rho_grid(h, T, S, GV, eos, rho_targets,
                           min_thickness=min_thickness, p_ref=p_ref)
    z_rho = jnp.cumsum(h_rho, axis=0)
    # relax interior interfaces toward the isopycnal target
    z_int = z_old[:-1] + qhybrlx * (z_rho[:-1] - z_old[:-1])
    # enforce the minimum z-layer profile cumulatively from the surface
    zmin = jnp.cumsum(dz0)[:-1, None, None]
    z_int = jnp.maximum(z_int, jnp.minimum(zmin, col[None]))
    z_int = jnp.clip(z_int, 0.0, col[None])
    z_int = jax.lax.cummax(z_int, axis=0)
    z_full = jnp.concatenate([jnp.zeros_like(col[None]), z_int,
                              col[None]], axis=0)
    h_new = jnp.maximum(z_full[1:] - z_full[:-1], min_thickness)
    scale = col / jnp.maximum(jnp.sum(h_new, axis=0), 1e-30)
    return h_new * scale[None]


def hybgen_unmix(T, S, h, GV, eos, rho_targets, *, k_fixed: int = 2,
                 q_max: float = 0.25, p_ref: float = 2e7):
    """Hybgen cabbeling-correction unmixing (reference:
    src/ALE/MOM_hybgen_unmix.F90): remapping into a hybrid grid mixes
    water across isopycnal-regime layers, drifting their densities off
    the Rlay targets; unmixing SWAPS equal volumes delta between each
    such layer and the one below so the upper layer's density returns
    to target — column heat and salt are exactly conserved (the swap is
    antisymmetric) and the transfer is capped at ``q_max`` of the
    thinner layer per call.

    Top-down lax.scan over layers (each swap updates the lower layer
    before it is visited); layers k < ``k_fixed`` (the fixed-z surface
    regime) are left untouched.  Returns (T', S')."""
    import jax

    nz = h.shape[0]
    rho_t = jnp.asarray(rho_targets, h.dtype)
    p = jnp.full_like(T[:1], p_ref)

    def rho_of(Tk, Sk):
        return GV.rho0 + eos.density(Tk, Sk, p[0], rho_ref=GV.rho0)

    def body(carry, k):
        T, S = carry
        Tk, Sk = T[k], S[k]
        Tk1, Sk1 = T[k + 1], S[k + 1]
        hk, hk1 = h[k], h[k + 1]
        r_k = rho_of(Tk, Sk)
        r_k1 = rho_of(Tk1, Sk1)
        # volume to swap so layer k returns to target density
        dr = rho_t[k] - r_k
        denom = r_k1 - r_k
        delta = hk * dr / jnp.where(jnp.abs(denom) > 1e-6, denom, 1e30)
        delta = jnp.clip(delta, 0.0, q_max * jnp.minimum(hk, hk1))
        # skip the fixed-z surface regime and unstratified pairs
        active = (k >= k_fixed) & (denom > 1e-6)
        delta = jnp.where(active, delta, 0.0)
        fT = delta * (Tk1 - Tk)
        fS = delta * (Sk1 - Sk)
        T = T.at[k].add(fT / jnp.maximum(hk, 1e-3))
        T = T.at[k + 1].add(-fT / jnp.maximum(hk1, 1e-3))
        S = S.at[k].add(fS / jnp.maximum(hk, 1e-3))
        S = S.at[k + 1].add(-fS / jnp.maximum(hk1, 1e-3))
        return (T, S), None

    (T, S), _ = jax.lax.scan(body, (T, S), jnp.arange(nz - 1))
    return T, S
