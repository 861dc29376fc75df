"""Horizontal ocean grid container.

Analogue of MOM6's ``ocean_grid_type`` (reference:
src/core/MOM_grid.F90:30-140) with the halo/index bookkeeping deleted:
all metric arrays are dense ``(ny, nx)`` global arrays in the non-symmetric
staggering of framework/stencil.py (u at EAST faces, v at NORTH faces,
q at NE corners).  Land is represented by 0/1 masks; wrap-around faces of
non-reentrant axes are masked out, which makes every roll-based stencil
correct without special boundary code.

The Grid is a frozen pytree: metric arrays are leaves (shardable over the
device mesh); sizes and flags are static aux data.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from mom6_tpu.framework.pytree import pytree_dataclass, static
from mom6_tpu.framework import constants

__all__ = ["Grid", "build_cartesian_grid", "build_spherical_grid"]


@pytree_dataclass
class Grid:
    # static metadata
    nx: int = static()
    ny: int = static()
    cyclic_x: bool = static(default=False)
    reentrant_y: bool = static(default=False)
    # tripolar northern fold: the top edge is identified with itself
    # under i -> nx-1-i (FOLD_NORTH_EDGE of the reference's
    # MOM_domain_infra.F90:10-34); consumed by the fold-aware stencils
    fold_north: bool = static(default=False)

    # cell-center (h-point) metrics [m], [m2]
    dxT: jnp.ndarray = None
    dyT: jnp.ndarray = None
    areaT: jnp.ndarray = None
    IareaT: jnp.ndarray = None
    IdxT: jnp.ndarray = None
    IdyT: jnp.ndarray = None

    # u-face (east) metrics
    dxCu: jnp.ndarray = None
    dyCu: jnp.ndarray = None
    IdxCu: jnp.ndarray = None
    IdyCu: jnp.ndarray = None

    # v-face (north) metrics
    dxCv: jnp.ndarray = None
    dyCv: jnp.ndarray = None
    IdxCv: jnp.ndarray = None
    IdyCv: jnp.ndarray = None

    # corner (q-point) metrics
    dxBu: jnp.ndarray = None
    dyBu: jnp.ndarray = None
    areaBu: jnp.ndarray = None
    IareaBu: jnp.ndarray = None

    # masks (1.0 = wet)
    mask2dT: jnp.ndarray = None
    mask2dCu: jnp.ndarray = None
    mask2dCv: jnp.ndarray = None
    mask2dBu: jnp.ndarray = None

    # Coriolis parameter at corners [s-1]
    CoriolisBu: jnp.ndarray = None

    # bathymetry: positive depth below mean sea level at h points [m]
    bathyT: jnp.ndarray = None

    # geographic coordinates (for forcing/diagnostics)
    geoLonT: jnp.ndarray = None
    geoLatT: jnp.ndarray = None
    geoLonBu: jnp.ndarray = None
    geoLatBu: jnp.ndarray = None

    @property
    def shape(self):
        return (self.ny, self.nx)


def _face_masks(mask_t: np.ndarray, cyclic_x: bool, reentrant_y: bool,
                fold_north: bool = False):
    """Derive u/v/q masks from the center mask; zero wrap faces of closed
    axes.  With ``fold_north`` the top v/q faces connect each column to
    its fold image (j=ny-1, nx-1-i) instead of being walls."""
    mu = mask_t * np.roll(mask_t, -1, axis=-1)
    mv = mask_t * np.roll(mask_t, -1, axis=-2)
    mq = (mask_t * np.roll(mask_t, -1, axis=-1)
          * np.roll(mask_t, -1, axis=-2)
          * np.roll(np.roll(mask_t, -1, axis=-1), -1, axis=-2))
    if not cyclic_x:
        mu[:, -1] = 0.0
        mq[:, -1] = 0.0
    if fold_north:
        top = mask_t[-1]
        mv[-1, :] = top * top[::-1]
        mq[-1, :] = (top * np.roll(top, -1)
                     * top[::-1] * np.roll(top[::-1], 1))
    elif not reentrant_y:
        mv[-1, :] = 0.0
        mq[-1, :] = 0.0
    return mu, mv, mq


def build_cartesian_grid(
    nx: int,
    ny: int,
    len_lon_km: float,
    len_lat_km: float,
    *,
    depth: Optional[np.ndarray] = None,
    max_depth: float = 4000.0,
    min_depth: float = 0.0,
    f0: float = 0.0,
    beta: float = 0.0,
    south_lat_km: float = 0.0,
    west_lon_km: float = 0.0,
    cyclic_x: bool = False,
    reentrant_y: bool = False,
    dtype=jnp.float32,
) -> Grid:
    """Uniform Cartesian beta-plane grid.

    Equivalent to MOM6 GRID_CONFIG="cartesian" with AXIS_UNITS="k"
    (reference: src/initialization/MOM_grid_initialize.F90:58-644).
    ``beta`` multiplies the absolute y coordinate in meters (origin at
    y=0, which sits ``south_lat_km`` below the southern edge).
    """
    dx = len_lon_km * 1e3 / nx
    dy = len_lat_km * 1e3 / ny
    x_q = west_lon_km * 1e3 + dx * (np.arange(nx) + 1.0)   # NE-corner x
    y_q = south_lat_km * 1e3 + dy * (np.arange(ny) + 1.0)
    x_t = x_q - 0.5 * dx
    y_t = y_q - 0.5 * dy

    ones = np.ones((ny, nx))
    dxT = ones * dx
    dyT = ones * dy

    if depth is None:
        depth = np.full((ny, nx), max_depth)
    depth = np.asarray(depth, dtype=np.float64)
    mask_t = (depth > max(min_depth, 0.0)).astype(np.float64)
    depth = depth * mask_t
    mu, mv, mq = _face_masks(mask_t, cyclic_x, reentrant_y)

    yy_q = np.broadcast_to(y_q[:, None], (ny, nx))
    # beta uses the absolute y coordinate, so a negative south_lat_km
    # places the f=f0 line (e.g. the equator) inside the domain
    f_q = f0 + beta * yy_q

    def J(a):
        return jnp.asarray(a, dtype=dtype)

    area = dxT * dyT
    return Grid(
        nx=nx, ny=ny, cyclic_x=cyclic_x, reentrant_y=reentrant_y,
        dxT=J(dxT), dyT=J(dyT), areaT=J(area), IareaT=J(1.0 / area),
        IdxT=J(1.0 / dxT), IdyT=J(1.0 / dyT),
        dxCu=J(dxT), dyCu=J(dyT), IdxCu=J(1.0 / dxT), IdyCu=J(1.0 / dyT),
        dxCv=J(dxT), dyCv=J(dyT), IdxCv=J(1.0 / dxT), IdyCv=J(1.0 / dyT),
        dxBu=J(dxT), dyBu=J(dyT), areaBu=J(area), IareaBu=J(1.0 / area),
        mask2dT=J(mask_t), mask2dCu=J(mu), mask2dCv=J(mv), mask2dBu=J(mq),
        CoriolisBu=J(f_q),
        bathyT=J(depth),
        geoLonT=J(np.broadcast_to(x_t[None, :], (ny, nx)) / 1e3),
        geoLatT=J(np.broadcast_to(y_t[:, None], (ny, nx)) / 1e3),
        geoLonBu=J(np.broadcast_to(x_q[None, :], (ny, nx)) / 1e3),
        geoLatBu=J(np.broadcast_to(y_q[:, None], (ny, nx)) / 1e3),
    )


def build_spherical_grid(
    nx: int,
    ny: int,
    west_lon_deg: float,
    south_lat_deg: float,
    len_lon_deg: float,
    len_lat_deg: float,
    *,
    depth: Optional[np.ndarray] = None,
    max_depth: float = 4000.0,
    min_depth: float = 0.0,
    cyclic_x: bool = False,
    isotropic: bool = False,
    radius: float = constants.EARTH_RADIUS,
    omega: float = constants.OMEGA,
    dtype=jnp.float32,
) -> Grid:
    """Spherical (lat-lon) grid with full metric terms and Coriolis
    2*Omega*sin(lat) (GRID_CONFIG="spherical" of
    src/initialization/MOM_grid_initialize.F90:
    set_grid_metrics_spherical).

    ``isotropic=True`` builds the MERCATOR spacing instead
    (set_grid_metrics_mercator / the ISOTROPIC option): row latitudes
    are uniform in the Mercator coordinate y = ln tan(pi/4 + lat/2), so
    dy = dx * cos(lat) everywhere — every cell is locally square, the
    isotropy most subgrid closures assume."""
    d2r = np.pi / 180.0
    dlon = len_lon_deg / nx
    lon_q = west_lon_deg + dlon * (np.arange(nx) + 1.0)
    if isotropic:
        # isotropy fixes the Mercator step to the longitude step:
        # dy = R cos(lat) dyM = R cos(lat) dlon = dx.  The northern
        # extent follows from ny (len_lat_deg is advisory, as in the
        # reference's Mercator grid generation).
        def merc(lat_deg):
            return np.log(np.tan(0.25 * np.pi + 0.5 * lat_deg * d2r))

        def inv_merc(y):
            return (2.0 * np.arctan(np.exp(y)) - 0.5 * np.pi) / d2r
        y0 = merc(south_lat_deg)
        dym = dlon * d2r
        yq = y0 + dym * (np.arange(ny) + 1.0)
        yt = yq - 0.5 * dym
        lat_q = inv_merc(yq)
        lat_t = inv_merc(yt)
        # per-row meridional spacing from the interface latitudes
        lat_qm = np.concatenate([[south_lat_deg], lat_q])
        dlat_row = np.diff(lat_qm)             # (ny,) row heights [deg]
    else:
        dlat = len_lat_deg / ny
        lat_q = south_lat_deg + dlat * (np.arange(ny) + 1.0)
        lat_t = lat_q - 0.5 * dlat
        dlat_row = np.full(ny, dlat)
    lon_t = lon_q - 0.5 * dlon

    def dx_at(lat_deg):
        return radius * np.cos(np.asarray(lat_deg) * d2r) * dlon * d2r

    dy_row = radius * dlat_row * d2r          # (ny,) per-row dy
    dxT = np.broadcast_to(dx_at(lat_t)[:, None], (ny, nx)).copy()
    dyT = np.broadcast_to(dy_row[:, None], (ny, nx)).copy()
    dxCu = dxT.copy()                         # u at same latitude as T
    dyCu = dyT.copy()
    dxCv = np.broadcast_to(dx_at(lat_q)[:, None], (ny, nx)).copy()
    # v/q rows sit at the interface latitudes: dy there spans half of
    # each adjacent row
    dy_v = 0.5 * (dy_row + np.concatenate([dy_row[1:], dy_row[-1:]]))
    dyCv = np.broadcast_to(dy_v[:, None], (ny, nx)).copy()
    dxBu = dxCv.copy()
    dyBu = dyCv.copy()

    if depth is None:
        depth = np.full((ny, nx), max_depth)
    depth = np.asarray(depth, dtype=np.float64)
    mask_t = (depth > max(min_depth, 0.0)).astype(np.float64)
    depth = depth * mask_t
    mu, mv, mq = _face_masks(mask_t, cyclic_x, False)

    f_q = 2.0 * omega * np.sin(np.asarray(lat_q) * d2r)
    f_q = np.broadcast_to(f_q[:, None], (ny, nx)).copy()

    def J(a):
        return jnp.asarray(a, dtype=dtype)

    area = dxT * dyT
    area_bu = dxBu * dyBu
    return Grid(
        nx=nx, ny=ny, cyclic_x=cyclic_x, reentrant_y=False,
        dxT=J(dxT), dyT=J(dyT), areaT=J(area), IareaT=J(1.0 / area),
        IdxT=J(1.0 / dxT), IdyT=J(1.0 / dyT),
        dxCu=J(dxCu), dyCu=J(dyCu), IdxCu=J(1.0 / dxCu), IdyCu=J(1.0 / dyCu),
        dxCv=J(dxCv), dyCv=J(dyCv), IdxCv=J(1.0 / dxCv), IdyCv=J(1.0 / dyCv),
        dxBu=J(dxBu), dyBu=J(dyBu), areaBu=J(area_bu),
        IareaBu=J(1.0 / area_bu),
        mask2dT=J(mask_t), mask2dCu=J(mu), mask2dCv=J(mv), mask2dBu=J(mq),
        CoriolisBu=J(f_q),
        bathyT=J(depth),
        geoLonT=J(np.broadcast_to(lon_t[None, :], (ny, nx))),
        geoLatT=J(np.broadcast_to(lat_t[:, None], (ny, nx))),
        geoLonBu=J(np.broadcast_to(lon_q[None, :], (ny, nx))),
        geoLatBu=J(np.broadcast_to(lat_q[:, None], (ny, nx))),
    )
