"""Branchless C-grid stencil operators.

Grid convention (fixed throughout mom6_tpu):

* arrays have shape ``(..., ny, nx)``; axis -1 is x (index i), axis -2 is y (j);
* ``h``-points are cell centers ``(j, i)``;
* ``u``-points sit on the EAST face of cell ``(j, i)`` (i.e. at ``x_{i+1/2}``);
* ``v``-points sit on the NORTH face of cell ``(j, i)`` (at ``y_{j+1/2}``);
* ``q``-points (vorticity) sit on the NORTHEAST corner of cell ``(j, i)``.

This is the MOM6 "non-symmetric" staggering (reference:
src/framework/MOM_memory_macros.h and src/core/MOM_grid.F90:30-140) with the
halo machinery deleted: every shift is a circular roll and solid walls are
enforced by multiplying with face masks.  On a sharded axis XLA lowers
``jnp.roll``/shift-by-one to a ``CollectivePermute`` between neighbouring
devices, which *is* the halo exchange — there is no separate halo
bookkeeping anywhere in the model.

Reference parity: pass_var/pass_vector of MOM_domains.F90:33-61 become no-ops
(GSPMD), directional/corner-omitting variants are unnecessary, and the
tripolar fold will be handled by the grid generator when global grids land.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "ip1", "im1", "jp1", "jm1",
    "delta_i", "delta_j", "mean_i", "mean_j",
    "h_to_u", "h_to_v", "u_to_h", "v_to_h",
    "u_to_q", "v_to_q", "q_to_u", "q_to_v",
    "h_to_q", "q_to_h",
]

_X = -1  # i axis
_Y = -2  # j axis


def ip1(a):
    """Value at (j, i+1): circular shift west by one."""
    return jnp.roll(a, -1, axis=_X)


def im1(a):
    """Value at (j, i-1)."""
    return jnp.roll(a, 1, axis=_X)


def jp1(a, fold=None):
    """Value at (j+1, i).

    ``fold``: None for periodic/walled axes (masks handle walls), or a
    staggering kind for a tripolar NORTHERN FOLD (FOLD_NORTH_EDGE of
    MOM_domain_infra.F90:10-34): the top edge is identified with itself
    under the 180-degree rotation i -> nx-1-i, so the northward
    neighbor of the top row is a mirrored copy of interior rows with
    sign flips for vector components (rotation maps (u,v) -> (-u,-v);
    scalars and vorticity are invariant).  Kinds:

      "h"  scalar at cell centers:      ghost[i] =  a[ny-1, nx-1-i]
      "u"  x-vector at east faces:      ghost[i] = -a[ny-1, nx-2-i]
      "us" scalar at east faces:        ghost[i] =  a[ny-1, nx-2-i]
      "v"  y-vector at north faces:     ghost[i] = -a[ny-2, nx-1-i]
      "vs" scalar at north faces:       ghost[i] =  a[ny-2, nx-1-i]
      "q"  scalar at NE corners:        ghost[i] =  a[ny-2, nx-2-i]
      "qv" y-vector component at corners: ghost[i] = -a[ny-2, nx-2-i]

    (the "v"/"vs" ghosts skip a row because the top v-face row LIES ON
    the fold; "u"/"q" shift one column because faces/corners mirror
    about cell centers).  Used by the dynamic kernels when
    ``G.fold_north``; composition is exact — any op whose inputs carry
    correct folded rows produces correct rows everywhere."""
    r = jnp.roll(a, -1, axis=_Y)
    if fold is None:
        return r
    return r.at[..., -1, :].set(fold_ghost(a, fold))


def fold_ghost(a, kind):
    """The northern-fold ghost row (see jp1) of array ``a``."""
    m = a[..., ::-1]                       # x-mirrored
    if kind == "h":
        return m[..., -1, :]
    if kind == "u":
        return -jnp.roll(m[..., -1, :], -1, axis=-1)
    if kind == "us":
        return jnp.roll(m[..., -1, :], -1, axis=-1)
    if kind == "v":
        return -m[..., -2, :]
    if kind == "vs":
        return m[..., -2, :]
    if kind == "q":
        return jnp.roll(m[..., -2, :], -1, axis=-1)
    if kind == "qv":
        return -jnp.roll(m[..., -2, :], -1, axis=-1)
    if kind == "dh":
        # y-antisymmetric center scalar (e.g. a dT/dy slope): the
        # rotation flips the y axis, so the mirrored value is negated
        return -m[..., -1, :]
    raise ValueError(f"unknown fold kind {kind!r}")


def jp1_sn(a_s, a_n, fold=None):
    """jp1 of a SOUTH/NORTH-edge pair of cell-centered values (e.g. PPM
    edge reconstructions): under the fold's 180-degree rotation the
    south edge of the ghost cell is the mirrored NORTH edge and vice
    versa, so the pair swaps.  Returns (jp1(a_s), jp1(a_n))."""
    rs = jnp.roll(a_s, -1, axis=_Y)
    rn = jnp.roll(a_n, -1, axis=_Y)
    if fold is None:
        return rs, rn
    return (rs.at[..., -1, :].set(fold_ghost(a_n, "h")),
            rn.at[..., -1, :].set(fold_ghost(a_s, "h")))


def jm1_s0(a, fold=None):
    """jm1 of a y-face FLUX with a solid southern wall: with a northern
    fold active, the wrap row read by jm1 at j=0 is the (nonzero) fold
    row, but the southern boundary of a tripolar grid is a wall — zero
    it.  (Without a fold, mask2dCv[-1] = 0 already makes this a no-op.)"""
    r = jnp.roll(a, 1, axis=_Y)
    if not fold:
        return r
    return r.at[..., 0, :].set(0.0)


def fold_kinds(G):
    """Per-staggering fold kinds gated on ``G.fold_north``: the 6-tuple
    ("h","u","v","q","us","vs") when the grid has a tripolar northern
    fold, else all None (jp1 falls back to the plain roll)."""
    if getattr(G, "fold_north", False):
        return "h", "u", "v", "q", "us", "vs"
    return None, None, None, None, None, None


def jm1(a):
    """Value at (j-1, i)."""
    return jnp.roll(a, 1, axis=_Y)


# -- first differences -------------------------------------------------------

def delta_i(a):
    """a(i+1) - a(i): center field -> u-point gradient numerator,
    or u-point flux -> divergence contribution at center i+1 ... use with care:
    for flux divergence at centers use ``a - im1(a)`` (see div_h)."""
    return ip1(a) - a


def delta_j(a):
    """a(j+1) - a(j)."""
    return jp1(a) - a


# -- two-point means between staggered locations ------------------------------

def mean_i(a):
    """0.5*(a(i) + a(i+1))."""
    return 0.5 * (a + ip1(a))


def mean_j(a):
    """0.5*(a(j) + a(j+1))."""
    return 0.5 * (a + jp1(a))


def h_to_u(a):
    """Center -> east-face (u-point) arithmetic mean."""
    return 0.5 * (a + ip1(a))


def h_to_v(a):
    """Center -> north-face (v-point) arithmetic mean."""
    return 0.5 * (a + jp1(a))


def u_to_h(a):
    """u-point -> center mean: faces at i-1/2 and i+1/2 of cell i are
    u[i-1] and u[i]."""
    return 0.5 * (a + im1(a))


def v_to_h(a):
    return 0.5 * (a + jm1(a))


def u_to_q(a):
    """u-point (east face) -> NE corner mean (average in j)."""
    return 0.5 * (a + jp1(a))


def v_to_q(a):
    """v-point (north face) -> NE corner mean (average in i)."""
    return 0.5 * (a + ip1(a))


def q_to_u(a):
    """Corner -> east face (average corners at j-1/2 and j+1/2)."""
    return 0.5 * (a + jm1(a))


def q_to_v(a):
    return 0.5 * (a + im1(a))


def h_to_q(a):
    """Center -> corner 4-point mean."""
    return 0.25 * ((a + ip1(a)) + (jp1(a) + ip1(jp1(a))))


def q_to_h(a):
    return 0.25 * ((a + im1(a)) + (jm1(a) + im1(jm1(a))))
