"""Deterministic, layout-invariant random streams (MOM_random analogue).

The reference (src/framework/MOM_random.F90) keeps one Mersenne-twister
stream per grid cell, seeded from a hash of the model date, a
user seed, and the cell's GLOBAL index — so fields are reproducible and
independent of the domain decomposition.  The equivalent here is
a counter-based stateless PRNG: JAX's threefry keyed by
(user seed, date hash, stream name) with the cell's position as the
counter.  A jitted ``random_2d_*`` call produces one global array whose
per-cell values depend only on (key, global index); under GSPMD the
generation is partitioned but the values are bitwise identical to the
unsharded run — decomposition invariance by construction rather than by
bookkeeping.

``seed_from_time`` reproduces the reference's date hash
(MOM_random.F90:175-198) so runs restarted at the same model date
regenerate the same streams.  ``random_01_cb`` is the reference's
counter-based "Squares" generator (arXiv:2004.06278 as adapted at
:65-84), host-side, for the callers that want a scalar stream from a
(counter, key) pair.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["seed_from_time", "grid_key", "random_2d_01",
           "random_2d_norm", "random_01_cb"]


def seed_from_time(year: int, month: int, day: int, hour: int = 0,
                   minute: int = 0, second: int = 0) -> int:
    """Hash of the model date (seed_from_time, MOM_random.F90:175-190):
    s1 from the time of day, s2 from the calendar day, xor-folded."""
    s1 = second + 61 * (minute + 61 * hour) + 379
    s2 = (day + 32 * (month + 13 * year)) % 2147483647
    return int(np.bitwise_xor(np.int64(s1 * 4111),
                              np.int64(s2)) & 0x7FFFFFFF)


def grid_key(seed: int, date=None, stream: int = 0):
    """Build the threefry key for a gridded stream: user seed xor-folded
    with the date hash (random_2d_constructor's tseed*9007 ^ seed
    construction, :151-172) and a stream discriminator."""
    tseed = seed_from_time(*date) if date is not None else 0
    base = int(np.bitwise_xor(np.int64(tseed * 9007),
                              np.int64(seed)) & 0x7FFFFFFF)
    key = jax.random.PRNGKey(base)
    if stream:
        key = jax.random.fold_in(key, stream)
    return key


def random_2d_01(key, shape):
    """Uniform [0,1) per cell (random_2d_01 role).  The value of cell
    (j, i) depends only on (key, j*nx + i): slicing a larger generation
    or sharding the array never changes it."""
    return jax.random.uniform(key, shape)


def random_2d_norm(key, shape):
    """Approximately normal per cell by the reference's 12-uniform sum
    (random_norm / random_2d_norm, MOM_random.F90:86-134): the Irwin-
    Hall construction, mean 0 and variance 1 by construction."""
    u = jax.random.uniform(key, (12,) + tuple(shape))
    return jnp.sum(u - 0.5, axis=0)


def random_01_cb(ctr, key):
    """The counter-based "Squares" generator exactly as the reference
    adapted it (random_01_CB, MOM_random.F90:65-84): three squaring
    rounds with 32-bit rotations on int64, returning a value in (0, 1].
    ``ctr``/``key`` may be scalars or integer arrays (vectorized).
    Host-side numpy: callers wanting device-side streams should use the
    threefry path above."""
    with np.errstate(over="ignore"):
        x = (np.int64(ctr) + 1) * (np.int64(key) + 65536)
        y = x.copy()
        z = y + (np.int64(key) + 65536)

        def rot(v):
            u = v.astype(np.uint64)
            return ((u << np.uint64(32)) | (u >> np.uint64(32))
                    ).astype(np.int64)

        x = rot(x * x + y)
        x = rot(x * x + z)
        x = rot(x * x + y)
        x = x * x + z
        top = (x.astype(np.uint64) >> np.uint64(32)).astype(np.int64)
        # int(...) in the reference truncates the SIGNED 32-bit view
        top32 = top.astype(np.int32).astype(np.float64)
        return 0.5 * (1.0 + 0.5 * top32 / float(2 ** 30))
