"""Ensemble ODA cycle: gather members -> EAKF -> analysis increments.

Analogue of MOM6's MOM_oda_driver.F90:824 (SURVEY.md §2.11): the
reference gathers member states onto filter PEs with redistribute_array,
runs the (ENABLE_ECDA) EAKF, and hands increments to MOM_oda_incupd for
ramped application inside the diabatic sequence
(MOM_diabatic_driver.F90:1770-1870).

Design: the ensemble is the leading axis of the state pytree
(parallel/ensemble.py) — the "gather" is a reshape, on-device; the
sequential-in-observations EAKF (physics/oda_eakf.py) runs as a lax.scan
over the observation batch; the output is a per-member
``IncrementalUpdate`` that step_mom applies over a ramp window via
Forcing.oda_inc (the oda_incupd call site of the diabatic sequence).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mom6_tpu.physics.oda_eakf import EAKFParams, eakf_update
from mom6_tpu.physics.oda_incupd import IncrementalUpdate

__all__ = ["ODAParams", "oda_analysis", "synthetic_sst_obs"]


class ODAParams(NamedTuple):
    eakf: EAKFParams = EAKFParams()
    ramp_seconds: float = 6.0 * 3600.0
    assim_T: bool = True
    assim_S: bool = False


def _flatten_members(ens_T, ens_S, assim_S):
    ne = ens_T.shape[0]
    parts = [ens_T.reshape(ne, -1)]
    if assim_S:
        parts.append(ens_S.reshape(ne, -1))
    return jnp.concatenate(parts, axis=1)


def oda_analysis(ens_state, obs_idx, obs_val, obs_var, G,
                 p: ODAParams = ODAParams()
                 ) -> Tuple[IncrementalUpdate, jnp.ndarray]:
    """One analysis step.

    ``ens_state``: state pytree with a leading ensemble axis (ne, ...);
    ``obs_idx``: (n_obs,) int32 indices into the FLATTENED assimilated
    state vector (T[, then S]) — e.g. surface-T observation at (j, i)
    has index j*nx + i;
    returns (IncrementalUpdate with per-member (ne, nz, ny, nx)
    increments, the updated flat ensemble for diagnostics)."""
    ens_T, ens_S = ens_state.T, ens_state.S
    ne = ens_T.shape[0]
    shape_T = ens_T.shape[1:]
    x_f = _flatten_members(ens_T, ens_S, p.assim_S)
    coords = None
    if p.eakf.loc_radius > 0.0:
        # (n, 2) grid coordinates per flat state element for the
        # Gaspari-Cohn localization (vertical treated as colocated)
        nz, ny, nx = shape_T
        jj, ii = np.mgrid[0:ny, 0:nx]
        c2 = np.stack([jj.ravel(), ii.ravel()], axis=-1).astype(np.float32)
        reps = nz * (2 if p.assim_S else 1)
        coords = jnp.asarray(np.tile(c2, (reps, 1)))
    x_a = eakf_update(x_f, obs_idx, obs_val, obs_var, p.eakf,
                      coords=coords)
    dx = (x_a - x_f)
    n_t = int(np.prod(shape_T))
    dT = dx[:, :n_t].reshape((ne,) + shape_T) * G.mask2dT[None, None]
    dS = None
    if p.assim_S:
        dS = dx[:, n_t:].reshape((ne,) + shape_T) * G.mask2dT[None, None]
    inc = IncrementalUpdate(dT=dT, dS=dS, ramp_seconds=p.ramp_seconds)
    return inc, x_a


def synthetic_sst_obs(truth_T, mask, n_obs, noise_std, seed=0):
    """Twin-experiment observations: sample n_obs wet surface points of
    the truth T field with Gaussian error.  Returns (obs_idx into the
    flattened (nz, ny, nx) T vector, obs_val, obs_var) as numpy."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = truth_T.shape
    wet = np.argwhere(np.asarray(mask) > 0.5)
    sel = wet[rng.choice(len(wet), size=n_obs, replace=False)]
    idx = (sel[:, 0] * nx + sel[:, 1]).astype(np.int32)   # k=0 surface
    vals = np.asarray(truth_T)[0, sel[:, 0], sel[:, 1]] \
        + noise_std * rng.standard_normal(n_obs)
    var = np.full(n_obs, noise_std ** 2)
    return idx, vals.astype(np.float64), var
