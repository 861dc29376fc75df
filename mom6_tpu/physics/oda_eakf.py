"""Ensemble Adjustment Kalman Filter (EAKF) for ocean data assimilation.

Role of the reference's optional ECDA/EAKF path in the ODA driver
(src/ocean_data_assim/MOM_oda_driver.F90:36 `#ifdef ENABLE_ECDA`, with
MOM_oda_incupd.F90 applying increments): given an ensemble of model
states (the framework's ensemble axis, parallel/ensemble.py) and point
observations, compute the deterministic EAKF update (Anderson 2001):

for each observation with value yo and error variance r, processed
sequentially (a ``lax.scan``; order-dependent only at f32 roundoff for
independent obs):

  1. obs-space prior: y_e = H x_e, mean ybar, variance s;
  2. posterior variance  s_a = s r / (s + r),
     posterior mean      ybar_a = s_a (ybar/s + yo/r);
  3. deterministic shift+contraction of the obs-space ensemble:
       dy_e = (ybar_a - ybar) + (sqrt(s_a/s) - 1)(y_e - ybar);
  4. regression onto every state element:
       x_e += cov(x, y)/s * dy_e   (optionally localized).

Everything is dense linear algebra over the (ne, n_state) block — two
matvecs per observation, at full float32 precision.  Localization uses the
Gaspari-Cohn 5th-order piecewise rational function of grid distance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["EAKFParams", "eakf_update", "gaspari_cohn"]


class EAKFParams(NamedTuple):
    inflation: float = 1.0        # multiplicative prior inflation
    loc_radius: float = 0.0       # localization half-radius [cells]; 0 = off
    s_min: float = 1e-12          # prior-variance floor


def gaspari_cohn(d, c):
    """Gaspari & Cohn (1999) compactly supported correlation function;
    d: distance, c: half-width (support = 2c)."""
    x = jnp.abs(d) / jnp.maximum(c, 1e-30)
    f1 = (((-0.25 * x + 0.5) * x + 0.625) * x - 5.0 / 3.0) * x ** 2 + 1.0
    f2 = ((((x / 12.0 - 0.5) * x + 0.625) * x + 5.0 / 3.0) * x
          - 5.0) * x + 4.0 - 2.0 / (3.0 * jnp.maximum(x, 1e-10))
    return jnp.where(x <= 1.0, f1, jnp.where(x <= 2.0, f2, 0.0))


def eakf_update(ens, obs_idx, obs_val, obs_var,
                p: EAKFParams = EAKFParams(),
                coords: Optional[jnp.ndarray] = None):
    """Sequential EAKF over point observations.

    ens:      (ne, n) ensemble of flattened states;
    obs_idx:  (n_obs,) int32 indices into the state vector (the H rows);
    obs_val:  (n_obs,) observed values;
    obs_var:  (n_obs,) observation error variances;
    coords:   optional (n, 2) grid coordinates per state element for
              Gaspari-Cohn localization (with p.loc_radius > 0).

    Returns the updated (ne, n) ensemble."""
    ne = ens.shape[0]
    if p.inflation != 1.0:
        mean = jnp.mean(ens, axis=0, keepdims=True)
        ens = mean + p.inflation * (ens - mean)

    use_loc = p.loc_radius > 0.0 and coords is not None

    def assimilate(ens, obs):
        idx, yo, r = obs
        y = ens[:, idx]                          # (ne,)
        ybar = jnp.mean(y)
        yp = y - ybar
        s = jnp.sum(yp * yp) / (ne - 1)
        s = jnp.maximum(s, p.s_min)
        s_a = s * r / (s + r)
        ybar_a = s_a * (ybar / s + yo / r)
        shrink = jnp.sqrt(s_a / s)
        dy = (ybar_a - ybar) + (shrink - 1.0) * yp       # (ne,)
        # regression of the state on the obs-space perturbation
        xp = ens - jnp.mean(ens, axis=0, keepdims=True)  # (ne, n)
        cov = jnp.matmul(yp, xp, precision=jax.lax.Precision.HIGHEST
                         ) / (ne - 1)                    # (n,)
        gain = cov / s
        if use_loc:
            d = jnp.sqrt(jnp.sum((coords - coords[idx]) ** 2, axis=-1))
            gain = gain * gaspari_cohn(d, p.loc_radius)
        return ens + dy[:, None] * gain[None, :], None

    obs = (obs_idx.astype(jnp.int32), obs_val, obs_var)
    ens, _ = jax.lax.scan(assimilate, ens, obs)
    return ens
