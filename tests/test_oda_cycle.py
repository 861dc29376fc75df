"""Closed ODA loop: twin experiment.

The full cycle of MOM_oda_driver.F90:824 + MOM_oda_incupd.F90:849 on the
vmapped ensemble: perturbed ensemble -> forecast -> EAKF analysis of
synthetic observations of a truth run -> ramped incremental application
inside the diabatic sequence (Forcing.oda_inc) -> repeat.  Assimilation
must demonstrably reduce the ensemble-mean error against the truth
relative to a no-DA control ensemble."""

import jax
import jax.numpy as jnp
import numpy as np

from mom6_tpu.core.mom import step_mom
from mom6_tpu.drivers.experiments import thermo_gyre
from mom6_tpu.physics.oda_driver import (ODAParams, oda_analysis,
                                         synthetic_sst_obs)
from mom6_tpu.physics.oda_eakf import EAKFParams


def _smooth_noise(rng, ny, nx, amp):
    """Large-scale random field from a few Fourier modes."""
    f = np.zeros((ny, nx))
    for _ in range(4):
        kx, ky = rng.integers(1, 3, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        f += np.cos(2 * np.pi * kx * np.arange(nx) / nx + ph[0])[None, :] \
            * np.cos(2 * np.pi * ky * np.arange(ny) / ny + ph[1])[:, None]
    return amp * f / 4.0


def test_twin_experiment_reduces_error():
    G, GV, state0, params, forcing = thermo_gyre(nx=24, ny=20, nz=3,
                                                 dt=1800.0)
    ne = 16
    rng = np.random.default_rng(7)
    step = jax.jit(lambda s: step_mom(s, forcing, G, GV, params))

    def step_inc(s, inc_T):
        from mom6_tpu.physics.oda_incupd import IncrementalUpdate
        f = forcing._replace(oda_inc=IncrementalUpdate(
            dT=inc_T, ramp_seconds=params.dyn.dt * params.n_dyn_per_thermo
            * steps_per_cycle))
        return step_mom(s, f, G, GV, params)

    steps_per_cycle = 8
    step_inc = jax.jit(jax.vmap(step_inc))
    vstep = jax.jit(jax.vmap(step))

    # truth + biased, spread ensemble: a SHARED large-scale bias (the
    # part assimilation must remove — it does not average out) plus
    # independent member spread (what the EAKF regresses on)
    truth = state0
    T0 = np.asarray(state0.T)
    bias = _smooth_noise(rng, G.ny, G.nx, amp=2.0)
    members = []
    for _ in range(ne):
        pert = bias + _smooth_noise(rng, G.ny, G.nx, amp=1.0)
        members.append(state0.replace(
            T=jnp.asarray(T0 + pert[None], jnp.float32)))
    ens = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    ctrl = ens

    p_oda = ODAParams(eakf=EAKFParams(inflation=1.12,
                                  loc_radius=8.0),
                  assim_T=True)
    msk = np.asarray(G.mask2dT)

    def rmse(e, tr):
        em = np.asarray(jnp.mean(e.T, axis=0))[0]
        tt = np.asarray(tr.T)[0]
        return float(np.sqrt((((em - tt) * msk) ** 2).sum()
                             / msk.sum()))

    r0 = rmse(ens, truth)
    n_cycles = 8
    for c in range(n_cycles):
        # analysis from synthetic surface-T observations of the truth
        idx, vals, var = synthetic_sst_obs(np.asarray(truth.T), msk,
                                           n_obs=100, noise_std=0.05,
                                           seed=100 + c)
        inc, _ = oda_analysis(ens, jnp.asarray(idx), jnp.asarray(vals),
                              jnp.asarray(var), G, p_oda)
        # forecast with the ramped increments; control without
        for _ in range(steps_per_cycle):
            ens = step_inc(ens, inc.dT)
            ctrl = vstep(ctrl)
            truth = step(truth)
    r_da = rmse(ens, truth)
    r_ctrl = rmse(ctrl, truth)
    assert np.isfinite(np.asarray(ens.T)).all()
    # assimilation beats both the control and the initial error decisively
    assert r_da < 0.5 * r_ctrl, (r_da, r_ctrl, r0)
    assert r_da < 0.5 * r0, (r_da, r0)
