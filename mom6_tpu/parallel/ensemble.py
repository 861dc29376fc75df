"""Ensemble parallelism.

Analogue of MOM6's ensemble manager (reference:
src/framework/MOM_ensemble_manager.F90; solo driver ensembles at
MOM_driver.F90:685; used by the ODA subsystem, SURVEY.md §2.11/§2.14.6):
N model replicas advanced together.

Design: the ensemble is a leading axis of the state pytree,
stepped with ``jax.vmap`` — one compiled program advances every member —
and optionally sharded over its own mesh axis ('e') so members scale
across devices independently of the spatial decomposition.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

__all__ = ["stack_ensemble", "ensemble_step", "member", "ensemble_mean",
           "ensemble_mesh", "shard_ensemble", "ensemble_step_sharded"]


def stack_ensemble(states: Sequence) -> object:
    """Stack per-member state pytrees along a new leading axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def member(ens_state, i: int):
    return jax.tree_util.tree_map(lambda x: x[i], ens_state)


def ensemble_mean(ens_state):
    return jax.tree_util.tree_map(lambda x: jnp.mean(x, axis=0), ens_state)


def ensemble_step(step_fn: Callable) -> Callable:
    """Vectorize a ``state -> state`` step over the ensemble axis."""
    return jax.vmap(step_fn)


def ensemble_mesh(n_members: int, spatial_shape=(1, 1)):
    """Build an ('e', 'y', 'x') device mesh: members sharded over their
    own axis, each member's domain over the remaining (y, x) submesh —
    the layout of the reference's concurrent ensemble PE lists
    (MOM_ensemble_manager.F90 ensemble_pelist_setup)."""
    import numpy as np
    from jax.sharding import Mesh
    devs = np.array(jax.devices())
    my, mx = spatial_shape
    need = n_members * my * mx
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(devs[:need].reshape(n_members, my, mx), ("e", "y", "x"))


def shard_ensemble(ens_state, mesh):
    """Place a stacked ensemble state on the mesh: leading axis over
    'e', trailing (ny, nx) over ('y', 'x') — every member lives on its
    own device subset and members advance concurrently, not just
    vectorized (device-sharded members vs the single-device vmap)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def place(x):
        spec = [None] * x.ndim
        spec[0] = "e"
        if x.ndim >= 3:
            spec[-2], spec[-1] = "y", "x"
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))
    return jax.tree_util.tree_map(place, ens_state)


def ensemble_step_sharded(step_fn: Callable, mesh) -> Callable:
    """vmap + GSPMD: one jitted program advancing all members, with the
    member axis sharded over the mesh's 'e' devices (XLA runs the
    members concurrently; spatial collectives stay within each member's
    ('y','x') submesh)."""
    vstep = jax.vmap(step_fn)

    @jax.jit
    def run(ens_state):
        from jax.sharding import NamedSharding, PartitionSpec as P

        def constrain(x):
            spec = [None] * x.ndim
            spec[0] = "e"
            if x.ndim >= 3:
                spec[-2], spec[-1] = "y", "x"
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(*spec)))
        ens_state = jax.tree_util.tree_map(constrain, ens_state)
        return vstep(ens_state)
    return run
