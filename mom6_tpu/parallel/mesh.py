"""Device mesh and sharding rules.

The replacement for MOM6's 2-D MPI domain decomposition (reference:
src/framework/MOM_domains.F90:33-61 and SURVEY.md §2.14): the (y, x)
horizontal plane is GSPMD-sharded over a ``jax.sharding.Mesh(('y', 'x'))``;
the vertical (k) axis, tracer count and ensemble axes stay device-local
(SURVEY.md §5.7).  Halo exchanges are not explicit: every roll-by-one in
framework/stencil.py lowers to a CollectivePermute between neighbouring
shards under GSPMD, and column solvers that need whole columns run per
shard (framework/solvers.py).

The mesh factoring is the algorithm's choice, not the interconnect's: the
GPUs of one host are joined all to all, so ``_factor2d`` picks the most
square layout, which minimises the halo perimeter per shard.

Land-block elimination (MASKTABLE) has no analogue here — dense compute +
masks (SURVEY.md §7 "Masked/ragged domains").
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "state_sharding", "shard_over", "constrain_state",
           "bind_mesh"]


def _factor2d(n: int) -> Tuple[int, int]:
    """Split n devices into the most square (ny, nx) layout (auto-LAYOUT
    analogue of MOM_domains_init)."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("y", "x")) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    if shape is None:
        shape = _factor2d(len(devices))
    dev_array = np.asarray(devices[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(dev_array, axis_names)


def spec_for(ndim: int) -> P:
    """PartitionSpec for an array whose trailing two dims are (y, x)."""
    if ndim >= 2:
        return P(*([None] * (ndim - 2) + ["y", "x"]))
    return P()


def shard_over(mesh: Mesh, tree):
    """Device-put a pytree with (..., y, x) sharding on its array leaves."""
    def put(x):
        if hasattr(x, "ndim"):
            return jax.device_put(x, NamedSharding(mesh, spec_for(x.ndim)))
        return x
    return jax.tree_util.tree_map(put, tree)


def state_sharding(mesh: Mesh, tree):
    """The matching shardings pytree (for jit in/out_shardings)."""
    def sh(x):
        if hasattr(x, "ndim"):
            return NamedSharding(mesh, spec_for(x.ndim))
        return None
    return jax.tree_util.tree_map(sh, tree)


def bind_mesh(params, mesh: Mesh):
    """Bind the device mesh into the model params for the solvers that
    manage their own halos: the wide-halo barotropic (BT_WIDE_HALO > 0,
    core/bt_widehalo.py) needs the mesh to build its shard_map rim
    exchanges.  A no-op unless a wide-halo width is configured.  Accepts
    the full model ``params`` (with a ``.dyn.bt``), a ``DynParams``
    (with ``.bt``), or a bare ``BTParams``."""
    def rebind_bt(bt):
        # != 0: a positive width or AUTO (-1) both need the mesh (AUTO
        # resolves its width from it at btstep time)
        return bt._replace(mesh=mesh) if bt.wide_halo != 0 else bt
    if hasattr(params, "dyn"):
        return params._replace(
            dyn=params.dyn._replace(bt=rebind_bt(params.dyn.bt)))
    if hasattr(params, "bt"):
        return params._replace(bt=rebind_bt(params.bt))
    return rebind_bt(params)


def constrain_state(tree):
    """Apply with_sharding_constraint matching the (y, x) rule inside jit."""
    def con(x):
        if hasattr(x, "ndim") and x.ndim >= 2:
            return jax.lax.with_sharding_constraint(
                x, P(*([None] * (x.ndim - 2) + ["y", "x"])))
        return x
    return jax.tree_util.tree_map(con, tree)
