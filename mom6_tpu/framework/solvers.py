"""Batched column solvers.

The vertical dimension is never sharded (SURVEY.md §5.7): every column solve
runs device-local, vectorized over (ny, nx).  Used by vertical viscosity,
diabatic diffusion, JHL shear mixing, the ALE edge-value solvers and the
wave-speed inverse iteration (reference: tridiagonal solvers in
src/parameterizations/vertical/MOM_vert_friction.F90:557 and
src/ALE/regrid_solvers.F90).

Two implementations of one Thomas recursion: ``_tridiag_scan``, a
``lax.scan`` over k that runs everywhere and is the reference, and the
GPU kernel of ``framework.pallas_tridiag``.  ``tridiag_solve`` picks the
kernel for float32 column batches lowered for a CUDA device, and the scan
for everything else.  Under a (y, x) device mesh the kernel runs once per
shard inside ``shard_map``, so no shard gathers its neighbours' columns.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mom6_tpu.framework.pallas_tridiag import tridiag_solve_kernel

__all__ = ["tridiag_solve"]


def _tridiag_scan(a, b, c, d):
    """Reference lax.scan Thomas solve (all backends)."""
    def fwd(carry, abcd):
        cp_prev, dp_prev = carry
        a_k, b_k, c_k, d_k = abcd
        denom = b_k - a_k * cp_prev
        inv = 1.0 / denom
        cp = c_k * inv
        dp = (d_k - a_k * dp_prev) * inv
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(d[0])
    (_, _), (cp, dp) = jax.lax.scan(fwd, (zeros, zeros), (a, b, c, d))

    def bwd(x_next, cpdp):
        cp_k, dp_k = cpdp
        x = dp_k - cp_k * x_next
        return x, x

    _, x_rev = jax.lax.scan(bwd, zeros, (cp, dp), reverse=True)
    return x_rev


def _ambient_mesh():
    """The device mesh of the enclosing ``jax.set_mesh`` or ``with mesh:``
    context, or None."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty:
        from jax._src.mesh import thread_resources
        mesh = thread_resources.env.physical_mesh
    return None if mesh.empty or mesh.size == 1 else mesh


def _kernel_fits(d, mesh) -> bool:
    """Whether the kernel takes this solve: float32 columns of nz >= 2 and,
    under a mesh, a (y, x) mesh that splits the plane evenly."""
    if d.ndim < 2 or d.shape[0] < 2 or d.dtype != jnp.float32:
        return False
    if mesh is None:
        return True
    if set(mesh.axis_names) != {"y", "x"} or d.ndim < 3:
        return False
    return (d.shape[-2] % mesh.shape["y"] == 0
            and d.shape[-1] % mesh.shape["x"] == 0)


def _kernel_per_shard(mesh):
    def solve(a, b, c, d):
        if mesh is None:
            return tridiag_solve_kernel(a, b, c, d)
        spec = P(*([None] * (d.ndim - 2)), "y", "x")
        a, b, c = (jnp.broadcast_to(v, d.shape) for v in (a, b, c))
        return jax.shard_map(tridiag_solve_kernel, mesh=mesh,
                             in_specs=(spec,) * 4, out_specs=spec,
                             check_vma=False)(a, b, c, d)
    return solve


def tridiag_solve(a, b, c, d):
    """Solve tridiagonal systems along axis 0 (Thomas algorithm).

    ``a`` is the sub-diagonal (a[0] ignored), ``b`` the diagonal, ``c`` the
    super-diagonal (c[-1] ignored), ``d`` the RHS; all shaped (nz, ...)
    (a/b/c may broadcast against d).  Returns x with
    b·x + a·x_{k-1} + c·x_{k+1} = d.
    """
    mesh = _ambient_mesh()
    if not _kernel_fits(d, mesh):
        return _tridiag_scan(a, b, c, d)
    return jax.lax.platform_dependent(a, b, c, d,
                                      cuda=_kernel_per_shard(mesh),
                                      default=_tridiag_scan)
