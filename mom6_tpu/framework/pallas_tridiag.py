"""Batched tridiagonal (Thomas) solve as one GPU kernel (Pallas, Triton route).

The scan form (``framework.solvers._tridiag_scan``) compiles to two while
loops over k on the GPU: about 2·nz small launches per solve, each
streaming a whole (ny, nx) plane.  This kernel runs the whole recursion
in one launch:

* the batch is flattened to (nz, N) columns;
* one program per power-of-two block of columns, k looped inside it with
  masked loads and stores (no padding copy of the operands);
* cp and dp are carried in registers on the way down and written once to
  an output pair (cp, x) that the back-substitution reads again while it
  is still in L2.

It performs the scan's operations in the scan's order, so the two agree
to rounding (bitwise where the compiler contracts multiply-adds alike).
``framework.solvers.tridiag_solve`` owns the choice between them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["tridiag_solve_kernel"]

_BLOCK = 256          # columns per program (power of two)


def _thomas_kernel(a_ref, b_ref, c_ref, d_ref, x_ref, cp_ref, *, block):
    nz, n = d_ref.shape
    start = pl.program_id(0) * block
    cols = pl.ds(start, block)
    mask = start + jnp.arange(block) < n

    def load(ref, k, other=0.0):
        return plgpu.load(ref.at[k, cols], mask=mask, other=other)

    def store(ref, k, val):
        plgpu.store(ref.at[k, cols], val, mask=mask)

    def fwd(k, carry):
        cp_prev, dp_prev = carry
        a_k = load(a_ref, k)
        inv = 1.0 / (load(b_ref, k, other=1.0) - a_k * cp_prev)
        cp = load(c_ref, k) * inv
        dp = (load(d_ref, k) - a_k * dp_prev) * inv
        store(cp_ref, k, cp)
        store(x_ref, k, dp)                 # x holds dp until the sweep back
        return cp, dp

    zeros = jnp.zeros((block,), d_ref.dtype)
    _, x_last = jax.lax.fori_loop(0, nz, fwd, (zeros, zeros))

    def bwd(i, x_next):
        k = nz - 2 - i
        x = load(x_ref, k) - load(cp_ref, k) * x_next
        store(x_ref, k, x)
        return x

    jax.lax.fori_loop(0, nz - 1, bwd, x_last)


def _solve_flat(a, b, c, d, interpret):
    """The kernel on (nz, N) operands of one shape."""
    n = d.shape[1]
    block = min(_BLOCK, pl.next_power_of_2(n))
    anywhere = pl.BlockSpec(memory_space=pl.ANY)
    x, _ = pl.pallas_call(
        functools.partial(_thomas_kernel, block=block),
        out_shape=[jax.ShapeDtypeStruct(d.shape, d.dtype)] * 2,
        grid=(pl.cdiv(n, block),),
        in_specs=[anywhere] * 4,
        out_specs=[anywhere] * 2,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="tridiag_thomas",
    )(a, b, c, d)
    return x


def _solve_nd(a, b, c, d, interpret):
    nz = d.shape[0]
    flat = (v.reshape(nz, -1) for v in (a, b, c, d))
    return _solve_flat(*flat, interpret).reshape(d.shape)


@functools.cache
def _solver(interpret: bool):
    """The kernel on (nz, ...) operands of one shape, batchable by vmap."""

    @jax.custom_batching.custom_vmap
    def solve(a, b, c, d):
        return _solve_nd(a, b, c, d, interpret)

    @solve.def_vmap
    def _(axis_size, in_batched, a, b, c, d):
        # a vmapped axis is one more batch of columns: put it behind k
        def behind_k(v, batched):
            if batched:
                return jnp.moveaxis(v, 0, 1)
            return jnp.broadcast_to(v[:, None],
                                    (v.shape[0], axis_size) + v.shape[1:])
        x = solve(*map(behind_k, (a, b, c, d), in_batched))
        return jnp.moveaxis(x, 1, 0), True

    return solve


def tridiag_solve_kernel(a, b, c, d, *, interpret: bool = False):
    """Thomas solve along axis 0 with the GPU kernel.

    Same semantics as ``framework.solvers.tridiag_solve``: a/b/c may
    broadcast against d, and any batch shape (nz, ...) is accepted.
    ``interpret=True`` runs the kernel through the Pallas interpreter
    (the CPU tests); it is never a fallback."""
    a, b, c = (jnp.broadcast_to(v, d.shape).astype(d.dtype)
               for v in (a, b, c))
    return _solver(interpret)(a, b, c, d)
