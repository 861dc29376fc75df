"""The GPU tridiagonal kernel (framework/pallas_tridiag.py) and the choice
between it and the scan (framework/solvers.py).

The kernel runs here through the Pallas interpreter; the choice is checked
on the lowered program for a CUDA device, which JAX builds without one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mom6_tpu.framework import solvers
from mom6_tpu.framework.pallas_tridiag import tridiag_solve_kernel
from mom6_tpu.parallel.mesh import make_mesh


def _system(shape, seed=0, dtype=np.float32):
    """A diagonally dominant system of the vertical-diffusion form."""
    rng = np.random.default_rng(seed)
    a = -rng.uniform(0.0, 1.0, shape)
    c = -rng.uniform(0.0, 1.0, shape)
    a[0] = 0.0
    c[-1] = 0.0
    b = 0.5 + rng.uniform(0.0, 1.0, shape) - a - c
    d = rng.standard_normal(shape)
    return tuple(jnp.asarray(v, dtype) for v in (a, b, c, d))


def _dense(a, b, c, d):
    """Column-by-column numpy.linalg.solve of the same systems."""
    shape = d.shape
    a, b, c, d = (np.broadcast_to(np.asarray(v, np.float64), shape)
                  .reshape(d.shape[0], -1) for v in (a, b, c, d))
    x = np.empty_like(d)
    for j in range(d.shape[1]):
        m = np.diag(b[:, j]) + np.diag(a[1:, j], -1) \
            + np.diag(c[:-1, j], 1)
        x[:, j] = np.linalg.solve(m, d[:, j])
    return x.reshape(shape)


def _kernel(a, b, c, d):
    return tridiag_solve_kernel(a, b, c, d, interpret=True)


# odd widths: fewer columns than one block, one partial block, and
# several blocks with a partial last one (the block is 256 columns)
@pytest.mark.parametrize("batch", [(1,), (7,), (5, 13), (3, 257)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nz", [2, 3, 32, 75])
def test_kernel_matches_scan_and_dense_solve(nz, batch):
    a, b, c, d = _system((nz,) + batch, seed=nz)
    x = np.asarray(_kernel(a, b, c, d))
    # same operations in the same order as the scan
    want = np.asarray(solvers._tridiag_scan(a, b, c, d))
    np.testing.assert_allclose(x, want, rtol=0,
                               atol=2e-6 * np.abs(x).max())
    np.testing.assert_allclose(x, _dense(a, b, c, d), rtol=2e-4,
                               atol=2e-5 * np.abs(x).max())


@pytest.mark.parametrize("coef_shape", ["column", "scalar_per_level"])
def test_kernel_broadcasts_coefficients(coef_shape):
    nz, ny, nx = 6, 5, 9
    a, b, c, d = _system((nz, ny, nx), seed=3)
    if coef_shape == "column":
        a, b, c = a[:, :1], b[:, :1], c[:, :1]        # (nz, 1, nx)
    else:
        a, b, c = a[:, :1, :1], b[:, :1, :1], c[:, :1, :1]
    x = np.asarray(_kernel(a, b, c, d))
    np.testing.assert_allclose(x, np.asarray(solvers._tridiag_scan(
        *(jnp.broadcast_to(v, d.shape) for v in (a, b, c)), d)),
        rtol=0, atol=2e-6 * np.abs(x).max())
    np.testing.assert_allclose(x, _dense(a, b, c, d), rtol=2e-4,
                               atol=2e-5 * np.abs(x).max())


def test_kernel_vert_diff_batch_shape():
    """tracers/vert_diff solves (nz, n_tr, ny, nx) with coefficients shared
    by the tracers, shaped (nz, 1, ny, nx)."""
    nz, ntr, ny, nx = 8, 3, 6, 11
    a, b, c, _ = _system((nz, 1, ny, nx), seed=4)
    d = jnp.asarray(np.random.default_rng(5).standard_normal(
        (nz, ntr, ny, nx)), jnp.float32)
    x = _kernel(a, b, c, d)
    assert x.shape == d.shape
    np.testing.assert_allclose(np.asarray(x), _dense(a, b, c, d),
                               rtol=2e-4, atol=2e-5 * float(jnp.abs(x).max()))


def test_kernel_under_vmap_folds_batch_into_columns():
    a, b, c, d = _system((5, 4, 6), seed=6)
    # the vmapped axis (1) carries the RHS only; the matrix is shared
    x = jax.vmap(lambda dd: _kernel(a[:, 0], b[:, 0], c[:, 0], dd),
                 in_axes=1, out_axes=1)(d)
    want = solvers._tridiag_scan(*(jnp.broadcast_to(v[:, :1], d.shape)
                                   for v in (a, b, c)), d)
    np.testing.assert_allclose(np.asarray(x), np.asarray(want), rtol=0,
                               atol=2e-6 * float(jnp.abs(want).max()))


@pytest.mark.parametrize("shape,dtype,expect", [
    ((8, 4, 6), jnp.float32, True),
    ((8, 24), jnp.float32, True),
    ((8, 4, 6), jnp.float64, False),
    ((8,), jnp.float32, False),
    ((1, 4, 6), jnp.float32, False),
], ids=["f32_3d", "f32_2d", "f64", "1d", "nz1"])
def test_kernel_choice_by_dtype_and_shape(shape, dtype, expect):
    assert solvers._kernel_fits(jax.ShapeDtypeStruct(shape, dtype),
                                None) is expect


def _lowered(fn, args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,expect", [("cuda", True), ("cpu", False)])
def test_kernel_choice_by_backend(platform, expect):
    """The kernel is lowered for CUDA devices only; the CPU gets the scan
    (chosen when the program is lowered, not from the default backend)."""
    args = _system((6, 4, 8))
    assert ("tridiag_thomas" in _lowered(solvers.tridiag_solve, args,
                                         platform)) is expect


def test_kernel_runs_per_shard_under_mesh(devices8):
    """Under a (y, x) mesh the kernel call sits inside shard_map: each
    device solves its own columns and nothing is gathered."""
    mesh = make_mesh(devices8[:4], shape=(2, 2))
    spec = NamedSharding(mesh, P(None, "y", "x"))
    args = [jax.device_put(v, spec) for v in _system((6, 8, 12), seed=7)]
    with mesh:
        text = _lowered(solvers.tridiag_solve, args, "cuda")
    assert "tridiag_thomas" in text
    assert "shard_map" in text or "manual" in text
    assert "all_gather" not in text and "all-gather" not in text


def test_kernel_interpreted_under_shard_map_matches_scan(devices8):
    mesh = make_mesh(devices8[:4], shape=(2, 2))
    spec = P(None, "y", "x")
    a, b, c, d = _system((5, 8, 12), seed=8)
    solve = jax.jit(jax.shard_map(_kernel, mesh=mesh, in_specs=(spec,) * 4,
                                  out_specs=spec, check_vma=False))
    args = [jax.device_put(v, NamedSharding(mesh, spec))
            for v in (a, b, c, d)]
    hlo = solve.lower(*args).compile().as_text()
    assert "all-gather" not in hlo
    np.testing.assert_allclose(
        np.asarray(solve(*args)),
        np.asarray(solvers._tridiag_scan(a, b, c, d)), rtol=0,
        atol=2e-6 * float(jnp.abs(d).max()))


def test_uneven_mesh_split_takes_the_scan(devices8):
    """A plane the mesh cannot split evenly keeps the scan (shard_map
    needs whole shards)."""
    mesh = make_mesh(devices8[:4], shape=(2, 2))
    args = _system((6, 7, 12))
    with mesh:
        assert "tridiag_thomas" not in _lowered(solvers.tridiag_solve,
                                                args, "cuda")
