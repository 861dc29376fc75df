"""remap_columns_multi (ale/remapping.py) against a per-column NumPy
integration.

The reference integrates each cell's reconstruction over its overlap with
every target cell in float64, one column at a time; the code under test
evaluates clipped cumulative integrals at all target interfaces at once
(the gather-free O(nz^2) scan).  The reconstruction itself
(``reconstruct``) is shared: these tests pin the integration.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mom6_tpu.ale import remapping as R


def _problem(nz0=10, nz1=14, ny=9, nx=17, nf=3, seed=0, vanished=False):
    rng = np.random.RandomState(seed)
    h0 = 20.0 + 10.0 * rng.rand(nz0, ny, nx).astype(np.float32)
    if vanished:
        h0[2] = 1e-10
        h0[7, : ny // 2] = 1e-10
    w = 0.5 + rng.rand(nz1, ny, nx).astype(np.float32)
    h1 = (w / w.sum(0, keepdims=True)
          * h0.sum(0, keepdims=True)).astype(np.float32)
    fields = rng.randn(nf, nz0, ny, nx).astype(np.float32)
    return jnp.asarray(fields), jnp.asarray(h0), jnp.asarray(h1)


def _column_reference(fields, h0, h1, scheme):
    """Overlap-by-overlap integration of the reconstruction, in float64."""
    coefs = [np.asarray(jnp.stack(R.reconstruct(f, h0, scheme)),
                        np.float64) for f in fields]
    h0, h1 = np.asarray(h0, np.float64), np.asarray(h1, np.float64)
    nf, (nz0, ny, nx), nz1 = len(coefs), h0.shape, h1.shape[0]
    out = np.zeros((nf, nz1, ny, nx))
    powers = np.arange(1, 6)

    def antideriv(c, xi):            # integral of u(xi') over [0, xi]
        return np.sum(c * xi ** powers / powers)

    for j in range(ny):
        for i in range(nx):
            z0 = np.concatenate([[0.0], np.cumsum(h0[:, j, i])])
            z1 = np.concatenate([[0.0], np.cumsum(h1[:, j, i])])
            z1 = np.minimum(z1, z0[-1])
            for t in range(nz1):
                for k in range(nz0):
                    lo = max(z1[t], z0[k])
                    hi = min(z1[t + 1], z0[k + 1])
                    if hi <= lo or h0[k, j, i] <= 0.0:
                        continue
                    for f in range(nf):
                        c = coefs[f][:, k, j, i]
                        out[f, t, j, i] += h0[k, j, i] * (
                            antideriv(c, (hi - z0[k]) / h0[k, j, i])
                            - antideriv(c, (lo - z0[k]) / h0[k, j, i]))
            out[:, :, j, i] /= np.maximum(h1[:, j, i], 1e-30)
    src = np.asarray(fields, np.float64)
    return np.clip(out, src.min(1, keepdims=True), src.max(1, keepdims=True))


@pytest.mark.parametrize("case", [
    dict(scheme=R.PPM_H4, kw=dict()),
    dict(scheme=R.PQM_IH4IH3, kw=dict(seed=3)),
    dict(scheme=R.PLM, kw=dict(vanished=True, seed=1)),
    dict(scheme=R.PPM_H4, kw=dict(ny=5, nx=13, nf=2, nz0=7, nz1=4, seed=2)),
], ids=["ppm", "pqm", "plm_vanished_layers", "ppm_odd_sizes"])
def test_remap_matches_column_integration(case):
    fields, h0, h1 = _problem(**case["kw"])
    got = np.asarray(R.remap_columns_multi(fields, h0, h1, case["scheme"]),
                     np.float64)
    want = _column_reference(fields, h0, h1, case["scheme"])
    assert np.isfinite(got).all()
    # float32 cumulative integrals differenced over ~20 m target cells in
    # ~250 m columns: a few ulps of the column integral per cell
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # conservation: the column content moves, it is not made or lost
    h064, h164 = np.asarray(h0, np.float64), np.asarray(h1, np.float64)
    np.testing.assert_allclose(
        (got * h164[None]).sum(1),
        (np.asarray(fields, np.float64) * h064[None]).sum(1),
        rtol=5e-5, atol=1e-3)
