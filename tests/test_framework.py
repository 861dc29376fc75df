"""Framework-layer unit tests: config parser, reproducing sums, checksums,
stencils, tridiagonal solver."""

import numpy as np
import jax.numpy as jnp
import pytest

from mom6_tpu.framework.config import param_file_from_text
from mom6_tpu.framework.repro_sum import reproducing_sum, fixed_point_sum
from mom6_tpu.framework.checksums import bitcount_checksum, chksum_stats
from mom6_tpu.framework import stencil
from mom6_tpu.framework.solvers import tridiag_solve


class TestConfig:
    def test_basic_types(self):
        pf = param_file_from_text("""
            ! a comment
            DT = 1200.0        ! time step
            NIGLOBAL = 44
            SPLIT = True
            INPUTDIR = "data/in"
            GRID_CONFIG = cartesian
        """)
        assert pf.get("DT", float) == 1200.0
        assert pf.get("NIGLOBAL", int) == 44
        assert pf.get("SPLIT", bool) is True
        assert pf.get("INPUTDIR", str) == "data/in"
        assert pf.get("GRID_CONFIG", str) == "cartesian"

    def test_defaults_and_override(self):
        pf = param_file_from_text("""
            DT = 100.0
            #override DT = 900.0
            DT = 300.0
        """)
        assert pf.get("DT", float) == 900.0
        assert pf.get("MISSING", float, default=7.5) == 7.5
        with pytest.raises(KeyError):
            pf.get("REQUIRED_THING", float)

    def test_fortran_literals(self):
        pf = param_file_from_text("KV = 1.0d-4\nN = 1E3\nFLAG = .true.\n")
        assert pf.get("KV", float) == 1e-4
        assert pf.get("N", int) == 1000
        assert pf.get("FLAG", bool) is True

    def test_list(self):
        pf = param_file_from_text("GPRIME = 9.8, 0.02, 0.01\n")
        assert pf.get_list("GPRIME") == [9.8, 0.02, 0.01]

    def test_unused_detection(self):
        pf = param_file_from_text("A = 1\nB = 2\n")
        pf.get("A", int)
        assert pf.unused_params() == ["B"]

    def test_doc_output(self, tmp_path):
        pf = param_file_from_text("DT = 900.0\n")
        pf.get("DT", float, default=1200.0, units="s", desc="time step",
               module="core")
        pf.get("KV", float, default=1e-4, units="m2 s-1", module="core")
        pf.write_doc(str(tmp_path))
        allf = (tmp_path / "MOM_parameter_doc.all").read_text()
        short = (tmp_path / "MOM_parameter_doc.short").read_text()
        assert "DT" in allf and "KV" in allf
        assert "DT" in short and "KV" not in short  # KV at default


class TestReproSum:
    def test_order_invariance(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal(10000) * 10.0 ** rng.integers(-6, 6, 10000)
        s1 = reproducing_sum(x)
        s2 = reproducing_sum(x[::-1].copy())
        perm = rng.permutation(x.size)
        s3 = reproducing_sum(x[perm])
        assert s1 == s2 == s3  # bitwise
        assert abs(s1 - np.sum(np.sort(x))) < 1e-8 * np.sum(np.abs(x))

    def test_partition_invariance(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal(4096)
        s_all = reproducing_sum(x)
        # summing partial EFP representations == summing all at once is the
        # design property; emulate by splitting then adding exact results
        s_split = reproducing_sum(np.concatenate([x[:1000], x[1000:]]))
        assert s_all == s_split

    def test_fixed_point_sum_jit(self):
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal((64, 64)), dtype=jnp.float32)
        s = fixed_point_sum(x, max_mag=16.0)
        assert abs(float(s) - float(np.asarray(x, np.float64).sum())) < 1e-3

    def test_accuracy_catastrophic_cancellation(self):
        x = np.array([1e15, 1.0, -1e15, 1.0])
        assert reproducing_sum(x) == 2.0


class TestChecksums:
    def test_layout_invariance(self):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((8, 16))
        assert bitcount_checksum(x) == bitcount_checksum(x.T.copy())
        assert bitcount_checksum(x) == bitcount_checksum(x.ravel()[::-1].copy())

    def test_sensitivity(self):
        x = np.ones((4, 4))
        y = x.copy()
        y[2, 2] = 1.0 + 1e-15
        assert bitcount_checksum(x) != bitcount_checksum(y)

    def test_stats(self):
        s = chksum_stats(np.array([1.0, 2.0, 3.0]))
        assert s["min"] == 1.0 and s["max"] == 3.0 and s["mean"] == 2.0


class TestStencil:
    def test_roll_identities(self):
        rng = np.random.default_rng(4)
        a = jnp.asarray(rng.standard_normal((3, 8, 8)))
        np.testing.assert_allclose(stencil.im1(stencil.ip1(a)), a)
        np.testing.assert_allclose(stencil.jm1(stencil.jp1(a)), a)

    def test_means_against_numpy(self):
        a = jnp.arange(16.0).reshape(4, 4)
        got = stencil.h_to_u(a)
        want = 0.5 * (np.asarray(a) + np.roll(a, -1, axis=-1))
        np.testing.assert_allclose(got, want)

    def test_divergence_telescopes(self):
        # sum of flux divergence over a periodic domain is zero: each
        # difference is rounded in f32, so allow f32-roundoff noise
        rng = np.random.default_rng(5)
        f = jnp.asarray(rng.standard_normal((8, 8)))
        div = f - stencil.im1(f)
        assert abs(float(np.asarray(div, np.float64).sum())) < 1e-5


class TestTridiag:
    def test_against_dense_solve(self):
        rng = np.random.default_rng(6)
        nz, n = 12, 5
        a = rng.uniform(0.1, 1.0, (nz, n)); a[0] = 0.0
        c = rng.uniform(0.1, 1.0, (nz, n)); c[-1] = 0.0
        b = 2.0 + a + c  # diagonally dominant
        d = rng.standard_normal((nz, n))
        x = np.asarray(tridiag_solve(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c), jnp.asarray(d)))
        for j in range(n):
            M = np.diag(b[:, j]) + np.diag(a[1:, j], -1) + np.diag(c[:-1, j], 1)
            want = np.linalg.solve(M, d[:, j])
            np.testing.assert_allclose(x[:, j], want, rtol=2e-5)


class TestPallasTridiag:
    def test_matches_scan_on_any_backend(self):
        """The GPU kernel, run by the Pallas interpreter, gives the scan's
        answer on a model-shaped (nz, ny, nx) batch."""
        from mom6_tpu.framework.pallas_tridiag import tridiag_solve_kernel
        from mom6_tpu.framework.solvers import _tridiag_scan
        rng = np.random.default_rng(7)
        nz, ny, nx = 10, 12, 20
        a = jnp.asarray(rng.uniform(0.1, 1.0, (nz, ny, nx)), jnp.float32
                        ).at[0].set(0.0)
        c = jnp.asarray(rng.uniform(0.1, 1.0, (nz, ny, nx)), jnp.float32
                        ).at[-1].set(0.0)
        b = 2.0 + a + c
        d = jnp.asarray(rng.standard_normal((nz, ny, nx)), jnp.float32)
        x_ref = _tridiag_scan(a, b, c, d)
        x_opt = tridiag_solve_kernel(a, b, c, d, interpret=True)
        np.testing.assert_allclose(np.asarray(x_opt), np.asarray(x_ref),
                                   atol=1e-6)


class TestDataOverride:
    def _field(self, periodic=False):
        from mom6_tpu.framework.data_override import TimeSeriesField
        times = np.array([0.0, 10.0, 20.0])
        data = np.stack([np.full((4, 5), v) for v in (1.0, 3.0, 5.0)])
        return TimeSeriesField(times, data, periodic=periodic)

    def test_linear_time_interp(self):
        f = self._field()
        np.testing.assert_allclose(f.at_time(5.0), 2.0)
        np.testing.assert_allclose(f.at_time(0.0), 1.0)
        np.testing.assert_allclose(f.at_time(25.0), 5.0)   # clamped

    def test_periodic_climatology(self):
        f = self._field(periodic=True)
        # period = 30; t=25 is midway between rec 2 (t=20) and rec 0 (t=30)
        np.testing.assert_allclose(f.at_time(25.0), 3.0)
        np.testing.assert_allclose(f.at_time(35.0), 2.0)   # == t=5

    def test_bilinear_regrid_exact_for_linear(self):
        from mom6_tpu.framework.data_override import (TimeSeriesField,
                                                      build_bilinear_map,
                                                      data_override)
        src_lon = np.linspace(0.0, 10.0, 11)
        src_lat = np.linspace(0.0, 8.0, 9)
        plane = (2.0 * src_lon[None, :] - 0.5 * src_lat[:, None] + 1.0)
        f = TimeSeriesField(np.array([0.0]), plane[None])
        dst_lon = np.random.RandomState(0).uniform(0.5, 9.5, (3, 4))
        dst_lat = np.random.RandomState(1).uniform(0.5, 7.5, (3, 4))
        m = build_bilinear_map(src_lon, src_lat, dst_lon, dst_lat)
        got = np.asarray(data_override(f, 0.0, bmap=m))
        want = 2.0 * dst_lon - 0.5 * dst_lat + 1.0
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_spatial_means_family():
    """global_layer/volume means, meridional mean and the mass integral
    (MOM_spatial_means.F90 API family): exact on uniform fields,
    weighted correctly on nonuniform ones."""
    import numpy as np
    import jax.numpy as jnp
    from mom6_tpu.diagnostics.diagnostics import (global_layer_mean,
                                                  global_mass_integral,
                                                  global_volume_mean,
                                                  meridional_mean)
    from mom6_tpu.grid.grid import build_cartesian_grid
    G = build_cartesian_grid(nx=8, ny=6, len_lon_km=80.0, len_lat_km=60.0,
                             max_depth=1000.0)
    h = jnp.concatenate([jnp.full((1, 6, 8), 100.0),
                         jnp.full((1, 6, 8), 900.0)])
    f = jnp.concatenate([jnp.full((1, 6, 8), 2.0),
                         jnp.full((1, 6, 8), 4.0)])
    np.testing.assert_allclose(global_layer_mean(f, h, G), [2.0, 4.0])
    # volume mean: (2*100 + 4*900)/1000 = 3.8
    np.testing.assert_allclose(global_volume_mean(f, h, G), 3.8,
                               rtol=1e-12)
    m = global_mass_integral(h, G)
    area = float(np.asarray(G.areaT).sum())
    np.testing.assert_allclose(m, 1035.0 * 1000.0 * area, rtol=1e-10)
    mm = meridional_mean(jnp.asarray(np.arange(8.0)[None, :]
                                     * np.ones((6, 1))), G)
    np.testing.assert_allclose(mm, np.arange(8.0), rtol=1e-12)
