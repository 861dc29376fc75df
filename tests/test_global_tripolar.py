"""Tripolar fold + mosaic grid + global real-continents config.

The fold gates are exact, not tolerances-of-convenience:
 * the supergrid's fold row must be mirror-symmetric to roundoff
   (the i <-> nx-1-i identification of FOLD_NORTH_EDGE,
   reference config_src/infra/FMS2/MOM_domain_infra.F90:10-34);
 * without Coriolis, a mirror-symmetric initial state must evolve
   mirror-symmetrically to MACHINE PRECISION (floating-point ops on
   mirrored operands are deterministic, so any asymmetry is a fold
   wiring bug);
 * the fold-line v row carries one physical set of faces shared by the
   two logical halves, so it must stay exactly antisymmetric;
 * volume is conserved across the fold (transport leaving a top-row
   cell enters its fold image).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_global_grid import make_tripolar_supergrid  # noqa: E402

from mom6_tpu.core.barotropic import BTParams, set_dtbt  # noqa: E402
from mom6_tpu.core.dynamics_split_rk2 import (  # noqa: E402
    DynParams, MechForcing, step_dynamics_split_rk2)
from mom6_tpu.core.state import init_state_resting  # noqa: E402
from mom6_tpu.grid.mosaic import build_grid_from_supergrid  # noqa: E402
from mom6_tpu.grid.vertical import build_layered_vgrid  # noqa: E402

R_EARTH = 6.378e6


def _cap_grid(nx=72, nyr=20, nyc=12):
    sg = make_tripolar_supergrid(nx, nyr, nyc, lat_s=30.0, lat_join=65.0,
                                 lon_bp=100.0)
    ny = nyr + nyc
    depth = np.full((ny, nx), 1000.0)
    lat_t = sg["y"][1::2, 1::2]
    lon_t = sg["x"][1::2, 1::2]
    for plon in (100.0, 280.0):
        dlon = np.abs(np.mod(lon_t - plon + 180.0, 360.0) - 180.0)
        depth[(np.abs(lat_t - 65.0) < 2.5)
              & (dlon * np.cos(np.deg2rad(lat_t)) < 4.0)] = 0.0
    G = build_grid_from_supergrid(sg, depth, cyclic_x=True,
                                  fold_north=True)
    return sg, G, lat_t


def test_supergrid_geometry():
    """Areas integrate to the spherical cap; the fold row is exactly
    mirror-symmetric; the joint row is continuous with the regular
    rows; the bipolar poles sit at the seam and halfway columns."""
    sg = make_tripolar_supergrid(90, 42, 8, lat_s=-80.0, lat_join=65.0,
                                 lon_bp=100.0)
    x, y, area = sg["x"], sg["y"], sg["area"]
    a_dom = 2 * np.pi * R_EARTH ** 2 * (np.sin(np.deg2rad(65))
                                        + np.sin(np.deg2rad(80)))
    a_cap = 2 * np.pi * R_EARTH ** 2 * (1 - np.sin(np.deg2rad(65)))
    nys_reg = 2 * 42
    np.testing.assert_allclose(area[:nys_reg].sum(), a_dom, rtol=1e-3)
    np.testing.assert_allclose(area[nys_reg:].sum(), a_cap, rtol=1e-3)
    # fold row mirrors about the seam: node i <-> nxs - i
    nxs = x.shape[1] - 1
    i = np.arange(nxs + 1)
    im = (-i) % nxs
    assert np.abs(y[-1] - y[-1][im]).max() < 1e-9
    # joint continuity: cap row 1 ~ regular longitude columns
    dlon = np.abs(np.mod(x[nys_reg + 1] - x[nys_reg] + 180, 360) - 180)
    assert dlon.max() < 0.1
    # poles: whole seam column and halfway column pinned at the joint
    assert np.abs(y[nys_reg:, 0] - 65.0).max() < 1e-9
    assert np.abs(y[nys_reg:, nxs // 2] - 65.0).max() < 1e-9


def test_fold_exactness_and_conservation():
    """A mirror-symmetric SSH bump centered on the north pole, no
    rotation: the evolution must stay EXACTLY mirror-symmetric, the
    fold-line v row exactly antisymmetric, and volume conserved."""
    import dataclasses
    sg, G, lat_t = _cap_grid()
    G0 = dataclasses.replace(G, CoriolisBu=jnp.zeros_like(G.CoriolisBu))
    GV = build_layered_vgrid(1)
    state = init_state_resting(G0, GV, [1000.0])
    ang = np.pi / 2 - np.deg2rad(lat_t)
    eta = 0.1 * np.exp(-(ang * R_EARTH / 1e3 / 600.0) ** 2) \
        * np.asarray(G0.mask2dT)
    state = state.replace(h=jnp.asarray(np.asarray(state.h) + eta[None],
                                        jnp.float32))
    dt = 600.0
    nstep, _ = set_dtbt(G0, GV, 1000.0, dt)
    params = DynParams(dt=dt, bt=BTParams(nstep=nstep,
                                          nfilter=max(1, nstep // 8)),
                       kv=0.0)
    step = jax.jit(lambda s: step_dynamics_split_rk2(
        s, MechForcing(), G0, GV, params))
    a = np.asarray(G0.areaT, np.float64) * np.asarray(G0.mask2dT,
                                                      np.float64)
    m0 = (np.asarray(state.h, np.float64) * a).sum()
    s = state
    for _ in range(60):
        s = step(s)
    h1 = np.asarray(s.h, np.float64)
    assert np.isfinite(h1).all()
    m1 = (h1 * a).sum()
    assert abs(m1 - m0) / m0 < 1e-6
    eta1 = (h1.sum(0) - np.asarray(G0.bathyT)) * np.asarray(G0.mask2dT)
    # exact mirror symmetry (fold wiring correctness, see module doc)
    assert np.abs(eta1 - eta1[:, ::-1]).max() == 0.0
    v = np.asarray(s.v, np.float64)[0, -1, :]
    assert np.abs(v + v[::-1]).max() < 1e-8
    # the bump actually radiated across the fold (dynamics, not a wall)
    assert eta1.max() < 0.8 * eta.max()


def test_fold_with_rotation_single_valued():
    """With Coriolis on, the shared fold-line faces must remain exactly
    single-valued (v antisymmetric) — the chiral dynamics may break
    mirror symmetry of the SOLUTION, but never the identification."""
    sg, G, lat_t = _cap_grid()
    GV = build_layered_vgrid(1)
    state = init_state_resting(G, GV, [1000.0])
    ang = np.pi / 2 - np.deg2rad(lat_t)
    eta = 0.1 * np.exp(-(ang * R_EARTH / 1e3 / 600.0) ** 2) \
        * np.asarray(G.mask2dT)
    state = state.replace(h=jnp.asarray(np.asarray(state.h) + eta[None],
                                        jnp.float32))
    dt = 600.0
    nstep, _ = set_dtbt(G, GV, 1000.0, dt)
    params = DynParams(dt=dt, bt=BTParams(nstep=nstep,
                                          nfilter=max(1, nstep // 8)),
                       kv=0.0)
    step = jax.jit(lambda s: step_dynamics_split_rk2(
        s, MechForcing(), G, GV, params))
    s = state
    for _ in range(60):
        s = step(s)
    v = np.asarray(s.v, np.float64)[0, -1, :]
    assert np.isfinite(np.asarray(s.h)).all()
    assert np.abs(v + v[::-1]).max() < 1e-7 + 0.01 * np.abs(v).max()


def test_global_2deg_runs_stably():
    """The shipped real-continents global tripolar config
    (configs/global_2deg: GRID_CONFIG=mosaic + TOPO_CONFIG=file +
    TRIPOLAR_N + full physics) steps stably: finite, volume conserved,
    wet temperatures physical, land columns inert."""
    from mom6_tpu.core.mom import step_mom
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    pf = ParamFile([os.path.join(REPO, "configs", "global_2deg",
                                 "MOM_input")])
    ms = build_model_from_params(pf)
    G = ms.grid
    assert G.fold_north and G.nx == 180 and G.ny == 100
    step = jax.jit(lambda s: step_mom(s, ms.forcing, G, ms.vgrid,
                                      ms.params))
    msk = np.asarray(G.mask2dT)
    a = np.asarray(G.areaT, np.float64) * msk
    s = ms.state
    m0 = (np.asarray(s.h, np.float64) * a).sum()
    T0_land = np.asarray(s.T) * (1 - msk[None])
    for _ in range(12):
        s = step(s)
    for f in ("h", "u", "v", "T", "S"):
        assert np.isfinite(np.asarray(getattr(s, f))).all(), f
    m1 = (np.asarray(s.h, np.float64) * a).sum()
    assert abs(m1 - m0) / m0 < 1e-6
    wetT = np.asarray(s.T) * msk[None]
    assert wetT.min() > -3.0 and wetT.max() < 35.0
    np.testing.assert_array_equal(np.asarray(s.T) * (1 - msk[None]),
                                  T0_land)


def test_fold_wired_lateral_modules():
    """Round-3 fold wiring of MEKE, interface filter, mixed-layer
    restrat, Zanna-Bolton and neutral diffusion: on the mirror-symmetric
    cap grid with mirror-symmetric inputs, every center-scalar output
    stays EXACTLY mirror-symmetric, and the flux forms conserve their
    integral across the fold (the fold face's export enters the mirror
    cell)."""
    from mom6_tpu.eos import get_eos
    from mom6_tpu.physics.lateral.interface_filter import (
        InterfaceFilterParams, interface_filter)
    from mom6_tpu.physics.lateral.meke import MEKEParams, step_meke
    from mom6_tpu.physics.lateral.mixed_layer_restrat import (
        MLRestratParams, mixedlayer_restrat)
    from mom6_tpu.physics.lateral.zanna_bolton import (ZBParams,
                                                       zanna_bolton_accel)
    from mom6_tpu.tracers.neutral_diffusion import (
        neutral_diffusion, neutral_diffusion_surfaces)

    sg, G, lat_t = _cap_grid()
    GV = build_layered_vgrid(3)
    eos = get_eos("LINEAR")
    ny, nx = G.ny, G.nx
    a = np.asarray(G.areaT, np.float64) * np.asarray(G.mask2dT, np.float64)

    # mirror-symmetric scalar fields peaked near the pole
    ang = np.pi / 2 - np.deg2rad(lat_t)
    bump = np.exp(-(ang * R_EARTH / 1e3 / 800.0) ** 2).astype(np.float32)
    bump = 0.5 * (bump + bump[:, ::-1])          # exact symmetrization
    h = np.stack([200.0 + 50.0 * bump, 300.0 * np.ones_like(bump),
                  500.0 - 50.0 * bump]).astype(np.float32)
    T = np.stack([10.0 + 5.0 * bump, 5.0 + bump, 2.0 * np.ones_like(bump)]
                 ).astype(np.float32)
    S = 35.0 * np.ones_like(T)
    hj, Tj, Sj = jnp.asarray(h), jnp.asarray(T), jnp.asarray(S)

    def sym(x, what):
        x = np.asarray(x, np.float64) * np.asarray(G.mask2dT)
        assert np.abs(x - x[..., ::-1]).max() == 0.0, what

    # MEKE: pure lateral diffusion of E (no sources/sinks) -> symmetric
    # and integral-conserving
    E = jnp.asarray(bump * 0.01)
    pm = MEKEParams(bgsrc=0.0, damping=0.0, cdrag=0.0, gm_src_frac=0.0,
                    uscale=0.0, kh_meke=500.0)
    E1 = step_meke(E, jnp.zeros_like(E), hj, G, 3600.0, pm)
    sym(E1, "MEKE E")
    np.testing.assert_allclose((np.asarray(E1, np.float64) * a).sum(),
                               (np.asarray(E, np.float64) * a).sum(),
                               rtol=2e-6)

    # interface filter: h stays symmetric, volume conserved
    h2, _, _ = interface_filter(hj, G, GV, 3600.0,
                                InterfaceFilterParams(time_scale=3600.0))
    for k in range(3):
        sym(h2[k], f"filter h[{k}]")
    np.testing.assert_allclose(
        (np.asarray(h2, np.float64) * a).sum(),
        (h.astype(np.float64) * a).sum(), rtol=1e-6)

    # mixed-layer restrat (|f| is mirror-symmetric)
    mld = jnp.asarray(100.0 + 50.0 * bump)
    h3, _, _ = mixedlayer_restrat(hj, Tj, Sj, mld, G, GV, eos, 3600.0,
                                  MLRestratParams())
    for k in range(3):
        sym(h3[k], f"mlr h[{k}]")
    np.testing.assert_allclose(
        (np.asarray(h3, np.float64) * a).sum(),
        (h.astype(np.float64) * a).sum(), rtol=1e-6)

    # Zanna-Bolton: an x-REFLECTION-invariant velocity field (u -> -u at
    # the paired face, v -> +v; a reflection, unlike the fold's rotation,
    # keeps v's sign) produces reflection-consistent accelerations
    rng = np.random.RandomState(7)
    u0 = rng.randn(3, ny, nx).astype(np.float32)
    u_sym = 0.5 * (u0 - np.roll(u0[..., ::-1], -1, axis=-1))
    v0 = rng.randn(3, ny, nx).astype(np.float32)
    v_sym = 0.5 * (v0 + v0[..., ::-1])
    uj = jnp.asarray(u_sym) * G.mask2dCu
    vj = jnp.asarray(v_sym) * G.mask2dCv
    du, dv = zanna_bolton_accel(uj, vj, hj, G, ZBParams(amplitude=0.1))
    du = np.asarray(du, np.float64)
    dv = np.asarray(dv, np.float64)
    assert np.isfinite(du).all() and np.isfinite(dv).all()
    # u-accel is antisymmetric under the face mirror i -> nx-2-i ONLY in
    # rows untouched by the fold ghost; gate the interior rows exactly
    dmir = du[:, :-1] + np.roll(du[..., ::-1], -1, axis=-1)[:, :-1]
    assert np.abs(dmir * np.asarray(G.mask2dCu)[:-1]
                  * np.roll(np.asarray(G.mask2dCu), -1, -1)[:-1]).max() \
        < 1e-12

    # neutral diffusion, both schemes: symmetric + tracer-conserving
    tr = jnp.asarray(T)[None]
    vol = (h.astype(np.float64) * a).sum(axis=(1, 2))
    for fn, name in ((neutral_diffusion, "redi"),
                     (neutral_diffusion_surfaces, "surfaces")):
        if fn is neutral_diffusion:
            out, _ = fn(tr, hj, Tj, Sj, G, GV, eos, 500.0, 3600.0)
        else:
            out = fn(tr, hj, Tj, Sj, G, GV, eos, 500.0, 3600.0)
        o = np.asarray(out[0], np.float64)
        assert np.isfinite(o).all(), name
        for k in range(3):
            sym(o[k], f"{name} tr[{k}]")
        m0 = (T.astype(np.float64) * h.astype(np.float64) * a).sum()
        m1 = (o * h.astype(np.float64) * a).sum()
        np.testing.assert_allclose(m1, m0, rtol=1e-6, err_msg=name)


def test_global_tripolar_sharded_layout(devices8):
    """The real-continents global config steps on an 8-device (y, x)
    mesh: the fold ghost row is an x-REVERSAL of the top row, so on an
    x-sharded mesh every fold exchange crosses shard boundaries (GSPMD
    lowers the reversal to collective permutes — the one halo pattern a
    plain roll cannot express).  Gates: the sharded step agrees with the
    single-device step to f32 ulp level, and volume is conserved on the
    mesh."""
    from mom6_tpu.core.mom import step_mom
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    from mom6_tpu.parallel.mesh import (constrain_state, make_mesh,
                                        shard_over, state_sharding)

    pf = ParamFile([os.path.join(REPO, "configs", "global_2deg",
                                 "MOM_input")])
    ms = build_model_from_params(pf)
    assert ms.grid.fold_north

    def run(devs, shape, n=2):
        mesh = make_mesh(devs, shape=shape)
        with mesh:
            G = shard_over(mesh, ms.grid)
            forcing = shard_over(mesh, ms.forcing)
            st = shard_over(mesh, ms.state)

            def step(s):
                return step_mom(constrain_state(s), forcing, G,
                                ms.vgrid, ms.params)

            stepj = jax.jit(step, out_shardings=state_sharding(mesh, st))
            for _ in range(n):
                st = stepj(st)
            jax.block_until_ready(st.h)
        return jax.device_get(st)

    out1 = run(devices8[:1], (1, 1))
    out8 = run(devices8, (2, 4))
    msk = np.asarray(ms.grid.mask2dT)
    h1 = np.asarray(out1.h) * msk[None]
    h8 = np.asarray(out8.h) * msk[None]
    assert np.isfinite(h8).all()
    # h: not bitwise — GSPMD compiles a different program per
    # partitioning and fusion shifts rounding by ~1 ulp in isolated
    # elements (same rationale as
    # test_full_physics_step_layout_invariance; measured: 0.08% of
    # elements differ, max 4.2e-6 rel)
    np.testing.assert_allclose(h8, h1, rtol=1e-5, atol=0)
    # T: threshold physics (KPP layer selection, convective Kd) flips on
    # those ulp seeds and REDISTRIBUTES heat vertically within isolated
    # columns — pointwise T may then differ by O(0.1 K) in a handful of
    # cells while the COLUMN heat content (the transported, conserved
    # quantity) stays layout-invariant.  Gate the invariant tightly and
    # the pointwise scatter by fraction (measured: 0.26% of cells).
    T1 = np.asarray(out1.T, np.float64)
    T8 = np.asarray(out8.T, np.float64)
    hc1 = (np.asarray(out1.h, np.float64) * T1).sum(0) * msk
    hc8 = (np.asarray(out8.h, np.float64) * T8).sum(0) * msk
    np.testing.assert_allclose(hc8, hc1, rtol=1e-5,
                               atol=1e-5 * np.abs(hc1).max())
    assert ((np.abs(T8 - T1) * msk[None]) > 0.01).mean() < 0.02
    a = np.asarray(ms.grid.areaT, np.float64) * msk
    m0 = (np.asarray(ms.state.h, np.float64) * a).sum()
    m8 = (h8.astype(np.float64) * a).sum()
    assert abs(m8 - m0) / m0 < 1e-6


def test_global_solo_driver_end_to_end(tmp_path):
    """The shipped global tripolar config runs END TO END through the
    solo driver — MOM_input parsing, mosaic grid + file topography,
    full physics, ocean.stats cadence (ENERGYSAVEDAYS), restart write —
    exactly as a user would run it (python -m mom6_tpu.drivers.solo
    configs/global_2deg).  Two model days here to keep CI time bounded;
    the committed configs/global_2deg artifacts are from the full
    DAYMAX=30 run."""
    import shutil

    from mom6_tpu.drivers import solo

    src = os.path.join(REPO, "configs", "global_2deg")
    for f in ("MOM_input", "ocean_hgrid.nc", "ocean_topog.nc"):
        shutil.copy(os.path.join(src, f), tmp_path / f)
    solo.main([str(tmp_path), "--days", "2"])

    stats = (tmp_path / "ocean.stats").read_text().strip().splitlines()
    assert len(stats) >= 2             # header + >= 1 ENERGYSAVEDAYS line
    import re
    rows = [ln for ln in stats if re.match(r"\s*\d+,", ln)]
    assert len(rows) >= 2              # 2 days at ENERGYSAVEDAYS=1.0
    masses = [float(re.search(r"Mass\s+([0-9.e+-]+)", ln).group(1))
              for ln in rows]
    assert all(np.isfinite(m) for m in masses)
    assert abs(masses[-1] - masses[0]) / masses[0] < 1e-5
    # restart written and reloadable metadata present
    assert any(f.name.startswith("MOM.res") for f in tmp_path.iterdir())


def test_fold_wired_internal_tides():
    """Internal-tide energy propagation across the fold: the ghost row
    is the x-mirrored top row with the ANGLE dimension rotated by pi
    (directions rotate with the 180-degree fold).  A field invariant
    under that involution  E(a, y, i) = E(a + na/2, y, nx-1-i)  must
    stay EXACTLY invariant, and the total energy must track the forcing
    with no fold leak (flux form, losses disabled)."""
    from mom6_tpu.physics.lateral.internal_tides import (
        InternalTidesParams, step_internal_tides)

    sg, G, lat_t = _cap_grid()
    GV = build_layered_vgrid(1)
    ny, nx = G.ny, G.nx
    na = 8
    p = InternalTidesParams(n_angle=na, decay_rate=0.0, drag_coef=0.0)

    rng = np.random.RandomState(11)
    # the involution the MIRROR-SYMMETRIC grid preserves is the
    # x-REFLECTION, which maps propagation angles th -> pi - th (bin
    # a -> na/2 - 1 - a); the fold ghost itself uses the ROTATION
    # th -> th + pi — both must be wired right for reflection symmetry
    # to survive transport THROUGH the fold
    def reflect(E):
        return E[(na // 2 - 1 - np.arange(na)) % na][..., ::-1]

    E0 = rng.rand(na, ny, nx).astype(np.float32)
    E0 = 0.5 * (E0 + reflect(E0))
    E0 = E0 * np.asarray(G.mask2dT)
    ang = np.pi / 2 - np.deg2rad(lat_t)
    tke = np.exp(-(ang * R_EARTH / 1e3 / 700.0) ** 2).astype(np.float32)
    tke = 0.5 * (tke + tke[:, ::-1]) * np.asarray(G.mask2dT) * 1e-3
    cn = 2.0 * np.ones((ny, nx), np.float32)

    En = jnp.asarray(E0)
    a = np.asarray(G.areaT, np.float64) * np.asarray(G.mask2dT)
    e_start = (np.asarray(En, np.float64) * a).sum()
    step = jax.jit(lambda e: step_internal_tides(
        e, jnp.asarray(tke), jnp.asarray(cn), G, GV, 600.0, p))
    put = 0.0
    for _ in range(20):
        En, loss = step(En)
        put += 600.0 * (1.0 - p.q_local) * float((tke * a).sum())
    E1 = np.asarray(En, np.float64)
    assert np.isfinite(E1).all()
    # involution symmetry at the ulp: XLA:CPU contracts the upwind
    # flux (max*E + min*E_nb) into FMAs whose association differs
    # between mirrored operand orders, leaving ~1 ulp of O(1) energy.
    # Anything above a few ulps is a fold-wiring bug.
    d = np.abs(E1 - reflect(E1))
    assert d.max() < 5e-7, d.max()
    # energy accounting: start + forcing = end (losses off, flux form)
    e_end = (E1 * a).sum()
    np.testing.assert_allclose(e_end, e_start + put, rtol=1e-5)
