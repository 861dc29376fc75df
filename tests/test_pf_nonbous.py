"""Non-Boussinesq FV pressure force tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from mom6_tpu.core.pressure_force import (pressure_force_fv,
                                          pressure_force_fv_nonbous)
from mom6_tpu.eos import get_eos
from mom6_tpu.grid.grid import build_cartesian_grid
from mom6_tpu.grid.vertical import build_layered_vgrid

NZ, NY, NX = 8, 6, 12
DEPTH = 2000.0


def _setup(topo=False):
    depth = None
    if topo:
        x = np.arange(NX)
        d = DEPTH - 800.0 * np.exp(-((x - NX / 2.0) ** 2) / 4.0)
        depth = np.broadcast_to(d, (NY, NX)).copy()
    G = build_cartesian_grid(NX, NY, 120.0, 60.0, max_depth=DEPTH,
                             depth=depth)
    GV = build_layered_vgrid(NZ)
    return G, GV


def _resting_state(G, GV, eos_name="WRIGHT"):
    """Flat-z interfaces clipped to topography, stratified T(z)."""
    eos = get_eos(eos_name)
    e_nom = np.linspace(0.0, DEPTH, NZ + 1)
    bathy = np.asarray(G.bathyT)
    e = np.minimum(e_nom[:, None, None], bathy[None])
    h = np.maximum(e[1:] - e[:-1], 1e-3).astype(np.float32)
    z_c = 0.5 * (e[1:] + e[:-1])
    T = (15.0 - 10.0 * z_c / DEPTH).astype(np.float32)
    S = np.full_like(T, 35.0)
    return jnp.asarray(h), jnp.asarray(T), jnp.asarray(S), eos


def test_resting_state_over_topography_is_quiet():
    """A resting stratified non-Boussinesq column over a seamount feels
    (almost) no pressure force — the FV telescoping gate."""
    G, GV = _setup(topo=True)
    h, T, S, eos = _resting_state(G, GV)
    # a resting non-Boussinesq layer's mass uses the IN-SITU density at
    # its own pressure: fixed-point the hydrostatic relation
    rho = eos.density(T, S, jnp.zeros_like(T))
    for _ in range(6):
        dp = GV.g_earth * h * rho
        p_int = jnp.concatenate([jnp.zeros_like(dp[:1]),
                                 jnp.cumsum(dp, axis=0)], axis=0)
        p_mid = 0.5 * (p_int[:-1] + p_int[1:])
        rho = eos.density(T, S, p_mid)
    h_mass = h * rho
    pf = pressure_force_fv_nonbous(h_mass, T, S, G, GV, eos)
    # scale: a 1 m/s flow spins up from ~1e-4 m/s2 in hours; demand the
    # residual acceleration is tiny compared to g*d(eta)~anything real
    assert np.abs(np.asarray(pf.PFu)).max() < 5e-4
    assert np.abs(np.asarray(pf.PFv)).max() < 5e-4
    assert np.isfinite(np.asarray(pf.PFu)).all()


def test_matches_boussinesq_in_weak_compressibility():
    """For h_mass = rho0 h with a LINEAR EOS, the non-Boussinesq PF
    agrees with the Boussinesq PF to O(drho/rho0)."""
    G, GV = _setup(topo=False)
    eos = get_eos("LINEAR")
    h = jnp.full((NZ, NY, NX), DEPTH / NZ, jnp.float32)
    # an eta bump: thicken the top layer
    bump = 0.5 * np.exp(-((np.arange(NX) - NX / 2.0) ** 2) / 4.0)
    h = h.at[0].add(jnp.asarray(np.broadcast_to(bump, (NY, NX)),
                                jnp.float32))
    z = jnp.cumsum(h, axis=0) - 0.5 * h
    T = (15.0 - 8.0 * z / DEPTH).astype(jnp.float32)
    S = jnp.full_like(T, 35.0)
    pf_b = pressure_force_fv(h, T, S, G, GV, eos)
    h_mass = h * GV.rho0
    pf_n = pressure_force_fv_nonbous(h_mass, T, S, G, GV, eos)
    a = np.asarray(pf_b.PFu)
    b = np.asarray(pf_n.PFu)
    scale = np.abs(a).max()
    assert scale > 1e-4                      # the bump drives a real PF
    assert np.abs(a - b).max() < 0.05 * scale, np.abs(a - b).max()


def test_pbce_predicts_pf_response():
    """pbce must be the actual d(PF)/d(eta_H) of the non-Boussinesq PF:
    add surface mass to half the domain and compare the true PF change
    at the step face against -pbce * d(eta)/dx, layer by layer (the
    Set_pbce_nonBouss contract; a wrong pbce destabilizes the split
    scheme within a few steps — the za/g-as-height bug collapsed htot to
    its 1e-10 floor and sent pbce to ~1e8).  Runs in an x64 subprocess:
    the finite difference needs headroom below the PF's own magnitude."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = r'''
import json, sys
sys.path.insert(0, %r)
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from mom6_tpu.core.pressure_force import pressure_force_fv_nonbous
from mom6_tpu.eos import get_eos
from mom6_tpu.grid.grid import build_cartesian_grid
from mom6_tpu.grid.vertical import build_layered_vgrid
NZ, NY, NX, DEPTH = 8, 6, 12, 2000.0
G = build_cartesian_grid(NX, NY, 120.0, 60.0, max_depth=DEPTH)
GV = build_layered_vgrid(NZ)
eos = get_eos("WRIGHT")
h = jnp.full((NZ, NY, NX), DEPTH / NZ, jnp.float64)
z = jnp.cumsum(h, 0) - 0.5 * h
T = (20.0 - 18.0 * z / DEPTH).astype(jnp.float64)
S = jnp.full_like(T, 35.0)
rho = GV.rho0 + eos.density(T, S, jnp.zeros_like(T), rho_ref=GV.rho0)
for _ in range(8):
    dp = GV.g_earth * rho * h
    pi = jnp.concatenate([jnp.zeros_like(dp[:1]), jnp.cumsum(dp, 0)], 0)
    rho = GV.rho0 + eos.density(T, S, 0.5 * (pi[:-1] + pi[1:]),
                                rho_ref=GV.rho0)
hm = h * rho / GV.rho0
d = 0.01
hp = hm.at[0, :, NX // 2:].add(d)
pf0 = pressure_force_fv_nonbous(GV.rho0 * hm, T, S, G, GV, eos)
pf1 = pressure_force_fv_nonbous(GV.rho0 * hp, T, S, G, GV, eos)
dpf = np.asarray(pf1.PFu - pf0.PFu)[:, NY // 2, NX // 2 - 1]
idx = float(np.asarray(G.IdxCu)[NY // 2, NX // 2 - 1])
pred = -np.asarray(pf0.pbce)[:, NY // 2, NX // 2 - 1] * d * idx
print("PBCE:" + json.dumps((dpf / pred).tolist()))
''' % repo
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("PBCE:")][-1]
    ratio = np.asarray(json.loads(line[len("PBCE:"):]))
    assert np.all(np.abs(ratio - 1.0) < 0.05), ratio


def test_eta_bump_accelerates_away():
    """Surface bump: depth-mean PFu points away from the bump with
    magnitude ~ g d(eta)/dx."""
    G, GV = _setup(topo=False)
    eos = get_eos("WRIGHT")
    h = jnp.full((NZ, NY, NX), DEPTH / NZ, jnp.float32)
    bump = 1.0 * np.exp(-((np.arange(NX) - NX / 2.0) ** 2) / 4.0)
    h = h.at[0].add(jnp.asarray(np.broadcast_to(bump, (NY, NX)),
                                jnp.float32))
    z = jnp.cumsum(h, axis=0) - 0.5 * h
    T = jnp.full((NZ, NY, NX), 10.0, jnp.float32)
    S = jnp.full_like(T, 35.0)
    rho = np.asarray(eos.density(T, S, jnp.zeros_like(T)))
    h_mass = h * jnp.asarray(rho)
    pf = pressure_force_fv_nonbous(h_mass, T, S, G, GV, eos)
    pfu = np.asarray(pf.PFu).mean(axis=0)[NY // 2]
    deta_dx = np.gradient(bump, 10e3)
    want = -9.8 * deta_dx
    # compare at the flanks (interior u faces)
    j = NX // 2 + 2
    assert np.sign(pfu[j]) == np.sign(want[j])
    assert abs(pfu[j]) > 0.3 * abs(want[j])
    assert abs(pfu[j]) < 3.0 * abs(want[j])


def test_plm_reconstruction_improves_pgf():
    """RECONSTRUCT_FOR_PRESSURE: with a smooth T(z) resolved by coarse
    layers and tilted interfaces, the PLM in-layer T variation brings
    the coarse-grid PGF closer to a fine-grid reference than PCM
    (int_density_dz_generic_plm role)."""
    import jax.numpy as jnp
    import numpy as np
    from mom6_tpu.core.pressure_force import pressure_force_fv
    from mom6_tpu.eos import get_eos
    from mom6_tpu.grid.grid import build_cartesian_grid
    from mom6_tpu.grid.vertical import build_layered_vgrid
    ny, nx = 3, 12
    G = build_cartesian_grid(nx=nx, ny=ny, len_lon_km=600.0,
                             len_lat_km=150.0, max_depth=1000.0)
    eos = get_eos("LINEAR")

    def setup(nz):
        GV = build_layered_vgrid(nz)
        # tilted interfaces: column depth constant, thickness profile
        # varying in x so layer centers shift
        x = np.arange(nx) / nx
        base = np.full((nz, ny, nx), 1000.0 / nz)
        tilt = 0.3 * np.sin(2 * np.pi * x)[None, None, :] \
            * np.sin(np.pi * (np.arange(nz) + 0.5) / nz)[:, None, None]
        h = base * (1.0 + tilt)
        h = h * (1000.0 / h.sum(0))[None]
        # T varies smoothly AND nonlinearly with depth; layer means from
        # exact integrals of T(z) = 15 + 8 cos(pi z / 1000)
        zi = np.concatenate([np.zeros((1, ny, nx)), np.cumsum(h, 0)], 0)

        def Tint(z):   # antiderivative of T(z)
            return 15.0 * z + 8.0 * 1000.0 / np.pi * np.sin(
                np.pi * z / 1000.0)
        T = (Tint(zi[1:]) - Tint(zi[:-1])) / h
        S = np.full_like(T, 35.0)
        return GV, jnp.asarray(h, jnp.float32), \
            jnp.asarray(T, jnp.float32), jnp.asarray(S, jnp.float32)

    # fine reference: PFu of the barotropic (depth-integrated) force
    GVf, hf, Tf, Sf = setup(64)
    pf_fine = pressure_force_fv(hf, Tf, Sf, G, GVf, eos)
    ref = np.asarray(jnp.sum(pf_fine.PFu * hf, axis=0))
    GVc, hc, Tc, Sc = setup(6)
    pf_pcm = pressure_force_fv(hc, Tc, Sc, G, GVc, eos)
    pf_plm = pressure_force_fv(hc, Tc, Sc, G, GVc, eos, plm_ts=True)
    e_pcm = np.abs(np.asarray(jnp.sum(pf_pcm.PFu * hc, 0)) - ref).max()
    e_plm = np.abs(np.asarray(jnp.sum(pf_plm.PFu * hc, 0)) - ref).max()
    assert e_plm < e_pcm, (e_plm, e_pcm)
    # and at rest over a FLAT interior the force is still ~0
    assert np.isfinite(np.asarray(pf_plm.PFu)).all()
