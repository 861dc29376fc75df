"""Wide-halo (march-inward) barotropic subcycling vs GSPMD: measured.

MOM6 widens the barotropic solver's halos so each rank can march
``nstep`` substeps inward without communicating, exchanging once per
cycle (reference: src/core/MOM_barotropic.F90 wide-halo clones and the
"march inward" comments; SURVEY.md §2.14.3).  Under GSPMD the
equivalent question is whether XLA's per-substep CollectivePermutes
(from jnp.roll inside the lax.scan) cost more than redundantly
computing a W-cell halo rim and exchanging every W substeps via an
explicit shard_map + ppermute.

This experiment times both forms of a linear shallow-water subcycle —
the communication structure of btstep without its physics extras — on
an N-device mesh, and writes the measurement to
``widehalo_results.json``.

Run on the virtual CPU mesh (structure check; CPU "collectives" are
memcpys, so the ratio is NOT a prediction for a real interconnect):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
    python tools/widehalo_experiment.py

On several real devices the same script measures the interconnect
tradeoff; the production solver stays on whichever path wins there.  Current
recorded result (8 virtual CPU devices, 512x512, 32 substeps): GSPMD
wins at halo widths 1-8 — see widehalo_results.json / PARITY.md.
"""

from __future__ import annotations

import json
import os
import sys
import time

if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", "") and len(sys.argv) == 1:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

G_E = 9.8
DEPTH = 4000.0
DX = 10.0e3


def subcycle_body(eta, u, v, dtbt):
    """One linear shallow-water forward-backward substep (the
    communication skeleton of btstep: one +1 and one -1 shift per
    direction per substep)."""
    c2 = G_E * DEPTH
    dudx = (u - jnp.roll(u, 1, axis=1)) / DX
    dvdy = (v - jnp.roll(v, 1, axis=0)) / DX
    eta = eta - dtbt * DEPTH * (dudx + dvdy)
    detadx = (jnp.roll(eta, -1, axis=1) - eta) / DX
    detady = (jnp.roll(eta, -1, axis=0) - eta) / DX
    u = u - dtbt * G_E * detadx
    v = v - dtbt * G_E * detady
    del c2
    return eta, u, v


def gspmd_cycle(nstep, mesh):
    """Whole subcycle under jit + sharding constraints: XLA inserts a
    CollectivePermute per shift, pipelined across substeps."""
    spec = NamedSharding(mesh, P("y", "x"))

    @jax.jit
    def run(eta, u, v):
        eta = jax.lax.with_sharding_constraint(eta, spec)

        def body(c, _):
            return subcycle_body(*c, 5.0), None
        (eta, u, v), _ = jax.lax.scan(body, (eta, u, v), None,
                                      length=nstep)
        return eta, u, v
    return run


def widehalo_cycle(nstep, halo, mesh):
    """shard_map form: each shard carries a ``halo``-wide rim of its
    neighbors, marches ``halo`` substeps without communication
    (redundant compute in the rim), then refreshes the rim with four
    ppermutes.  halo >= 1; nstep % halo == 0 for simplicity."""
    ny_ax = jax.lax.axis_index  # noqa: F841  (used inside shard fn)

    def exchange(z, halo):
        """Refresh the rim: pull halo rows/cols from the +/- neighbors
        along each mesh axis (periodic)."""
        def pull(arr, axis_name, shift, sl):
            n = jax.lax.psum(1, axis_name)
            perm = [((i + shift) % n, i) for i in range(n)]
            return jax.lax.ppermute(arr[sl], axis_name, perm)
        core = z[halo:-halo, halo:-halo]
        top = pull(core, "y", -1, (slice(-halo, None), slice(None)))
        bot = pull(core, "y", +1, (slice(None, halo), slice(None)))
        z = z.at[:halo, halo:-halo].set(top)
        z = z.at[-halo:, halo:-halo].set(bot)
        mid = z[:, halo:-halo]
        left = pull(mid, "x", -1, (slice(None), slice(-halo, None)))
        right = pull(mid, "x", +1, (slice(None), slice(None, halo)))
        z = z.at[:, :halo].set(left)
        z = z.at[:, -halo:].set(right)
        return z

    def shard_fn(eta, u, v):
        # local arrays come in WITHOUT halos; allocate the rim
        def pad(z):
            return jnp.pad(z, halo, mode="constant")
        eta, u, v = pad(eta), pad(u), pad(v)
        n_outer = nstep // halo

        def outer(c, _):
            eta, u, v = c
            eta = exchange(eta, halo)
            u = exchange(u, halo)
            v = exchange(v, halo)

            def inner(c2, _):
                return subcycle_body(*c2, 5.0), None
            (eta, u, v), _ = jax.lax.scan(inner, (eta, u, v), None,
                                          length=halo)
            return (eta, u, v), None
        (eta, u, v), _ = jax.lax.scan(outer, (eta, u, v), None,
                                      length=n_outer)
        sl = slice(halo, -halo)
        return eta[sl, sl], u[sl, sl], v[sl, sl]

    spec = P("y", "x")
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=(spec, spec, spec))
    return jax.jit(fn)


def time_fn(fn, args, n=10):
    out = fn(*args)
    jax.block_until_ready(out[0])
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*out)
    jax.block_until_ready(out[0])
    return (time.perf_counter() - t0) / n


def main(size=512, nstep=32):
    devs = np.array(jax.devices())
    n = len(devs)
    my, mx = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4),
              16: (4, 4)}.get(n, (1, n))
    mesh = Mesh(devs.reshape(my, mx), ("y", "x"))
    print(f"mesh {my}x{mx} over {n} {devs[0].platform} devices; "
          f"grid {size}x{size}, {nstep} substeps")
    rng = np.random.default_rng(0)
    eta = jnp.asarray(rng.normal(0, 0.1, (size, size)), jnp.float32)
    u = jnp.zeros((size, size), jnp.float32)
    v = jnp.zeros((size, size), jnp.float32)
    spec = NamedSharding(mesh, P("y", "x"))
    eta, u, v = (jax.device_put(a, spec) for a in (eta, u, v))

    results = {"devices": n, "platform": devs[0].platform,
               "grid": size, "nstep": nstep, "cases": {}}
    with mesh:
        t = time_fn(gspmd_cycle(nstep, mesh), (eta, u, v))
        results["cases"]["gspmd"] = t * 1e3
        print(f"  gspmd (roll->CollectivePermute/substep): {t*1e3:8.2f} ms")
        for halo in (1, 2, 4, 8):
            if nstep % halo:
                continue
            t = time_fn(widehalo_cycle(nstep, halo, mesh), (eta, u, v))
            results["cases"][f"widehalo_{halo}"] = t * 1e3
            print(f"  shard_map wide-halo W={halo}:              "
                  f"{t*1e3:8.2f} ms")
    best = min(results["cases"], key=results["cases"].get)
    results["winner"] = best
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "widehalo_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"winner: {best}; written to {out}")
    return results


if __name__ == "__main__":
    main()
