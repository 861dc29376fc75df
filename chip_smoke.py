#!/usr/bin/env python
"""Smoke test of the ocean model on one NVIDIA GPU.

    python chip_smoke.py               # one GPU: phases a-e below
    python chip_smoke.py --four-gpus   # four GPUs: the 2x2-mesh path only

Runs in one process, on ``configs/global_half_deg`` (720x400x32 tripolar,
real continents, WRIGHT EOS, KPP, GM, z* ALE; DT 1200 s, DT_THERM 7200 s):

a. device: JAX platform, device kind and count, and the card's name and
   power limit from nvidia-smi;
b. main path: ``mom6_tpu.drivers.solo.main`` for one day (12 thermo
   cycles) in a scratch copy of the run directory, gated on finite
   ocean.stats, maxCFL below the truncation clip and the mass drift;
c. reference: 2 thermo cycles on the GPU and on XLA:CPU in this process,
   ocean.stats compared within stated tolerances;
d. determinism: two identical 2-cycle GPU segments, ocean.stats bitwise;
e. kernels: the tridiagonal kernel against the scan at real widths, alone
   and inside the thermo cycle, and the scan remap's time;
f. (--four-gpus) 4 cycles on a 2x2 mesh against the same cycles on one
   GPU, ocean.stats compared and the column solves checked per shard.

It exits non-zero, and prints no ok line, if JAX finds no GPU or any phase
fails.  The last line of its output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "global_half_deg")
RUN_DIR = os.path.join(REPO, ".chip_smoke")
STATS_KEYS = ("mass", "KE", "APE", "heat", "salt")
CFL_CLIP = 0.25           # limit_velocity's truncation (vert_friction.py)
# Relative change of the total mass over the day.  Continuity and the z*
# remap conserve volume to rounding and the ocean.stats mass is an exact
# fixed-point sum rounded once to float32 (one ulp = 6e-8 relative); 1e-6
# leaves room for a few ulp flips and still catches a leak of one metre
# of water over a millionth of the ocean's area.
MASS_DRIFT_REL = 1e-6
# GPU against XLA:CPU after 2 cycles.  Both run float32 with the same
# operations; they differ in summation order, multiply-add contraction and
# the libm of exp/log/pow in the EOS.  Mass, heat and salt are conserved
# to rounding on either device, so they agree to a few ulps of the total;
# KE and APE carry the rounding differences through 12 dynamic steps.
REF_TOL = {"mass": 1e-6, "heat": 1e-6, "salt": 1e-6, "KE": 1e-3,
           "APE": 1e-4}
# One GPU against the 2x2 mesh after 4 cycles: the partitioned program
# fuses differently, so the states part by rounding that threshold physics
# (KPP layer choice, convective adjustment) can amplify in a few columns.
MESH_TOL = {"mass": 1e-6, "heat": 1e-6, "salt": 1e-6, "KE": 5e-3,
            "APE": 1e-4}
# Kernel against scan: both float32 in the same order of operations; they
# differ only where the compilers contract multiply-adds differently, and
# the diagonally dominant recursion damps such differences.
TRIDIAG_TOL = 1e-5
# the config's column solves, and an OM4-class grid's (1440x1080x75)
TRIDIAG_SHAPES = ((32, 400, 720), (75, 1080, 1440))


class PhaseError(RuntimeError):
    pass


class _Tee(io.StringIO):
    """Keeps what is written and passes it on."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def timed(fn, *args, reps=10):
    """(seconds per call, result) of a jitted ``fn`` after one warm call."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def prepare_run_dir() -> str:
    """A fresh copy of the config's run directory; the solo driver writes
    its grid inputs, ocean.stats and restart there."""
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    for name in ("MOM_input", "make_inputs.py"):
        shutil.copy(os.path.join(CONFIG, name), RUN_DIR)
    with open(os.path.join(RUN_DIR, "MOM_override"), "w") as fh:
        # one ocean.stats line per thermo cycle (2 h)
        fh.write("#override ENERGYSAVEDAYS = 0.08333333333\n")
    return RUN_DIR


def parse_stats(path):
    rows = []
    for ln in open(path):
        if ln.startswith("#"):
            continue
        nums = [float(v) for v in re.findall(
            r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan|inf", ln)]
        mass = float(re.search(r"Mass\s+([-+\d.eE]+)", ln).group(1))
        cfl = float(re.search(r"maxCFL\s+([-+\d.eE]+)", ln).group(1))
        rows.append({"nums": nums, "mass": mass, "cfl": cfl})
    return rows


def phase_main_path(smi):
    """b: the solo driver for one day, as a user runs it."""
    from mom6_tpu.drivers import solo
    rundir = prepare_run_dir()
    buf = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        solo.main([rundir, "--days", "1"])
    wall = time.perf_counter() - t0
    log = buf.getvalue()
    segs = [float(v) for v in re.findall(
        r"segment \d+: 1 cycles stepped in ([\d.]+) s", log)]
    check(len(segs) == 12, f"expected 12 one-cycle segments, got {segs}")
    rows = parse_stats(os.path.join(rundir, "ocean.stats"))
    check(len(rows) == 12, f"expected 12 ocean.stats lines, got {len(rows)}")
    check(all(math.isfinite(v) for r in rows for v in r["nums"]),
          "non-finite value in ocean.stats")
    max_cfl = max(r["cfl"] for r in rows)
    check(max_cfl < CFL_CLIP, f"maxCFL {max_cfl} at the truncation clip")
    drift = abs(rows[-1]["mass"] - rows[0]["mass"]) / rows[0]["mass"]
    check(drift < MASS_DRIFT_REL, f"mass drift {drift:.3e}")
    steady = sorted(segs[1:])[len(segs[1:]) // 2]
    print(f"main path: global_half_deg 1 day, 12 cycles: maxCFL {max_cfl}, "
          f"mass drift {drift:.3e} (bound {MASS_DRIFT_REL}); first cycle "
          f"{segs[0]:.3f} s (compile {segs[0] - steady:.3f} s), steady "
          f"{steady:.4f} s/cycle (median of 11), driver wall {wall:.1f} s "
          f"[{smi}]")
    return rundir


def build(rundir, device):
    import jax
    from mom6_tpu.drivers.config_driver import build_model_from_params
    from mom6_tpu.framework.config import ParamFile
    with jax.default_device(device):
        return build_model_from_params(
            ParamFile([os.path.join(rundir, "MOM_input")]))


def stats_of(ms, state):
    import jax
    from mom6_tpu.diagnostics.sum_output import compute_stats_jit
    s = jax.jit(lambda st: compute_stats_jit(
        st, ms.grid, ms.vgrid, ms.params.dyn.dt,
        cp=ms.params.diabatic.cp))(state)
    return {k: float(v) for k, v in s.items()}


def run_cycles(ms, device, n, stepper=None):
    """(stats, seconds per cycle after the first, stepper, state) of ``n``
    cycles on ``device`` from the initial state."""
    import jax
    import jax.numpy as jnp
    from mom6_tpu.drivers.solo import make_mom_stepper
    with jax.default_device(device):
        stepper = stepper or make_mom_stepper(ms.grid, ms.vgrid, ms.params,
                                              ms.forcing)
        st = jax.tree_util.tree_map(jnp.copy, ms.state)
        st = stepper(st)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(n - 1):
            st = stepper(st)
        jax.block_until_ready(st)
        per_cycle = (time.perf_counter() - t0) / max(n - 1, 1)
        return stats_of(ms, st), per_cycle, stepper, st


def phase_reference(rundir, smi):
    """c and d: GPU against XLA:CPU, and the GPU against itself."""
    import jax
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    ms_gpu = build(rundir, gpu)
    g1, t_gpu, stepper, _ = run_cycles(ms_gpu, gpu, 2)
    g2 = run_cycles(ms_gpu, gpu, 2, stepper)[0]
    t0 = time.perf_counter()
    ms_cpu = build(rundir, cpu)
    c1, t_cpu, _, _ = run_cycles(ms_cpu, cpu, 2)
    t_cpu_all = time.perf_counter() - t0
    for k in STATS_KEYS:
        rel = abs(g1[k] - c1[k]) / abs(c1[k])
        print(f"reference: {k} gpu {g1[k]!r} cpu {c1[k]!r} rel "
              f"{rel:.3e} (tol {REF_TOL[k]})")
        check(rel <= REF_TOL[k], f"GPU vs CPU {k}: rel {rel:.3e}")
    print(f"reference: 2 cycles, gpu {t_gpu:.4f} s/cycle, cpu "
          f"{t_cpu:.3f} s/cycle ({t_cpu_all:.1f} s with build and compile) "
          f"[{smi}]")
    diff = [k for k in g1 if g1[k] != g2[k]]
    check(not diff, f"two identical GPU segments differ in {diff}")
    print(f"determinism: two 2-cycle GPU segments, ocean.stats bitwise equal "
          f"({len(g1)} fields)")
    return ms_gpu, stepper


def phase_kernels(ms, stepper, smi):
    """e: each kernel against its plain reference, alone and in context."""
    import jax
    import jax.numpy as jnp
    from mom6_tpu.ale.remapping import PPM_H4, remap_columns_multi
    from mom6_tpu.drivers.solo import make_mom_stepper
    from mom6_tpu.framework import solvers
    from mom6_tpu.framework.pallas_tridiag import tridiag_solve_kernel

    gpu = jax.devices()[0]
    for shape in TRIDIAG_SHAPES:
        ka, kb, kc, kd = jax.random.split(jax.random.PRNGKey(0), 4)
        a = -jax.random.uniform(ka, shape)
        c = -jax.random.uniform(kc, shape)
        b = 2.5 + jax.random.uniform(kb, shape)
        d = jax.random.normal(kd, shape)
        t_k, x_k = timed(jax.jit(tridiag_solve_kernel), a, b, c, d)
        t_s, x_s = timed(jax.jit(solvers._tridiag_scan), a, b, c, d)
        err = float(jnp.max(jnp.abs(x_k - x_s)) / jnp.max(jnp.abs(x_s)))
        print(f"tridiag {shape} float32: kernel {t_k * 1e3:.4f} ms, scan "
              f"{t_s * 1e3:.4f} ms, max err {err:.3e} of max|x| "
              f"(tol {TRIDIAG_TOL}), bitwise {bool(jnp.all(x_k == x_s))} "
              f"[{smi}]")
        check(err <= TRIDIAG_TOL, f"tridiag kernel error {err:.3e}")
        del a, b, c, d, x_k, x_s

    st = ms.state
    h1 = st.h * (1.0 + 0.1 * jnp.cos(jnp.arange(st.h.shape[0]))[:, None,
                                                                 None])
    h1 = h1 * (jnp.sum(st.h, 0) / jnp.sum(h1, 0))[None]
    remap = jax.jit(remap_columns_multi, static_argnums=3)
    for fields in (jnp.stack([st.T, st.S]), st.u[None]):
        t_r, out = timed(remap, fields, st.h, h1, PPM_H4)
        check(bool(jnp.all(jnp.isfinite(out))), "remap output not finite")
        print(f"remap scan {tuple(fields.shape)} PPM_H4: "
              f"{t_r * 1e3:.4f} ms per remap [{smi}]")

    # in context: the same thermo cycle with the scan in every column
    # solve, timed in turns with the kernel build (kernel, scan, scan,
    # kernel)
    fits = solvers._kernel_fits
    solvers._kernel_fits = lambda d, mesh: False
    try:
        scan_stepper = make_mom_stepper(ms.grid, ms.vgrid, ms.params,
                                        ms.forcing)
        run_cycles(ms, gpu, 1, scan_stepper)          # compile
    finally:
        solvers._kernel_fits = fits
    times = {"kernel": [], "scan": []}
    for name in ("kernel", "scan", "scan", "kernel"):
        s = stepper if name == "kernel" else scan_stepper
        times[name].append(run_cycles(ms, gpu, 6, s)[1])
    k, s = min(times["kernel"]), min(times["scan"])
    print(f"tridiag in context, global_half_deg cycle: kernel {k:.4f} s, "
          f"scan {s:.4f} s (best of 2 runs of 5 cycles each, "
          f"runs {times}) [{smi}]")


def phase_four_gpus(smi):
    """f: the 2x2-mesh path against one GPU."""
    import jax
    from mom6_tpu.core.mom import step_mom
    from mom6_tpu.parallel.mesh import (constrain_state, make_mesh,
                                        shard_over, state_sharding)

    check(len(jax.devices()) >= 4, f"need 4 GPUs, have {jax.devices()}")
    rundir = prepare_run_dir()
    subprocess.run([sys.executable, os.path.join(rundir, "make_inputs.py"),
                    rundir], check=True, env=dict(
                        os.environ, PYTHONPATH=REPO))
    gpu = jax.devices()[0]
    ms = build(rundir, gpu)
    one, t_one, _, st_one = run_cycles(ms, gpu, 4)

    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    with mesh:
        G = shard_over(mesh, ms.grid)
        forcing = shard_over(mesh, ms.forcing)
        st0 = shard_over(mesh, ms.state)
        # the ocean.stats sums are layout-invariant: one state, two layouts
        same = stats_of(ms._replace(grid=G), shard_over(mesh, st_one))
        step = jax.jit(
            lambda s: step_mom(constrain_state(s), forcing, G, ms.vgrid,
                               ms.params),
            out_shardings=state_sharding(mesh, st0), donate_argnums=0)
        compiled = step.lower(st0).compile()
        hlo = compiled.as_text()
        four, t_four, _, _ = run_cycles(ms._replace(state=st0), gpu, 4,
                                        compiled)
    diff = [k for k in one if one[k] != same[k]]
    check(not diff, f"stats of one state differ across layouts: {diff}")
    print("four gpus: ocean.stats of one state on 1 GPU and on the 2x2 "
          "mesh bitwise equal")
    ny, nx = ms.state.h.shape[-2:]
    full = re.compile(rf"f32\[(\d+,)*{ny},{nx}\][^\n]*all-gather")
    gathers = [ln for ln in hlo.splitlines() if full.search(ln)]
    n_kernel = hlo.count("tridiag_thomas")
    print(f"four gpus: 2x2 mesh, {n_kernel} tridiag kernel calls in the "
          f"step, {len(gathers)} all-gathers of full ({ny}, {nx}) planes")
    check(n_kernel > 0, "no tridiag kernel in the sharded step")
    check(not gathers, "full-plane all-gather in the sharded step:\n"
          + "\n".join(gathers[:5]))
    bitwise = all(one[k] == four[k] for k in one)
    for k in STATS_KEYS:
        rel = abs(one[k] - four[k]) / abs(one[k])
        print(f"four gpus: {k} 1 gpu {one[k]!r} 2x2 {four[k]!r} rel "
              f"{rel:.3e} (tol {MESH_TOL[k]})")
        check(rel <= MESH_TOL[k], f"1 vs 4 GPUs {k}: rel {rel:.3e}")
    print(f"four gpus: 4 cycles, 1 gpu {t_one:.4f} s/cycle, 2x2 mesh "
          f"{t_four:.4f} s/cycle, stepped ocean.stats bitwise {bitwise} "
          f"[{smi}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 2x2-mesh path and its comparison")
    args = ap.parse_args(argv)

    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX backend is {backend!r}, not a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from mom6_tpu.framework.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")

    dev = jax.devices()[0]
    smi = nvidia_smi_line()
    print(f"device: platform {dev.platform}, kind {dev.device_kind}, "
          f"count {len(jax.devices())}")
    print(f"nvidia-smi: {smi}", flush=True)
    if args.four_gpus:
        phases = [("four_gpus", lambda: phase_four_gpus(smi))]
    else:
        ctx = {}
        phases = [
            ("main_path", lambda: ctx.update(
                rundir=phase_main_path(smi))),
            ("reference_and_determinism", lambda: ctx.update(zip(
                ("ms", "stepper"), phase_reference(ctx["rundir"], smi)))),
            ("kernels", lambda: phase_kernels(ctx["ms"], ctx["stepper"],
                                              smi)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:        # report the phase, then fail
            import traceback
            traceback.print_exc()
            print(f"phase {name}: FAILED ({type(e).__name__}: {e})",
                  file=sys.stderr)
            return 1
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
