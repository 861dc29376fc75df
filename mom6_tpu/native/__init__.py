"""Native (C++) host-runtime kernels, loaded via ctypes.

The device compute path is jax/XLA; this package is the native half of the
host runtime — the per-segment CPU work the reference does in
Fortran/FMS (reproducing sums for ocean.stats, checksum fingerprints).
See ``src/mom6_native.cc`` for the kernel inventory and reference
citations.

The shared library is built on demand with ``g++ -O3`` into this
package directory (no pip/pybind dependency) and cached; import never
fails — ``LIB`` is None when no compiler is available and callers fall
back to the numpy implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["available", "repro_sum", "bitcount", "field_stats"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "mom6_native.cc")
_SO = os.path.join(_DIR, "libmom6_native.so")

LIB = None


def _build() -> bool:
    try:
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", _SO + ".tmp", _SRC],
            capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(_SO + ".tmp", _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global LIB
    if LIB is not None:
        return LIB
    if not os.path.exists(_SO) or \
            os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.mom6_repro_sum_acc.restype = ctypes.c_longlong
    lib.mom6_repro_sum_acc.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
        ctypes.c_double, ctypes.POINTER(ctypes.c_longlong)]
    lib.mom6_repro_sum_finish.restype = ctypes.c_double
    lib.mom6_repro_sum_finish.argtypes = [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.mom6_bitcount64.restype = ctypes.c_longlong
    lib.mom6_bitcount64.argtypes = [ctypes.POINTER(ctypes.c_double),
                                    ctypes.c_longlong]
    lib.mom6_bitcount32.restype = ctypes.c_longlong
    lib.mom6_bitcount32.argtypes = [ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_longlong]
    lib.mom6_field_stats.restype = None
    lib.mom6_field_stats.argtypes = [ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_longlong,
                                     ctypes.POINTER(ctypes.c_double)]
    LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def repro_sum(x, scale: float = 1.0) -> float:
    """Native order-invariant sum; bit-identical to
    framework.repro_sum.reproducing_sum (same 6 x 2^46 EFP design)."""
    lib = _load()
    a = np.ascontiguousarray(np.asarray(x, np.float64).ravel())
    limbs = np.zeros(6, np.int64)
    lib.mom6_repro_sum_acc(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.size,
        float(scale), limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    return float(lib.mom6_repro_sum_finish(
        limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))))


def bitcount(x) -> int:
    """Native popcount checksum mod 1e9 (MOM_checksums bitcount)."""
    lib = _load()
    a = np.asarray(x)
    if a.dtype == np.float32:
        a = np.ascontiguousarray(a.ravel())
        return int(lib.mom6_bitcount32(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.size))
    a = np.ascontiguousarray(np.asarray(a, np.float64).ravel())
    return int(lib.mom6_bitcount64(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.size))


def field_stats(x):
    """Native fused (min, max, mean, nan_count)."""
    lib = _load()
    a = np.ascontiguousarray(np.asarray(x, np.float64).ravel())
    out = np.zeros(4, np.float64)
    lib.mom6_field_stats(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return float(out[0]), float(out[1]), float(out[2]), int(out[3])
