"""Numerical-fault surveillance (the sanitizer role).

The reference's debugging stack initializes fresh allocations to NaN
(FMS init-to-NaN) and checksums every field each step under DEBUG=True,
so an uninitialized read or an exploding term is caught at the step it
happens with the field named.  Under JAX the first half is moot — arrays
are produced whole by pure functions, there are no uninitialized reads —
so the sanitizer here is the second half made cheap: a per-segment
sweep of the whole state pytree that counts non-finite values per field
(wet cells separated from land, where guarded divisions may legitimately
produce junk that the masks then zero), names the offending fields, and
stops the run with a written report instead of letting NaNs silently
propagate through ocean.stats.

Wired into the solo driver behind ``DEBUG_CHECK_NANS`` (the DEBUG
family of MOM_input); `check_finite_state` is also usable standalone
around any suspect call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["field_nan_report", "check_finite_state", "NanFault"]


class NanFault(FloatingPointError):
    """Raised when the state contains non-finite values in wet cells."""


def _wet_mask_for(name: str, G) -> Optional[np.ndarray]:
    if G is None:
        return None
    if name.startswith("u") or name in ("du_av_inst",):
        m = G.mask2dCu
    elif name.startswith("v") or name in ("dv_av_inst",):
        m = G.mask2dCv
    else:
        m = G.mask2dT
    return np.asarray(m) > 0.5


def field_nan_report(state, G=None) -> Dict[str, Tuple[int, int, tuple]]:
    """Scan every array field of the state pytree (including the tracer
    registry dict).  Returns {field: (n_bad_wet, n_bad_land,
    first_bad_index)} for fields with any non-finite entry."""
    import jax

    report: Dict[str, Tuple[int, int, tuple]] = {}

    def scan(name, arr):
        if arr is None:
            return
        a = np.asarray(jax.device_get(arr))
        if not np.issubdtype(a.dtype, np.floating):
            return
        bad = ~np.isfinite(a)
        if not bad.any():
            return
        wet = _wet_mask_for(name, G)
        if wet is not None and a.ndim >= 2 \
                and a.shape[-2:] == wet.shape:
            bad_wet = bad & np.broadcast_to(wet, a.shape)
            n_wet = int(bad_wet.sum())
            n_land = int(bad.sum()) - n_wet
            first = np.argwhere(bad_wet if n_wet else bad)[0]
        else:
            n_wet = int(bad.sum())
            n_land = 0
            first = np.argwhere(bad)[0]
        report[name] = (n_wet, n_land, tuple(int(i) for i in first))

    for name in getattr(state, "_fields", ()) or \
            [f for f in dir(state) if not f.startswith("_")]:
        val = getattr(state, name, None)
        if name == "tr" and isinstance(val, dict):
            for tname, tarr in val.items():
                scan(f"tr[{tname}]", tarr)
        elif hasattr(val, "dtype") or hasattr(val, "shape"):
            scan(name, val)
    return report


def check_finite_state(state, G=None, *, step: Optional[int] = None,
                       fatal_path: Optional[str] = None) -> None:
    """Raise :class:`NanFault` naming every field with non-finite wet
    values (land-only junk is reported but tolerated — masks zero it).
    ``fatal_path``: also write the report there (the rundir breadcrumb
    the solo driver leaves for post-mortem)."""
    rep = field_nan_report(state, G)
    wet_bad = {k: v for k, v in rep.items() if v[0] > 0}
    if not wet_bad:
        return
    lines = [f"NaN/Inf detected"
             + (f" at step {step}" if step is not None else "") + ":"]
    for k, (nw, nl, idx) in sorted(wet_bad.items()):
        lines.append(f"  {k}: {nw} wet (+{nl} land) non-finite, "
                     f"first at {idx}")
    msg = "\n".join(lines)
    if fatal_path is not None:
        with open(fatal_path, "w") as f:
            f.write(msg + "\n")
    raise NanFault(msg)
