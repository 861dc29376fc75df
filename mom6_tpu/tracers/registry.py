"""Tracer registry.

Analogue of MOM6's tracer registry (reference:
src/tracer/MOM_tracer_registry.F90:997, MOM_tracer_types.F90): a central
list of advected tracers with metadata, used by advection, diffusion,
column physics, restarts and diagnostics.

Design: the registered tracers live in one dict ``{name: (nz,ny,nx)}``
inside the model state; advection/diffusion operate on a single stacked
(n_tracer, nz, ny, nx) array so every tracer shares one reconstruction
(the tracer count is a batch dimension, SURVEY.md §5.7)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import jax.numpy as jnp

__all__ = ["TracerMeta", "TracerRegistry"]


@dataclass
class TracerMeta:
    name: str
    units: str = ""
    longname: str = ""
    conc_scale: float = 1.0
    registry_diags: bool = True


class TracerRegistry:
    def __init__(self):
        self._meta: Dict[str, TracerMeta] = {}
        self._locked = False

    def register(self, name: str, units: str = "", longname: str = "") -> None:
        if self._locked:
            raise RuntimeError("tracer registry locked after init")
        if name in self._meta:
            raise ValueError(f"tracer {name} already registered")
        self._meta[name] = TracerMeta(name, units, longname or name)

    def lock(self) -> None:
        self._locked = True

    @property
    def names(self) -> List[str]:
        return list(self._meta)

    def meta(self, name: str) -> TracerMeta:
        return self._meta[name]

    def stack(self, tracers: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        """Stack dict -> (n_tracer, nz, ny, nx) in registry order."""
        return jnp.stack([tracers[n] for n in self.names])

    def unstack(self, arr) -> Dict[str, jnp.ndarray]:
        return {n: arr[i] for i, n in enumerate(self.names)}
