"""mom6_tpu — an ocean general circulation model in JAX.

A brand-new hydrostatic Arakawa C-grid ocean dynamical core with the
capabilities of GFDL's MOM6 (see SURVEY.md), designed for accelerators
driven by XLA (NVIDIA GPUs are the target):

* state is a pytree of dense ``jnp`` arrays of shape ``(..., ny, nx)``;
* horizontal domain decomposition is GSPMD sharding over a
  ``jax.sharding.Mesh('y', 'x')`` — no MPI, no explicit halos in user code;
* every stencil is expressed with branchless roll/shift operators so land
  boundaries are enforced by masks (no ragged domains, no data-dependent
  control flow under ``jit``);
* the whole baroclinic time step (including the subcycled barotropic solver,
  as a ``lax.scan``) compiles to a single XLA program with no host round trips.

Layer map (mirrors SURVEY.md §1, re-architected for JAX):
  framework/   config parser, reproducing sums, checksums, diagnostics, restart
  parallel/    device mesh, sharding rules, explicit halo collectives
  grid/        horizontal/vertical grid containers & generation
  eos/         equation-of-state family (linear, Wright, ...)
  core/        continuity, Coriolis, pressure force, barotropic, split RK2
  physics/     vertical & lateral parameterizations
  ale/         regridding + conservative remapping
  tracers/     tracer registry, advection, diffusion
  drivers/     solo driver, surface forcing
  diagnostics/ energy/statistics output (ocean.stats analogue)
"""

__version__ = "0.1.0"
