"""Test configuration: run everything on the CPU backend with 8 virtual
devices.

Mirrors the role of MOM6's .testing harness host setup: tests must be
hardware-independent, and the sharding tests need a multi-device mesh on
machines that have one accelerator or none.  Both settings go into the
environment before JAX starts a backend, so test subprocesses inherit
them too.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from mom6_tpu.framework.compile_cache import enable_compile_cache  # noqa: E402

# test subprocesses share the cache through the environment
os.environ["JAX_COMPILATION_CACHE_DIR"] = enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_collection_modifyitems(config, items):
    """Triage tiers: everything not explicitly marked ``slow`` is ``fast``
    (the <10-min tier; ``pytest -m fast``).  Heavy driver-level /
    compile-bound integration files opt into ``slow`` via pytestmark."""
    for item in items:
        if item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.fast)


@pytest.fixture(scope="session")
def devices8():
    d = jax.devices()
    assert len(d) >= 8, f"expected 8 virtual devices, got {len(d)}"
    return d[:8]
