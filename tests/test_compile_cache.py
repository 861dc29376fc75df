"""The persistent compilation cache's directory
(framework/compile_cache.py): the caller's JAX_COMPILATION_CACHE_DIR when
set, else one fixed, git-ignored path inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax; "
         "from mom6_tpu.framework.compile_cache import enable_compile_cache; "
         "print(enable_compile_cache()); "
         "print(jax.config.jax_compilation_cache_dir)")


def _resolve(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    return out[-2], out[-1]


@pytest.mark.parametrize("env_value", ["caller", None],
                         ids=["variable_set", "variable_unset"])
def test_compile_cache_dir(env_value, tmp_path):
    want = str(tmp_path / "cache") if env_value else \
        os.path.join(REPO, ".jax_cache")
    returned, configured = _resolve(want if env_value else None)
    assert returned == configured == want
    if env_value is None:
        # fixed, inside the checkout, and never committed
        ignored = subprocess.run(
            ["git", "check-ignore", "-q", want], cwd=REPO).returncode
        assert ignored in (0, 128)    # 128: not a git checkout
        assert open(os.path.join(REPO, ".gitignore")).read().count(
            ".jax_cache/") == 1
