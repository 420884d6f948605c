"""Process-level runtime settings: where the compile cache lives, and how
timings wait for the device."""

import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE = os.path.join(REPO, ".jax_cache")

# Imports the package in a fresh process, compiles one tiny program with
# the cache threshold at zero, and prints the cache directory JAX uses.
_PROBE = """
import jax
import descriptools_jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _cache_dir(cwd, cache_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if cache_env is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_env
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


def test_cache_lands_in_the_directory_the_variable_names(tmp_path):
    target = tmp_path / "cache"
    assert _cache_dir(str(tmp_path), str(target)) == str(target)
    assert target.is_dir() and any(target.iterdir())


@pytest.mark.parametrize("where", ["repo", "elsewhere"])
def test_cache_defaults_to_the_checkout(tmp_path, where):
    cwd = REPO if where == "repo" else str(tmp_path)
    assert _cache_dir(cwd) == DEFAULT_CACHE


def test_two_fresh_processes_share_the_cache_path(tmp_path):
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    assert _cache_dir(str(a)) == _cache_dir(str(b))


def test_timeit_blocks_every_call_and_returns_the_median(monkeypatch):
    import jax

    from descriptools_jax.utils import timing

    sleeps = iter([0.0, 0.2, 0.02, 0.1])  # warmup, then three timed calls
    blocked = []

    def fn():
        time.sleep(next(sleeps))
        return object()

    def spy(x):
        blocked.append(x)
        return x

    monkeypatch.setattr(jax, "block_until_ready", spy)
    t = timing.timeit(fn, warmup=1, iters=3)
    assert len(blocked) == 4
    assert 0.1 <= t < 0.2
