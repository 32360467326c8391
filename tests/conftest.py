"""Test harness configuration.

Runs the whole suite on the CPU backend with 8 virtual XLA devices so that
mesh/collective code is exercised without several devices — the standard JAX
testing pattern (SURVEY.md §4 "equivalent-strategy mapping").
"""
import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
