"""Typed configuration for the simplex_tpu framework.

The reference keeps its configuration as bare module constants
(``/root/reference/app/config.py:12-24``) plus hard-coded solver options
(``solver_controller.py:76``).  Here everything is a small typed dataclass
with environment-variable overrides, as SURVEY.md §5.6 prescribes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

BASE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# Artifact directory (same role as the reference's ``outputs/``).
OUTPUT_DIR = os.environ.get(
    "SIMPLEX_TPU_OUTPUT_DIR", os.path.join(BASE_DIR, "outputs")
)

# Sequential-file prefixes — identical to the reference contract so that
# artifacts round-trip (reference ``app/config.py:20-24``).
PREFIX_FUNCION_OBJETIVO = "funcion_objetivo"
PREFIX_RESTRICCIONES = "restricciones"
PREFIX_SOLUCION = "solucion_"
PREFIX_PROBLEMA = "problema_"
PREFIX_PDF = "reporte_solucion_"

# Web secret key: overridable, unlike the reference's hardcoded one
# (``routers.py:23``).
SECRET_KEY = os.environ.get("SIMPLEX_TPU_SECRET_KEY", "simplex_tpu_dev_key")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed.  Otherwise the cache lives at the fixed path
    ``.jax_cache/`` of the checkout, never a path built from a temporary
    name, a pid or the time, which a later run could not find again.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(BASE_DIR, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Options for the simplex engines.

    Replaces the reference's hard-coded ``{"presolve": True, "time_limit": 10}``
    scipy options (``solver_controller.py:76``).
    """

    # Pivot rule: "devex" (Forrest-Goldfarb approximate steepest edge;
    # ~4x fewer pivots than "dantzig" on large dense LPs) or "dantzig".
    # Both get an automatic Bland's-rule fallback after `bland_after`
    # consecutive NON-IMPROVING pivots (stall-gated: pricing reverts as soon
    # as the objective moves again — cycles never improve, so the
    # anti-cycling guarantee is intact).
    pivot_rule: str = "devex"
    bland_after: int = 256

    # Presolve reductions before the device solve (core/presolve.py) —
    # the reference's scipy ``presolve: True`` role.
    presolve: bool = True

    # Feasibility / optimality tolerance in the working dtype.
    tol: float = 1e-6

    # Hard pivot-iteration cap (static bound for lax.while_loop).
    max_iters: int = 16384

    # Working dtype on device.  The final basis is re-solved on host in
    # float64 when `refine=True`, which recovers 1e-6 objective parity vs
    # the CPU reference (SURVEY.md §7 "hard parts").
    dtype: str = "float32"
    refine: bool = True

    # f64-certify BATCHED/SHARDED verdicts (batched LU KKT check of every
    # claimed-optimal basis + exact host re-solve of untrusted instances,
    # models/certify.py).  Single-LP paths always certify regardless; this
    # flag exists so throughput benchmarks can measure the raw device loop.
    certify: bool = True

    # Wall-clock budget (seconds) honoured by host-side drivers; mirrors the
    # reference's 10 s scipy time_limit.
    time_limit: Optional[float] = 10.0

    # History capture cap (pivotSteps snapshots kept for reports).
    max_history: int = 64

    # Exact-refactorization period (pivots between T = B^-1·T0 rebuilds).
    # None = auto: max(64, m_pad // 8), so the O(m^3) refactor stays a
    # small fraction of the O(m^2·n)-per-period pivot work at any size.
    refactor_every: Optional[int] = None

    @staticmethod
    def from_env() -> "SolverConfig":
        """Build a config from ``SIMPLEX_TPU_*`` env vars.

        Every field is honored and every default matches the dataclass, so
        ``SolverConfig.from_env()`` under an empty environment is exactly
        ``SolverConfig()`` (an env-configured run must never get a
        different solver than a default-constructed one).
        """
        d = SolverConfig()

        def _env_bool(name: str, default: bool) -> bool:
            v = os.environ.get(name)
            if not v:
                return default
            return v.strip().lower() in ("1", "true", "yes", "on")

        time_limit_s = os.environ.get("SIMPLEX_TPU_TIME_LIMIT")
        refactor_s = os.environ.get("SIMPLEX_TPU_REFACTOR_EVERY")
        return SolverConfig(
            pivot_rule=os.environ.get("SIMPLEX_TPU_PIVOT_RULE", d.pivot_rule),
            bland_after=_env_int("SIMPLEX_TPU_BLAND_AFTER", d.bland_after),
            presolve=_env_bool("SIMPLEX_TPU_PRESOLVE", d.presolve),
            tol=_env_float("SIMPLEX_TPU_TOL", d.tol),
            max_iters=_env_int("SIMPLEX_TPU_MAX_ITERS", d.max_iters),
            dtype=os.environ.get("SIMPLEX_TPU_DTYPE", d.dtype),
            refine=_env_bool("SIMPLEX_TPU_REFINE", d.refine),
            certify=_env_bool("SIMPLEX_TPU_CERTIFY", d.certify),
            time_limit=(float(time_limit_s) if time_limit_s
                        else d.time_limit),
            max_history=_env_int("SIMPLEX_TPU_MAX_HISTORY", d.max_history),
            refactor_every=(int(refactor_s) if refactor_s
                            else d.refactor_every),
        )


DEFAULT_CONFIG = SolverConfig()

_warned_x64 = False


def resolve_dtype(dtype_str: str):
    """``np.dtype`` for a config dtype, with an x64-honesty check.

    JAX silently downcasts float64 arrays to float32 unless
    ``jax_enable_x64`` is on — a request for a float64 device solve would
    otherwise quietly run f32 (results stay exact regardless: every
    verdict is certified/refined on host in f64).  Warn once so the user
    knows what the device is actually executing.
    """
    import numpy as np

    dt = np.dtype(dtype_str)
    if dt == np.float64:
        global _warned_x64
        import jax

        if not jax.config.jax_enable_x64 and not _warned_x64:
            _warned_x64 = True
            import warnings

            warnings.warn(
                "dtype=float64 sin jax_enable_x64: el dispositivo ejecuta "
                "float32 (la certificación/refinado f64 en host mantiene "
                "la exactitud). Para f64 real en dispositivo: "
                "JAX_ENABLE_X64=1 o jax.config.update('jax_enable_x64', "
                "True) antes de crear arrays.", RuntimeWarning,
                stacklevel=3)
    return dt
