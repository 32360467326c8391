"""Tracing, metrics, and benchmark helpers (SURVEY.md §5.1/§5.5).

The reference's observability is ``print`` statements on the solve path
(``solver_controller.py:62,70,75,90``).  Here:

* :class:`SolveRecord` — structured per-solve record (problem shape,
  engine, pivots, status, wall time) with a JSONL sink;
* :func:`trace_span` — context manager emitting ``jax.profiler`` trace
  annotations (visible in TensorBoard/Perfetto captures) plus wall time;
* :func:`simple_timeit` — the standard JAX steady-state timing pattern:
  compile/warm-up first, then timed runs with ``block_until_ready`` and a
  data dependency so elided duplicate dispatches can't fake bandwidth
  (without it a measured bandwidth can exceed the part's peak — see
  bench.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import jax


@dataclasses.dataclass
class SolveRecord:
    engine: str
    n_vars: int
    n_cons: int
    status: int
    iterations: int
    wall_s: float
    batch: int = 1
    extra: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["extra"] is None:
            del d["extra"]
        return json.dumps(d)


class MetricsLog:
    """Append-only JSONL sink for solve records."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[SolveRecord] = []

    def log(self, record: SolveRecord):
        self.records.append(record)
        if self.path:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(record.to_json() + "\n")

    def summary(self) -> Dict[str, Any]:
        if not self.records:
            return {"solves": 0}
        total = len(self.records)
        ok = sum(1 for r in self.records if r.status == 0)
        wall = sum(r.wall_s for r in self.records)
        pivots = sum(r.iterations for r in self.records)
        return {
            "solves": total,
            "optimal": ok,
            "total_wall_s": round(wall, 4),
            "total_pivots": pivots,
            "pivots_per_sec": round(pivots / wall, 2) if wall else None,
        }


# Process-wide default sink: every orchestrated solve records here; set
# SIMPLEX_TPU_METRICS_FILE to also append JSONL to disk.  Exposed over
# HTTP at GET /metrics (web/app.py).
DEFAULT_METRICS = MetricsLog(os.environ.get("SIMPLEX_TPU_METRICS_FILE"))


@contextlib.contextmanager
def trace_span(name: str):
    """jax.profiler annotation + wall-clock span."""
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    _SPANS.setdefault(name, []).append(dt)


_SPANS: Dict[str, List[float]] = {}


def span_stats() -> Dict[str, Dict[str, float]]:
    out = {}
    for name, times in _SPANS.items():
        out[name] = {
            "count": len(times),
            "total_s": round(sum(times), 6),
            "mean_ms": round(1e3 * sum(times) / len(times), 3),
        }
    return out


def simple_timeit(fn: Callable, *args, iters: int = 20,
                  warmup: int = 2) -> Dict[str, float]:
    """Steady-state timing with compile exclusion and output blocking."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters": iters}
