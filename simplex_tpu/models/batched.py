"""Batched LP solving: thousands of independent instances per chip.

BASELINE config 2 ("batch of 10k random dense feasible LPs vmapped on one
chip").  The reference has no analogue — it solves one LP per request; this
is the accelerator's scale axis (SURVEY.md §5.7).

Two entry points:

* :func:`solve_lp_batch` — list of heterogeneous :class:`LinearProgram`s,
  padded to a shared bucket shape (host loop; convenience path).
* :func:`BatchedSimplexSolver.solve_arrays` — uniform-shape array batch
  ``(c: (B,n), A: (B,m,n), b: (B,m), ops: (m,))``, compiled fully
  vectorized on host and solved in one device call (performance path).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SolverConfig, DEFAULT_CONFIG
from ..core.problem import (
    OP_EQ,
    OP_LE,
    LinearProgram,
    STATUS_OPTIMAL,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    split_free_variables,
)
from ..ops import batched as batched_ops


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _batch_layout(m: int, n_cols: int, row_pad: int, col_pad: int,
                  align_total: bool):
    """``(m_pad, n_pad)`` of a uniform batch tableau.

    ``align_total=True`` rounds the TOTAL tableau (m_pad + 1 rows and
    n_pad + 1 columns, objective row and RHS column included) up to
    multiples of ``row_pad`` and ``col_pad``; each padding row brings its
    own unit column.  ``align_total=False`` keeps m_pad itself a multiple
    of ``row_pad`` instead — required by the row-sharded path, which splits
    the constraint rows (without the objective row) evenly across mesh
    devices.
    """
    if align_total:
        m_pad = max(_round_up(m + 1, row_pad), row_pad) - 1
        n_pad = max(_round_up(n_cols + (m_pad - m) + 1, col_pad),
                    col_pad) - 1
    else:
        m_pad = max(_round_up(m, row_pad), row_pad)
        n_pad = max(_round_up(n_cols + (m_pad - m), 8), col_pad)
    return m_pad, n_pad


@dataclasses.dataclass
class BatchResult:
    """Vectorized result of a batched solve."""

    x: np.ndarray          # (B, n) decision variables (user order)
    z: np.ndarray          # (B,) objective in the user sense
    fun: np.ndarray        # (B,) min-form objective
    status: np.ndarray     # (B,) int32 scipy-compatible codes
    success: np.ndarray    # (B,) bool
    nit: int               # shared loop trip count
    pivots: Optional[np.ndarray] = None  # (B,) per-instance pivot counts
    solve_time: float = 0.0
    basis: Optional[np.ndarray] = None   # (B, m_pad) final basis columns
    # Bounded solves: (B, n_pad) bool — nonbasic columns sitting AT their
    # finite upper bound (None for classic [0, inf) batches).
    at_upper: Optional[np.ndarray] = None
    # f64 certification (None when config.certify is off): certified[i] is
    # True iff instance i's verdict passed the host f64 KKT check — directly
    # for device optima, or via exact host re-solve for escalated instances
    # (models/certify.py).  escalated[i] marks the re-solved ones.
    certified: Optional[np.ndarray] = None
    escalated: Optional[np.ndarray] = None

    @property
    def n_optimal(self) -> int:
        return int(np.sum(self.status == STATUS_OPTIMAL))

    @property
    def n_escalated(self) -> int:
        return 0 if self.escalated is None else int(np.sum(self.escalated))


@dataclasses.dataclass
class CompiledBatch:
    """Host-compiled batch ready for ``ops.batched.solve_tableau_batch``."""

    T0: np.ndarray          # (B, m_pad+1, n_pad+1)
    basis: np.ndarray       # (B, m_pad)
    col_mask_p1: np.ndarray
    col_mask_p2: np.ndarray
    obj_row_p1: np.ndarray
    obj_row_p2: np.ndarray
    need_p1: np.ndarray     # (B,)
    n_vars: int
    maximize: np.ndarray    # (B,) bool
    # (B, n_pad) upper bounds in tableau dtype (+inf on slack/artificial/
    # padding columns); None for classic [0, inf) batches.
    ub_ext: Optional[np.ndarray] = None


def _build_ub_ext(ub, B: int, n: int, n_pad: int, dtype):
    """Validate + pad user upper bounds to the tableau column layout.

    ``ub`` is (n,) or (B, n), entries in [0, +inf] (lb is 0 by convention
    — general lower bounds go through ``core.problem.normalize_bounds``
    first).  Returns (B, n_pad) with +inf on every non-structural column,
    or None when every bound is +inf (the classic kernel then runs).
    """
    if ub is None:
        return None
    ub = np.broadcast_to(np.asarray(ub, np.float64), (B, n))
    if np.any(np.isnan(ub)) or np.any(ub < 0.0):
        raise ValueError(
            "Las cotas superiores deben cumplir ub >= 0 (normalice las "
            "cotas inferiores primero con normalize_bounds).")
    if not np.any(np.isfinite(ub)):
        return None
    ub_ext = np.full((B, n_pad), np.inf, np.float64)
    ub_ext[:, :n] = ub
    return ub_ext.astype(dtype, copy=False)


def compile_batch_uniform(c: np.ndarray, A: np.ndarray, b: np.ndarray,
                          ops: np.ndarray, maximize,
                          row_pad: int = 8, col_pad: int = 8,
                          dtype=np.float32,
                          align_total: bool = True,
                          ub=None) -> CompiledBatch:
    """Vectorized standard-form compilation for a uniform-shape batch.

    The column layout is uniform across the batch (slack i at n+i,
    artificial i at n+m+i, dead slots masked per instance), so the whole
    tableau assembly is pure numpy broadcasting — no Python loop over
    instances.  ``ops`` may be a shared (m,) vector or per-instance
    (B, m); ``maximize`` a scalar or a (B,) bool array.
    """
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    ops = np.asarray(ops, np.int64)
    for name, arr in (("c", c), ("A", A), ("b", b)):
        if not np.all(np.isfinite(arr)):
            raise ValueError(
                f"Los datos del problema deben ser finitos: '{name}' "
                f"contiene NaN/Inf.")
    B, m, n = A.shape
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,)).copy()

    c_min = np.where(maximize[:, None], -c, c)

    # Row normalization: flip rows with negative rhs (flips the operator).
    neg = b < 0                                    # (B, m)
    A = np.where(neg[:, :, None], -A, A)
    b = np.where(neg, -b, b)
    ops2 = ops if ops.ndim == 2 else ops[None, :]
    ops_b = np.where(neg, -ops2, ops2)             # (B, m)

    # Column layout is operator-dependent and ops_b varies per instance when
    # rows were flipped, so build per-instance layouts via vectorized masks:
    # every inequality row gets a slack slot; every row gets an artificial
    # slot.  Unused artificial slots (<= rows) are masked out per instance.
    # This keeps the layout uniform: slack i at n+i, artificial i at n+m+i.
    # When NO instance needs artificials (all rows <= after normalization,
    # the tall-LP benchmark shape), the artificial block is dropped
    # entirely — it would otherwise double the tableau width, and every
    # pivot streams the full width (n_art = 0 ⇒ ~2x less HBM per pivot).
    is_le_pre = ops_b == OP_LE
    n_art = 0 if bool(np.all(is_le_pre)) else m
    n_cols = n + m + n_art
    m_pad, n_pad = _batch_layout(m, n_cols, row_pad, col_pad, align_total)

    # Allocate the tableau DIRECTLY in the target dtype: the f64
    # intermediate doubled peak host memory, which is what caps the
    # 100k-row config-5 regime (a 100k x 100k f32 tableau is 40 GB; its
    # f64 twin would put assembly alone at 120 GB on a 125 GB host).
    # Assignments below cast f64 sources per-element; the small
    # objective/mask arrays stay f64 until the final cast.
    T = np.zeros((B, m_pad + 1, n_pad + 1), dtype=np.dtype(dtype))
    T[:, :m, :n] = A
    T[:, :m, n_pad] = b

    is_ineq = ops_b != OP_EQ                       # (B, m)
    is_le = ops_b == OP_LE
    sign = np.where(is_le, 1.0, -1.0) * is_ineq    # slack/surplus sign
    rows = np.arange(m)
    T[:, rows, n + rows] = sign

    # Artificials: needed for >= and = rows.
    need_art = ~is_le                              # (B, m)
    if n_art:
        T[:, rows, n + m + rows] = need_art.astype(np.float64)

    basis = np.where(is_le, n + rows[None, :], n + m + rows[None, :])
    basis = basis.astype(np.int32)                 # (B, m)

    basis_full = np.zeros((B, m_pad), np.int32)
    basis_full[:, :m] = basis
    # Padding rows: dedicated unit columns so the basis stays invertible.
    pad_rows = np.arange(m, m_pad)
    pad_cols = n_cols + (pad_rows - m)
    T[:, pad_rows, pad_cols] = 1.0
    basis_full[:, m:] = pad_cols[None, :].astype(np.int32)

    col_valid = np.zeros((B, n_pad), bool)
    col_valid[:, :n] = True
    col_valid[:, n:n + m] = is_ineq                # live slack columns
    art_live = np.zeros((B, n_pad), bool)
    if n_art:
        art_live[:, n + m:n + 2 * m] = need_art
    col_mask_p1 = col_valid | art_live
    col_mask_p2 = col_valid

    need_p1 = need_art.any(axis=1)

    obj_row_p1 = np.zeros((B, n_pad + 1), np.float64)
    obj_row_p2 = np.zeros((B, n_pad + 1), np.float64)
    obj_row_p2[:, :n] = c_min
    if n_art:
        obj_row_p1[:, n + m:n + 2 * m] = need_art.astype(np.float64)
        # Phase-1 objective row (priced out): r = -sum over artificial
        # rows, zero on the artificial columns themselves.
        art_rows_sum = np.einsum("bm,bmn->bn", need_art.astype(np.float64),
                                 T[:, :m, :])
        obj1 = -art_rows_sum
        obj1[:, n + m:n + 2 * m] = 0.0
        # Instances with no artificials start directly in phase 2: install
        # the priced-out phase-2 objective (initial basis is all-slack,
        # cost 0, so the raw row is already priced out).
        T[:, m_pad, :] = np.where(need_p1[:, None], obj1, obj_row_p2)
    else:
        T[:, m_pad, :] = obj_row_p2

    ub_ext = _build_ub_ext(ub, B, n, n_pad, dtype)
    if ub_ext is not None:
        # Fixed columns (ub == 0): x_j = 0 always — mask them out of both
        # phases (a zero-span variable would bound-flip forever).
        fixed = ub_ext[:, :n_pad] == 0.0
        col_mask_p1 &= ~fixed
        col_mask_p2 &= ~fixed

    return CompiledBatch(
        T0=T.astype(dtype, copy=False),
        basis=basis_full,
        col_mask_p1=col_mask_p1,
        col_mask_p2=col_mask_p2,
        obj_row_p1=obj_row_p1.astype(dtype, copy=False),
        obj_row_p2=obj_row_p2.astype(dtype, copy=False),
        need_p1=need_p1,
        n_vars=n,
        maximize=maximize,
        ub_ext=ub_ext,
    )


def compile_batch_on_device(c, A, b, ops, maximize,
                            row_pad: int = 8, col_pad: int = 8,
                            dtype=np.float32,
                            align_total: bool = True,
                            ub=None) -> CompiledBatch:
    """Device-side standard-form assembly for a uniform array batch.

    Functionally identical to :func:`compile_batch_uniform`, but the padded
    tableau, masks, and objective rows are built INSIDE one jitted program:
    the host ships only the raw ``(c, A, b)`` — ~3x fewer bytes than the
    padded tableau — and the assembly (flips, slack/artificial unit
    columns, phase-1 pricing) runs at HBM speed.  At B=65536x30x50 the
    numpy assembly is host time that grows with the padded tableau; this
    removes that bottleneck from the sweep pipeline.
    """
    A = np.asarray(A)
    B, m, n = A.shape
    for name, arr in (("c", c), ("A", A), ("b", b)):
        if not np.all(np.isfinite(np.asarray(arr))):
            raise ValueError(
                f"Los datos del problema deben ser finitos: '{name}' "
                f"contiene NaN/Inf.")
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,)).copy()
    dt = np.dtype(dtype)
    # Static layout decision (host): drop the artificial block when no row
    # can need one after sign normalization — ~2x less tableau width on
    # all-<= batches (mirrors compile_batch_uniform's n_art logic).
    b_np = np.asarray(b)
    ops_np = np.asarray(ops, np.int64)
    ops2 = ops_np if ops_np.ndim == 2 else ops_np[None, :]
    ops_flip = np.where(b_np < 0, -ops2, ops2)
    with_art = bool(np.any(ops_flip != OP_LE))
    out = _assemble_batch_jit(
        jnp.asarray(c, dt), jnp.asarray(A, dt), jnp.asarray(b, dt),
        jnp.asarray(np.asarray(ops, np.int32)), jnp.asarray(maximize),
        row_pad=int(row_pad), col_pad=int(col_pad),
        align_total=bool(align_total), with_art=with_art)
    T, basis, cm1, cm2, o1, o2, need_p1 = out
    ub_ext = _build_ub_ext(ub, B, n, cm1.shape[1], dt)
    if ub_ext is not None:
        live = jnp.asarray(ub_ext != 0.0)     # mask out fixed columns
        cm1 = jnp.logical_and(cm1, live)
        cm2 = jnp.logical_and(cm2, live)
    return CompiledBatch(
        T0=T, basis=basis, col_mask_p1=cm1, col_mask_p2=cm2,
        obj_row_p1=o1, obj_row_p2=o2, need_p1=need_p1,
        n_vars=n, maximize=maximize, ub_ext=ub_ext,
    )


@functools.partial(
    jax.jit,
    static_argnames=("row_pad", "col_pad", "align_total", "with_art"))
def _assemble_batch_jit(c, A, b, ops, maximize,
                        row_pad: int, col_pad: int, align_total: bool,
                        with_art: bool = True):
    """Jitted twin of the numpy assembly in ``compile_batch_uniform``.

    ``with_art`` is the STATIC artificial-block decision made on host
    (False ⇒ every row is <= after normalization, no artificial columns
    are allocated and the tableau is ~2x narrower)."""
    B, m, n = A.shape
    dt = A.dtype
    c_min = jnp.where(maximize[:, None], -c, c)

    neg = b < 0
    A = jnp.where(neg[:, :, None], -A, A)
    b = jnp.where(neg, -b, b)
    ops2 = ops if ops.ndim == 2 else ops[None, :]
    ops_b = jnp.where(neg, -ops2, ops2)

    n_art = m if with_art else 0
    n_cols = n + m + n_art
    m_pad, n_pad = _batch_layout(m, n_cols, row_pad, col_pad, align_total)

    rows = jnp.arange(m)
    is_ineq = ops_b != OP_EQ
    is_le = ops_b == OP_LE
    sign = jnp.where(is_le, 1.0, -1.0) * is_ineq
    need_art = ~is_le

    T = jnp.zeros((B, m_pad + 1, n_pad + 1), dt)
    T = T.at[:, :m, :n].set(A)
    T = T.at[:, :m, n_pad].set(b)
    T = T.at[:, rows, n + rows].set(sign.astype(dt))
    if with_art:
        T = T.at[:, rows, n + m + rows].set(need_art.astype(dt))
    pad_rows = np.arange(m, m_pad)
    pad_cols = n_cols + (pad_rows - m)
    T = T.at[:, pad_rows, pad_cols].set(1.0)

    basis = jnp.where(is_le, (n + rows)[None, :],
                      (n + m + rows)[None, :]).astype(jnp.int32)
    basis_full = jnp.concatenate(
        [basis, jnp.broadcast_to(jnp.asarray(pad_cols, jnp.int32)[None, :],
                                 (B, m_pad - m))], axis=1)

    col_idx = jnp.arange(n_pad)[None, :]
    col_valid = col_idx < n
    slack_live = (col_idx >= n) & (col_idx < n + m)
    # Broadcast the per-row liveness onto the column axis.
    pad_f = jnp.zeros((B, n_pad - m), bool)
    slack_mask = jnp.concatenate(
        [jnp.zeros((B, n), bool), is_ineq, pad_f[:, : n_pad - n - m]],
        axis=1) & slack_live
    col_mask_p2 = col_valid | slack_mask
    obj_row_p2 = jnp.concatenate(
        [c_min, jnp.zeros((B, n_pad + 1 - n), dt)], axis=1)

    if with_art:
        art_pos = (col_idx >= n + m) & (col_idx < n + 2 * m)
        art_mask = jnp.concatenate(
            [jnp.zeros((B, n + m), bool), need_art,
             pad_f[:, : n_pad - n - 2 * m]], axis=1) & art_pos
        col_mask_p1 = col_mask_p2 | art_mask
        need_p1 = jnp.any(need_art, axis=1)
        obj_row_p1 = jnp.concatenate(
            [jnp.zeros((B, n + m), dt), need_art.astype(dt),
             jnp.zeros((B, n_pad + 1 - n - 2 * m), dt)], axis=1)
        art_rows_sum = jnp.einsum("bm,bmn->bn", need_art.astype(dt),
                                  T[:, :m, :],
                                  precision=jax.lax.Precision.HIGHEST)
        obj1 = -art_rows_sum
        obj1 = obj1.at[:, n + m:n + 2 * m].set(0.0)
        T = T.at[:, m_pad, :].set(
            jnp.where(need_p1[:, None], obj1, obj_row_p2))
    else:
        col_mask_p1 = col_mask_p2
        need_p1 = jnp.zeros((B,), bool)
        obj_row_p1 = jnp.zeros((B, n_pad + 1), dt)
        T = T.at[:, m_pad, :].set(obj_row_p2)
    return T, basis_full, col_mask_p1, col_mask_p2, obj_row_p1, obj_row_p2, \
        need_p1


def _run_batch(cb: CompiledBatch, config: SolverConfig,
               max_iters: Optional[int] = None) -> BatchResult:
    import time
    t0 = time.perf_counter()
    m_pad = cb.basis.shape[1]
    n_pad = cb.col_mask_p1.shape[1]
    if max_iters is None:
        max_iters = min(config.max_iters, 50 * (m_pad + n_pad))
    bland_after = min(config.bland_after, max_iters // 2)

    # STATIC fast-path flag: an all-phase-2 batch (every row <= after sign
    # normalization) runs the chunked no-cond driver loop (ops/batched.py
    # phase2_only, which drops the per-iteration phase-flip conds).
    phase2_only = not bool(np.any(np.asarray(cb.need_p1)))
    at_upper = None
    if cb.ub_ext is not None:
        # Native-bounds kernel (ops/batched.solve_tableau_batch_bounded).
        T, basis, at_up, status, iters, pivots = \
            batched_ops.solve_tableau_batch_bounded(
                jnp.asarray(cb.T0), jnp.asarray(cb.basis),
                jnp.asarray(cb.col_mask_p1), jnp.asarray(cb.col_mask_p2),
                jnp.asarray(cb.obj_row_p1), jnp.asarray(cb.obj_row_p2),
                jnp.asarray(cb.need_p1), jnp.asarray(cb.ub_ext),
                tol=_batch_tol(config, cb.T0.dtype),
                max_iters=int(max_iters),
                bland_after=int(bland_after),
                refactor_every=int(config.refactor_every
                                   or max(64, m_pad // 8)),
                devex=config.pivot_rule == "devex",
                phase2_only=phase2_only,
            )
        x, z_min = batched_ops.extract_solution_batch_bounded(
            T, basis, at_up, jnp.asarray(cb.ub_ext), cb.n_vars)
        at_upper = np.asarray(at_up)
    else:
        T, basis, status, iters, pivots = batched_ops.solve_tableau_batch(
            jnp.asarray(cb.T0), jnp.asarray(cb.basis),
            jnp.asarray(cb.col_mask_p1), jnp.asarray(cb.col_mask_p2),
            jnp.asarray(cb.obj_row_p1), jnp.asarray(cb.obj_row_p2),
            jnp.asarray(cb.need_p1),
            tol=_batch_tol(config, cb.T0.dtype),
            max_iters=int(max_iters),
            bland_after=int(bland_after),
            refactor_every=int(config.refactor_every
                               or max(64, m_pad // 8)),
            devex=config.pivot_rule == "devex",
            phase2_only=phase2_only,
        )
        x, z_min = batched_ops.extract_solution_batch(T, basis, cb.n_vars)
    x = np.maximum(np.asarray(x, np.float64), 0.0)
    fun = np.asarray(z_min, np.float64)
    status = np.asarray(status)
    z = np.where(cb.maximize, -fun, fun) + 0.0
    ok = status == STATUS_OPTIMAL
    return BatchResult(
        x=np.where(ok[:, None], x, np.nan),
        z=np.where(ok, z, np.nan),
        fun=np.where(ok, fun, np.nan),
        status=status,
        success=ok,
        nit=int(iters),
        pivots=np.asarray(pivots),
        solve_time=time.perf_counter() - t0,
        basis=np.asarray(basis),
        at_upper=at_upper,
    )


def _batch_tol(config: SolverConfig, dtype) -> float:
    """Working tolerance for the batched kernel, dtype-aware.

    f32 can't separate progress from round-off below ~1e-6, so the floor
    protects it; a float64 batch honours ``config.tol`` exactly like the
    dense path (``models/dense.py`` scales tol by dtype the same way).
    """
    if np.dtype(dtype) == np.float64:
        return float(config.tol)
    return float(max(config.tol, 1e-6))


def certify_uniform_result(res: BatchResult, c, A, b, ops, maximize,
                           row_pad: int = 8, col_pad: int = 8,
                           align_total: bool = True, tol: float = 1e-7,
                           chunk: int = 8192, ub=None) -> BatchResult:
    """f64-certify a uniform-batch result in place (models/certify.py).

    Recompiles the standard form in float64 per ``chunk`` of instances
    (bounded host memory even at 1M-instance sweeps), runs the batched KKT
    check against the exact data, and escalates every untrusted verdict to
    the exact host engine.  The layout parameters must match the solve.

    Bounded results (``ub`` given) and large-m batches route through the
    structured raw-data certifier, which knows the bounded KKT system and
    scales past the dense-LU regime.
    """
    from .certify import certify_and_escalate

    ops = np.asarray(ops)
    A = np.asarray(A)
    B = A.shape[0]
    maximize = np.broadcast_to(np.asarray(maximize, bool), (B,))
    certified = np.zeros((B,), bool)
    escalated = np.zeros((B,), bool)
    # Result arrays may be zero-copy views of device buffers (read-only).
    res.status = np.array(res.status)
    res.x = np.array(res.x)
    res.fun = np.array(res.fun)
    res.z = np.array(res.z)
    if np.all(ops == OP_LE):
        # All-<= sweep (shared or per-instance ops vector): the fully-
        # vectorized structured certifier (one batched LAPACK pair
        # straight from raw data — ~17x the chunked standard-form path,
        # the 1M-exact-sweep enabler).  Returns None when some b < 0
        # (row flips create artificials) — fall through.
        from .certify import certify_sweep_le_f64

        fix = certify_sweep_le_f64(res.status, res.basis, c, A, b,
                                   maximize, ub=ub, at_upper=res.at_upper,
                                   tol=tol)
        if fix is not None:
            res.status = fix["status"]
            res.x = fix["x"]
            res.fun = fix["fun"]
            res.z = fix["z"]
            res.success = res.status == STATUS_OPTIMAL
            res.certified = fix["certified"]
            res.escalated = fix["escalated"]
            return res
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    if ub is not None or A.shape[1] >= 512:
        # Large-m regime: the structured certifier (k×k LU per instance,
        # k <= n) replaces the dense m×m batched LU, which is O(m^3) host
        # LAPACK — prohibitive from ~16k rows (VERDICT r3 item 2).  It is
        # also the only certifier that knows the bounded KKT system.
        from .certify import certify_and_escalate_raw

        fix = certify_and_escalate_raw(
            res.status, res.basis, c, A, b, ops, maximize, tol=tol,
            ub=ub, at_upper=res.at_upper)
        res.status = fix["status"]
        res.x = fix["x"]
        res.fun = fix["fun"]
        res.z = fix["z"]
        res.success = res.status == STATUS_OPTIMAL
        res.certified = fix["certified"]
        res.escalated = fix["escalated"]
        return res
    for start in range(0, B, chunk):
        end = min(start + chunk, B)
        ops_chunk = ops if ops.ndim == 1 else ops[start:end]
        cb64 = compile_batch_uniform(
            c[start:end], A[start:end], b[start:end], ops_chunk,
            maximize[start:end], row_pad=row_pad, col_pad=col_pad,
            dtype=np.float64, align_total=align_total)
        m_pad = cb64.basis.shape[1]
        n_pad = cb64.col_mask_p1.shape[1]

        def mk(i, _s=start, _ops=ops_chunk):
            return LinearProgram(
                c=c[_s + i], A=A[_s + i], b=b[_s + i],
                ops=_ops if _ops.ndim == 1 else _ops[i],
                maximize=bool(maximize[_s + i]))

        fix = certify_and_escalate(
            res.status[start:end], res.basis[start:end],
            cb64.T0[:, :m_pad, :n_pad], cb64.T0[:, :m_pad, n_pad],
            cb64.obj_row_p2[:, :n_pad],
            cb64.col_mask_p1 & ~cb64.col_mask_p2, cb64.col_mask_p2,
            mk, maximize[start:end], cb64.n_vars, tol=tol,
            c1_std=cb64.obj_row_p1[:, :n_pad], mask_p1=cb64.col_mask_p1)
        certified[start:end] = fix["certified"]
        escalated[start:end] = fix["escalated"]
        res.status[start:end] = fix["status"]
        res.x[start:end] = fix["x"]
        res.fun[start:end] = fix["fun"]
        res.z[start:end] = fix["z"]
    res.success = res.status == STATUS_OPTIMAL
    res.certified = certified
    res.escalated = escalated
    return res


class BatchedSimplexSolver:
    """Batched two-phase simplex over a shared padded shape."""

    def __init__(self, config: SolverConfig = DEFAULT_CONFIG):
        self.config = config

    def solve_arrays(self, c, A, b, ops, maximize=True,
                     dtype=None, ub=None) -> BatchResult:
        """Uniform-shape performance path: one device call for the batch.

        Standard-form assembly happens ON DEVICE
        (:func:`compile_batch_on_device`) — the host ships raw (c, A, b)
        only, so large sweeps aren't bottlenecked on numpy assembly.  When
        ``config.certify`` is on (default), every verdict is then f64-KKT
        checked against the exact data and untrusted ones re-solved by the
        exact host engine — the same guarantee single-LP solves carry.

        ``ub`` ((n,) or (B, n), entries in [0, +inf]): NATIVE upper bounds
        — solved by the bounded ratio-test kernel at zero row cost, the
        capability HiGHS provides behind the reference's
        ``solver_controller.py:78-85`` (general lower bounds are lowered
        first via ``core.problem.normalize_bounds``; see solve_lp_sweep).
        """
        cb = compile_batch_on_device(
            c, A, b, ops, maximize,
            dtype=np.dtype(dtype or self.config.dtype), ub=ub,
        )
        res = self._solve_compiled(cb)
        if self.config.certify:
            res = certify_uniform_result(res, c, A, b, ops, maximize,
                                         ub=ub)
        return res

    def _solve_compiled(self, cb: CompiledBatch) -> BatchResult:
        return _run_batch(cb, self.config)

    def solve_many(self, lps: Sequence[LinearProgram]) -> BatchResult:
        """Same-variable-count convenience path: pad instances to one bucket.

        Constraint counts and operators may differ per instance; the number
        of decision variables must match (solution extraction reads the
        first ``n_vars`` columns of every instance).
        """
        assert lps, "empty batch"
        n_vars = {lp.n_vars for lp in lps}
        assert len(n_vars) == 1, (
            f"solve_many requires a uniform variable count, got {n_vars}"
        )
        n_user = lps[0].n_vars
        if any(lp.has_finite_bounds for lp in lps):
            # Convenience path: lower finite bounds onto rows per
            # instance, so one standard-form build feeds both the solve
            # AND this path's std-form-based certifier.  Bound-heavy
            # batches that want the NATIVE bounded kernel (zero row
            # inflation + raw-data certification) go through
            # solve_lp_sweep / solve_arrays(ub=...) instead.
            lps = [lower_bounds_to_rows(lp) for lp in lps]
        free_maps = None
        if any(lp.has_free for lp in lps):
            # Lower free variables per instance (x = x+ - x-).  The split
            # columns sit right after the user columns, so extraction reads
            # the widest expanded width and each instance merges its own map.
            pairs = [split_free_variables(lp) for lp in lps]
            lps = [p[0] for p in pairs]
            free_maps = [p[1] for p in pairs]
        dtype = np.dtype(self.config.dtype)
        # Compile in f64: the same arrays feed both the (cast) device batch
        # and the f64 certification pass — one standard-form build, two uses.
        sfs = [compile_standard_form(lp, dtype=np.float64) for lp in lps]
        m_pad = max(sf.m_pad for sf in sfs)
        n_pad = max(sf.n_pad for sf in sfs)
        B = len(sfs)

        T0 = np.zeros((B, m_pad + 1, n_pad + 1), np.float64)
        basis = np.zeros((B, m_pad), np.int32)
        cm1 = np.zeros((B, n_pad), bool)
        cm2 = np.zeros((B, n_pad), bool)
        o1 = np.zeros((B, n_pad + 1), np.float64)
        o2 = np.zeros((B, n_pad + 1), np.float64)
        need = np.zeros((B,), bool)
        for i, sf in enumerate(sfs):
            mp, np_ = sf.m_pad, sf.n_pad
            T0[i, :mp, :np_] = sf.tableau[:mp, :np_]
            T0[i, :mp, n_pad] = sf.tableau[:mp, np_]        # RHS column
            T0[i, m_pad, :np_] = sf.tableau[mp, :np_]       # objective row
            T0[i, m_pad, n_pad] = sf.tableau[mp, np_]
            basis[i, :mp] = sf.basis
            # Extra padding rows (mp..m_pad) need their own unit columns.
            for k, row in enumerate(range(mp, m_pad)):
                col = np_ + k
                assert col < n_pad
                T0[i, row, col] = 1.0
                basis[i, row] = col
            cm1[i, :np_] = sf.col_mask_p1
            cm2[i, :np_] = sf.col_mask_p2
            o1[i, :np_] = sf.obj_row_p1[:np_]
            o1[i, n_pad] = sf.obj_row_p1[np_]
            o2[i, :np_] = sf.obj_row_p2[:np_]
            o2[i, n_pad] = sf.obj_row_p2[np_]
            need[i] = sf.need_phase1
            if not sf.need_phase1:
                # compile_standard_form leaves the objective row zero when
                # there is no phase 1; the batched kernel expects the
                # phase-2 row pre-installed (all-slack basis has zero cost,
                # so the raw row is already priced out).
                T0[i, m_pad, :np_] = sf.obj_row_p2[:np_]
                T0[i, m_pad, n_pad] = sf.obj_row_p2[np_]

        cb = CompiledBatch(
            T0=T0.astype(dtype), basis=basis, col_mask_p1=cm1,
            col_mask_p2=cm2, obj_row_p1=o1.astype(dtype),
            obj_row_p2=o2.astype(dtype), need_p1=need,
            n_vars=max(sf.n_vars for sf in sfs),
            maximize=np.array([lp.maximize for lp in lps]),
        )
        res = self._solve_compiled(cb)
        if self.config.certify:
            from .certify import certify_and_escalate

            fix = certify_and_escalate(
                res.status, res.basis,
                T0[:, :m_pad, :n_pad], T0[:, :m_pad, n_pad],
                o2[:, :n_pad], cm1 & ~cm2, cm2,
                lambda i: lps[i], cb.maximize, cb.n_vars,
                c1_std=o1[:, :n_pad], mask_p1=cm1)
            res = dataclasses.replace(
                res, status=fix["status"], x=fix["x"], fun=fix["fun"],
                z=fix["z"], success=fix["status"] == STATUS_OPTIMAL,
                certified=fix["certified"], escalated=fix["escalated"])
        if free_maps is not None:
            merged = np.stack([
                merge_free_solution(res.x[i], n_user, free_maps[i])
                for i in range(len(lps))
            ])
            res = dataclasses.replace(res, x=merged)
        return res


def solve_lp_batch(lps: Sequence[LinearProgram],
                   config: SolverConfig = DEFAULT_CONFIG) -> BatchResult:
    """Convenience wrapper: batched solve of a list of LinearPrograms."""
    return BatchedSimplexSolver(config).solve_many(lps)


def solve_lp_sweep(lps: Sequence[LinearProgram],
                   config: SolverConfig = DEFAULT_CONFIG):
    """Heterogeneous sweep: arbitrary LPs, bucketed + solved on device.

    The production entry for "solve this pile of unrelated LPs fast"
    (SURVEY.md §7: "bucketed compilation for the batch path").  Per LP the
    host does ONE cheap transform pass (lower bounds shifted/flipped out
    by ``normalize_bounds``, free → split; remaining finite UPPER bounds
    stay NATIVE via the bounded ratio-test kernel, adding zero rows) and
    computes a bucket key from the RAW shape rounded up to a multiple of
    8 — no standard-form compile, no per-instance tableau assembly.  Each
    bucket pads its raw (c, A, b, ops) arrays to the bucket shape
    (vacuous ``0'x <= 1`` rows, zero-cost zero columns) and goes through
    :meth:`BatchedSimplexSolver.solve_arrays`, whose standard-form
    assembly runs ON DEVICE — so a 100k mixed-shape sweep spends its time
    on the chip, not in a numpy loop.  Certification (config.certify)
    applies per bucket like any uniform batch.

    Returns per-LP results in the ORIGINAL order as ``(x, z, status,
    success)`` tuples (x in the instance's own variable order; None when
    not optimal).
    """
    from collections import defaultdict

    from ..core.problem import normalize_bounds

    solver = BatchedSimplexSolver(config)
    prepared = []            # per lp: (lp_t, n_user, free_map, bounds_tr)
    buckets = defaultdict(list)
    for idx, lp in enumerate(lps):
        # NATIVE bounds (VERDICT r3 item 4): finite lower bounds are
        # shifted/flipped out by normalize_bounds and the remaining finite
        # UPPER bounds ride the bounded ratio-test kernel at zero row cost
        # — a bound-heavy sweep keeps m equal to the structural row count
        # instead of re-inflating it with dense bound rows.
        lp_t, tr = (normalize_bounds(lp) if lp.has_finite_bounds
                    else (lp, None))
        if tr is not None and tr.identity:
            tr = None
        fmap = None
        if lp_t.has_free:
            lp_t, fmap = split_free_variables(lp_t)
        prepared.append((lp_t, lp.n_vars, fmap, tr))
        m_b = _round_up(max(lp_t.n_cons, 1), 8)
        n_b = _round_up(lp_t.n_vars, 8)
        buckets[(m_b, n_b)].append(idx)

    results = [None] * len(lps)
    for (m_b, n_b), indices in buckets.items():
        Bk = len(indices)
        c = np.zeros((Bk, n_b))
        A = np.zeros((Bk, m_b, n_b))
        # Vacuous padding rows: 0'x <= 1 (never binding, slack basic).
        b = np.ones((Bk, m_b))
        ops_b = np.full((Bk, m_b), OP_LE, np.int64)
        maxi = np.zeros((Bk,), bool)
        ub = np.full((Bk, n_b), np.inf)
        any_ub = False
        for k, i in enumerate(indices):
            lp_t, _, _, _ = prepared[i]
            m, n = lp_t.n_cons, lp_t.n_vars
            c[k, :n] = lp_t.c
            A[k, :m, :n] = lp_t.A
            b[k, :m] = lp_t.b
            ops_b[k, :m] = lp_t.ops
            maxi[k] = lp_t.maximize
            if np.any(np.isfinite(lp_t.ub)):
                ub[k, :n] = lp_t.ub
                any_ub = True
        res = solver.solve_arrays(c, A, b, ops_b, maximize=maxi,
                                  ub=ub if any_ub else None)
        for k, i in enumerate(indices):
            ok = bool(res.success[k])
            lp_t, n_user, fmap, tr = prepared[i]
            x = None
            z = None
            if ok:
                x = np.asarray(res.x[k][: lp_t.n_vars], np.float64)
                if fmap is not None:
                    x = merge_free_solution(x, n_user, fmap)
                if tr is not None:
                    x = tr.restore_x(x)
                z = (float(lps[i].c @ x)
                     if (tr is not None or fmap is not None)
                     else float(res.z[k]))
            results[i] = (x, z, int(res.status[k]), ok)
    return results


def solve_arrays_stream(batches, config: SolverConfig = DEFAULT_CONFIG,
                        maximize=True):
    """Pipelined sweep over an iterable of ``(c, A, b, ops[, ub])`` batches.

    JAX dispatch is asynchronous, so staging batch k+1 into device memory
    (``device_put``) is issued while batch k's solve is still executing —
    end-to-end throughput approaches ``max(transfer, solve)`` instead of
    their sum.  Yields one :class:`BatchResult` per input
    batch, in order.  All batches must share (m, n) and ``ops`` layout so
    one compiled program serves the whole sweep.

    Each batch may carry a fifth element ``ub`` ((n,) or (B, n) upper
    bounds): those batches ride the bounded fused kernel
    (``solve_tableau_batch_bounded``) with the same overlapped staging —
    bound-heavy sweeps no longer have to leave the streaming pipeline
    (VERDICT r4 missing #5).  Mixing bounded and unbounded batches in one
    stream is allowed (two compiled programs serve the sweep).
    """
    import time as _time

    import jax

    def stage(batch):
        c, A, b, ops = batch[:4]
        ub = batch[4] if len(batch) > 4 else None
        # Device-side assembly: the host only ships raw (c, A, b); the
        # padded tableau is built on device, overlapped with the previous
        # batch's solve like everything else in this pipeline.
        cb = compile_batch_on_device(c, A, b, ops, maximize,
                                     dtype=np.dtype(config.dtype), ub=ub)
        dev = [jnp.asarray(x) for x in
               (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
                cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
        if cb.ub_ext is not None:
            dev.append(jnp.asarray(cb.ub_ext))
        return cb, dev, batch

    it = iter(batches)
    try:
        current = stage(next(it))
    except StopIteration:
        return

    m_pad = current[0].basis.shape[1]
    n_pad = current[0].col_mask_p1.shape[1]
    max_iters = min(config.max_iters, 50 * (m_pad + n_pad))
    bland_after = min(config.bland_after, max_iters // 2)
    refactor_every = int(config.refactor_every or max(64, m_pad // 8))
    kern_kw = dict(
        tol=_batch_tol(config, np.dtype(config.dtype)),
        max_iters=int(max_iters), bland_after=int(bland_after),
        refactor_every=refactor_every,
        devex=config.pivot_rule == "devex",
    )

    while current is not None:
        cb, dev_args, raw = current
        bounded = cb.ub_ext is not None
        phase2_only = not bool(np.any(np.asarray(cb.need_p1)))
        t0 = _time.perf_counter()
        if bounded:
            out = batched_ops.solve_tableau_batch_bounded(
                *dev_args, phase2_only=phase2_only, **kern_kw)
        else:
            out = batched_ops.solve_tableau_batch(
                *dev_args, phase2_only=phase2_only, **kern_kw)
        # Stage the NEXT batch while the current solve runs on device.
        try:
            current = stage(next(it))
        except StopIteration:
            current = None

        at_upper = None
        if bounded:
            T, basis, at_up, status, iters, pivots = out
            x, z_min = batched_ops.extract_solution_batch_bounded(
                T, basis, at_up, jnp.asarray(cb.ub_ext), cb.n_vars)
            at_upper = np.asarray(at_up)
        else:
            T, basis, status, iters, pivots = out
            x, z_min = batched_ops.extract_solution_batch(
                T, basis, cb.n_vars)
        x = np.maximum(np.asarray(x, np.float64), 0.0)
        fun = np.asarray(z_min, np.float64)
        status = np.asarray(status)
        z = np.where(cb.maximize, -fun, fun) + 0.0
        ok = status == STATUS_OPTIMAL
        res = BatchResult(
            x=np.where(ok[:, None], x, np.nan),
            z=np.where(ok, z, np.nan),
            fun=np.where(ok, fun, np.nan),
            status=status,
            success=ok,
            nit=int(iters),
            pivots=np.asarray(pivots),
            solve_time=_time.perf_counter() - t0,
            basis=np.asarray(basis),
            at_upper=at_upper,
        )
        if config.certify:
            # Certification runs on host AFTER the next batch's solve was
            # dispatched, so it overlaps device work like staging does.
            rc, rA, rb, rops = raw[:4]
            rub = raw[4] if len(raw) > 4 else None
            res = certify_uniform_result(res, rc, rA, rb, rops,
                                         cb.maximize, ub=rub)
        yield res
