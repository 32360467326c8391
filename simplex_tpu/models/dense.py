"""Dense tableau-simplex solver: the framework's authoritative single-LP engine.

Plays the role scipy/HiGHS plays in the reference
(``solver_controller.py:78-85``): given a :class:`LinearProgram`, returns a
scipy-compatible result object (``success`` / ``status`` / ``x`` / ``fun`` /
``message``) so the orchestration layer keeps the same contract.

Numerics: the pivot loop runs on device in float32; when
``config.refine`` is set the final basis system ``B x_B = b`` is re-solved on
host in float64, recovering 1e-6+ objective parity with the CPU reference
(SURVEY.md §7 "numerical tolerance in f32").
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import jax.numpy as jnp

from ..config import SolverConfig, DEFAULT_CONFIG, resolve_dtype
from ..core.problem import (
    LinearProgram,
    StandardForm,
    STATUS_ITERATION_LIMIT,
    STATUS_MESSAGES,
    STATUS_OPTIMAL,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    split_free_variables,
)
from ..ops import tableau as tableau_ops


def _bucket(x: int, minimum: int = 8) -> int:
    """Round up to the next power of two (limits jit recompilation)."""
    b = minimum
    while b < x:
        b *= 2
    return b


def _bucket_gentle(x: int, align: int = 8) -> int:
    """Quantize ``x`` up with at most ~12.5% padding overhead.

    Buckets are multiples of ``align`` AND of 1/8 of the enclosing power of
    two, so the number of distinct compiled shapes stays logarithmic (8 per
    octave) while the padding waste is bounded.  Power-of-two bucketing
    (``_bucket``) wastes up to 2x just above a power of two — a 2048-row LP
    was being solved on a 4096-row tableau, doubling every pivot's HBM
    traffic.
    """
    x = max(int(x), align)
    step = max(align, (1 << (x.bit_length() - 1)) // 8)
    step = ((step + align - 1) // align) * align
    return ((x + step - 1) // step) * step


def _pad_plan(lp: LinearProgram):
    """(row_pad, col_pad) compile targets for one LP.

    Rows: total (constraints + objective) gently bucketed.  Columns: the
    EXACT slack/artificial count after RHS-flip canonicalization — not the
    3m+n worst case, which allocated artificial columns even for pure-<=
    problems (another ~1.8x of dead HBM traffic at large m).
    """
    m, n = lp.n_cons, lp.n_vars
    row_total = _bucket_gentle(m + 1, 8)
    m_pad = row_total - 1
    ops_eff = np.where(lp.b < 0, -lp.ops, lp.ops)
    n_cols = n + int(np.sum(ops_eff != 0)) + int(np.sum(ops_eff != -1))
    col_total = _bucket_gentle(n_cols + (m_pad - m) + 1, 128)
    return row_total, col_total


@dataclasses.dataclass
class SimplexResult:
    """scipy.optimize.OptimizeResult-compatible solve result."""

    x: Optional[np.ndarray]     # decision variables (user order), float64
    fun: Optional[float]        # min-form objective (scipy convention)
    status: int                 # 0 optimal / 1 iter-limit / 2 infeasible / 3 unbounded
    success: bool
    message: str
    nit: int                    # pivot iterations
    basis: Optional[np.ndarray] = None  # final basis column indices
    z: Optional[float] = None   # objective in the USER sense (max ⇒ -fun)
    solve_time: float = 0.0
    # Bounded solves (revised engine): (n_pad,) bool — nonbasic columns at
    # their finite upper bound, in the engine's NORMALIZED padded space.
    # Feed back together with ``basis`` as a warm start
    # (``RevisedSimplexSolver.solve(warm_basis=..., warm_at_upper=...)``).
    at_upper: Optional[np.ndarray] = None
    # Sensitivity (None unless optimal and computable) — USER-sense signs:
    # duals[i] = dZ_user/db_i (shadow price of constraint i);
    # reduced_costs[j] = dZ_user/dx_j when forcing nonbasic x_j off its bound
    # (0 for basic variables up to round-off).
    duals: Optional[np.ndarray] = None
    reduced_costs: Optional[np.ndarray] = None

    def variable_values(self, variables: List[str]) -> Dict[str, float]:
        return {v: float(self.x[i]) for i, v in enumerate(variables)}


def _refine_on_host(sf: StandardForm, lp: LinearProgram,
                    basis: np.ndarray) -> Optional[np.ndarray]:
    """Re-solve the final basis system in float64 on the host.

    The f32 device loop decides *which* basis is optimal; this recovers the
    exact vertex for that basis: ``B x_B = b`` with B the basic columns of the
    float64 standard-form matrix.
    """
    m = sf.n_rows
    basis = np.asarray(basis[:m], dtype=np.int64)
    if np.any(basis >= sf.n_cols):  # a padding column is basic → bail out
        return None

    # Rebuild the float64 initial tableau columns (compile once more in f64).
    sf64 = compile_standard_form(lp, dtype=np.float64)
    A_full = sf64.tableau[:m, : sf.n_cols]
    b = sf64.tableau[:m, sf64.n_pad]
    B = A_full[:, basis]
    try:
        x_b = np.linalg.solve(B, b)
    except np.linalg.LinAlgError:
        x_b, *_ = np.linalg.lstsq(B, b, rcond=None)
    if not np.all(np.isfinite(x_b)):
        return None
    x = np.zeros((sf.n_cols,), dtype=np.float64)
    x[basis] = x_b
    return x


def _sensitivity_on_host(sf: StandardForm, lp: LinearProgram,
                         basis: np.ndarray):
    """Shadow prices and reduced costs from the optimal basis (host f64).

    The simplex multipliers of the min-form standard problem are
    ``y' = c_B' B^-1`` (one dense triangular-ish solve); reduced costs are
    ``rc = c - y'A``.  Signs are mapped back to the USER's orientation:
    standard-form row i is ``s_i * (original row i)`` (rows with negative
    rhs were flipped during compilation), and user Z is ``-Z_min`` for
    maximize — so ``dZ_user/db_i = (max ? -1 : 1) * s_i * y_i``.  This is
    capability the reference throws away: HiGHS computes marginals but
    ``solver_controller.py`` never reads them.

    Returns ``(duals, reduced_costs)`` or ``(None, None)`` when the basis
    includes padding columns or is numerically singular.
    """
    m = sf.n_rows
    basis = np.asarray(basis[:m], dtype=np.int64)
    if np.any(basis >= sf.n_cols):
        return None, None
    sf64 = compile_standard_form(lp, dtype=np.float64)
    A_full = sf64.tableau[:m, : sf.n_cols]
    c_full = sf64.obj_row_p2[: sf.n_cols]
    B = A_full[:, basis]
    try:
        y = np.linalg.solve(B.T, c_full[basis])
    except np.linalg.LinAlgError:
        return None, None
    if not np.all(np.isfinite(y)):
        return None, None
    rc_min = c_full - y @ A_full

    user_sign = -1.0 if lp.maximize else 1.0
    row_sign = np.where(lp.b < 0, -1.0, 1.0)       # compile-time row flips
    duals = user_sign * row_sign * y
    reduced = user_sign * rc_min[: lp.n_vars]
    return duals, reduced


def _finalize_on_host(sf: StandardForm, lp: LinearProgram,
                      basis: np.ndarray, sf64: Optional[StandardForm] = None,
                      tol: float = 1e-7):
    """One-factorization certify + refine + sensitivity (host f64).

    Certification, refinement, and sensitivity each need the SAME basis
    factorization (``B x_B = b`` and ``B' y = c_B``); computing them
    separately cost three f64 standard-form rebuilds and up to six dense
    LU factorizations per solve.  This does it once: one LU of B, two
    triangular solves, one rc matvec.

    Returns ``(certified, x_full, duals, reduced)`` — ``certified`` is the
    f64 KKT verdict of the claimed-optimal basis (see
    :func:`_certify_optimal_basis` for why every f32 verdict is checked);
    ``x_full`` the exact vertex over all standard-form columns (None when
    the basis is singular/padded); duals/reduced in USER-sense signs.
    """
    from scipy.linalg import lu_factor, lu_solve

    m = sf.n_rows
    basis = np.asarray(basis[:m], dtype=np.int64)
    if np.any(basis >= sf.n_cols):
        return False, None, None, None
    if sf64 is None:
        sf64 = compile_standard_form(lp, dtype=np.float64)
    A_full = sf64.tableau[:m, : sf.n_cols]
    b = sf64.tableau[:m, sf64.n_pad]
    c_full = sf64.obj_row_p2[: sf.n_cols]
    B = A_full[:, basis]
    try:
        lu = lu_factor(B)
        x_B = lu_solve(lu, b)
        y = lu_solve(lu, c_full[basis], trans=1)
    except (np.linalg.LinAlgError, ValueError):
        return False, None, None, None
    if not (np.all(np.isfinite(x_B)) and np.all(np.isfinite(y))):
        return False, None, None, None

    x_full = np.zeros((sf.n_cols,), dtype=np.float64)
    x_full[basis] = x_B

    rc_min = c_full - y @ A_full
    user_sign = -1.0 if lp.maximize else 1.0
    row_sign = np.where(lp.b < 0, -1.0, 1.0)
    duals = user_sign * row_sign * y
    reduced = user_sign * rc_min[: lp.n_vars]

    scale = 1.0 + float(np.max(np.abs(b))) if b.size else 1.0
    c_scale = 1.0 + float(np.max(np.abs(c_full)))
    art = (sf.col_mask_p1 & ~sf.col_mask_p2)[: sf.n_cols]
    valid = sf.col_mask_p2[: sf.n_cols]
    certified = (
        not np.any(x_B < -tol * scale)
        and not np.any(art[basis] & (np.abs(x_B) > tol * scale))
        and bool(np.all(rc_min[valid] >= -tol * c_scale))
    )
    return certified, x_full, duals, reduced


def _finalize_on_host_bounded(sf: StandardForm, lp: LinearProgram,
                              basis: np.ndarray, at_upper: np.ndarray,
                              sf64: Optional[StandardForm] = None,
                              tol: float = 1e-7):
    """Bounded-variable counterpart of :func:`_finalize_on_host`.

    The vertex is defined by (basis, at_upper): nonbasic columns sit at 0
    or at their upper bound u_j, so ``B x_B = b - A_U u_U``.  f64 KKT
    certification adds the bound-side conditions: ``0-tol <= x_B <=
    u_B+tol``; at-LOWER nonbasics need rc >= -tol, at-UPPER nonbasics
    rc <= +tol (their reduced cost pushes INTO the bound).  This is the
    per-solve safety net that makes the f32 bounded ratio test
    (models/revised.py) trustworthy.
    """
    from scipy.linalg import lu_factor, lu_solve

    m = sf.n_rows
    basis = np.asarray(basis[:m], dtype=np.int64)
    if np.any(basis >= sf.n_cols):
        return False, None, None, None
    if sf64 is None:
        sf64 = compile_standard_form(lp, dtype=np.float64, bounded=True)
    A_full = sf64.tableau[:m, : sf.n_cols]
    b = sf64.tableau[:m, sf64.n_pad]
    c_full = sf64.obj_row_p2[: sf.n_cols]
    ub = (sf64.ub_ext[: sf.n_cols] if sf64.ub_ext is not None
          else np.full((sf.n_cols,), np.inf))
    at_up = np.asarray(at_upper[: sf.n_cols], bool) & np.isfinite(ub)
    at_up[basis] = False
    u_vec = np.where(at_up, ub, 0.0)

    B = A_full[:, basis]
    try:
        lu = lu_factor(B)
        x_B = lu_solve(lu, b - A_full @ u_vec)
        y = lu_solve(lu, c_full[basis], trans=1)
    except (np.linalg.LinAlgError, ValueError):
        return False, None, None, None
    if not (np.all(np.isfinite(x_B)) and np.all(np.isfinite(y))):
        return False, None, None, None

    x_full = u_vec.copy()
    x_full[basis] = x_B

    rc_min = c_full - y @ A_full
    user_sign = -1.0 if lp.maximize else 1.0
    row_sign = np.where(lp.b < 0, -1.0, 1.0)
    duals = user_sign * row_sign * y
    reduced = user_sign * rc_min[: lp.n_vars]

    scale = 1.0 + float(np.max(np.abs(b))) if b.size else 1.0
    c_scale = 1.0 + float(np.max(np.abs(c_full)))
    art = (sf.col_mask_p1 & ~sf.col_mask_p2)[: sf.n_cols]
    valid = sf.col_mask_p2[: sf.n_cols]
    ub_B = ub[basis]
    nonbasic = valid.copy()
    nonbasic[basis] = False
    lo_side = nonbasic & ~at_up
    up_side = nonbasic & at_up
    certified = (
        not np.any(x_B < -tol * scale)
        and not np.any(np.isfinite(ub_B) & (x_B > ub_B + tol * scale))
        and not np.any(art[basis] & (np.abs(x_B) > tol * scale))
        and bool(np.all(rc_min[lo_side] >= -tol * c_scale))
        and bool(np.all(rc_min[up_side] <= tol * c_scale))
    )
    return certified, x_full, duals, reduced


def _certify_optimal_basis(sf: StandardForm, lp: LinearProgram,
                           basis: np.ndarray, tol: float = 1e-7) -> bool:
    """f64 KKT check of a device-optimal basis (host).

    The f32 device loop can be defeated by exactly-dependent columns — e.g.
    the ± pairs a free-variable split produces: round-off drift lets a
    dependent column into the basis, the basis matrix turns singular, and
    refactorization against it can certify a false verdict.  So every
    'optimal' claimed by the f32 loop is re-checked here in float64:
    primal feasibility (``B x_B = b`` with ``x_B >= -tol``), dual
    feasibility (``rc >= -tol`` over phase-2 columns), and no artificial
    basic above tolerance.
    """
    m = sf.n_rows
    basis = np.asarray(basis[:m], dtype=np.int64)
    if np.any(basis >= sf.n_cols):
        return False
    sf64 = compile_standard_form(lp, dtype=np.float64)
    A_full = sf64.tableau[:m, : sf.n_cols]
    b = sf64.tableau[:m, sf64.n_pad]
    c_full = sf64.obj_row_p2[: sf.n_cols]
    B = A_full[:, basis]
    try:
        x_B = np.linalg.solve(B, b)
        y = np.linalg.solve(B.T, c_full[basis])
    except np.linalg.LinAlgError:
        return False
    if not (np.all(np.isfinite(x_B)) and np.all(np.isfinite(y))):
        return False
    scale = 1.0 + float(np.max(np.abs(b))) if b.size else 1.0
    if np.any(x_B < -tol * scale):
        return False
    art = (sf.col_mask_p1 & ~sf.col_mask_p2)[: sf.n_cols]
    if np.any(art[basis] & (np.abs(x_B) > tol * scale)):
        return False
    rc = c_full - y @ A_full
    c_scale = 1.0 + float(np.max(np.abs(c_full)))
    valid = sf.col_mask_p2[: sf.n_cols]
    return bool(np.all(rc[valid] >= -tol * c_scale))


def _host_simplex_f64(sf64: StandardForm, max_iters: int = 100000,
                      perturb: bool = False):
    """Reference two-phase dense simplex in numpy float64 (host).

    The escalation engine behind :func:`solve_lp`: when the f32 device
    verdict fails certification, the SAME compiled standard form is
    re-solved here exactly (Dantzig pricing with a stall-gated Bland
    fallback, Harris two-pass ratio test, periodic refactorization).
    Pure numpy — no toolchain or device dependency — and returns the basis
    so the refine/sensitivity machinery applies unchanged.
    Returns ``(status, basis, nit)``.

    ``perturb``: classical anti-degeneracy RHS perturbation — add a tiny
    deterministic jitter (~1e-8 relative) to b, solve, then RESTORE the
    exact b by refactoring the final basis.  Massively degenerate LPs
    (the round-4 adversarial corpus: exact ties on 30% of rows) ground
    through 100k stall-gated pivots unperturbed and ~2k perturbed; the
    caller re-runs phase 2 on the restored data if the perturbed basis
    came back slightly infeasible, and certification downstream judges
    the final answer either way.
    """
    T = sf64.tableau.astype(np.float64).copy()
    basis = sf64.basis.astype(np.int64).copy()
    n_pad = sf64.n_pad
    raw1 = sf64.obj_row_p1.astype(np.float64)
    raw2 = sf64.obj_row_p2.astype(np.float64)
    T0_rows = sf64.tableau.astype(np.float64)[:-1]
    tol = 1e-9
    nit = 0
    b_true = None
    if perturb:
        T0_rows = T0_rows.copy()
        b_true = T0_rows[:, n_pad].copy()
        jit_rng = np.random.default_rng(0x5EED)
        b_pert = b_true + 1e-8 * (1.0 + np.abs(b_true)) \
            * jit_rng.uniform(0.5, 1.5, size=b_true.shape[0])
        T0_rows[:, n_pad] = b_pert
        T[:-1, n_pad] = b_pert

    def refactor(obj_raw):
        nonlocal T
        B = T0_rows[:, basis]
        try:
            T_rows = np.linalg.solve(B, T0_rows)
        except np.linalg.LinAlgError:
            return False
        if not np.all(np.isfinite(T_rows)):
            return False
        obj = obj_raw - obj_raw[basis] @ T_rows
        T = np.concatenate([T_rows, obj[None, :]], axis=0)
        return True

    def run_phase(col_mask, obj_raw):
        nonlocal T, basis, nit
        since, no_imp, best = 0, 0, np.inf
        stalled_total = 0
        bland_lock = False
        w = np.ones((T.shape[1] - 1,))       # Devex reference weights
        for _ in range(max_iters):
            rc = np.where(col_mask, T[-1, :-1], np.inf)
            eligible = rc < -tol
            if not eligible.any():
                if since and refactor(obj_raw):
                    since = 0
                    continue
                return STATUS_OPTIMAL
            # Stall-gated Bland with a PERMANENT lock: the gate disengages
            # on any improvement, which on massively degenerate LPs lets
            # Devex re-enter the same degenerate face forever (measured:
            # 60k+ pivots without termination on the round-4 adversarial
            # corpus).  After a cumulative stall budget, commit to Bland's
            # rule outright — its finite-termination theorem needs the
            # rule applied CONSISTENTLY.
            if stalled_total >= 4096:
                bland_lock = True
            if bland_lock and no_imp >= 4096:
                # Even committed Bland made zero progress for 4k pivots:
                # the basis is numerically wedged (typically singular
                # from accumulated tiny pivots) — give up fast instead of
                # burning the full cap (certification downstream reports
                # the honest iteration-limit verdict).
                return STATUS_ITERATION_LIMIT
            if bland_lock or no_imp >= 64:
                s = int(np.argmax(eligible))
            else:
                s = int(np.argmax(np.where(eligible, rc * rc / w,
                                           -np.inf)))
            col = T[:-1, s]
            rhs = T[:-1, -1]
            pos = col > tol
            if not pos.any():
                if since and refactor(obj_raw):
                    since = 0
                    continue
                return 3  # unbounded
            # Never step backward: Harris's tolerance-relaxed pivots can
            # leave slightly-NEGATIVE rhs entries; an unclamped ratio then
            # goes negative, the "min ratio" pivot takes a backward step
            # (objective INCREASES), and tiny-pivot amplification turns
            # the tolerance debt into runaway infeasibility (measured on
            # the round-4 corpus: min-form objective 686 -> 1.4e6 over
            # 16k pivots).  Clamping makes such rows exit at theta = 0 —
            # a degenerate pivot — which restores their feasibility.
            rhs_c = np.maximum(rhs, 0.0)
            ratios = np.where(pos, rhs_c / np.where(pos, col, 1.0), np.inf)
            if bland_lock or no_imp >= 64:   # Bland row rule
                # The tie window must admit round-off-level ratios: at a
                # degenerate vertex the tied rows carry rhs ~1e-15 noise,
                # and a window of min*(1+1e-12)+1e-300 (i.e. [0, 1e-300]
                # when min = 0) excluded them — Bland then picked a
                # NON-minimal-ratio row, voiding its termination theorem
                # (measured: 96k Bland pivots without exit on the round-4
                # adversarial corpus; the device kernels already use the
                # eps-scaled window).
                mn = float(ratios.min())
                near = ratios <= mn + 64.0 * np.finfo(np.float64).eps \
                    * (1.0 + abs(mn))
                cand = near & pos
                # Pivot-magnitude floor: a Bland pivot on a ~1e-9 entry
                # multiplies the row by ~1e9 and was observed to drive
                # the basis numerically SINGULAR on the round-4 corpus;
                # among tied rows prefer small indices but only over
                # pivots within 1e-7 of the largest available.
                cmax = float(col[cand].max())
                good = cand & (col >= max(1e-7 * cmax, tol))
                if not good.any():
                    good = cand & (col == cmax)
                key = np.where(good, basis, np.iinfo(np.int64).max)
                r = int(np.argmin(key))
            else:                        # Harris: biggest pivot in window
                delta = tol * (1.0 + np.abs(rhs))
                tmax = np.where(pos, (rhs_c + delta) /
                                np.where(pos, col, 1.0), np.inf).min()
                cand = pos & (ratios <= tmax)
                r = int(np.argmax(np.where(cand, col, -np.inf)))
            # Devex weight update from the normalized pivot row.
            alpha = T[r, :-1] / T[r, s]
            w_s = w[s]
            w = np.maximum(w, (alpha * alpha) * w_s)
            w[basis[r]] = max(w_s, 1.0)
            w[s] = 1.0
            if w.max() > 1e8:
                w[:] = 1.0
            prow = T[r] / T[r, s]
            # Execute the CLAMPED step: selection treated a tolerance-
            # negative rhs row as a theta = 0 tie; the elimination must
            # execute that same theta (prow[-1] = rhs_r/pivot), or every
            # other row takes a backward step and the tolerance debt
            # amplifies through small pivots (observed: objective racing
            # UP by 1e6 on the round-4 corpus).  Equivalent to EXPAND-
            # style bound shifting; the periodic refactorization against
            # the exact data keeps total drift at tolerance level.
            prow[-1] = max(prow[-1], 0.0)
            T = T - T[:, s:s + 1] * prow[None, :]
            T[r] = prow
            T[:, s] = 0.0
            T[r, s] = 1.0
            basis[r] = s
            nit += 1
            since += 1
            obj = -T[-1, -1]
            # NaN-safe stall gate: best starts at +inf, and inf - inf is
            # NaN (which compares False) — track the running minimum
            # unconditionally, like the device kernels do.
            if obj < -1e14:
                # Objective runaway: equilibrated data is O(1e±2), so a
                # legitimate finite optimum cannot reach -1e14 — the loop
                # is riding an unbounded ray whose reduced cost never
                # quite clears the pricing tolerance (the classic
                # practical unboundedness cutoff; CPLEX uses -1e75).
                return 3
            if not np.isfinite(best) or obj < best - tol * (1.0 + abs(best)):
                no_imp = 0
            else:
                no_imp += 1
                stalled_total += 1
            best = min(best, obj)
            if since >= 256:
                refactor(obj_raw)
                since = 0
        return STATUS_ITERATION_LIMIT

    if sf64.need_phase1:
        st = run_phase(sf64.col_mask_p1, raw1)
        if st != STATUS_OPTIMAL:
            return (st if st != 3 else STATUS_ITERATION_LIMIT, basis, nit)
        b_scale = 1.0 + float(np.max(np.abs(T0_rows[:, n_pad])))
        if -T[-1, -1] > 1e-7 * b_scale:
            return (2, basis, nit)       # infeasible
        # Evict basic artificials (zero rows stay put harmlessly).
        art = np.concatenate([sf64.col_mask_p1 & ~sf64.col_mask_p2,
                              np.zeros((1,), bool)])
        for i in range(T.shape[0] - 1):
            if art[basis[i]]:
                row = np.where(sf64.col_mask_p2, np.abs(T[i, :-1]), -np.inf)
                j = int(np.argmax(row))
                if row[j] > tol:
                    prow = T[i] / T[i, j]
                    T = T - T[:, j:j + 1] * prow[None, :]
                    T[i] = prow
                    T[:, j] = 0.0
                    T[i, j] = 1.0
                    basis[i] = j
    # Install + price out phase-2 objective.
    obj2 = raw2 - raw2[basis] @ T[:-1]
    T[-1] = obj2
    st = run_phase(sf64.col_mask_p2, raw2)
    if perturb and st == STATUS_OPTIMAL:
        # Restore the EXACT rhs and refactor the optimal basis; if the
        # true x_B picked up a small infeasibility (the perturbation was
        # the separation between tied vertices), finish with phase-2
        # pivots on the exact data — the basis is optimal for a problem
        # 1e-8 away, so this is a handful of cleanup steps.
        T0_rows[:, n_pad] = b_true
        if refactor(raw2):
            if np.min(T[:-1, -1]) >= -tol * (1.0 + np.abs(b_true).max()):
                return (st, basis, nit)
            st = run_phase(sf64.col_mask_p2, raw2)
    return (st, basis, nit)


def solve_lp_host_exact(lp: LinearProgram,
                        config: SolverConfig = DEFAULT_CONFIG
                        ) -> SimplexResult:
    """Exact host-f64 solve — no device round-trip.

    The escalation target for the batched/sharded paths: when a batch
    instance's f32 verdict fails certification (or claims infeasible /
    unbounded / iteration-limit), re-running the whole f32 device pipeline
    per instance would just repeat the untrusted computation.  This goes
    straight to the same host f64 reference engine + single-LU finalization
    that :func:`solve_lp` escalates through, so a batch verdict and a
    single-LP verdict end up certified by the identical machinery.
    """
    t0 = time.perf_counter()
    if config.presolve and _equilibrate_gate(lp):
        # Same Ruiz wrapper as solve_lp: the exact engine is the LAST
        # escalation stop, and unscaled 1e±4 spreads can defeat even its
        # f64 pricing tolerance (a sweep-path escalation was observed to
        # confirm a fake 'unbounded' on raw data that the equilibrated
        # engines solve to a certified optimum).
        from ..core.presolve import equilibrate

        lp_e, eq = equilibrate(lp)
        if not eq.identity:
            res = solve_lp_host_exact(lp_e, config)
            if res.x is not None:
                res.x = eq.restore_x(res.x)
                c_min = -lp.c if lp.maximize else lp.c
                res.fun = float(c_min @ res.x)
                res.z = (-res.fun if lp.maximize else res.fun) + 0.0
            # The bounded inner path returns duals over the ROW-LOWERED
            # system (structural + bound rows) — only restore sensitivity
            # when shapes line up with the original LP.
            if res.duals is not None and \
                    res.duals.shape[0] == lp.n_cons:
                res.duals = eq.restore_duals(res.duals)
            else:
                res.duals = None
            if res.reduced_costs is not None and \
                    res.reduced_costs.shape[0] == lp.n_vars:
                res.reduced_costs = eq.restore_reduced(res.reduced_costs)
            else:
                res.reduced_costs = None
            res.solve_time = time.perf_counter() - t0
            return res
    if lp.has_finite_bounds:
        res = solve_lp_host_exact(lower_bounds_to_rows(lp), config)
        res.solve_time = time.perf_counter() - t0
        return res
    if lp.has_free:
        lp2, fidx = split_free_variables(lp)
        res = solve_lp_host_exact(lp2, config)
        if res.x is not None:
            res.x = merge_free_solution(res.x, lp.n_vars, fidx)
        if res.reduced_costs is not None:
            res.reduced_costs = res.reduced_costs[: lp.n_vars]
        return res
    if lp.n_cons == 0:
        c_min = -lp.c if lp.maximize else lp.c
        if np.any(c_min < 0):
            return SimplexResult(x=None, fun=None, status=3, success=False,
                                 message=STATUS_MESSAGES[3], nit=0)
        x = np.zeros((lp.n_vars,))
        return SimplexResult(x=x, fun=0.0, status=0, success=True,
                             message=STATUS_MESSAGES[0], nit=0, z=0.0,
                             solve_time=time.perf_counter() - t0)

    sf64 = compile_standard_form(lp, dtype=np.float64)
    status, basis, nit = _host_simplex_f64(sf64)
    if status != STATUS_OPTIMAL:
        return SimplexResult(
            x=None, fun=None, status=status, success=False,
            message=STATUS_MESSAGES.get(status, "Unknown status."),
            nit=nit, basis=basis, solve_time=time.perf_counter() - t0)
    certified, x_full, duals, reduced = _finalize_on_host(
        sf64, lp, basis, sf64=sf64)
    if x_full is None:
        return SimplexResult(
            x=None, fun=None, status=STATUS_ITERATION_LIMIT, success=False,
            message=STATUS_MESSAGES[1], nit=nit, basis=basis,
            solve_time=time.perf_counter() - t0)
    x = np.maximum(x_full[: lp.n_vars], 0.0)
    c_min = -lp.c if lp.maximize else lp.c
    fun = float(c_min @ x)
    return SimplexResult(
        x=x, fun=fun, status=0, success=True,
        message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
        basis=np.asarray(basis), z=(-fun if lp.maximize else fun) + 0.0,
        solve_time=time.perf_counter() - t0, duals=duals,
        reduced_costs=reduced)


def _try_warm_start(sf: StandardForm,
                    warm_basis: np.ndarray) -> Optional[StandardForm]:
    """Rebuild the tableau from a saved basis if it is primal-feasible.

    Returns a StandardForm whose tableau is the refactorized warm tableau
    with ``need_phase1=False``, or None when the basis is stale (wrong
    size, singular, or infeasible for the new data).
    """
    m_pad, n_pad = sf.m_pad, sf.n_pad
    basis = np.asarray(warm_basis, dtype=np.int32).reshape(-1)
    if basis.shape[0] != m_pad or np.any(basis < 0) or \
            np.any(basis >= n_pad):
        return None
    T0 = sf.tableau.astype(np.float64)
    rows = T0[:m_pad]
    B = rows[:, basis]
    try:
        T_rows = np.linalg.solve(B, rows)
    except np.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(T_rows)):
        return None
    x_B = T_rows[:, n_pad]
    if np.any(x_B < -1e-9):            # not primal-feasible for this data
        return None
    art_cols = sf.col_mask_p1 & ~sf.col_mask_p2
    if np.any(art_cols[basis]):        # artificial in basis — cold start
        return None
    T = np.concatenate([T_rows, np.zeros((1, n_pad + 1))], axis=0)
    return dataclasses.replace(
        sf,
        tableau=T.astype(sf.tableau.dtype),
        basis=basis,
        need_phase1=False,
    )


def _equilibrate_gate(lp: LinearProgram) -> bool:
    """True when the LP's coefficient range warrants Ruiz scaling (the
    scaled recursive call lands under the threshold, ending recursion)."""
    if lp.n_cons == 0:
        return False
    from ..core.presolve import coefficient_range

    return coefficient_range(lp.A) > 1e3


def solve_lp(lp: LinearProgram,
             config: SolverConfig = DEFAULT_CONFIG,
             warm_basis: Optional[np.ndarray] = None) -> SimplexResult:
    """Solve one LP with the jitted two-phase dense tableau simplex.

    ``warm_basis`` (column indices from a previous ``SimplexResult.basis``)
    enables warm starting: if the saved basis is primal-feasible for this
    problem, phase 1 is skipped entirely and phase 2 resumes from that
    vertex — the basis-checkpoint/resume capability SURVEY.md §5.4 calls
    out as impossible in the reference.  An infeasible or stale basis falls
    back to a cold start transparently.
    """
    t0 = time.perf_counter()
    dtype = resolve_dtype(config.dtype)

    if config.presolve and _equilibrate_gate(lp):
        # Ruiz equilibration for 1e±4 netlib-style coefficient spreads
        # (core/presolve.equilibrate) — same wrapper as the revised
        # engine; identity below a 1e3 range so well-scaled solves are
        # untouched.
        from ..core.presolve import equilibrate

        lp_e, eq = equilibrate(lp)
        if not eq.identity:
            res = solve_lp(lp_e, config, warm_basis)
            if res.x is not None:
                res.x = eq.restore_x(res.x)
                c_min = -lp.c if lp.maximize else lp.c
                res.fun = float(c_min @ res.x)
                res.z = (-res.fun if lp.maximize else res.fun) + 0.0
            res.duals = eq.restore_duals(res.duals)
            res.reduced_costs = eq.restore_reduced(res.reduced_costs)
            res.solve_time = time.perf_counter() - t0
            return res

    if lp.has_finite_bounds:
        # The dense tableau kernel has no bounded ratio test — lower finite
        # bounds onto rows (the documented fallback; the revised engine
        # handles bounds natively, VERDICT r2 item 1).  Duals of the bound
        # rows fold back into native reduced costs: rc = c - y'A over the
        # STRUCTURAL rows only.
        lp_rows = lower_bounds_to_rows(lp)
        res = solve_lp(lp_rows, config)
        m = lp.n_cons
        if res.duals is not None:
            duals = res.duals[:m]
            user_sign = -1.0 if lp.maximize else 1.0
            row_sign = np.where(lp.b < 0, -1.0, 1.0)
            c_min = -lp.c if lp.maximize else lp.c
            y_min = user_sign * row_sign * duals
            res.reduced_costs = user_sign * (c_min - y_min @ lp.A)
            res.duals = duals
        res.solve_time = time.perf_counter() - t0
        return res

    if lp.has_free:
        # Netlib-class LPs have unrestricted variables (MPS FR/MI/negative
        # LO); lower them to the nonnegative IR via x = x+ - x- and merge
        # back.  Duals are unchanged; reduced costs of the first n columns
        # are the user-space +direction marginals.
        lp2, fidx = split_free_variables(lp)
        res = solve_lp(lp2, config, warm_basis)
        if res.x is not None:
            res.x = merge_free_solution(res.x, lp.n_vars, fidx)
        if res.reduced_costs is not None:
            res.reduced_costs = res.reduced_costs[: lp.n_vars]
        return res

    if config.presolve and warm_basis is None:
        from ..core.presolve import presolve as _presolve

        pr = _presolve(lp)
        if pr.decided:
            return SimplexResult(
                x=None, fun=None, status=pr.status, success=False,
                message=STATUS_MESSAGES.get(pr.status, "Unknown status."),
                nit=0, solve_time=time.perf_counter() - t0,
            )
        if pr.reduced:
            inner_cfg = dataclasses.replace(config, presolve=False)
            inner = solve_lp(pr.lp, inner_cfg)
            if not inner.success:
                return inner
            x = pr.postsolve_x(inner.x)
            c_min = -lp.c if lp.maximize else lp.c
            fun = float(c_min @ x)
            duals_ps = pr.postsolve_duals(inner.duals)
            return SimplexResult(
                x=x, fun=fun, status=0, success=True,
                message=inner.message, nit=inner.nit, basis=inner.basis,
                z=(-fun if lp.maximize else fun) + 0.0,
                solve_time=time.perf_counter() - t0,
                duals=duals_ps,
                reduced_costs=pr.postsolve_reduced_costs(
                    inner.reduced_costs, lp, duals=duals_ps),
            )

    if lp.n_cons == 0:
        # No constraints: optimum is x=0 unless some cost direction improves,
        # in which case the LP is unbounded (x >= 0 only). Mirrors the
        # reference's unbounded/no-constraint regression tests.
        c_min = -lp.c if lp.maximize else lp.c
        if np.any(c_min < 0):
            return SimplexResult(x=None, fun=None, status=3, success=False,
                                 message=STATUS_MESSAGES[3], nit=0)
        x = np.zeros((lp.n_vars,))
        return SimplexResult(x=x, fun=0.0, status=0, success=True,
                             message=STATUS_MESSAGES[0], nit=0,
                             z=0.0, solve_time=time.perf_counter() - t0)

    row_pad, col_pad = _pad_plan(lp)
    # Compile ONCE in f64 and cast: compile_standard_form assembles in f64
    # internally anyway, and the f64 form is reused by host finalization
    # and escalation (saves a full rebuild per solve).
    sf64 = compile_standard_form(lp, row_pad=row_pad, col_pad=col_pad,
                                 dtype=np.float64)
    sf = dataclasses.replace(
        sf64,
        tableau=sf64.tableau.astype(dtype),
        obj_row_p1=sf64.obj_row_p1.astype(dtype),
        obj_row_p2=sf64.obj_row_p2.astype(dtype),
    )

    if warm_basis is not None:
        warm = _try_warm_start(sf, warm_basis)
        if warm is not None:
            sf = warm

    max_iters = min(config.max_iters, 50 * (sf.m_pad + sf.n_pad))
    # Bland's rule must engage well before the iteration cap, or cycling can
    # burn the whole budget under Dantzig pricing (anti-cycling guarantee).
    bland_after = min(config.bland_after, max_iters // 2)
    refactor_every = config.refactor_every or max(64, sf.m_pad // 8)
    tol = float(config.tol if dtype == np.float64 else max(config.tol, 1e-6))

    # Wall-clock budget (the reference's scipy time_limit=10 role): the
    # device loop runs in fixed-size chunks — ONE compiled program reused —
    # with the clock checked between chunks; a still-running solve resumes
    # from its current basis via the warm-start path.  Mid-phase-1 states
    # (artificials basic) cannot warm-resume, so the first chunk carries
    # the full iteration budget and later chunks only ever continue
    # phase 2.
    chunk = int(max_iters)
    sf_run = sf
    nit = 0
    while True:
        T, basis, status, iters = tableau_ops.solve_tableau(
            jnp.asarray(sf_run.tableau),
            jnp.asarray(sf_run.basis),
            jnp.asarray(sf_run.col_mask_p1),
            jnp.asarray(sf_run.col_mask_p2),
            jnp.asarray(sf_run.obj_row_p1),
            jnp.asarray(sf_run.obj_row_p2),
            need_phase1=sf_run.need_phase1,
            tol=tol,
            max_iters=chunk,
            bland_after=int(bland_after),
            refactor_every=int(refactor_every),
            devex=config.pivot_rule == "devex",
        )
        status = int(status)
        basis_np = np.asarray(basis)
        nit += int(iters)
        if status == 1 and int(iters) < chunk:
            break   # early numeric-stall exit — escalated to f64 below
        if status != 1 or nit >= config.max_iters:
            break
        if config.time_limit is not None and \
                time.perf_counter() - t0 > config.time_limit:
            break
        warm = _try_warm_start(sf, basis_np)
        if warm is None:
            break                      # cannot resume — report the cap
        sf_run = warm

    # f64 verdict certification + escalation.  The f32 device loop is the
    # fast path, but exactly-dependent columns (e.g. the ± pairs of a
    # free-variable split) can drift it onto a singular basis whose
    # refactorization certifies a false optimal/unbounded/infeasible.  A
    # claimed optimum is KKT-checked on host in f64; failed checks and all
    # terminal infeasible/unbounded verdicts are re-solved exactly by the
    # host f64 reference engine (same compiled standard form).
    escalated = False
    certified, x_full, duals, reduced = False, None, None, None
    if status == STATUS_OPTIMAL:
        certified, x_full, duals, reduced = _finalize_on_host(
            sf, lp, basis_np, sf64=sf64)
        escalated = not certified
    elif status in (2, 3):
        escalated = True
    elif status == 1 and nit < config.max_iters:
        # The loop exited on the numeric-stall cutoff, not the user's
        # iteration cap: f32 drift is faking eligible pivots.
        escalated = True
    if escalated:
        status, basis_np, nit2 = _host_simplex_f64(sf64)
        nit += nit2
        if status == STATUS_OPTIMAL:
            # Same padding as sf, so the unpadded slices _finalize reads
            # line up — saves a third f64 standard-form rebuild.
            certified, x_full, duals, reduced = _finalize_on_host(
                sf, lp, basis_np, sf64=sf64)
            if x_full is None:
                return SimplexResult(
                    x=None, fun=None, status=STATUS_ITERATION_LIMIT,
                    success=False, message=STATUS_MESSAGES[1], nit=nit,
                    basis=basis_np, solve_time=time.perf_counter() - t0)

    if status != STATUS_OPTIMAL:
        return SimplexResult(
            x=None, fun=None, status=status, success=False,
            message=STATUS_MESSAGES.get(status, "Unknown status."),
            nit=nit, basis=basis_np,
            solve_time=time.perf_counter() - t0,
        )

    c_min = -lp.c if lp.maximize else lp.c
    if escalated or (config.refine and certified and x_full is not None):
        # Exact f64 vertex for the final basis (the refine step — free now,
        # certification already solved the basis system).
        x = x_full[: lp.n_vars]
        fun = float(c_min @ x)
    else:
        x_dev, z_min_dev = tableau_ops.extract_solution(T, basis, sf.n_vars)
        x = np.asarray(x_dev, dtype=np.float64)
        fun = float(np.asarray(z_min_dev))

    z_user = (-fun if lp.maximize else fun) + 0.0  # +0.0 normalizes -0.0
    return SimplexResult(
        x=np.maximum(x, 0.0),  # clamp -0.0 / tiny negatives from refinement
        fun=fun, status=0, success=True,
        message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
        basis=basis_np, z=z_user,
        solve_time=time.perf_counter() - t0,
        duals=duals, reduced_costs=reduced,
    )


def reoptimize(lp: LinearProgram, basis: np.ndarray,
               config: SolverConfig = DEFAULT_CONFIG,
               at_upper: Optional[np.ndarray] = None) -> SimplexResult:
    """Dual-simplex reoptimization from a previously-optimal basis.

    The warm-start counterpart :func:`solve_lp` ``warm_basis=...`` covers
    (cost changes keep the basis primal-feasible); this covers RHS
    changes: the old basis stays DUAL-feasible (reduced costs are
    untouched by ``b``) but may go primal-infeasible, exactly the state
    the dual simplex iterates away.  This is the capability HiGHS's
    ``highs-ds`` brings to the reference, natively.

    BOUNDED LPs reoptimize natively too (VERDICT r4 #4): pass the parent
    solve's ``(basis, at_upper)`` pair (``SimplexResult.basis`` /
    ``.at_upper`` from the revised engine or a previous reoptimize) and
    the bounded dual kernel (``ops.tableau.solve_tableau_dual_bounded``)
    iterates the two-sided primal infeasibilities away instead of
    cold-starting.

    Falls back to a cold :func:`solve_lp` when the basis is stale (wrong
    shape, singular, artificial columns basic, or not dual-feasible for
    the new costs).
    """
    t0 = time.perf_counter()
    dtype = resolve_dtype(config.dtype)
    if lp.has_finite_bounds:
        if at_upper is None:
            # No at-upper state from the parent: a bounded vertex is not
            # identified by the basis alone — cold-start.
            return solve_lp(lp, config)
        return _reoptimize_bounded(lp, basis, at_upper, config, t0)
    if lp.has_free:
        lp2, fidx = split_free_variables(lp)
        res = reoptimize(lp2, basis, config)
        if res.x is not None:
            res.x = merge_free_solution(res.x, lp.n_vars, fidx)
        if res.reduced_costs is not None:
            res.reduced_costs = res.reduced_costs[: lp.n_vars]
        return res
    if lp.n_cons == 0 or basis is None:
        return solve_lp(lp, config)

    row_pad, col_pad = _pad_plan(lp)
    sf = compile_standard_form(lp, row_pad=row_pad, col_pad=col_pad,
                               dtype=dtype)
    m_pad, n_pad = sf.m_pad, sf.n_pad
    basis = np.asarray(basis, dtype=np.int32).reshape(-1)
    if basis.shape[0] != m_pad or np.any(basis < 0) or np.any(basis >= n_pad):
        return solve_lp(lp, config)
    art_cols = sf.col_mask_p1 & ~sf.col_mask_p2
    if np.any(art_cols[basis]):
        return solve_lp(lp, config)

    tol = float(config.tol if dtype == np.float64 else max(config.tol, 1e-6))
    max_iters = min(config.max_iters, 50 * (m_pad + n_pad))
    if m_pad > 4096:
        # Large-m path: the O(m^3) + O(m^2 n) warm refactorization runs
        # ON DEVICE (refactor_tableau — the same LU the dual loop's
        # periodic drift control uses).  Only the objective row (n_pad
        # floats) returns to host for the dual-feasibility gate; the f64
        # certification below guards the f32 factorization exactly like
        # everywhere else.
        T_dev = tableau_ops.refactor_tableau(
            jnp.asarray(sf.tableau[:m_pad], dtype), jnp.asarray(basis),
            jnp.asarray(sf.obj_row_p2, dtype))
        obj = np.asarray(T_dev[-1], np.float64)
        if not np.all(np.isfinite(obj)):
            return solve_lp(lp, config)
        if not np.all(obj[:n_pad][sf.col_mask_p2] >= -10 * tol):
            return solve_lp(lp, config)
        T_in = T_dev
    else:
        # Refactor for the new data under the old basis (f64 host).
        T0 = sf.tableau.astype(np.float64)
        rows = T0[:m_pad]
        try:
            T_rows = np.linalg.solve(rows[:, basis], rows)
        except np.linalg.LinAlgError:
            return solve_lp(lp, config)
        if not np.all(np.isfinite(T_rows)):
            return solve_lp(lp, config)
        obj = sf.obj_row_p2.astype(np.float64).copy()
        obj -= obj[basis] @ T_rows
        rc_ok = np.all(obj[:n_pad][sf.col_mask_p2] >= -10 * tol)
        if not rc_ok:                   # costs changed too: not dual-feasible
            return solve_lp(lp, config)
        T_in = jnp.asarray(np.concatenate([T_rows, obj[None, :]],
                                          axis=0).astype(dtype))

    T_d, basis_d, status, iters = tableau_ops.solve_tableau_dual(
        T_in, jnp.asarray(basis), jnp.asarray(sf.col_mask_p2),
        tol=tol, max_iters=int(max_iters),
        bland_after=int(min(config.bland_after, max_iters // 2)),
        devex=config.pivot_rule == "devex",
    )
    status = int(status)
    nit = int(iters)
    basis_np = np.asarray(basis_d)
    # Same f64 safety net as the primal path: a dual-loop verdict that
    # fails certification (or any non-optimal verdict) goes to the cold
    # primal solve, which certifies/escalates itself.
    if status != STATUS_OPTIMAL or \
            not _certify_optimal_basis(sf, lp, basis_np):
        return solve_lp(lp, config)

    x_dev, z_min_dev = tableau_ops.extract_solution(T_d, basis_d, sf.n_vars)
    x = np.asarray(x_dev, np.float64)
    c_min = -lp.c if lp.maximize else lp.c
    fun = float(np.asarray(z_min_dev))
    if config.refine:
        x_full = _refine_on_host(sf, lp, basis_np)
        if x_full is not None and np.all(x_full[: sf.n_cols] >= -1e-7):
            x = x_full[: lp.n_vars]
            fun = float(c_min @ x)
    duals, reduced = _sensitivity_on_host(sf, lp, basis_np)
    z_user = (-fun if lp.maximize else fun) + 0.0
    return SimplexResult(
        x=np.maximum(x, 0.0), fun=fun, status=0, success=True,
        message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
        basis=basis_np, z=z_user, solve_time=time.perf_counter() - t0,
        duals=duals, reduced_costs=reduced,
    )


def _reoptimize_bounded(lp: LinearProgram, basis: np.ndarray,
                        at_upper: np.ndarray, config: SolverConfig,
                        t0: float) -> SimplexResult:
    """Warm bounded reoptimization via the bounded dual kernel.

    The parent's ``(basis, at_upper)`` identifies the old bounded vertex
    in the NORMALIZED padded space (``normalize_bounds`` + bounded
    ``compile_standard_form`` — the same lowering the revised engine
    applies, so its results feed straight in).  Gates: basis shape/
    validity, no artificial basic, and two-sided f64 dual feasibility
    (at-lower rc >= -tol, at-upper rc <= +tol); any failure cold-starts.
    The dual verdict is f64-KKT-certified (``_finalize_on_host_bounded``)
    before being trusted — same safety net as every other engine.
    """
    from ..core.problem import normalize_bounds

    dtype = resolve_dtype(config.dtype)
    lp_t, tr = normalize_bounds(lp)
    if lp_t.has_free or lp_t.n_cons == 0 or basis is None:
        return solve_lp(lp, config)
    basis = np.asarray(basis, dtype=np.int32).reshape(-1)
    # The parent may come from the revised engine (default pads) or a
    # previous bounded reoptimize (_pad_plan pads) — accept either layout
    # (column indices are pad-independent; only m_pad must line up).
    sf = compile_standard_form(lp_t, dtype=np.float64, bounded=True)
    if sf.m_pad != basis.shape[0]:
        row_pad, col_pad = _pad_plan(lp_t)
        sf = compile_standard_form(lp_t, row_pad=row_pad, col_pad=col_pad,
                                   dtype=np.float64, bounded=True)
    m_pad, n_pad = sf.m_pad, sf.n_pad
    if basis.shape[0] != m_pad or np.any(basis < 0) \
            or np.any(basis >= n_pad):
        return solve_lp(lp, config)
    art_cols = sf.col_mask_p1 & ~sf.col_mask_p2
    if np.any(art_cols[basis]):
        return solve_lp(lp, config)
    ub_ext = (sf.ub_ext if sf.ub_ext is not None
              else np.full((n_pad,), np.inf))
    atu = np.zeros((n_pad,), bool)
    au = np.asarray(at_upper, bool).reshape(-1)[:n_pad]
    atu[: au.shape[0]] = au
    atu &= np.isfinite(ub_ext[:n_pad])
    atu[basis] = False

    tol = float(config.tol if dtype == np.float64
                else max(config.tol, 1e-6))
    max_iters = min(config.max_iters, 50 * (m_pad + n_pad))

    # f64 host refactor for the dual-feasibility gate (two-sided signs).
    rows = sf.tableau[:m_pad].astype(np.float64)
    try:
        T_rows = np.linalg.solve(rows[:, basis], rows)
    except np.linalg.LinAlgError:
        return solve_lp(lp, config)
    if not np.all(np.isfinite(T_rows)):
        return solve_lp(lp, config)
    obj = sf.obj_row_p2.astype(np.float64).copy()
    obj -= obj[basis] @ T_rows
    nonbasic = sf.col_mask_p2.copy()
    nonbasic[basis] = False
    lo_side = nonbasic & ~atu
    up_side = nonbasic & atu
    if not (np.all(obj[:n_pad][lo_side] >= -10 * tol)
            and np.all(obj[:n_pad][up_side] <= 10 * tol)):
        return solve_lp(lp, config)

    # Anchor tableau: RAW rows + raw phase-2 objective; the kernel builds
    # the effective (at-upper-adjusted) start itself.
    T_anchor = np.concatenate(
        [sf.tableau[:m_pad], sf.obj_row_p2[None, :]], axis=0).astype(dtype)
    T_d, basis_d, atu_d, status, iters = \
        tableau_ops.solve_tableau_dual_bounded(
            jnp.asarray(T_anchor), jnp.asarray(basis),
            jnp.asarray(sf.col_mask_p2), jnp.asarray(ub_ext),
            jnp.asarray(atu),
            tol=tol, max_iters=int(max_iters),
            bland_after=int(min(config.bland_after, max_iters // 2)),
            devex=config.pivot_rule == "devex",
        )
    status = int(status)
    nit = int(iters)
    basis_np = np.asarray(basis_d)
    atu_np = np.asarray(atu_d)
    if status != STATUS_OPTIMAL:
        return solve_lp(lp, config)
    certified, x_full, duals, reduced = _finalize_on_host_bounded(
        sf, lp_t, basis_np, atu_np, sf64=sf)
    if not certified or x_full is None:
        return solve_lp(lp, config)

    x_user = tr.restore_x(x_full[: lp_t.n_vars])
    c_min = -lp.c if lp.maximize else lp.c
    fun = float(c_min @ x_user)
    z_user = (-fun if lp.maximize else fun) + 0.0
    return SimplexResult(
        x=x_user, fun=fun, status=0, success=True,
        message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
        basis=basis_np, z=z_user, at_upper=atu_np,
        solve_time=time.perf_counter() - t0,
        duals=duals, reduced_costs=tr.restore_reduced(reduced),
    )


class DenseSimplexSolver:
    """Object-style facade over :func:`solve_lp` / :func:`reoptimize`."""

    def __init__(self, config: SolverConfig = DEFAULT_CONFIG):
        self.config = config

    def solve(self, lp: LinearProgram) -> SimplexResult:
        return solve_lp(lp, self.config)

    def reoptimize(self, lp: LinearProgram, basis: np.ndarray,
                   at_upper: Optional[np.ndarray] = None) -> SimplexResult:
        return reoptimize(lp, basis, self.config, at_upper=at_upper)
