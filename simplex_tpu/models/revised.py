"""Revised simplex with explicit basis-inverse maintenance (single chip).

BASELINE config 4 ("netlib-style LPs via revised simplex with
basis-factorization updates").  Where the dense tableau engine rewrites the
whole (m x n) tableau every pivot (memory-bound), the revised method keeps
only the m x m basis inverse and the original column data:

  pricing:    pi = c_B  B_inv        (m^2 matvec)
              rc = c - pi A          (m*n matvec — the only O(mn) op)
  FTRAN:      d  = B_inv a_s         (m^2)
  update:     eta rank-1 on B_inv    (m^2), periodic exact refactorization
              via jnp.linalg.solve   (m^3, amortized)

so for n >> m (netlib-shaped: many columns, fewer rows) per-pivot cost drops
from O(mn) memory traffic to O(m^2) + one matvec.  Phase handling matches
``ops/tableau.py``; basic artificials are driven out in phase 2 by the
ratio-test preference used in the sharded kernel (``parallel/sharded.py``).

Why explicit inverse + periodic dense refactor, NOT an LU/eta file: CPU
production codes keep a sparse LU of B and append eta vectors because their
FTRAN/BTRAN are cache-friendly sparse triangular solves.  On an accelerator
a triangular solve is sequential along the diagonal, while the
explicit-inverse update is a rank-1 dense operation and every
FTRAN/BTRAN/PRICE is a dense matvec that streams at memory bandwidth.  The
LU lives inside the periodic ``jnp.linalg.solve`` refactorization (O(m^3)
amortized over ``refactor_every`` pivots), which also bounds the
inverse-drift the eta-style rank-1 updates accumulate.  Sparsity in A is
not exploited: netlib-scale dense matvecs are cheap on the device
(SURVEY.md §7 "hard parts").  Every contraction states
``precision=HIGHEST``: a float32 product may run in TF32 on the GPU.

Numerics: float32 on device with f64 host verdict certification +
refinement of the final basis (same policy as models/dense), plus a
one-shot loose-tol retry on numeric stalls.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import SolverConfig, DEFAULT_CONFIG, resolve_dtype
from ..core.problem import (
    LinearProgram,
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_MESSAGES,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    normalize_bounds,
    split_free_variables,
)
from .dense import (
    SimplexResult,
    _finalize_on_host,
    _finalize_on_host_bounded,
    _host_simplex_f64,
)

RUNNING = -1
_INT_MAX = jnp.iinfo(jnp.int32).max
_ART_BONUS = 1 << 20
_HI = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def _refactor(A_std, b, basis, at_upper=None, ub=None):
    """Exact B_inv and x_B from the original data (batched dense solves).

    With bounds, nonbasic-at-upper columns contribute their bound value:
    ``x_B = B_inv (b - A_U u_U)`` where U is the at-upper set.
    """
    B = jnp.take(A_std, basis, axis=1)
    eye = jnp.eye(B.shape[0], dtype=A_std.dtype)
    B_inv = jnp.linalg.solve(B, eye)
    if at_upper is None:
        x_B = _mm(B_inv, b)
    else:
        ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)
        u_vec = jnp.where(at_upper, ub_safe, 0.0)
        x_B = _mm(B_inv, b - _mm(A_std, u_vec))
    return B_inv, x_B


@functools.partial(
    jax.jit,
    static_argnames=("tol", "max_iters", "bland_after", "refactor_every",
                     "devex"),
)
def _run_phase_revised(A_std, b, cost, col_mask, art_mask_ext,
                       B_inv, x_B, basis, at_upper, ub, iters0, in_phase2,
                       tol: float = 1e-6, max_iters: int = 8192,
                       bland_after: int = 2048, refactor_every: int = 64,
                       devex: bool = False):
    """One phase of BOUNDED-VARIABLE revised simplex.  Returns
    (B_inv, x_B, basis, at_upper, iters, status, objective).

    The general ``0 <= x <= u`` ratio test (u may be +inf — then this
    reduces exactly to the classic method, which is how unbounded LPs run
    through the same compiled kernel):

      * a nonbasic variable is eligible entering from its LOWER bound when
        rc < -tol, or from its UPPER bound when rc > +tol (it then
        DEcreases);
      * the step t is limited by (a) a basic variable hitting 0,
        (b) a basic variable hitting its own upper bound, or (c) the
        entering variable reaching its opposite bound — case (c) is a
        BOUND FLIP: no basis change, no B_inv update, O(m) work.

    This is the capability HiGHS provides natively behind the reference's
    ``solver_controller.py:78-85`` (its call site only uses ``(0, None)``,
    but netlib MPS BOUNDS sections need the general form — BASELINE.md:34).

    ``devex``: Forrest-Goldfarb reference-weight pricing.  The weight
    update needs the transformed pivot row ``alpha = B_inv[r] @ A_std`` —
    one extra O(mn) matvec per pivot (BTRAN+PRICE in production
    terms), typically repaid severalfold in saved iterations.
    """

    # f32 numeric-stall cutoff (see ops/tableau.py): exit after a full
    # Bland budget of consecutive non-improving pivots; the driver then
    # escalates to the host f64 engine instead of burning the whole cap.
    stall_limit = bland_after + 1024
    ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)

    def cond(state):
        iters, status, no_imp = state[4], state[5], state[9]
        return ((status == RUNNING) & (iters < max_iters)
                & (no_imp < stall_limit))

    def body(state):
        (B_inv, x_B, basis, at_upper, iters, status, since, w, best_obj,
         no_imp) = state

        do_ref = since >= refactor_every
        B_inv, x_B = lax.cond(
            do_ref, lambda _: _refactor(A_std, b, basis, at_upper, ub),
            lambda _: (B_inv, x_B), None)

        # Pricing: dual-infeasibility magnitude per nonbasic column.
        c_B = cost[basis]
        pi = _mm(c_B, B_inv)                               # (m,)
        rc = cost[:-1] - _mm(pi, A_std)                    # (n,)
        elig_lo = col_mask & ~at_upper & (rc < -tol)
        elig_up = col_mask & at_upper & (rc > tol)
        eligible = elig_lo | elig_up
        viol = jnp.where(eligible, jnp.abs(rc), -jnp.inf)
        # Stall-gated Bland: engage only after ``bland_after`` consecutive
        # non-improving pivots, revert when the objective moves (cycles are
        # improvement-free, so termination is preserved; cf. ops/tableau.py).
        use_bland = no_imp >= bland_after
        if devex:
            score = jnp.where(eligible, (viol * viol) / w, -jnp.inf)
            s_price = jnp.argmax(score)
        else:
            s_price = jnp.argmax(viol)
        s = jnp.where(use_bland, jnp.argmax(eligible), s_price)
        optimal = ~jnp.any(eligible)

        # FTRAN.  sigma = +1 entering from lower (x_s increases), -1 from
        # upper (x_s decreases); basics move as x_B(t) = x_B - sigma t d.
        d = _mm(B_inv, A_std[:, s])                        # (m,)
        sigma = jnp.where(at_upper[s], -1.0, 1.0).astype(x_B.dtype)
        dd = sigma * d
        is_art_row = art_mask_ext[basis]
        ub_B = ub[basis]

        pos = dd > tol
        neg = (dd < -tol) & jnp.isfinite(ub_B)
        art_exit = in_phase2 & is_art_row & (jnp.abs(dd) > tol)
        # Backward-step clamps on BOTH limits (see ops/tableau).
        xB_c = jnp.maximum(x_B, 0.0)
        span_c = jnp.maximum(ub_B - x_B, 0.0)
        t_lo = jnp.where(pos, xB_c / jnp.where(pos, dd, 1.0), jnp.inf)
        t_lo = jnp.where(art_exit, 0.0, t_lo)
        t_hi = jnp.where(neg, span_c / jnp.where(neg, -dd, 1.0),
                         jnp.inf)
        t_row = jnp.minimum(t_lo, t_hi)
        cand = pos | neg | art_exit
        min_row = jnp.min(t_row)
        t_self = ub[s]                                     # entering's span
        theta = jnp.minimum(min_row, t_self)
        unbounded = (~optimal) & jnp.isinf(theta)
        # Bound flip: the entering variable reaches its opposite bound
        # before any basic variable blocks — basis unchanged.
        flip = (~optimal) & (~unbounded) & (t_self <= min_row)

        eps = jnp.finfo(x_B.dtype).eps
        near = cand & (t_row <= min_row
                       + 64.0 * eps * (1.0 + jnp.abs(min_row)))
        key = jnp.where(near,
                        basis - jnp.where(is_art_row, _ART_BONUS, 0),
                        _INT_MAX)
        r = jnp.argmin(key)
        leave_up = t_hi[r] < t_lo[r]       # leaving var exits AT its upper

        stop = optimal | unbounded
        new_status = jnp.where(
            stop, jnp.where(optimal, STATUS_OPTIMAL, STATUS_UNBOUNDED),
            RUNNING).astype(jnp.int32)

        def do_flip(args):
            B_inv, x_B, basis, at_upper, w = args
            # ub may be +inf on basics with no upper bound — clip against
            # the RAW ub (inf upper = no-op), never the zeroed ub_safe.
            x_B2 = jnp.clip(x_B - dd * t_self, 0.0, ub[basis])
            at_upper2 = at_upper.at[s].set(~at_upper[s])
            return B_inv, x_B2, basis, at_upper2, w

        def do_pivot(args):
            B_inv, x_B, basis, at_upper, w = args
            dr = d[r]
            if devex:
                alpha = _mm(B_inv[r], A_std) / dr          # pivot row
                w_s = w[s]
                w_new = jnp.maximum(w, (alpha * alpha) * w_s)
                w_new = w_new.at[basis[r]].set(jnp.maximum(w_s, 1.0))
                w_new = w_new.at[s].set(1.0)
                w = jnp.where(jnp.max(w_new) > 1e8,
                              jnp.ones_like(w_new), w_new)
            er = B_inv[r] / dr
            B_inv2 = B_inv - d[:, None] * er[None, :]
            B_inv2 = B_inv2.at[r].set(er)
            x_B2 = x_B - dd * theta
            # Entering variable's new value: from lower it sits at theta;
            # from upper it sits at u_s - theta.
            x_enter = jnp.where(at_upper[s], ub_safe[s] - theta, theta)
            x_B2 = x_B2.at[r].set(x_enter)
            j_out = basis[r]
            basis2 = basis.at[r].set(s.astype(basis.dtype))
            at_upper2 = at_upper.at[j_out].set(leave_up)
            at_upper2 = at_upper2.at[s].set(False)
            x_B2 = jnp.clip(x_B2, 0.0, ub[basis2])
            return B_inv2, x_B2, basis2, at_upper2, w

        branch = jnp.where(stop, 0, jnp.where(flip, 1, 2))
        B_inv, x_B, basis, at_upper, w = lax.switch(
            branch, [lambda a: a, do_flip, do_pivot],
            (B_inv, x_B, basis, at_upper, w))

        # Objective incl. at-upper nonbasic contributions (for the
        # stall gate only — verdicts come from the f64 finalize).
        obj = _mm(cost[basis], x_B) + jnp.sum(
            jnp.where(at_upper, cost[:-1] * ub_safe, 0.0))
        improved = obj < best_obj - tol * (1.0 + jnp.abs(best_obj))
        best_obj = jnp.minimum(best_obj, obj)
        no_imp = jnp.where(improved, 0,
                           no_imp + (~stop).astype(no_imp.dtype))
        iters = iters + (~stop).astype(iters.dtype)
        since = jnp.where(do_ref, jnp.int32(1), since + 1)
        return (B_inv, x_B, basis, at_upper, iters, new_status, since, w,
                best_obj, no_imp)

    w0 = jnp.ones((A_std.shape[1],), A_std.dtype)
    state = (B_inv, x_B, basis, at_upper, iters0, jnp.int32(RUNNING),
             jnp.int32(1), w0, jnp.asarray(jnp.inf, x_B.dtype),
             jnp.int32(0))
    (B_inv, x_B, basis, at_upper, iters, status, _, _, _, _) = \
        lax.while_loop(cond, body, state)
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)
    obj = _mm(cost[basis], x_B) + jnp.sum(
        jnp.where(at_upper, cost[:-1] * ub_safe, 0.0))
    return B_inv, x_B, basis, at_upper, iters, status, obj


class RevisedSimplexSolver:
    """Single-LP revised simplex (basis-inverse maintenance)."""

    def __init__(self, config: SolverConfig = DEFAULT_CONFIG):
        self.config = config

    def solve(self, lp: LinearProgram,
              warm_basis: Optional[np.ndarray] = None,
              _tol_scale: float = 1.0,
              warm_at_upper: Optional[np.ndarray] = None,
              _equilibrated: bool = False) -> SimplexResult:
        """Solve one LP.  ``warm_basis`` (column indices from a previous
        ``SimplexResult.basis``) skips phase 1 entirely when the saved
        basis is still primal-feasible for this data — the same
        checkpoint/resume capability the dense engine has (stale or
        infeasible bases fall back to a cold start transparently).
        ``warm_at_upper`` (``SimplexResult.at_upper`` from a previous
        bounded solve) carries the nonbasic-at-upper set, so warm starts
        work on BOUNDED LPs too (VERDICT r3 item 8); without it a bounded
        warm basis is validated with every nonbasic at its lower bound.

        General variable bounds are handled NATIVELY: finite lower bounds
        are shifted out and (-inf, u] variables flipped by
        ``normalize_bounds``; the remaining finite UPPER bounds go through
        the bounded ratio test in :func:`_run_phase_revised` at zero row
        cost — no dense bound rows (VERDICT r2 item 1)."""
        t0 = time.perf_counter()
        if self.config.presolve and not _equilibrated and lp.n_cons > 0:
            # Ruiz equilibration for netlib-style 1e±4 coefficient
            # spreads (core/presolve.equilibrate; identity under 1e3
            # range).  Unscaled, the round-4 adversarial corpus ran
            # 100k+ pivots without converging; scaled it solves in ~2k.
            from ..core.presolve import equilibrate

            lp_e, eq = equilibrate(lp)
            if not eq.identity:
                res = self.solve(lp_e, warm_basis, _tol_scale,
                                 warm_at_upper, _equilibrated=True)
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
            lp_n, tr = normalize_bounds(lp)
            if not tr.identity:
                # Warm data lives in the NORMALIZED space (it came from a
                # previous solve of the same LP, whose inner call produced
                # it there) — forward it through the normalization.
                res = self.solve(lp_n, warm_basis, _tol_scale,
                                 warm_at_upper,
                                 _equilibrated=_equilibrated)
                if res.x is not None:
                    res.x = tr.restore_x(res.x)
                    c_min = -lp.c if lp.maximize else lp.c
                    res.fun = float(c_min @ res.x)
                    res.z = (-res.fun if lp.maximize else res.fun) + 0.0
                if res.reduced_costs is not None:
                    res.reduced_costs = tr.restore_reduced(
                        res.reduced_costs)
                res.solve_time = time.perf_counter() - t0
                return res
        if lp.has_free:
            lp2, fidx = split_free_variables(lp)
            res = self.solve(lp2, warm_basis, _tol_scale, warm_at_upper,
                             _equilibrated=_equilibrated)
            if res.x is not None:
                res.x = merge_free_solution(res.x, lp.n_vars, fidx)
            if res.reduced_costs is not None:
                res.reduced_costs = res.reduced_costs[: lp.n_vars]
            return res
        if lp.n_cons == 0:
            from .dense import solve_lp
            return solve_lp(lp, self.config)

        dtype = resolve_dtype(self.config.dtype)
        sf = compile_standard_form(lp, dtype=np.float64, bounded=True)
        m_pad, n_pad = sf.m_pad, sf.n_pad
        ub_np = (sf.ub_ext if sf.ub_ext is not None
                 else np.full((n_pad,), np.inf))

        A_std = jnp.asarray(sf.tableau[:m_pad, :n_pad], dtype)
        b = jnp.asarray(sf.tableau[:m_pad, n_pad], dtype)
        basis = jnp.asarray(sf.basis)
        at_up = jnp.zeros((n_pad,), bool)
        ub_dev = jnp.asarray(ub_np, dtype)
        col_p1 = jnp.asarray(sf.col_mask_p1)
        col_p2 = jnp.asarray(sf.col_mask_p2)
        art_ext = jnp.asarray(
            np.concatenate([sf.col_mask_p1 & ~sf.col_mask_p2,
                            np.ones((m_pad,), bool)])[:n_pad])
        cost1 = jnp.asarray(sf.obj_row_p1[:n_pad + 1], dtype)
        cost2 = jnp.asarray(sf.obj_row_p2[:n_pad + 1], dtype)

        tol = max(self.config.tol, 1e-6 if dtype == np.float32 else 1e-9)
        tol *= _tol_scale
        max_iters = min(self.config.max_iters, 50 * (m_pad + n_pad))
        bland_after = min(self.config.bland_after, max_iters // 2)

        need_phase1 = sf.need_phase1
        if warm_basis is not None:
            wb = self._check_warm_basis(sf, warm_basis, warm_at_upper,
                                        ub_np)
            if wb is not None:
                basis = jnp.asarray(wb[0])
                at_up = jnp.asarray(wb[1])
                need_phase1 = False

        B_inv, x_B = _refactor(A_std, b, basis, at_up, ub_dev)
        iters = jnp.int32(0)

        if need_phase1:
            B_inv, x_B, basis, at_up, iters, status, obj1 = \
                _run_phase_revised(
                    A_std, b, cost1, col_p1, art_ext, B_inv, x_B, basis,
                    at_up, ub_dev, iters,
                    jnp.bool_(False), tol=tol, max_iters=max_iters,
                    bland_after=bland_after,
                    devex=self.config.pivot_rule == "devex")
            b_scale = 1.0 + float(np.max(np.abs(sf.tableau[:m_pad, n_pad])))
            if int(status) != STATUS_OPTIMAL:
                return self._finish_failed(int(status), int(iters), lp, sf,
                                           t0)
            if float(obj1) > 1e-5 * b_scale:
                return self._finish_failed(STATUS_INFEASIBLE, int(iters),
                                           lp, sf, t0)

        B_inv, x_B, basis, at_up, iters, status, obj = _run_phase_revised(
            A_std, b, cost2, col_p2, art_ext, B_inv, x_B, basis, at_up,
            ub_dev, iters,
            jnp.bool_(True), tol=tol, max_iters=max_iters,
            bland_after=bland_after,
            devex=self.config.pivot_rule == "devex")
        status = int(status)
        nit = int(iters)
        basis_np = np.asarray(basis)
        at_up_np = np.asarray(at_up)

        # f64 verdict certification + escalation — the same safety net the
        # dense engine has (exactly-dependent columns can defeat any f32
        # loop; see models/dense._certify_optimal_basis).
        escalated = False
        fin = (False, None, None, None)
        if status == STATUS_OPTIMAL:
            fin = _finalize_on_host_bounded(sf, lp, basis_np, at_up_np,
                                            sf64=sf)
            escalated = not fin[0]
        elif status in (STATUS_INFEASIBLE, STATUS_UNBOUNDED):
            escalated = True
        elif status == STATUS_ITERATION_LIMIT and \
                nit < self.config.max_iters:
            # Numeric-stall exit (f32 drift faking eligible pivots), not
            # the user's cap.  A stall almost always means the optimality
            # tolerance sits below the f32 pricing noise at this problem's
            # scale — retry once with 10x looser device tol (the f64
            # certification + refinement still deliver the exact optimum),
            # and only then fall back to the slow host f64 engine.
            if _tol_scale == 1.0:
                res = self.solve(lp, warm_basis, _tol_scale=10.0,
                                 warm_at_upper=warm_at_upper,
                                 _equilibrated=_equilibrated)
                res.nit += nit
                res.solve_time = time.perf_counter() - t0
                return res
            escalated = True
        if escalated:
            if sf.ub_ext is not None:
                return self._escalate_bounded(lp, nit, t0)
            status, basis_np, nit2 = _host_simplex_f64(sf)
            nit += nit2
            if status == STATUS_OPTIMAL:
                fin = _finalize_on_host(sf, lp, basis_np, sf64=sf)
                if fin[1] is None:
                    return self._fail(STATUS_ITERATION_LIMIT, nit, t0)
        if status != STATUS_OPTIMAL:
            return self._fail(status, nit, t0)

        certified, x_full, duals, reduced = fin
        c_min = -lp.c if lp.maximize else lp.c
        if x_full is not None and (escalated or self.config.refine):
            x = x_full[: lp.n_vars]
        else:
            x_B_np = np.asarray(x_B, np.float64)
            x = np.zeros((sf.n_pad,))
            x[np.asarray(basis)] = x_B_np
            up = at_up_np & np.isfinite(ub_np)
            x[up] = ub_np[up]
            x = x[: lp.n_vars]
        fun = float(c_min @ x)
        z_user = (-fun if lp.maximize else fun) + 0.0
        return SimplexResult(
            x=np.maximum(x, 0.0), fun=fun, status=0, success=True,
            message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
            basis=basis_np, z=z_user,
            solve_time=time.perf_counter() - t0,
            duals=duals, reduced_costs=reduced,
            at_upper=at_up_np,
        )

    def _escalate_bounded(self, lp: LinearProgram, nit: int,
                          t0: float) -> SimplexResult:
        """Exact f64 escalation for bounded LPs: lower the (already
        normalized, lb=0) upper bounds onto rows and run the host f64
        reference engine, then report duals/reduced costs in the NATIVE
        sense (dual y restricted to the structural rows; rc = c - y'A),
        so the sensitivity contract matches the bounded fast path."""
        lp_rows = lower_bounds_to_rows(lp)
        sf_l = compile_standard_form(lp_rows, dtype=np.float64)
        status, basis_l, nit2 = _host_simplex_f64(sf_l)
        nit += nit2
        if status != STATUS_OPTIMAL:
            return self._fail(status, nit, t0)
        ok, x_full, duals_l, _ = _finalize_on_host(sf_l, lp_rows, basis_l,
                                                   sf64=sf_l)
        if x_full is None:
            return self._fail(STATUS_ITERATION_LIMIT, nit, t0)
        m = lp.n_cons
        x = x_full[: lp.n_vars]
        c_min = -lp.c if lp.maximize else lp.c
        user_sign = -1.0 if lp.maximize else 1.0
        duals = None if duals_l is None else duals_l[:m]
        reduced = None
        if duals is not None:
            row_sign = np.where(lp.b < 0, -1.0, 1.0)
            y_min = user_sign * row_sign * duals
            reduced = user_sign * (c_min - y_min @ lp.A)
        fun = float(c_min @ x)
        z_user = (-fun if lp.maximize else fun) + 0.0
        return SimplexResult(
            x=x, fun=fun, status=0, success=True,
            message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
            basis=basis_l, z=z_user,
            solve_time=time.perf_counter() - t0,
            duals=duals, reduced_costs=reduced,
        )

    @staticmethod
    def _check_warm_basis(sf, warm_basis, warm_at_upper=None, ub=None):
        """Validate a saved basis (+ optional at-upper set): right shape,
        no artificials, no basic-at-upper conflicts, invertible, and
        primal-feasible WITHIN BOUNDS for the new data:
        ``x_B = B^{-1}(b - A_U u_U)`` must sit in ``[0, ub_B]``.
        Returns ``(basis, at_upper)`` or None → cold start."""
        basis = np.asarray(warm_basis, dtype=np.int32).reshape(-1)
        if basis.shape[0] != sf.m_pad or np.any(basis < 0) or \
                np.any(basis >= sf.n_pad):
            return None
        art = sf.col_mask_p1 & ~sf.col_mask_p2
        if np.any(art[basis]):
            return None
        if ub is None:
            ub = np.full((sf.n_pad,), np.inf)
        ub = np.asarray(ub, np.float64)[: sf.n_pad]
        if warm_at_upper is None:
            at_up = np.zeros((sf.n_pad,), bool)
        else:
            at_up = np.asarray(warm_at_upper, bool).reshape(-1)
            if at_up.shape[0] != sf.n_pad:
                return None
            at_up = at_up & np.isfinite(ub)
            if np.any(at_up[basis]):
                return None            # basic columns cannot sit at-upper
        rows = sf.tableau.astype(np.float64)[: sf.m_pad]
        rhs = rows[:, sf.n_pad]
        if np.any(at_up):
            u_vec = np.where(at_up, np.where(np.isfinite(ub), ub, 0.0),
                             0.0)
            rhs = rhs - rows[:, : sf.n_pad] @ u_vec
        try:
            x_B = np.linalg.solve(rows[:, basis], rhs)
        except np.linalg.LinAlgError:
            return None
        if not np.all(np.isfinite(x_B)) or np.any(x_B < -1e-9):
            return None
        ub_B = ub[basis]
        fin = np.isfinite(ub_B)
        if np.any(x_B[fin] > ub_B[fin] + 1e-9):
            return None
        return basis, at_up

    def _finish_failed(self, status: int, nit: int, lp, sf,
                       t0: float) -> SimplexResult:
        """Phase-1 failure: certify infeasibility in f64 before reporting."""
        if sf.ub_ext is not None:
            # Bounded problem: the classic host engine would drop the upper
            # bounds — escalate through the row-lowered exact solve instead.
            return self._escalate_bounded(lp, nit, t0)
        status2, basis2, nit2 = _host_simplex_f64(sf)
        nit += nit2
        if status2 != STATUS_OPTIMAL:
            return self._fail(status2, nit, t0)
        _, x_full, duals, reduced = _finalize_on_host(sf, lp, basis2,
                                                      sf64=sf)
        if x_full is None:
            return self._fail(status, nit, t0)
        c_min = -lp.c if lp.maximize else lp.c
        x = x_full[: lp.n_vars]
        fun = float(c_min @ x)
        z_user = (-fun if lp.maximize else fun) + 0.0
        return SimplexResult(
            x=np.maximum(x, 0.0), fun=fun, status=0, success=True,
            message=STATUS_MESSAGES[STATUS_OPTIMAL], nit=nit,
            basis=basis2, z=z_user, solve_time=time.perf_counter() - t0,
            duals=duals, reduced_costs=reduced,
        )

    @staticmethod
    def _fail(status: int, nit: int, t0: float) -> SimplexResult:
        return SimplexResult(
            x=None, fun=None, status=status, success=False,
            message=STATUS_MESSAGES.get(status, "Unknown status."),
            nit=nit, solve_time=time.perf_counter() - t0,
        )
