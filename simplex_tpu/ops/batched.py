"""Batched tableau-simplex kernel: one padded shape, many LP instances.

The reference solves one LP per HTTP request (``solver_controller.py:53-120``);
the accelerator's scale axis is **instance batching** (BASELINE config 2:
10k random 50x30 LPs vmapped on one chip).  Design notes:

* One ``lax.while_loop`` advances ALL instances together; finished instances
  are frozen by masking instead of exiting (SURVEY.md §7 "batched while_loop
  efficiency").  The loop ends when every instance has a verdict or the
  iteration cap is hit.
* No data-dependent branching inside the body: periodic refactorization is
  applied to every instance on the same schedule (a batched
  ``linalg.solve``), so there is no per-instance control-flow divergence.  Unlike
  the single-LP kernel (ops/tableau.py), terminal verdicts are accepted
  directly from the incrementally-updated tableau: confirm-refactors would
  fire nearly every iteration at batch scale.  Drift control comes from the
  periodic refactor plus optional float64 host refinement of each final
  basis (models/batched.py).
* The per-pivot update is a batched rank-1 row reduction over a
  (B, m+1, n+1) tensor, fully vectorized.
* Phases are fused: each instance carries a ``phase`` flag; pricing uses the
  phase-appropriate objective row and column mask, and a phase-1→2 flip is a
  masked artificial eviction + objective-row swap, not a host round-trip.
* Gathers of a pivot column, row or basis columns are index gathers, never
  one-hot contractions: a float32 product may run in TF32 on the GPU and
  would round every gathered entry.  The contractions that remain state
  ``precision=HIGHEST``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..core.problem import (
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
)

RUNNING = -1
_INT_MAX = jnp.iinfo(jnp.int32).max
_HI = lax.Precision.HIGHEST

def _gather_col(T, s):
    """Column ``T[b, :, s[b]]`` per instance."""
    return jnp.take_along_axis(T, s[:, None, None], axis=2)[:, :, 0]


def _gather_row(T, r):
    """Row ``T[b, r[b], :]`` per instance."""
    return jnp.take_along_axis(T, r[:, None, None], axis=1)[:, 0, :]


def _gather_lane(x, j):
    """``x[b, j[b]]`` per instance."""
    return jnp.take_along_axis(x, j[:, None], axis=1)[:, 0]


def _basis_cols(T_rows, basis):
    """``T_rows[b, :, basis[b, i]]`` -> (B, m, m): the basis columns."""
    return jnp.take_along_axis(T_rows, basis[:, None, :], axis=2)


def _select_pivot_b(T, basis, col_mask, tol, use_bland, weights=None):
    """Batched pivot selection. All inputs carry a leading batch axis.

    T: (B, m+1, n+1); basis: (B, m); col_mask: (B, n).
    ``weights`` (optional, (B, n)): per-instance Devex reference weights —
    pricing becomes ``argmax rc^2 / w`` (approximate steepest edge), the
    same rule as the single-chip and sharded kernels.
    Returns (s, r, optimal, unbounded) each of shape (B,).
    """
    rc = jnp.where(col_mask, T[:, -1, :-1], jnp.inf)
    eligible = rc < -tol

    if weights is None:
        s_price = jnp.argmin(rc, axis=-1)
    else:
        score = jnp.where(eligible, (rc * rc) / weights, -jnp.inf)
        s_price = jnp.argmax(score, axis=-1)
    s_bland = jnp.argmax(eligible, axis=-1)
    s = jnp.where(use_bland, s_bland, s_price)

    optimal = ~jnp.any(eligible, axis=-1)

    col = _gather_col(T, s)[:, :-1]
    rhs = T[:, :-1, -1]
    positive = col > tol
    # Backward-step clamp — see ops/tableau.select_pivot.
    rhs_c = jnp.maximum(rhs, 0.0)
    ratios = jnp.where(positive, rhs_c / jnp.where(positive, col, 1.0),
                       jnp.inf)
    min_ratio = jnp.min(ratios, axis=-1)
    unbounded = (~optimal) & jnp.isinf(min_ratio)

    # Harris two-pass ratio test (largest pivot inside the tol-relaxed
    # window) for stability; Bland mode keeps the smallest-basis-index rule
    # its termination proof needs (same design as ops/tableau.select_pivot).
    delta = tol * (1.0 + jnp.abs(rhs))
    theta_relax = jnp.where(positive,
                            (rhs_c + delta) / jnp.where(positive, col, 1.0),
                            jnp.inf)
    theta_max = jnp.min(theta_relax, axis=-1)
    cand = positive & (ratios <= theta_max[:, None])
    r_harris = jnp.argmax(jnp.where(cand, col, -jnp.inf), axis=-1)

    eps = jnp.finfo(T.dtype).eps
    near = ratios <= (min_ratio + 64.0 * eps * (1.0 + jnp.abs(min_ratio)))[:, None]
    tie_key = jnp.where(near & positive, basis, _INT_MAX)
    r_bland = jnp.argmin(tie_key, axis=-1)
    r = jnp.where(use_bland, r_bland, r_harris)
    return s, r, optimal, unbounded


def _devex_update_b(w, T, basis, r, s, active):
    """Batched Forrest-Goldfarb Devex weight update for pivots (r, s).

    ``alpha = pivot_row / pivot`` (normalized), ``w <- max(w, alpha^2 w_s)``,
    leaving variable restarts at ``max(w_s, 1)``, entering at 1, and an
    instance's reference framework resets when its weights overflow 1e8 —
    per instance, applied only where ``active``.
    """
    n = T.shape[2] - 1
    piv_row = _gather_row(T, r)[:, :n]                          # (B, n)
    pivot = _gather_lane(piv_row, s)
    safe = jnp.where(jnp.abs(pivot) > 0, pivot, 1.0)
    alpha = piv_row / safe[:, None]
    w_s = _gather_lane(w, s)                                    # (B,)
    w_new = jnp.maximum(w, (alpha * alpha) * w_s[:, None])
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    j_out = jnp.take_along_axis(basis, r[:, None], axis=1)      # (B, 1)
    w_new = jnp.where(idx == j_out,
                      jnp.maximum(w_s, 1.0)[:, None], w_new)
    w_new = jnp.where(idx == s[:, None], 1.0, w_new)
    w_new = jnp.where(jnp.max(w_new, axis=1, keepdims=True) > 1e8,
                      jnp.ones_like(w_new), w_new)
    return jnp.where(active[:, None], w_new, w)


def _pivot_update_b(T, basis, r, s, active, clamp_rhs: bool = False):
    """Batched masked rank-1 pivot: inactive instances pass through untouched.

    ``clamp_rhs``: execute theta = max(rhs_r, 0)/pivot instead of the raw
    ratio — required on the primal solve path so tolerance-negative rhs
    rows pivot at theta = 0 rather than stepping every other row backward
    (see ops/tableau.pivot_update; round-4 adversarial corpus find).
    Eviction sweeps keep the exact step (their pivot sign is arbitrary
    and levels are ~0)."""
    B, M, N = T.shape
    piv_row = _gather_row(T, r)                                  # (B, N)
    pivot = _gather_lane(piv_row, s)
    safe_pivot = jnp.where(active & (jnp.abs(pivot) > 0), pivot, 1.0)
    piv_row = piv_row / safe_pivot[:, None]
    if clamp_rhs:
        piv_row = piv_row.at[:, N - 1].set(
            jnp.maximum(piv_row[:, N - 1], 0.0))

    col = _gather_col(T, s)
    T_new = T - col[:, :, None] * piv_row[:, None, :]

    row_hot = jax.nn.one_hot(r, M, dtype=bool, axis=-1)          # (B, M)
    T_new = jnp.where(row_hot[:, :, None], piv_row[:, None, :], T_new)
    col_hot = jax.nn.one_hot(s, N, dtype=bool, axis=-1)          # (B, N)
    unit = row_hot.astype(T.dtype)                               # (B, M)
    T_new = jnp.where(col_hot[:, None, :], unit[:, :, None], T_new)

    T_out = jnp.where(active[:, None, None], T_new, T)
    basis_new = jnp.where(
        active[:, None] & row_hot[:, :M - 1],      # drop the objective row
        s[:, None].astype(basis.dtype), basis
    )
    return T_out, basis_new


def _price_out_b(T, basis, obj_row):
    """Batched objective install + price-out against the current basis."""
    basis_costs = jnp.take_along_axis(obj_row, basis, axis=1)     # (B, m)
    obj2 = obj_row - jnp.einsum("bm,bmn->bn", basis_costs, T[:, :-1, :],
                                precision=_HI)
    return T.at[:, -1, :].set(obj2)


def _evict_artificials_b(T, basis, art_mask_ext, col_mask_p2, tol):
    """Batched post-phase-1 eviction of basic artificial columns."""
    m_rows = T.shape[1] - 1

    def body(i, state):
        T, basis = state
        is_art = jnp.take_along_axis(
            art_mask_ext, basis[:, i][:, None], axis=1)[:, 0]
        row = T[:, i, :-1]
        cand = col_mask_p2 & (jnp.abs(row) > tol)
        j = jnp.argmax(cand, axis=-1)
        active = is_art & jnp.any(cand, axis=-1)
        r = jnp.full_like(j, i)
        return _pivot_update_b(T, basis, r, j, active)

    return lax.fori_loop(0, m_rows, body, (T, basis))


def _refine_solution_b(T, basis, basis0, T0_rows, raw_obj):
    """Iterative refinement of the reported solution (RHS column + objective).

    The full exact refactor (`_refactor_b`) runs a batched tiny-LU
    ``linalg.solve`` over every instance, yet only the RHS column and
    objective cell of its output feed :func:`extract_solution_batch`.
    Instead, polish x_B with one Newton step using the approximate inverse
    ALREADY EMBEDDED in the incremental tableau: the initial basis
    ``basis0`` indexes the identity columns of T0 (slack for <=, artificial
    for >=/=, unit pads), so ``M = T_rows[:, :, basis0] ≈ B^{-1}`` up to the
    same drift as the tableau.  One step squares the drift (e ~ 1e-4 →
    1e-8) for three small batched matvecs; the update is kept only where it
    reduces the residual, so a badly-drifted instance can never be made
    worse.
    """
    T_rows = T[:, :-1, :]
    Bmat = _basis_cols(T0_rows, basis)                  # (B, mp, mp)
    Minv = _basis_cols(T_rows, basis0)                  # ~ B^{-1}

    b0 = T0_rows[:, :, -1]
    xB = T[:, :-1, -1]
    r0 = b0 - jnp.einsum("bij,bj->bi", Bmat, xB, precision=_HI)
    xB1 = xB + jnp.einsum("bij,bj->bi", Minv, r0, precision=_HI)
    r1 = b0 - jnp.einsum("bij,bj->bi", Bmat, xB1, precision=_HI)
    better = (jnp.sum(r1 * r1, axis=-1) < jnp.sum(r0 * r0, axis=-1)) \
        & jnp.all(jnp.isfinite(xB1), axis=-1)
    xB_out = jnp.where(better[:, None], xB1, xB)

    cB = jnp.take_along_axis(raw_obj, basis, axis=1)    # (B, mp)
    z_min = jnp.sum(cB * xB_out, axis=-1)               # c_B' x_B
    T = T.at[:, :-1, -1].set(xB_out)
    T = T.at[:, -1, -1].set(-z_min)
    return T


def _refactor_b(T, basis, T0_rows, raw_obj, active):
    """Batched exact recomputation of tableaus from (T0, basis).

    ``B = T0_rows[:, :, basis]`` per instance; a batched dense solve.
    Instances that are inactive or whose basis matrix is singular keep their
    incremental tableau.
    """
    T_rows = jnp.linalg.solve(_basis_cols(T0_rows, basis), T0_rows)
    basis_costs = jnp.take_along_axis(raw_obj, basis, axis=1)
    obj = raw_obj - jnp.einsum("bm,bmn->bn", basis_costs, T_rows,
                               precision=_HI)
    T_new = jnp.concatenate([T_rows, obj[:, None, :]], axis=1)
    ok = active & jnp.all(jnp.isfinite(T_new), axis=(1, 2))
    return jnp.where(ok[:, None, None], T_new, T)


@functools.partial(
    jax.jit,
    static_argnames=("tol", "max_iters", "bland_after", "feas_tol",
                     "refactor_every", "devex", "phase2_only"),
)
def solve_tableau_batch(T0, basis0, col_mask_p1, col_mask_p2,
                        obj_row_p1, obj_row_p2, need_p1,
                        tol: float = 1e-6, max_iters: int = 4096,
                        bland_after: int = 1024, feas_tol: float = 1e-5,
                        refactor_every: int = 64,
                        devex: bool = False, phase2_only: bool = False):
    """Solve a batch of LPs sharing one padded tableau shape.

    Args:
      T0:          (B, m+1, n+1) initial tableaus with the phase-1 objective
                   row installed for instances needing artificials and the
                   (priced-out) phase-2 row for the rest — as produced by
                   ``models.batched.compile_batch``.
      basis0:      (B, m) int32 initial basis.
      col_mask_*:  (B, n) bool eligible-column masks per phase.
      obj_row_*:   (B, n+1) raw cost rows (phase-1 artificial costs / min-form
                   phase-2 costs).
      need_p1:     (B,) bool — instance starts in phase 1.

    Returns ``(T, basis, status, iters, pivots)``; ``status`` is
    per-instance with scipy-compatible codes, ``iters`` the shared loop
    trip count, ``pivots`` the per-instance pivot counts.

    ``devex`` switches pricing to per-instance Forrest-Goldfarb reference
    weights (the 4x+ pivot-count reduction the single-chip kernels measure
    on large LPs, VERDICT r1 weak #2), threaded per instance the same way
    the Bland flags are.

    ``phase2_only`` (STATIC; caller asserts every instance starts in
    phase 2, i.e. ``need_p1`` is all-False — true for every all-<= sweep
    after sign normalization): runs a fast two-level loop with NO
    per-iteration ``lax.cond``.  The identity branches of the refactor and
    phase-flip conds can force XLA to copy the whole tableau every
    iteration (the same pathology as the sharded kernel's resync cond);
    chunking the refactor to the boundary of an inner while_loop removes
    both copies.
    """
    Bsz = T0.shape[0]
    b_scale = 1.0 + jnp.max(jnp.abs(T0[:, :-1, -1]), axis=1)
    T0_rows = T0[:, :-1, :]
    art_mask_ext = jnp.concatenate(
        [col_mask_p1 & ~col_mask_p2, jnp.zeros((Bsz, 1), bool)], axis=1
    )

    phase0 = jnp.where(need_p1, jnp.int32(1), jnp.int32(2))

    if phase2_only:
        # -------- FAST PATH: no per-iteration lax.cond (see docstring) -- #
        def istep(state):
            (T, basis, status, iters, chunk, pivots, best_obj, no_imp,
             w) = state
            live = status == RUNNING
            use_bland = no_imp >= bland_after
            s, r, optimal, unbounded = _select_pivot_b(
                T, basis, col_mask_p2, tol, use_bland,
                weights=w if devex else None)
            active = live & ~optimal & ~unbounded
            if devex:
                w = _devex_update_b(w, T, basis, r, s, active)
            T, basis = _pivot_update_b(T, basis, r, s, active,
                                       clamp_rhs=True)
            want_stop = (optimal | unbounded) & live
            status = jnp.where(
                want_stop & optimal, STATUS_OPTIMAL,
                jnp.where(want_stop & unbounded, STATUS_UNBOUNDED, status))
            pivots = pivots + active.astype(pivots.dtype)
            obj_b = -T[:, -1, -1]
            improved = obj_b < best_obj - tol * (1.0 + jnp.abs(best_obj))
            best_obj = jnp.minimum(best_obj, obj_b)
            no_imp = jnp.where(improved, 0,
                               no_imp + active.astype(no_imp.dtype))
            return (T, basis, status, iters + 1, chunk + 1, pivots,
                    best_obj, no_imp, w)

        def icond(state):
            status, iters, chunk = state[2], state[3], state[4]
            return (jnp.any(status == RUNNING) & (iters < max_iters)
                    & (chunk < refactor_every))

        def ocond(state):
            status, iters = state[2], state[3]
            return jnp.any(status == RUNNING) & (iters < max_iters)

        def obody(state):
            state = lax.while_loop(
                icond, istep, state[:4] + (jnp.int32(0),) + state[5:])
            (T, basis, status, iters, chunk, pivots, best_obj, no_imp,
             w) = state
            # Periodic drift refactor at the CHUNK boundary — the cond's
            # copy now costs once per refactor_every iterations.
            cont = jnp.any(status == RUNNING) & (iters < max_iters)
            T = lax.cond(
                cont,
                lambda T: _refactor_b(T, basis, T0_rows, obj_row_p2,
                                      status == RUNNING),
                lambda T: T, T)
            return (T, basis, status, iters, chunk, pivots, best_obj,
                    no_imp, w)

        state0 = (T0, basis0, jnp.full((Bsz,), RUNNING, jnp.int32),
                  jnp.int32(0), jnp.int32(0),
                  jnp.zeros((Bsz,), jnp.int32),
                  jnp.full((Bsz,), jnp.inf, T0.dtype),
                  jnp.zeros((Bsz,), jnp.int32),
                  jnp.ones((Bsz, T0.shape[2] - 1), T0.dtype))
        T, basis, status, iters, _, pivots, _, _, _ = lax.while_loop(
            ocond, obody, state0)
        T = _refine_solution_b(T, basis, basis0, T0_rows, obj_row_p2)
        status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT,
                           status)
        return T, basis, status, iters, pivots

    def cond(state):
        status, iters = state[3], state[4]
        return jnp.any(status == RUNNING) & (iters < max_iters)

    def body(state):
        T, basis, phase, status, iters, since_ref, pivots, best_obj, \
            no_imp, w = state
        live = status == RUNNING
        in_p1 = phase == 1
        col_mask = jnp.where(in_p1[:, None], col_mask_p1, col_mask_p2)
        raw_obj = jnp.where(in_p1[:, None], obj_row_p1, obj_row_p2)
        # Stall-gated Bland, per instance: engage after ``bland_after``
        # consecutive non-improving pivots, revert on progress (cycles never
        # improve, so anti-cycling is preserved; see ops/tableau.py).
        use_bland = no_imp >= bland_after

        # Periodic batched refactorization (drift control, all instances).
        do_refactor = since_ref >= refactor_every
        T = lax.cond(
            do_refactor,
            lambda T: _refactor_b(T, basis, T0_rows, raw_obj, live),
            lambda T: T,
            T,
        )

        s, r, optimal, unbounded = _select_pivot_b(
            T, basis, col_mask, tol, use_bland,
            weights=w if devex else None)
        want_stop = (optimal | unbounded) & live

        # --- Phase-1 completion --------------------------------------- #
        p1_done = want_stop & in_p1
        p1_obj = -T[:, -1, -1]
        infeasible = p1_done & (p1_obj > feas_tol * b_scale)
        to_p2 = p1_done & ~infeasible

        # The eviction sweep is m sequential batched pivots — by far the most
        # expensive step in the body — so it only runs on iterations where at
        # least one instance actually flips to phase 2 (typically once or
        # twice per solve, not every iteration).
        def flip(args):
            T, basis, phase = args
            T_ev, basis_ev = _evict_artificials_b(T, basis, art_mask_ext,
                                                  col_mask_p2, tol)
            T_p2 = _price_out_b(T_ev, basis_ev, obj_row_p2)
            T = jnp.where(to_p2[:, None, None], T_p2, T)
            basis = jnp.where(to_p2[:, None], basis_ev, basis)
            phase = jnp.where(to_p2, jnp.int32(2), phase)
            return T, basis, phase

        T, basis, phase = lax.cond(
            jnp.any(to_p2), flip, lambda a: a, (T, basis, phase)
        )

        # --- Terminal statuses ----------------------------------------- #
        finish_p2 = want_stop & ~in_p1
        status = jnp.where(
            infeasible, STATUS_INFEASIBLE,
            jnp.where(finish_p2 & optimal, STATUS_OPTIMAL,
                      jnp.where(finish_p2 & unbounded, STATUS_UNBOUNDED,
                                status)),
        )

        # --- Pivot all still-running, non-flipping instances ------------ #
        active = ((status == RUNNING) & ~to_p2 & live
                  & ~optimal & ~unbounded)
        if devex:
            w = _devex_update_b(w, T, basis, r, s, active)
        T, basis = _pivot_update_b(T, basis, r, s, active, clamp_rhs=True)
        pivots = pivots + active.astype(pivots.dtype)

        # Objective-progress tracking for the stall-gated Bland switch
        # (min-form objective -T[-1,-1] is non-increasing along pivots).
        obj_b = -T[:, -1, -1]
        improved = obj_b < best_obj - tol * (1.0 + jnp.abs(best_obj))
        best_obj = jnp.minimum(best_obj, obj_b)
        no_imp = jnp.where(improved, 0, no_imp + active.astype(no_imp.dtype))
        # A phase flip installs a fresh objective: reset progress state
        # (and the Devex reference framework — new objective, new weights).
        inf_ = jnp.asarray(jnp.inf, best_obj.dtype)
        best_obj = jnp.where(to_p2, inf_, best_obj)
        no_imp = jnp.where(to_p2, 0, no_imp)
        if devex:
            w = jnp.where(to_p2[:, None], 1.0, w)

        since_ref = jnp.where(do_refactor, jnp.int32(1), since_ref + 1)
        return (T, basis, phase, status, iters + 1, since_ref, pivots,
                best_obj, no_imp, w)

    state0 = (
        T0, basis0, phase0,
        jnp.full((Bsz,), RUNNING, jnp.int32),
        jnp.int32(0), jnp.int32(1),
        jnp.zeros((Bsz,), jnp.int32),
        jnp.full((Bsz,), jnp.inf, T0.dtype),
        jnp.zeros((Bsz,), jnp.int32),
        jnp.ones((Bsz, T0.shape[2] - 1), T0.dtype),   # Devex weights
    )
    T, basis, phase, status, iters, _, pivots, _, _, _ = lax.while_loop(
        cond, body, state0)

    # Final solution polish so reported objectives/solutions are drift-free.
    # (Newton refinement of x_B — NOT the O(m^3) batched-LU refactor, which
    # costs more than the whole pivot loop at large B; see
    # ``_refine_solution_b``.)
    raw_obj = jnp.where((phase == 1)[:, None], obj_row_p1, obj_row_p2)
    T = _refine_solution_b(T, basis, basis0, T0_rows, raw_obj)
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)
    return T, basis, status, iters, pivots


def _evict_artificials_bounded_b(T, basis, at_upper, art_mask_ext,
                                 col_mask_p2, tol):
    """Post-phase-1 eviction with bounds: entering candidates must be
    nonbasic AT LOWER (an at-upper column entering at the artificial's
    ~zero level would silently teleport from its bound)."""
    m_rows = T.shape[1] - 1

    def body(i, state):
        T, basis = state
        is_art = jnp.take_along_axis(
            art_mask_ext, basis[:, i][:, None], axis=1)[:, 0]
        row = T[:, i, :-1]
        cand = col_mask_p2 & ~at_upper & (jnp.abs(row) > tol)
        j = jnp.argmax(cand, axis=-1)
        active = is_art & jnp.any(cand, axis=-1)
        r = jnp.full_like(j, i)
        return _pivot_update_b(T, basis, r, j, active)

    return lax.fori_loop(0, m_rows, body, (T, basis))


def _refine_solution_bounded_b(T, basis, basis0, T0_rows, raw_obj,
                               at_upper, ub):
    """Bounded twin of :func:`_refine_solution_b`: the Newton residual is
    taken against the at-upper-adjusted RHS ``b_eff = b0 - A u_U`` and the
    reported objective includes the at-upper nonbasic contributions."""
    T_rows = T[:, :-1, :]
    Bmat = _basis_cols(T0_rows, basis)
    Minv = _basis_cols(T_rows, basis0)

    ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)
    u_vec = jnp.where(at_upper, ub_safe, 0.0)                 # (B, n)
    b_eff = T0_rows[:, :, -1] - jnp.einsum(
        "bkn,bn->bk", T0_rows[:, :, :-1], u_vec, precision=_HI)
    xB = T[:, :-1, -1]
    r0 = b_eff - jnp.einsum("bij,bj->bi", Bmat, xB, precision=_HI)
    xB1 = xB + jnp.einsum("bij,bj->bi", Minv, r0, precision=_HI)
    r1 = b_eff - jnp.einsum("bij,bj->bi", Bmat, xB1, precision=_HI)
    better = (jnp.sum(r1 * r1, axis=-1) < jnp.sum(r0 * r0, axis=-1)) \
        & jnp.all(jnp.isfinite(xB1), axis=-1)
    xB_out = jnp.where(better[:, None], xB1, xB)

    cB = jnp.take_along_axis(raw_obj, basis, axis=1)
    z_min = jnp.sum(cB * xB_out, axis=-1) + jnp.sum(
        jnp.where(at_upper, raw_obj[:, :-1] * ub_safe, 0.0), axis=-1)
    T = T.at[:, :-1, -1].set(xB_out)
    T = T.at[:, -1, -1].set(-z_min)
    return T


def _refactor_bounded_b(T, basis, at_upper, ub, T0_rows, raw_obj, active):
    """Bounded exact refactorization: ``B^{-1} A`` and the reduced costs are
    bound-independent, but the RHS column solves against the at-upper-
    adjusted ``b_eff`` and the objective cell adds the at-upper terms."""
    ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)
    u_vec = jnp.where(at_upper, ub_safe, 0.0)
    b_eff = T0_rows[:, :, -1] - jnp.einsum(
        "bkn,bn->bk", T0_rows[:, :, :-1], u_vec, precision=_HI)
    rhs_all = jnp.concatenate(
        [T0_rows[:, :, :-1], b_eff[:, :, None]], axis=2)
    T_rows = jnp.linalg.solve(_basis_cols(T0_rows, basis), rhs_all)
    basis_costs = jnp.take_along_axis(raw_obj, basis, axis=1)
    obj = raw_obj - jnp.einsum("bm,bmn->bn", basis_costs, T_rows,
                               precision=_HI)
    z_min = jnp.sum(basis_costs * T_rows[:, :, -1], axis=-1) + jnp.sum(
        jnp.where(at_upper, raw_obj[:, :-1] * ub_safe, 0.0), axis=-1)
    obj = obj.at[:, -1].set(-z_min)
    T_new = jnp.concatenate([T_rows, obj[:, None, :]], axis=1)
    ok = active & jnp.all(jnp.isfinite(T_new), axis=(1, 2))
    return jnp.where(ok[:, None, None], T_new, T)


@functools.partial(
    jax.jit,
    static_argnames=("tol", "max_iters", "bland_after", "feas_tol",
                     "refactor_every", "devex", "phase2_only"),
)
def solve_tableau_batch_bounded(T0, basis0, col_mask_p1, col_mask_p2,
                                obj_row_p1, obj_row_p2, need_p1, ub,
                                tol: float = 1e-6, max_iters: int = 4096,
                                bland_after: int = 1024,
                                feas_tol: float = 1e-5,
                                refactor_every: int = 64,
                                devex: bool = False,
                                phase2_only: bool = False):
    """Batched tableau simplex with NATIVE upper bounds ``0 <= x <= ub``.

    The general bounded ratio test of the revised engine
    (``models/revised.py:171-245``) ported to the batched tableau kernel
    (VERDICT r3 item 4): a nonbasic column is eligible entering from its
    LOWER bound when rc < -tol or from its UPPER bound when rc > +tol
    (it then decreases); the step is limited by a basic variable hitting
    0, a basic variable hitting its own upper bound, or the entering
    variable reaching its opposite bound — the last case is a BOUND FLIP
    (no basis change; O(m) RHS update).  This is what HiGHS provides
    natively behind the reference's ``solver_controller.py:78-85`` and
    what netlib BOUNDS sections need without inflating m with dense bound
    rows (BASELINE.md:34).

    Mechanics per pivot: the ``B^{-1}A`` block and the reduced-cost row
    update by the standard rank-1 elimination (both are bound-
    independent), while the RHS column and the objective CELL are
    maintained explicitly (``x_B -= σ d θ``; entering lands at θ from
    lower or ``u_s - θ`` from upper; ``z += σ rc_s θ``) — the rank-1
    formulas for those two are only correct in the leave-at-zero case.
    Harris two-pass row selection relaxes BOTH limits by the feasibility
    tolerance and picks the largest |pivot| inside the window.

    ``ub``: (B, n_pad) in the tableau dtype, +inf where unbounded (slack/
    artificial/padding columns must be +inf).  Fixed columns (ub == 0)
    must be masked out of ``col_mask_*`` by the compiler — a zero-span
    variable would flip forever.

    ``phase2_only`` (static,
    caller asserts need_p1 all-False) removes the per-iteration lax.conds
    exactly as in :func:`solve_tableau_batch`.

    Returns ``(T, basis, at_upper, status, iters, pivots)``.
    """
    Bsz = T0.shape[0]
    N = T0.shape[2] - 1
    b_scale = 1.0 + jnp.max(jnp.abs(T0[:, :-1, -1]), axis=1)
    T0_rows = T0[:, :-1, :]
    art_mask_ext = jnp.concatenate(
        [col_mask_p1 & ~col_mask_p2, jnp.zeros((Bsz, 1), bool)], axis=1
    )
    phase0 = jnp.where(need_p1, jnp.int32(1), jnp.int32(2))
    ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)
    col_idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    _ART = jnp.asarray(1e30, T0.dtype)

    if phase2_only:
        # -------- FAST PATH: no per-iteration lax.cond ------------------ #
        # Same two-level chunked structure as the classic driver's fast
        # path (see solve_tableau_batch docstring).  phase2_only implies
        # need_p1 is all-False, hence NO artificial columns exist in the
        # batch (the compiler only allocates the artificial block when a
        # row needs one), so the artificial-exit machinery is dead and the
        # step below drops it.
        def istep(state):
            (T, basis, at_upper, status, iters, chunk, pivots, best_obj,
             no_imp, w, ub_B, is_art_row) = state
            live = status == RUNNING
            use_bland = no_imp >= bland_after
            rc = T[:, -1, :-1]
            elig_lo = col_mask_p2 & ~at_upper & (rc < -tol)
            elig_up = col_mask_p2 & at_upper & (rc > tol)
            eligible = elig_lo | elig_up
            viol = jnp.where(eligible, jnp.abs(rc), -jnp.inf)
            if devex:
                score = jnp.where(eligible, (viol * viol) / w,
                                  -jnp.inf)
                s_price = jnp.argmax(score, axis=-1)
            else:
                s_price = jnp.argmax(viol, axis=-1)
            s_bland = jnp.argmax(eligible, axis=-1)
            s = jnp.where(use_bland, s_bland, s_price)
            optimal = ~jnp.any(eligible, axis=-1)

            s_from_up = jnp.take_along_axis(
                at_upper, s[:, None], axis=1)[:, 0]
            sigma = jnp.where(s_from_up, -1.0, 1.0).astype(T.dtype)
            rc_s = jnp.take_along_axis(rc, s[:, None], axis=1)[:, 0]
            ub_s = jnp.take_along_axis(ub, s[:, None], axis=1)[:, 0]
            ub_s_safe = jnp.where(jnp.isfinite(ub_s), ub_s, 0.0)

            d = _gather_col(T, s)[:, :-1]
            dd = sigma[:, None] * d
            xB = T[:, :-1, -1]
            pos = dd > tol
            neg = (dd < -tol) & jnp.isfinite(ub_B)
            xB_c = jnp.maximum(xB, 0.0)
            span_c = jnp.maximum(ub_B - xB, 0.0)
            t_lo = jnp.where(pos, xB_c / jnp.where(pos, dd, 1.0),
                             jnp.inf)
            t_hi = jnp.where(neg, span_c / jnp.where(neg, -dd, 1.0),
                             jnp.inf)
            t_row = jnp.minimum(t_lo, t_hi)
            cand = pos | neg
            min_row = jnp.min(t_row, axis=-1)
            theta = jnp.minimum(min_row, ub_s)
            unbounded = (~optimal) & jnp.isinf(theta)
            flip = (~optimal) & (~unbounded) & (ub_s <= min_row)
            theta_safe = jnp.where(jnp.isfinite(theta), theta, 0.0)

            delta_lo = tol * (1.0 + jnp.abs(xB))
            delta_hi = tol * (1.0 + jnp.abs(ub_B - xB))
            t_lo_rel = jnp.where(pos, (xB_c + delta_lo) /
                                 jnp.where(pos, dd, 1.0), jnp.inf)
            t_hi_rel = jnp.where(neg, (span_c + delta_hi) /
                                 jnp.where(neg, -dd, 1.0), jnp.inf)
            theta_max = jnp.min(jnp.minimum(t_lo_rel, t_hi_rel),
                                axis=-1)
            harris_cand = cand & (t_row <= theta_max[:, None])
            hval = jnp.where(harris_cand, jnp.abs(dd), -jnp.inf)
            r_harris = jnp.argmax(hval, axis=-1)
            eps = jnp.finfo(T.dtype).eps
            near = cand & (
                t_row <= (min_row + 64.0 * eps
                          * (1.0 + jnp.abs(min_row)))[:, None])
            tie_key = jnp.where(near, basis, _INT_MAX)
            r_bland = jnp.argmin(tie_key, axis=-1)
            r = jnp.where(use_bland, r_bland, r_harris)
            t_lo_r = jnp.take_along_axis(t_lo, r[:, None],
                                         axis=1)[:, 0]
            t_hi_r = jnp.take_along_axis(t_hi, r[:, None],
                                         axis=1)[:, 0]
            leave_up = t_hi_r < t_lo_r

            moving = live & ~optimal & ~unbounded
            do_pivot = moving & ~flip
            do_flip = moving & flip
            if devex:
                w = _devex_update_b(w, T, basis, r, s, do_pivot)

            z_min_old = -T[:, -1, -1]
            xB_flip = jnp.clip(xB - dd * ub_s_safe[:, None], 0.0,
                               ub_B)
            z_flip = z_min_old + sigma * rc_s * ub_s_safe
            s_hot = col_idx == s[:, None]
            at_upper_flip = jnp.where(s_hot, ~at_upper, at_upper)

            x_enter = jnp.where(s_from_up, ub_s_safe - theta_safe,
                                theta_safe)
            xB_piv = xB - dd * theta_safe[:, None]
            row_hot = jax.nn.one_hot(r, T.shape[1] - 1, dtype=bool,
                                     axis=-1)
            xB_piv = jnp.where(row_hot, x_enter[:, None], xB_piv)
            z_piv = z_min_old + sigma * rc_s * theta_safe
            j_out = jnp.take_along_axis(basis, r[:, None],
                                        axis=1)[:, 0]
            T_upd, basis_upd = _pivot_update_b(T, basis, r, s,
                                               do_pivot)
            upd_row = do_pivot[:, None] & row_hot
            ub_B = jnp.where(upd_row, ub_s[:, None], ub_B)
            xB_piv = jnp.clip(xB_piv, 0.0, ub_B)
            rhs_new = jnp.where(
                do_pivot[:, None], xB_piv,
                jnp.where(do_flip[:, None], xB_flip, xB))
            T_upd = T_upd.at[:, :-1, -1].set(rhs_new)
            z_new = jnp.where(do_pivot, z_piv,
                              jnp.where(do_flip, z_flip, z_min_old))
            T_upd = T_upd.at[:, -1, -1].set(-z_new)
            jout_hot = col_idx == j_out[:, None]
            at_up_piv = jnp.where(jout_hot, leave_up[:, None],
                                  at_upper)
            at_up_piv = jnp.where(s_hot, False, at_up_piv)
            at_upper = jnp.where(
                do_pivot[:, None], at_up_piv,
                jnp.where(do_flip[:, None], at_upper_flip, at_upper))
            T = T_upd
            basis = basis_upd

            want_stop = (optimal | unbounded) & live
            status = jnp.where(
                want_stop & optimal, STATUS_OPTIMAL,
                jnp.where(want_stop & unbounded, STATUS_UNBOUNDED, status))
            pivots = pivots + moving.astype(pivots.dtype)
            obj_b = -T[:, -1, -1]
            improved = obj_b < best_obj - tol * (1.0 + jnp.abs(best_obj))
            best_obj = jnp.minimum(best_obj, obj_b)
            no_imp = jnp.where(improved, 0,
                               no_imp + moving.astype(no_imp.dtype))
            return (T, basis, at_upper, status, iters + 1, chunk + 1,
                    pivots, best_obj, no_imp, w, ub_B, is_art_row)

        def icond(state):
            status, iters, chunk = state[3], state[4], state[5]
            return (jnp.any(status == RUNNING) & (iters < max_iters)
                    & (chunk < refactor_every))

        def ocond(state):
            status, iters = state[3], state[4]
            return jnp.any(status == RUNNING) & (iters < max_iters)

        def obody(state):
            state = lax.while_loop(
                icond, istep, state[:5] + (jnp.int32(0),) + state[6:])
            (T, basis, at_upper, status, iters, chunk, pivots, best_obj,
             no_imp, w, ub_B, is_art_row) = state
            cont = jnp.any(status == RUNNING) & (iters < max_iters)
            T = lax.cond(
                cont,
                lambda T: _refactor_bounded_b(T, basis, at_upper, ub,
                                              T0_rows, obj_row_p2,
                                              status == RUNNING),
                lambda T: T, T)
            return (T, basis, at_upper, status, iters, chunk, pivots,
                    best_obj, no_imp, w, ub_B, is_art_row)

        state0 = (T0, basis0, jnp.zeros((Bsz, N), bool),
                  jnp.full((Bsz,), RUNNING, jnp.int32),
                  jnp.int32(0), jnp.int32(0),
                  jnp.zeros((Bsz,), jnp.int32),
                  jnp.full((Bsz,), jnp.inf, T0.dtype),
                  jnp.zeros((Bsz,), jnp.int32),
                  jnp.ones((Bsz, N), T0.dtype),
                  jnp.take_along_axis(ub, basis0, axis=1),
                  jnp.take_along_axis(art_mask_ext, basis0, axis=1))
        (T, basis, at_upper, status, iters, _, pivots, _, _, _, _,
         _) = lax.while_loop(ocond, obody, state0)
        T = _refine_solution_bounded_b(T, basis, basis0, T0_rows,
                                       obj_row_p2, at_upper, ub)
        status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT,
                           status)
        return T, basis, at_upper, status, iters, pivots

    def cond(state):
        status, iters = state[4], state[5]
        return jnp.any(status == RUNNING) & (iters < max_iters)

    def body(state):
        (T, basis, at_upper, phase, status, iters, since_ref, pivots,
         best_obj, no_imp, w, ub_B, is_art_row) = state
        live = status == RUNNING
        in_p1 = phase == 1
        col_mask = jnp.where(in_p1[:, None], col_mask_p1, col_mask_p2)
        raw_obj = jnp.where(in_p1[:, None], obj_row_p1, obj_row_p2)
        use_bland = no_imp >= bland_after

        do_refactor = since_ref >= refactor_every
        T = lax.cond(
            do_refactor,
            lambda T: _refactor_bounded_b(T, basis, at_upper, ub, T0_rows,
                                          raw_obj, live),
            lambda T: T,
            T,
        )

        # ---- pricing: dual-infeasibility over BOTH bounds --------- #
        rc = T[:, -1, :-1]
        elig_lo = col_mask & ~at_upper & (rc < -tol)
        elig_up = col_mask & at_upper & (rc > tol)
        eligible = elig_lo | elig_up
        viol = jnp.where(eligible, jnp.abs(rc), -jnp.inf)
        if devex:
            score = jnp.where(eligible, (viol * viol) / w, -jnp.inf)
            s_price = jnp.argmax(score, axis=-1)
        else:
            s_price = jnp.argmax(viol, axis=-1)
        s_bland = jnp.argmax(eligible, axis=-1)
        s = jnp.where(use_bland, s_bland, s_price)
        optimal = ~jnp.any(eligible, axis=-1)

        s_from_up = jnp.take_along_axis(
            at_upper, s[:, None], axis=1)[:, 0]
        sigma = jnp.where(s_from_up, -1.0, 1.0).astype(T.dtype)  # (B,)
        rc_s = jnp.take_along_axis(rc, s[:, None], axis=1)[:, 0]
        ub_s = jnp.take_along_axis(ub, s[:, None], axis=1)[:, 0]
        ub_s_safe = jnp.where(jnp.isfinite(ub_s), ub_s, 0.0)

        # ---- bounded ratio test ----------------------------------- #
        d = _gather_col(T, s)[:, :-1]                         # (B, m)
        dd = sigma[:, None] * d
        xB = T[:, :-1, -1]
        # ub_B / is_art_row are CARRIED state (updated at the pivot
        # row, refreshed on phase flips): the per-iteration lane-axis
        # take_along_axis gathers they replace were a visible slice of
        # the bounded kernel's 2x cost over the classic one (round 4).
        pos = dd > tol
        neg = (dd < -tol) & jnp.isfinite(ub_B)
        art_exit = (~in_p1)[:, None] & is_art_row & (jnp.abs(dd) > tol)
        # Backward-step clamps on BOTH limits (see ops/tableau).
        xB_c = jnp.maximum(xB, 0.0)
        span_c = jnp.maximum(ub_B - xB, 0.0)
        t_lo = jnp.where(pos, xB_c / jnp.where(pos, dd, 1.0), jnp.inf)
        t_lo = jnp.where(art_exit, 0.0, t_lo)
        t_hi = jnp.where(neg, span_c / jnp.where(neg, -dd, 1.0),
                         jnp.inf)
        t_row = jnp.minimum(t_lo, t_hi)
        cand = pos | neg | art_exit
        min_row = jnp.min(t_row, axis=-1)
        theta = jnp.minimum(min_row, ub_s)
        unbounded = (~optimal) & jnp.isinf(theta)
        flip = (~optimal) & (~unbounded) & (ub_s <= min_row)
        theta_safe = jnp.where(jnp.isfinite(theta), theta, 0.0)

        # Harris two-pass over BOTH limits: relax each by the
        # feasibility tolerance, largest |pivot| inside the window.
        delta_lo = tol * (1.0 + jnp.abs(xB))
        delta_hi = tol * (1.0 + jnp.abs(ub_B - xB))
        t_lo_rel = jnp.where(pos, (xB_c + delta_lo) /
                             jnp.where(pos, dd, 1.0), jnp.inf)
        t_hi_rel = jnp.where(neg, (span_c + delta_hi) /
                             jnp.where(neg, -dd, 1.0), jnp.inf)
        theta_max = jnp.min(jnp.minimum(t_lo_rel, t_hi_rel), axis=-1)
        harris_cand = (cand & (t_row <= theta_max[:, None])) | art_exit
        hval = jnp.where(harris_cand,
                         jnp.abs(dd) + jnp.where(art_exit, _ART, 0.0),
                         -jnp.inf)
        r_harris = jnp.argmax(hval, axis=-1)
        eps = jnp.finfo(T.dtype).eps
        near = cand & (
            t_row <= (min_row + 64.0 * eps
                      * (1.0 + jnp.abs(min_row)))[:, None])
        tie_key = jnp.where(near, basis, _INT_MAX)
        r_bland = jnp.argmin(tie_key, axis=-1)
        r = jnp.where(use_bland, r_bland, r_harris)
        t_lo_r = jnp.take_along_axis(t_lo, r[:, None], axis=1)[:, 0]
        t_hi_r = jnp.take_along_axis(t_hi, r[:, None], axis=1)[:, 0]
        leave_up = t_hi_r < t_lo_r

        want_stop = (optimal | unbounded) & live

        # --- Phase-1 completion ----------------------------------------- #
        p1_done = want_stop & in_p1
        p1_obj = -T[:, -1, -1]
        infeasible = p1_done & (p1_obj > feas_tol * b_scale)
        to_p2 = p1_done & ~infeasible

        def flip_phase(args):
            T, basis, phase, ub_B, is_art_row = args
            T_ev, basis_ev = _evict_artificials_bounded_b(
                T, basis, at_upper, art_mask_ext, col_mask_p2, tol)
            # Eviction re-bases rows: refresh the carried per-row state
            # (runs only on flip iterations — once or twice per solve).
            ub_ev = jnp.take_along_axis(ub, basis_ev, axis=1)
            art_ev = jnp.take_along_axis(art_mask_ext, basis_ev, axis=1)
            ub_B = jnp.where(to_p2[:, None], ub_ev, ub_B)
            is_art_row = jnp.where(to_p2[:, None], art_ev, is_art_row)
            T_p2 = _price_out_b(T_ev, basis_ev, obj_row_p2)
            # Objective cell must include the at-upper contributions the
            # generic price-out cannot know about.
            cB = jnp.take_along_axis(obj_row_p2, basis_ev, axis=1)
            z_min = jnp.sum(cB * T_p2[:, :-1, -1], axis=-1) + jnp.sum(
                jnp.where(at_upper, obj_row_p2[:, :-1] * ub_safe, 0.0),
                axis=-1)
            T_p2 = T_p2.at[:, -1, -1].set(-z_min)
            T = jnp.where(to_p2[:, None, None], T_p2, T)
            basis = jnp.where(to_p2[:, None], basis_ev, basis)
            phase = jnp.where(to_p2, jnp.int32(2), phase)
            return T, basis, phase, ub_B, is_art_row

        T, basis, phase, ub_B, is_art_row = lax.cond(
            jnp.any(to_p2), flip_phase, lambda a: a,
            (T, basis, phase, ub_B, is_art_row)
        )

        # --- Terminal statuses ------------------------------------------ #
        finish_p2 = want_stop & ~in_p1
        status = jnp.where(
            infeasible, STATUS_INFEASIBLE,
            jnp.where(finish_p2 & optimal, STATUS_OPTIMAL,
                      jnp.where(finish_p2 & unbounded, STATUS_UNBOUNDED,
                                status)),
        )

        moving = (status == RUNNING) & ~to_p2 & live & ~optimal & ~unbounded
        do_pivot = moving & ~flip
        do_flip = moving & flip

        if devex:
            w = _devex_update_b(w, T, basis, r, s, do_pivot)

        # --- BOUND FLIP: no basis change, O(m) state update --------- #
        z_min_old = -T[:, -1, -1]
        xB_flip = jnp.clip(xB - dd * ub_s_safe[:, None], 0.0, ub_B)
        z_flip = z_min_old + sigma * rc_s * ub_s_safe
        s_hot = col_idx == s[:, None]                      # (B, n)
        at_upper_flip = jnp.where(s_hot, ~at_upper, at_upper)

        # --- PIVOT: rank-1 on B^{-1}A + rc; explicit RHS/objective -- #
        x_enter = jnp.where(s_from_up, ub_s_safe - theta_safe,
                            theta_safe)
        xB_piv = xB - dd * theta_safe[:, None]
        row_hot = jax.nn.one_hot(r, T.shape[1] - 1, dtype=bool, axis=-1)
        xB_piv = jnp.where(row_hot, x_enter[:, None], xB_piv)
        z_piv = z_min_old + sigma * rc_s * theta_safe
        j_out = jnp.take_along_axis(basis, r[:, None], axis=1)[:, 0]
        T_upd, basis_upd = _pivot_update_b(T, basis, r, s, do_pivot)
        # Overwrite the RHS column / objective cell with the bounded-
        # semantics values (the rank-1 RHS formula assumes
        # leave-at-zero).
        is_art_s = jnp.take_along_axis(
            art_mask_ext, s[:, None], axis=1)[:, 0]
        upd_row = do_pivot[:, None] & row_hot
        ub_B_new = jnp.where(upd_row, ub_s[:, None], ub_B)
        is_art_row = jnp.where(upd_row, is_art_s[:, None], is_art_row)
        ub_B = ub_B_new
        xB_piv = jnp.clip(xB_piv, 0.0, ub_B_new)
        # Fallback = the CURRENT (possibly phase-flipped) state, not
        # the pre-flip xB/z snapshot — do_pivot/do_flip are disjoint
        # from to_p2, so the moving instances' snapshots are still
        # current.
        cur_rhs = T[:, :-1, -1]
        cur_z = -T[:, -1, -1]
        rhs_new = jnp.where(
            do_pivot[:, None], xB_piv,
            jnp.where(do_flip[:, None], xB_flip, cur_rhs))
        T_upd = T_upd.at[:, :-1, -1].set(rhs_new)
        z_new = jnp.where(do_pivot, z_piv,
                          jnp.where(do_flip, z_flip, cur_z))
        T_upd = T_upd.at[:, -1, -1].set(-z_new)
        # at-upper bookkeeping: leaving variable exits at its bound;
        # entering/flipping column toggles.
        jout_hot = col_idx == j_out[:, None]
        at_up_piv = jnp.where(jout_hot, leave_up[:, None], at_upper)
        at_up_piv = jnp.where(s_hot, False, at_up_piv)
        at_upper = jnp.where(do_pivot[:, None], at_up_piv,
                             jnp.where(do_flip[:, None], at_upper_flip,
                                       at_upper))
        T = T_upd
        basis = basis_upd
        pivots = pivots + moving.astype(pivots.dtype)

        # Objective-progress tracking (min-form objective non-increasing).
        obj_b = -T[:, -1, -1]
        improved = obj_b < best_obj - tol * (1.0 + jnp.abs(best_obj))
        best_obj = jnp.minimum(best_obj, obj_b)
        no_imp = jnp.where(improved, 0,
                           no_imp + moving.astype(no_imp.dtype))
        inf_ = jnp.asarray(jnp.inf, best_obj.dtype)
        best_obj = jnp.where(to_p2, inf_, best_obj)
        no_imp = jnp.where(to_p2, 0, no_imp)
        if devex:
            w = jnp.where(to_p2[:, None], 1.0, w)

        since_ref = jnp.where(do_refactor, jnp.int32(1), since_ref + 1)
        return (T, basis, at_upper, phase, status, iters + 1, since_ref,
                pivots, best_obj, no_imp, w, ub_B, is_art_row)

    state0 = (
        T0, basis0, jnp.zeros((Bsz, N), bool), phase0,
        jnp.full((Bsz,), RUNNING, jnp.int32),
        jnp.int32(0), jnp.int32(1),
        jnp.zeros((Bsz,), jnp.int32),
        jnp.full((Bsz,), jnp.inf, T0.dtype),
        jnp.zeros((Bsz,), jnp.int32),
        jnp.ones((Bsz, N), T0.dtype),
        jnp.take_along_axis(ub, basis0, axis=1),
        jnp.take_along_axis(art_mask_ext, basis0, axis=1),
    )
    (T, basis, at_upper, phase, status, iters, _, pivots, _, _, _, _,
     _) = lax.while_loop(cond, body, state0)

    raw_obj = jnp.where((phase == 1)[:, None], obj_row_p1, obj_row_p2)
    T = _refine_solution_bounded_b(T, basis, basis0, T0_rows, raw_obj,
                                   at_upper, ub)
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)
    return T, basis, at_upper, status, iters, pivots


def extract_solution_batch_bounded(T, basis, at_upper, ub, n_vars: int):
    """Decision-variable recovery with bounds: basic rows' RHS plus the
    at-upper nonbasic columns sitting AT their bound."""
    rhs = T[:, :-1, -1]
    onehot = basis[:, :, None] == jnp.arange(n_vars,
                                             dtype=basis.dtype)[None, None, :]
    x = jnp.sum(jnp.where(onehot, rhs[:, :, None], 0.0), axis=1)
    ub_safe = jnp.where(jnp.isfinite(ub[:, :n_vars]), ub[:, :n_vars], 0.0)
    x = jnp.where(at_upper[:, :n_vars], ub_safe, x)
    z_min = -T[:, -1, -1]
    return x, z_min


def extract_solution_batch(T, basis, n_vars: int):
    """Batched decision-variable recovery: x from basic rows' RHS."""
    rhs = T[:, :-1, -1]                                           # (B, m)
    onehot = basis[:, :, None] == jnp.arange(n_vars,
                                             dtype=basis.dtype)[None, None, :]
    x = jnp.sum(jnp.where(onehot, rhs[:, :, None], 0.0), axis=1)  # (B, n)
    z_min = -T[:, -1, -1]
    return x, z_min
