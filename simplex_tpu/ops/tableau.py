"""Dense tableau-simplex kernels (single-chip, jitted, static shapes).

This module is the device replacement for both of the reference's solve
engines: scipy/HiGHS's C++ dual simplex (``solver_controller.py:78-85``) and
the pure-Python ``simple_simplex`` tableau loop (``:290-319``).  Everything is
expressed as masked, fixed-shape JAX so it compiles once per shape bucket and
runs entirely on device:

* Dantzig pricing  = masked argmin over the reduced-cost row,
  with a Bland's-rule fallback after ``bland_after`` iterations (anti-cycling);
* ratio test       = masked argmin with basis-index tie-breaking;
* pivot update     = rank-1 row-reduction over the whole tableau
  (the memory-bound hot op);
* two phases       = phase 1 minimizes artificial infeasibility, phase 2 the
  real objective with artificial columns masked out.

Tableau convention (min form): ``T[:-1]`` are constraint rows with RHS in the
last column; ``T[-1]`` holds reduced costs with ``T[-1, -1] == -z``.
Optimality: all masked reduced costs ≥ -tol.

Every contraction states ``precision=HIGHEST``: a float32 product may run in
TF32 on the GPU (about 10 mantissa bits).
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

RUNNING = -1  # internal sentinel while the pivot loop is active

_INT_MAX = jnp.iinfo(jnp.int32).max
_HI = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def select_pivot(T, basis, col_mask, tol, use_bland, weights=None):
    """Choose the entering column and leaving row.

    Returns ``(col, row, optimal, unbounded)``.  Data-dependent control flow is
    expressed as masked argmins so the whole step stays inside one XLA program
    (SURVEY.md §7 "degeneracy & cycling ... masked argmins").

    ``weights`` (optional, (n,)): Devex reference weights — pricing becomes
    ``argmax rc^2 / w`` over eligible columns (approximate steepest edge,
    Forrest-Goldfarb), which typically needs far fewer pivots than Dantzig
    on large problems.  Bland's rule still overrides for anti-cycling.
    """
    rc = jnp.where(col_mask, T[-1, :-1], jnp.inf)
    eligible = rc < -tol

    if weights is None:
        s_price = jnp.argmin(rc)
    else:
        score = jnp.where(eligible, (rc * rc) / weights, -jnp.inf)
        s_price = jnp.argmax(score)
    s_bland = jnp.argmax(eligible)  # first eligible index
    s = jnp.where(use_bland, s_bland, s_price)

    optimal = ~jnp.any(eligible)

    col = T[:-1, s]
    rhs = T[:-1, -1]
    positive = col > tol
    # Never step backward: Harris-relaxed pivots leave tolerance-level
    # NEGATIVE rhs entries; unclamped, those rows later produce negative
    # ratios and the "minimum ratio" pivot steps BACKWARD (objective
    # worsens, infeasibility feeds back and amplifies through tiny
    # pivots — seen as runaway objectives on the round-4 adversarial
    # corpus).  Clamped, such rows exit at theta = 0 (degenerate pivot),
    # which restores their feasibility.
    rhs_c = jnp.maximum(rhs, 0.0)
    ratios = jnp.where(positive, rhs_c / jnp.where(positive, col, 1.0),
                       jnp.inf)
    min_ratio = jnp.min(ratios)
    unbounded = (~optimal) & jnp.isinf(min_ratio)

    # Harris two-pass ratio test (stability): pass 1 bounds the step by the
    # tol-relaxed minimum ratio; pass 2 picks the LARGEST pivot element among
    # rows whose exact ratio fits under that bound.  Tiny pivot elements
    # (barely above ``tol``) are what turn the basis near-singular and let
    # f32 refactorization certify false verdicts — e.g. on split-variable
    # (x = x+ - x-) LPs whose columns come in exact ± pairs.  The basic
    # variables other than the leaving one drift at most ``delta`` negative
    # per pivot, which the periodic exact refactorization re-zeroes.
    delta = tol * (1.0 + jnp.abs(rhs))
    theta_relax = jnp.where(positive,
                            (rhs_c + delta) / jnp.where(positive, col, 1.0),
                            jnp.inf)
    theta_max = jnp.min(theta_relax)
    cand = positive & (ratios <= theta_max)
    r_harris = jnp.argmax(jnp.where(cand, col, -jnp.inf))

    # Bland mode: smallest basis index among near-minimal ratios (the row
    # rule Bland's termination proof needs).  The tie window stays at
    # round-off scale — admitting a strictly larger ratio would void the
    # anti-cycling guarantee.
    eps = jnp.finfo(T.dtype).eps
    near = ratios <= min_ratio + 64.0 * eps * (1.0 + jnp.abs(min_ratio))
    tie_key = jnp.where(near & positive, basis, _INT_MAX)
    r_bland = jnp.argmin(tie_key)
    r = jnp.where(use_bland, r_bland, r_harris)
    return s, r, optimal, unbounded


def pivot_update(T, basis, r, s, clamp_rhs: bool = False):
    """Rank-1 row-reduction pivot: eliminate column ``s`` against row ``r``.

    This is the per-iteration O(m·n) memory-bound operation that
    BASELINE.json targets at ≥80% of roofline.  Formulated as ONE fused
    elementwise pass (rank-1 update + pivot-row override + unit-column
    override all via broadcasted ``where`` masks) so XLA emits a single
    read+write stream over the tableau, instead of the extra full-array
    passes a scatter (``.at[].set``) formulation compiles into.
    """
    M, N = T.shape
    pivot = T[r, s]
    inv = 1.0 / pivot
    piv_row = lax.dynamic_slice(T, (r, 0), (1, N)) * inv        # (1, N)
    if clamp_rhs:
        # Execute the clamped step theta = max(rhs_r, 0)/pivot (primal
        # pivots have pivot > tol): the ratio test already treats
        # tolerance-negative rhs rows as theta = 0 ties, and executing
        # the raw negative theta instead walks every other row backward
        # — the tolerance debt then amplifies through small pivots
        # (EXPAND-style shifting; round-4 adversarial corpus find).
        piv_row = piv_row.at[0, N - 1].set(
            jnp.maximum(piv_row[0, N - 1], 0.0))
    col = lax.dynamic_slice(T, (0, s), (M, 1))                  # (M, 1)
    is_r = lax.broadcasted_iota(jnp.int32, (M, 1), 0) == r
    is_s = lax.broadcasted_iota(jnp.int32, (1, N), 1) == s
    T_new = T - col * piv_row                                   # rank-1
    T_new = jnp.where(is_r, piv_row, T_new)
    # Exact unit column for numerical hygiene.
    T_new = jnp.where(is_s, jnp.where(is_r, 1.0, 0.0).astype(T.dtype), T_new)
    basis = basis.at[r].set(s.astype(basis.dtype))
    return T_new, basis


def refactor_tableau(T0_rows, basis, raw_obj):
    """Recompute the tableau exactly from the original data and current basis.

    ``T_rows = B⁻¹ · T0_rows`` with ``B = T0_rows[:, basis]`` (dense LU solve
    on device), then re-price the raw objective row.  This bounds
    float32 round-off drift over long pivot sequences — the same role
    basis refactorization plays in production simplex codes (cf. PAPERS.md
    revised-simplex references).  Falls back to the old tableau if the basis
    matrix is numerically singular.
    """
    B = jnp.take(T0_rows, basis, axis=1)
    T_rows = jnp.linalg.solve(B, T0_rows)
    obj = raw_obj - _mm(raw_obj[basis], T_rows)
    T_new = jnp.concatenate([T_rows, obj[None, :]], axis=0)
    return T_new


def _devex_update(w, T, basis, r, s):
    """Forrest-Goldfarb Devex weight update for pivot (r, s).

    ``alpha_j = T[r, j] / T[r, s]`` (the transformed pivot row);
    ``w_j <- max(w_j, alpha_j^2 * w_s)`` for every column, the leaving
    variable restarts at ``max(w_s / alpha_s^2, 1) = max(w_s/1, 1)`` in the
    normalized row, and the whole reference framework resets to 1 when the
    weights overflow their useful range.
    """
    piv_row = T[r, :-1]
    alpha = piv_row / piv_row[s]
    w_s = w[s]
    w_new = jnp.maximum(w, (alpha * alpha) * w_s)
    j_out = basis[r]
    w_new = w_new.at[j_out].set(jnp.maximum(w_s, 1.0))
    w_new = w_new.at[s].set(1.0)
    return jnp.where(jnp.max(w_new) > 1e8, jnp.ones_like(w_new), w_new)


def _run_phase(T, basis, col_mask, T0_rows, raw_obj,
               tol, max_iters, bland_after, refactor_every, iters0,
               devex: bool = False):
    """Pivot until optimal/unbounded/iteration-cap via ``lax.while_loop``.

    Numerics: the tableau is refactorized from the original data every
    ``refactor_every`` pivots, and a terminal verdict (optimal/unbounded) is
    only accepted when the tableau is freshly refactorized — otherwise the
    loop refactorizes and re-tests ("confirm before exit").
    """

    # Numeric-stall cutoff: Bland's rule guarantees termination in exact
    # arithmetic, but f32 drift can fake eligible columns forever.  After
    # this many consecutive non-improving pivots (Bland engaged at
    # ``bland_after``, then a full anti-cycling budget on top) the loop
    # exits as ITERATION_LIMIT and the driver escalates to host f64.
    stall_limit = bland_after + 1024

    def cond(state):
        _, _, iters, status, _, _, _, _, no_imp = state
        return ((status == RUNNING) & (iters < max_iters)
                & (no_imp < stall_limit))

    def body(state):
        T, basis, iters, _, since_ref, stall, best_obj, w, no_imp = state
        # Stall-gated Bland: engage Bland's rule only after ``bland_after``
        # consecutive pivots WITHOUT objective improvement, and fall back to
        # Dantzig/Devex as soon as progress resumes.  Any cycle is
        # improvement-free, so the anti-cycling guarantee is preserved, while
        # large non-degenerate solves never pay Bland's slow pivot sequences
        # (a permanent iteration-count switch measured 11k+ pivots where
        # Devex needs 2.5k on a 1024x1024 dense LP).
        use_bland = no_imp >= bland_after
        s, r, optimal, unbounded = select_pivot(
            T, basis, col_mask, tol, use_bland,
            weights=w if devex else None)
        want_stop = optimal | unbounded
        fresh = since_ref == 0

        # branch 0: accept terminal verdict; 1: refactorize and re-test;
        # branch 2: pivot.  A marginal reduced cost (≈ -tol) can flip the
        # verdict back and forth across refactorizations forever (degenerate
        # livelock); ``stall`` counts confirm-refactors with no objective
        # improvement and forces acceptance after 3.
        accept_now = want_stop & (fresh | (stall >= 3))
        branch = jnp.where(
            accept_now, 0,
            jnp.where(want_stop | (since_ref >= refactor_every), 1, 2),
        )

        def accept(args):
            T, basis, since_ref, w = args
            return T, basis, since_ref, w

        def do_refactor(args):
            T, basis, _, w = args
            T_new = refactor_tableau(T0_rows, basis, raw_obj)
            ok = jnp.all(jnp.isfinite(T_new))
            T = jnp.where(ok, T_new, T)
            return T, basis, jnp.int32(0), w

        def do_pivot(args):
            T, basis, since_ref, w = args
            if devex:
                w = _devex_update(w, T, basis, r, s)
            T, basis = pivot_update(T, basis, r, s, clamp_rhs=True)
            return T, basis, since_ref + 1, w

        T, basis, since_ref, w = lax.switch(
            branch, [accept, do_refactor, do_pivot], (T, basis, since_ref, w)
        )
        obj = -T[-1, -1]
        improved = obj < best_obj - tol * (1.0 + jnp.abs(best_obj))
        stall = jnp.where(improved, 0, stall + ((branch == 1) & want_stop))
        no_imp = jnp.where(improved, 0,
                           no_imp + (branch == 2).astype(no_imp.dtype))
        best_obj = jnp.minimum(best_obj, obj)
        status = jnp.where(
            branch == 0,
            jnp.where(optimal, STATUS_OPTIMAL, STATUS_UNBOUNDED),
            RUNNING,
        )
        iters = iters + (branch == 2).astype(iters.dtype)
        return T, basis, iters, status, since_ref, stall, best_obj, w, no_imp

    w0 = jnp.ones((T.shape[1] - 1,), T.dtype)
    # since_ref starts beyond the period so the very first verdict is also
    # confirmed against a fresh refactorization.
    T, basis, iters, status, _, _, _, _, _ = lax.while_loop(
        cond, body,
        (T, basis, iters0, jnp.int32(RUNNING), jnp.int32(1), jnp.int32(0),
         jnp.asarray(jnp.inf, T.dtype), w0, jnp.int32(0)),
    )
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)
    return T, basis, iters, status


def _price_out(T, basis, obj_row):
    """Install ``obj_row`` as the objective and price out the current basis.

    obj2 = obj_row - costs[basis] @ T_rows — a vec×mat contraction.
    """
    # ``basis`` may point at the RHS slot (dummy padding rows); that entry of
    # ``obj_row`` is zero, so the gather is safe without masking.
    basis_costs = obj_row[basis]
    obj2 = obj_row - _mm(basis_costs, T[:-1])
    return T.at[-1].set(obj2)


def _evict_artificials(T, basis, art_mask_ext, col_mask_p2, tol):
    """Pivot basic artificials out of the basis where possible.

    After phase 1, an artificial may remain basic at value zero.  For each such
    row, pivot on any eligible real column with a nonzero entry; if the row is
    all-zero on real columns it is redundant and left in place (it can never be
    selected by the ratio test afterwards).
    """
    m_rows = T.shape[0] - 1

    def body(i, state):
        T, basis = state
        is_art = art_mask_ext[basis[i]]
        row = lax.dynamic_slice_in_dim(T, i, 1, axis=0)[0]
        cand = col_mask_p2 & (jnp.abs(row[:-1]) > tol)
        # Largest-magnitude eligible entry: eviction pivots on zero-value
        # rows, so pivot size is pure numerical hygiene (a ~tol pivot here
        # would shear the whole tableau by ~1/tol).
        j = jnp.argmax(jnp.where(cand, jnp.abs(row[:-1]), -jnp.inf))
        can_pivot = is_art & jnp.any(cand)

        def do(args):
            T, basis = args
            return pivot_update(T, basis, i, j)

        return lax.cond(can_pivot, do, lambda a: a, (T, basis))

    return lax.fori_loop(0, m_rows, body, (T, basis))


@functools.partial(
    jax.jit,
    static_argnames=("need_phase1", "tol", "max_iters", "bland_after",
                     "feas_tol", "refactor_every", "devex"),
)
def solve_tableau(T0, basis0, col_mask_p1, col_mask_p2, obj_row_p1, obj_row_p2,
                  need_phase1: bool, tol: float = 1e-6,
                  max_iters: int = 16384, bland_after: int = 2048,
                  feas_tol: float = 1e-5, refactor_every: int = 64,
                  devex: bool = False):
    """Full two-phase dense simplex solve on one padded tableau.

    Drift control is the exact on-device LU refactorization
    (:func:`refactor_tableau`) every ``refactor_every`` pivots and before
    any terminal verdict is accepted.

    Returns ``(T, basis, status, iters)`` with scipy-compatible status codes
    (0 optimal, 1 iteration limit, 2 infeasible, 3 unbounded).
    """
    b_scale = 1.0 + jnp.max(jnp.abs(T0[:-1, -1]))
    iters0 = jnp.int32(0)
    T0_rows = T0[:-1]  # original constraint rows — refactorization anchor

    if need_phase1:
        T, basis, iters, status = _run_phase(
            T0, basis0, col_mask_p1, T0_rows, obj_row_p1,
            tol, max_iters, bland_after, refactor_every, iters0,
            devex=devex,
        )
        phase1_obj = -T[-1, -1]
        infeasible = phase1_obj > feas_tol * b_scale
        art_mask_ext = jnp.concatenate(
            [col_mask_p1 & ~col_mask_p2, jnp.zeros((1,), bool)]
        )
        T, basis = _evict_artificials(T, basis, art_mask_ext, col_mask_p2, tol)
        # Phase-1 "unbounded" cannot happen (objective bounded below by 0);
        # treat any non-optimal terminal state as the reported status.
        hard_fail = (status != STATUS_OPTIMAL)
    else:
        T, basis, iters = T0, basis0, iters0
        infeasible = jnp.bool_(False)
        hard_fail = jnp.bool_(False)
        status = jnp.int32(STATUS_OPTIMAL)

    T = _price_out(T, basis, obj_row_p2)
    T2, basis2, iters2, status2 = _run_phase(
        T, basis, col_mask_p2, T0_rows, obj_row_p2,
        tol, max_iters, bland_after, refactor_every, iters,
        devex=devex,
    )

    final_status = jnp.where(
        infeasible, STATUS_INFEASIBLE, jnp.where(hard_fail, status, status2)
    )
    return T2, basis2, final_status, iters2


def extract_solution(T, basis, n_vars: int):
    """Recover decision variables and the min-form objective from a tableau."""
    rhs = T[:-1, -1]
    onehot = basis[:, None] == jnp.arange(n_vars, dtype=basis.dtype)[None, :]
    x = jnp.sum(jnp.where(onehot, rhs[:, None], jnp.zeros_like(rhs)[:, None]),
                axis=0)
    z_min = -T[-1, -1]
    return x, z_min


# --------------------------------------------------------------------------- #
# Dual simplex: reoptimization from a dual-feasible basis                     #
# --------------------------------------------------------------------------- #
@functools.partial(
    jax.jit,
    static_argnames=("tol", "max_iters", "bland_after", "refactor_every",
                     "devex"),
)
def solve_tableau_dual(T0, basis0, col_mask, tol: float = 1e-6,
                       max_iters: int = 16384, bland_after: int = 2048,
                       refactor_every: int = 64, devex: bool = True):
    """Dual simplex pivots on a tableau with nonnegative reduced costs.

    The mirror image of the primal loop — the device counterpart of the
    reference's authoritative engine, HiGHS *dual* simplex
    (``solver_controller.py:83`` ``method='highs-ds'``).  Start state: a
    basis that is dual-feasible (``T[-1, :-1] >= -tol`` on eligible
    columns) but possibly primal-infeasible (negative RHS entries) — the
    situation after perturbing ``b`` under a previously-optimal basis.
    Per iteration, all masked arithmetic:

    * leaving row  = **dual Devex** (``devex=True``, default): maximize
      ``rhs_r² / w_r`` over infeasible rows, with Forrest-Goldfarb-style
      reference weights approximating the dual steepest-edge norms
      ``‖B⁻¹eᵣ‖²`` — the row pricing HiGHS's dual simplex uses, typically
      a large pivot-count reduction vs most-negative-RHS on problems
      where infeasibilities differ wildly in scale.  ``devex=False``
      falls back to most-negative-RHS (Dantzig-style);
    * entering col = masked argmin of ``rc_j / -T[r, j]`` over columns with
      ``T[r, j] < -tol`` (keeps the objective row nonnegative — dual
      feasibility is the loop invariant);
    * Bland fallback (lowest eligible column index + most-negative row),
      **stall-gated** like the primal phases: it engages only after
      ``bland_after`` consecutive pivots without dual-objective
      improvement and reverts as soon as progress resumes (cycles never
      improve, so the anti-cycling guarantee is intact — the same design
      as ``_run_phase``).

    Dual Devex weight update after a pivot on (r, s) with column
    ``α = T[:-1, s]`` (pre-pivot): ``w_i ← max(w_i, (α_i/α_r)² w_r)`` for
    ``i ≠ r`` and ``w_r ← max(w_r/α_r², 1)``; weights reset to 1 when they
    overflow past 1e8 and otherwise persist across refactorizations (they
    are reference approximations, not exact norms — a refactorization
    changes the tableau's numerical basis, not the pricing frame).

    Numerics mirror the primal loop too: the tableau is refactorized from
    the INPUT tableau's rows every ``refactor_every`` pivots (the input
    rows/objective are the drift anchor — reduced costs compose, so
    pricing out the input objective row against ``B_rel^{-1} T0_rows``
    yields the current reduced costs exactly), and a terminal verdict is
    only accepted from a freshly-refactorized tableau ("confirm before
    exit"), with a 3-strike stall escape against degenerate livelock.

    Returns ``(T, basis, status, iters)``: STATUS_OPTIMAL when the RHS is
    nonnegative (primal feasibility reached = optimality under the dual
    invariant), STATUS_INFEASIBLE when a negative row has no negative
    eligible entry (primal empty), STATUS_ITERATION_LIMIT otherwise.
    """
    T0_rows = T0[:-1]
    raw_obj = T0[-1]
    m = T0_rows.shape[0]
    dt = T0.dtype

    def cond(state):
        status, iters = state[3], state[2]
        return (status == RUNNING) & (iters < max_iters)

    def body(state):
        T, basis, iters, _, since_ref, stall, best_obj, no_imp, w = state
        rhs = T[:-1, -1]
        infeas = rhs < -tol
        use_bland = no_imp >= bland_after
        if devex:
            score = jnp.where(infeas, (rhs * rhs) / w, -jnp.inf)
            r_price = jnp.argmax(score)
        else:
            r_price = jnp.argmin(rhs)
        # Stall mode: deterministic most-negative row (argmin is unique up
        # to ties broken by lowest index — the Bland-style row rule).
        r = jnp.where(use_bland, jnp.argmin(rhs), r_price)
        primal_ok = ~jnp.any(infeas)

        row = T[r, :-1]
        eligible = col_mask & (row < -tol)
        no_pivot = ~jnp.any(eligible)

        rc = T[-1, :-1]
        safe = jnp.where(eligible, -row, 1.0)
        ratios = jnp.where(eligible, jnp.maximum(rc, 0.0) / safe, jnp.inf)
        # Harris-style stabilization (mirror of the primal ratio test):
        # among columns whose dual ratio is within the tol-relaxed window
        # of the minimum, enter the one with the LARGEST |pivot| — tiny
        # pivots are what drive the basis near-singular in f32.
        min_ratio = jnp.min(ratios)
        window = eligible & (
            ratios <= min_ratio + tol * (1.0 + jnp.abs(min_ratio)))
        s_harris = jnp.argmax(jnp.where(window, -row, -jnp.inf))
        s = jnp.where(use_bland, jnp.argmax(eligible), s_harris)

        want_stop = primal_ok | no_pivot
        fresh = since_ref == 0
        accept_now = want_stop & (fresh | (stall >= 3))
        branch = jnp.where(
            accept_now, 0,
            jnp.where(want_stop | (since_ref >= refactor_every), 1, 2),
        )

        def accept(args):
            return args

        def do_refactor(args):
            T, basis, _, w = args
            T_new = refactor_tableau(T0_rows, basis, raw_obj)
            ok = jnp.all(jnp.isfinite(T_new))
            T = jnp.where(ok, T_new, T)
            return T, basis, jnp.int32(0), w

        def do_pivot(args):
            T, basis, since_ref, w = args
            if devex:
                # Pre-pivot entering column; scatter-free masked update.
                alpha = _gather_col_single(T, s)[:-1]       # (m,)
                a_r = alpha[jnp.minimum(r, m - 1)]
                a_r = jnp.where(jnp.abs(a_r) > 0, a_r, 1.0)
                ratio2 = (alpha / a_r) ** 2
                w_r = w[jnp.minimum(r, m - 1)]
                is_r = jnp.arange(m) == r
                w_new = jnp.maximum(w, ratio2 * w_r)
                w_new = jnp.where(is_r, jnp.maximum(w_r / (a_r * a_r), 1.0),
                                  w_new)
                w = jnp.where(jnp.max(w_new) > 1e8, jnp.ones_like(w_new),
                              w_new)
            T, basis = pivot_update(T, basis, r, s)
            return T, basis, since_ref + 1, w

        T, basis, since_ref, w = lax.switch(
            branch, [accept, do_refactor, do_pivot],
            (T, basis, since_ref, w)
        )
        # Dual objective -T[-1,-1] is non-DEcreasing along dual pivots.
        obj = -T[-1, -1]
        improved = obj > best_obj + tol * (1.0 + jnp.abs(best_obj))
        stall = jnp.where(improved, 0, stall + ((branch == 1) & want_stop))
        no_imp = jnp.where(improved, 0,
                           no_imp + (branch == 2).astype(no_imp.dtype))
        best_obj = jnp.maximum(best_obj, obj)
        status = jnp.where(
            branch == 0,
            jnp.where(primal_ok, STATUS_OPTIMAL, STATUS_INFEASIBLE),
            RUNNING,
        )
        iters = iters + (branch == 2).astype(iters.dtype)
        return (T, basis, iters, status, since_ref, stall, best_obj, no_imp,
                w)

    # since_ref starts beyond the period so the first verdict is confirmed.
    T, basis, iters, status, _, _, _, _, _ = lax.while_loop(
        cond, body,
        (T0, basis0, jnp.int32(0), jnp.int32(RUNNING), jnp.int32(1),
         jnp.int32(0), jnp.asarray(-jnp.inf, dt), jnp.int32(0),
         jnp.ones((m,), dt)))
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)
    return T, basis, status, iters


def _gather_col_single(T, s):
    """Column ``T[:, s]`` (an exact index gather)."""
    return lax.dynamic_slice_in_dim(T, s, 1, axis=1)[:, 0]


@functools.partial(
    jax.jit,
    static_argnames=("tol", "max_iters", "bland_after", "refactor_every",
                     "devex"),
)
def solve_tableau_dual_bounded(T0, basis0, col_mask, ub, at_upper0,
                               tol: float = 1e-6, max_iters: int = 16384,
                               bland_after: int = 2048,
                               refactor_every: int = 64,
                               devex: bool = True):
    """Dual simplex with NATIVE bounds ``0 <= x <= ub`` (VERDICT r4 #4).

    The bounded mirror of :func:`solve_tableau_dual` — the capability
    HiGHS ``highs-ds`` provides behind the reference's
    ``solver_controller.py:83``: reoptimize a BOUNDED LP after an RHS
    change from the old (still dual-feasible) basis.  Primal feasibility
    is two-sided: a basic variable is infeasible BELOW 0 or ABOVE its
    upper bound; the leaving row is the largest violation (dual Devex
    scores ``viol² / w``).  With ``δ_r = +1`` for a below-lower leave and
    ``-1`` for an above-upper leave, the entering candidates over the
    sign-adjusted row ``row' = δ_r T[r, :]`` are at-LOWER columns with
    ``row' < -tol`` or at-UPPER columns with ``row' > +tol``; the dual
    ratio is ``|rc_j| / |row'_j|`` (dual feasibility: at-lower rc >= 0,
    at-upper rc <= 0 — both stay valid under the common minimum).

    The pivot itself stays the standard rank-1 update; bound semantics
    ride as TWO RHS-column axpys that preserve the invariant
    ``x_B = B^{-1}(b - A_U u_U)`` exactly (objective cell included, since
    the objective row's entry of a column j is rc_j):

    * entering from UPPER: pre-flip s down — ``T[:, -1] += T[:, s] u_s``;
    * leaving at UPPER (δ_r = -1): post-flip j_out up —
      ``T[:, -1] -= T'[:, j_out] u_jout`` with the POST-pivot column.

    ``T0``'s RHS column must hold the RAW ``b0`` (the drift anchor);
    the caller passes the effective starting tableau via the same array
    — refactorization rebuilds rows from T0 and re-subtracts the
    at-upper contributions.  ``at_upper0``: (n_cols,) bool, basic
    columns False.  Returns ``(T, basis, at_upper, status, iters)``.
    """
    T0_rows = T0[:-1]
    raw_obj = T0[-1]
    m = T0_rows.shape[0]
    n_cols = T0.shape[1] - 1
    dt = T0.dtype
    ub = jnp.asarray(ub, dt)
    ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)

    def _refactor_bounded(basis, at_upper):
        T_new = refactor_tableau(T0_rows, basis, raw_obj)
        u_vec = jnp.where(at_upper, ub_safe, 0.0)
        adj = _mm(T_new[:, :n_cols], u_vec)
        return T_new.at[:, -1].add(-adj)

    # Effective starting tableau: T0's rows under basis0, RHS adjusted for
    # the at-upper set (identical math to the periodic refactor, so the
    # caller only ships the anchor once).
    T_start = _refactor_bounded(basis0, at_upper0)
    T_start = jnp.where(jnp.all(jnp.isfinite(T_start)), T_start, T0)

    def cond(state):
        status, iters = state[4], state[3]
        return (status == RUNNING) & (iters < max_iters)

    def body(state):
        (T, basis, at_upper, iters, _, since_ref, stall, best_obj, no_imp,
         w) = state
        rhs = T[:-1, -1]
        ub_B = jnp.take(ub, basis)
        viol_lo = -rhs
        viol_up = jnp.where(jnp.isfinite(ub_B), rhs - ub_B, -jnp.inf)
        viol = jnp.maximum(viol_lo, viol_up)
        infeas = viol > tol
        use_bland = no_imp >= bland_after
        if devex:
            score = jnp.where(infeas, (viol * viol) / w, -jnp.inf)
            r_price = jnp.argmax(score)
        else:
            r_price = jnp.argmax(jnp.where(infeas, viol, -jnp.inf))
        r = jnp.where(use_bland,
                      jnp.argmax(jnp.where(infeas, viol, -jnp.inf)),
                      r_price)
        primal_ok = ~jnp.any(infeas)
        delta = jnp.where(viol_lo[r] >= viol_up[r], 1.0, -1.0).astype(dt)
        leave_up = delta < 0

        row = T[r, :-1]
        rowp = delta * row
        # Entering candidates must be NONBASIC.  The unbounded dual gets
        # this for free (a basic column's row-r entry is 0, and the
        # leaving column's own +1 fails ``row < -tol``), but with
        # delta = -1 the sign flip makes the LEAVING column itself pass
        # ``rowp < -tol`` at dual ratio 0 — a self-pivot that marks a
        # still-basic column at-upper and certifies a primal-infeasible
        # vertex (round-5 review finding, reproduced on RHS increases).
        basic_mask = jnp.zeros((n_cols,), bool).at[basis].set(True)
        elig_lo = col_mask & ~basic_mask & ~at_upper & (rowp < -tol)
        elig_up = col_mask & ~basic_mask & at_upper & (rowp > tol)
        eligible = elig_lo | elig_up
        no_pivot = ~jnp.any(eligible)

        rc = T[-1, :-1]
        num = jnp.where(at_upper, jnp.maximum(-rc, 0.0),
                        jnp.maximum(rc, 0.0))
        safe = jnp.where(eligible, jnp.abs(rowp), 1.0)
        ratios = jnp.where(eligible, num / safe, jnp.inf)
        min_ratio = jnp.min(ratios)
        window = eligible & (
            ratios <= min_ratio + tol * (1.0 + jnp.abs(min_ratio)))
        s_harris = jnp.argmax(jnp.where(window, jnp.abs(rowp), -jnp.inf))
        s = jnp.where(use_bland, jnp.argmax(eligible), s_harris)

        want_stop = primal_ok | no_pivot
        fresh = since_ref == 0
        accept_now = want_stop & (fresh | (stall >= 3))
        branch = jnp.where(
            accept_now, 0,
            jnp.where(want_stop | (since_ref >= refactor_every), 1, 2),
        )

        def accept(args):
            return args

        def do_refactor(args):
            T, basis, at_upper, _, w = args
            T_new = _refactor_bounded(basis, at_upper)
            ok = jnp.all(jnp.isfinite(T_new))
            T = jnp.where(ok, T_new, T)
            return T, basis, at_upper, jnp.int32(0), w

        def do_pivot(args):
            T, basis, at_upper, since_ref, w = args
            if devex:
                alpha = _gather_col_single(T, s)[:-1]
                a_r = alpha[jnp.minimum(r, m - 1)]
                a_r = jnp.where(jnp.abs(a_r) > 0, a_r, 1.0)
                ratio2 = (alpha / a_r) ** 2
                w_r = w[jnp.minimum(r, m - 1)]
                is_r = jnp.arange(m) == r
                w_new = jnp.maximum(w, ratio2 * w_r)
                w_new = jnp.where(
                    is_r, jnp.maximum(w_r / (a_r * a_r), 1.0), w_new)
                w = jnp.where(jnp.max(w_new) > 1e8, jnp.ones_like(w_new),
                              w_new)
            j_out = basis[r]
            # Pre-flip: an at-upper entering column first returns to its
            # lower bound (RHS += column * u_s; exact, obj cell included).
            s_up = at_upper[s]
            u_s = jnp.where(s_up, ub_safe[s], 0.0)
            col_s = _gather_col_single(T, s)
            T = T.at[:, -1].add(u_s * col_s)
            at_upper = at_upper.at[s].set(False)
            T, basis = pivot_update(T, basis, r, s)
            # Post-flip: a leave-at-upper variable parks AT its bound
            # (RHS -= post-pivot column * u_jout).
            u_out = jnp.where(leave_up, jnp.take(ub_safe, j_out), 0.0)
            col_out = _gather_col_single(T, j_out)
            T = T.at[:, -1].add(-u_out * col_out)
            at_upper = at_upper.at[j_out].set(leave_up)
            return T, basis, at_upper, since_ref + 1, w

        T, basis, at_upper, since_ref, w = lax.switch(
            branch, [accept, do_refactor, do_pivot],
            (T, basis, at_upper, since_ref, w)
        )
        obj = -T[-1, -1]
        improved = obj > best_obj + tol * (1.0 + jnp.abs(best_obj))
        stall = jnp.where(improved, 0, stall + ((branch == 1) & want_stop))
        no_imp = jnp.where(improved, 0,
                           no_imp + (branch == 2).astype(no_imp.dtype))
        best_obj = jnp.maximum(best_obj, obj)
        status = jnp.where(
            branch == 0,
            jnp.where(primal_ok, STATUS_OPTIMAL, STATUS_INFEASIBLE),
            RUNNING,
        )
        iters = iters + (branch == 2).astype(iters.dtype)
        return (T, basis, at_upper, iters, status, since_ref, stall,
                best_obj, no_imp, w)

    # since_ref starts at 0: T_start IS a fresh refactor, so an immediate
    # verdict is already confirmed.
    T, basis, at_upper, iters, status, _, _, _, _, _ = lax.while_loop(
        cond, body,
        (T_start, jnp.asarray(basis0), jnp.asarray(at_upper0),
         jnp.int32(0), jnp.int32(RUNNING), jnp.int32(0),
         jnp.int32(0), jnp.asarray(-jnp.inf, dt), jnp.int32(0),
         jnp.ones((m,), dt)))
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)
    return T, basis, at_upper, status, iters


# --------------------------------------------------------------------------- #
# History-capturing variant: fixed-length lax.scan emitting tableau snapshots #
# (the simple_simplex ``pivotSteps`` contract, solver_controller.py:290-363)  #
# --------------------------------------------------------------------------- #
@functools.partial(
    jax.jit,
    static_argnames=("need_phase1", "tol", "max_steps", "bland_after",
                     "feas_tol", "devex"),
)
def solve_tableau_history(T0, basis0, col_mask_p1, col_mask_p2, obj_row_p2,
                          need_phase1: bool, tol: float = 1e-6,
                          max_steps: int = 64, bland_after: int = 2048,
                          feas_tol: float = 1e-5, devex: bool = False):
    """Two-phase solve that records every pivot.

    Returns ``(T, basis, status, snapshots, pivots, valid)`` where
    ``snapshots[k]`` is the tableau BEFORE pivot k (so snapshot 0 is the
    initial tableau), ``pivots[k] = (row, col)`` the pivot applied to it, and
    ``valid[k]`` marks live steps.  Capped at ``max_steps`` — history capture
    is a presentation feature for small problems, exactly like the reference's
    simple_simplex Plan B.

    Pricing mirrors the production kernel (:func:`solve_tableau`): the same
    ``devex`` weights and the same stall-gated Bland switch, and the same
    ``feas_tol`` phase-1 verdict — so the recorded pivot sequence is the one
    the production solve actually takes (VERDICT r1 weak #3/#9: a separate
    Dantzig-only history could display a different vertex path, and a
    hardcoded 1e-4 threshold could disagree on marginal infeasibility).
    """

    def make_step(phase_idx):
        def step(carry, _):
            T, basis, status, iters, w, best_obj, no_imp = carry
            col_mask = col_mask_p1 if phase_idx == 1 else col_mask_p2
            use_bland = no_imp >= bland_after
            s, r, optimal, unbounded = select_pivot(
                T, basis, col_mask, tol, use_bland,
                weights=w if devex else None,
            )
            live = status == RUNNING
            new_status = jnp.where(
                ~live, status,
                jnp.where(optimal, STATUS_OPTIMAL,
                          jnp.where(unbounded, STATUS_UNBOUNDED, RUNNING)),
            )
            do = live & (new_status == RUNNING)

            def do_pivot(args):
                T, basis, w = args
                if devex:
                    w = _devex_update(w, T, basis, r, s)
                T, basis = pivot_update(T, basis, r, s, clamp_rhs=True)
                return T, basis, w

            T_next, basis_next, w = lax.cond(do, do_pivot, lambda a: a,
                                             (T, basis, w))
            iters = iters + do.astype(iters.dtype)
            obj = -T_next[-1, -1]
            improved = obj < best_obj - tol * (1.0 + jnp.abs(best_obj))
            no_imp = jnp.where(improved, 0, no_imp + do.astype(no_imp.dtype))
            best_obj = jnp.minimum(best_obj, obj)
            out = (T, jnp.where(do, r, -1), jnp.where(do, s, -1), do)
            return (T_next, basis_next, new_status, iters, w, best_obj,
                    no_imp), out

        return step

    w0 = jnp.ones((T0.shape[1] - 1,), T0.dtype)
    inf_ = jnp.asarray(jnp.inf, T0.dtype)
    state = (T0, basis0, jnp.int32(RUNNING), jnp.int32(0), w0, inf_,
             jnp.int32(0))
    if need_phase1:
        state, hist1 = lax.scan(make_step(1), state, None, length=max_steps)
        T, basis, status, iters, w, _, _ = state
        infeasible = -T[-1, -1] > feas_tol * (
            1.0 + jnp.max(jnp.abs(T0[:-1, -1])))
        art_mask_ext = jnp.concatenate(
            [col_mask_p1 & ~col_mask_p2, jnp.zeros((1,), bool)]
        )
        T, basis = _evict_artificials(T, basis, art_mask_ext, col_mask_p2, tol)
        status = jnp.where(infeasible, STATUS_INFEASIBLE,
                           jnp.where(status == STATUS_OPTIMAL, RUNNING, status))
        # Fresh phase: reset devex weights and the progress tracker.
        state = (_price_out(T, basis, obj_row_p2), basis, status, iters,
                 jnp.ones_like(w), inf_, jnp.int32(0))
    else:
        hist1 = None
        T, basis, status, iters = state[0], state[1], state[2], state[3]
        state = (_price_out(T, basis, obj_row_p2), basis, status, iters,
                 w0, inf_, jnp.int32(0))

    state, hist2 = lax.scan(make_step(2), state, None, length=max_steps)
    T, basis, status = state[0], state[1], state[2]
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)

    if hist1 is not None:
        snaps = jnp.concatenate([hist1[0], hist2[0]], axis=0)
        rows = jnp.concatenate([hist1[1], hist2[1]], axis=0)
        cols = jnp.concatenate([hist1[2], hist2[2]], axis=0)
        valid = jnp.concatenate([hist1[3], hist2[3]], axis=0)
    else:
        snaps, rows, cols, valid = hist2

    return T, basis, status, snaps, jnp.stack([rows, cols], axis=-1), valid
