"""Multi-chip sharded simplex: row-block partitioning with collectives.

BASELINE config 5 ("100k-constraint LP row-block sharded across a multi-host
pod with all-reduce pricing + ratio-test collectives").  The reference has no
distributed execution at all (SURVEY.md §2.4); this is the multi-device
scale path: constraint rows of the tableau live block-partitioned across the
``row`` mesh axis, independent LP instances across the ``batch`` axis.

Communication pattern per pivot (SURVEY.md §5.7):
  * pricing           — replicated (the objective row is replicated);
  * ratio test        — local masked min + ``lax.pmin`` over ``row``
                        (value), then a second ``pmin`` on a Bland row key
                        for the global tie-break;
  * pivot row         — ``lax.psum`` of the owner's normalized row
                        (a broadcast expressed as a masked all-reduce);
  * rank-1 update     — embarrassingly row-parallel, no communication.

So each iteration moves O(n_pad) floats between devices (one row + two
scalars; NVLink collectives within a host), while the O(m_loc * n_pad)
update runs at local device-memory bandwidth.

Numerics match the single-chip kernels (``ops/tableau.py`` /
``ops/batched.py``):

  * **Devex pricing** — the objective row is replicated, so the
    Forrest-Goldfarb reference weights are replicated too; the weight
    update needs only the (already broadcast) normalized pivot row plus one
    scalar ``psum`` for the leaving variable's column index.
  * **Stall-gated Bland** — per instance, Bland's rule engages only after
    ``bland_after`` consecutive pivots without objective improvement and
    reverts when progress resumes (cycles never improve, so anti-cycling
    is preserved; the permanent iteration-count switch this replaces is the
    design commit 2718582 measured at 6.5x more pivots).
  * **Periodic drift resync** — full distributed refactorization would need
    a distributed LU of the row-sharded basis matrix (or an all-gather of
    the whole tableau, defeating memory scaling), so drift is controlled on
    the two quantities that actually decide pivots and verdicts: every
    ``refactor_every`` iterations the RHS column gets a sharded Newton
    refinement against the ORIGINAL data (x_B += ~B^{-1}(b0 - B x_B), with
    ~B^{-1} read off the current tableau's initial-basis columns — the
    scheme of ``ops/batched._refine_solution_b``, here with three m-vector
    all-gathers), and the objective row is re-priced exactly against the
    current rows (``raw_obj - c_B' T_rows``, one psum).  A final Newton
    polish runs after the loop so reported solutions are drift-free.

Artificial-variable handling differs from the single-chip kernel: instead of
a post-phase-1 eviction sweep (a global row loop), basic artificials are
driven out by a ratio-test preference — any row whose basic variable is
artificial and has a nonzero pivot-column entry gets ratio 0 and wins ties,
so it leaves the basis on the first pivot that touches it.  This keeps every
step O(1) in collectives.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import (
    STATUS_INFEASIBLE,
    STATUS_ITERATION_LIMIT,
    STATUS_OPTIMAL,
    STATUS_UNBOUNDED,
)

RUNNING = -1
_INT_MAX = jnp.iinfo(jnp.int32).max
# Every device contraction states its precision: a float32 product may run
# in TF32 on the GPU (about 10 mantissa bits).
_einsum = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)
_ART_BONUS = 1 << 20  # tie-break bonus: artificial-basic rows leave first


def make_mesh(batch: int = 1, row: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (batch, row) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    assert batch * row <= len(devices), (
        f"mesh {batch}x{row} needs {batch * row} devices, "
        f"have {len(devices)}"
    )
    arr = np.asarray(devices[: batch * row]).reshape(batch, row)
    return Mesh(arr, axis_names=("batch", "row"))


def _sharded_body(T_loc, basis_loc, obj, col_mask_p1, col_mask_p2,
                  art_mask, obj_row_p1, obj_row_p2, need_p1,
                  row_valid_loc, ub, tol, feas_tol, max_iters, bland_after,
                  refactor_every, devex, bounded, axis="row"):
    """Per-device while_loop over pivots.  Shapes (device-local):

    T_loc:        (B, m_loc, N+1) constraint-row block (no objective row)
    basis_loc:    (B, m_loc) int32
    obj:          (B, N+1) replicated objective row (priced out)
    col_mask_*:   (B, N) replicated
    art_mask:     (B, N) replicated — artificial columns
    obj_row_*:    (B, N+1) replicated raw cost rows
    need_p1:      (B,) replicated
    row_valid_loc:(B, m_loc) — False on padding rows
    ub:           (B, N) replicated upper bounds (+inf where unbounded)

    ``bounded`` (static): enable the NATIVE 0 <= x <= ub machinery — the
    bounded ratio test over both limits (with pmin/pmax collectives over
    the row axis), bound flips (no basis change; replicated O(m_loc)
    state update), at-upper bookkeeping (replicated (B, N) flags), and
    explicit RHS-column/objective-cell maintenance.  False compiles the
    classic kernel unchanged (no gather of ub, no flip arithmetic), so
    the measured single-LP bench path pays nothing.
    """
    Bl = T_loc.shape[0]
    N1 = T_loc.shape[2]
    N = N1 - 1
    dt = T_loc.dtype
    col_idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    bidx = jnp.arange(Bl)[:, None]

    b_scale = 1.0 + lax.pmax(
        jnp.max(jnp.where(row_valid_loc, jnp.abs(T_loc[:, :, -1]), 0.0),
                axis=1),
        axis,
    )

    # Extended artificial mask including the RHS slot (basis may point at
    # padding unit columns which are never artificial).
    art_ext = jnp.concatenate([art_mask, jnp.zeros((Bl, 1), bool)], axis=1)
    ub_safe = jnp.where(jnp.isfinite(ub), ub, 0.0)

    phase0 = jnp.where(need_p1, jnp.int32(1), jnp.int32(2))

    # Drift anchors: the initial rows / basis index the exact original data.
    # ``basis0_full`` columns of T0 are the identity, so the current
    # tableau's basis0 columns approximate B^{-1} (ops/batched.py design).
    T0_loc = T_loc
    b0_loc = T0_loc[:, :, -1]
    basis0_full = lax.all_gather(basis_loc, axis, axis=1, tiled=True)

    def _gather_rows(x):
        return lax.all_gather(x, axis, axis=1, tiled=True)

    def _scatter_cols(idx_full, val_full):
        """Place per-row values at their basis columns: (B, m) -> (B, N+1).

        Basis columns are distinct within an instance, so scatter-add is a
        set; the matvec ``M[:, cols] @ v`` then becomes a plain local-row
        matmul against this dense vector (no lane-axis gather of M).
        """
        return jnp.zeros((Bl, N1), dt).at[bidx, idx_full].add(val_full)

    def _newton_rhs(T_cur, basis_cur, u_vec=None):
        """One sharded Newton step on x_B against the original data.

        r0 = b0 - B x_B with B = T0[:, basis]; dx = ~B^{-1} r0 with
        ~B^{-1} = T_cur[:, basis0].  Kept only where it reduces the global
        residual and stays finite, so a drifted instance can never get
        worse.  Comms: three m-vector all-gathers + two scalar psums.
        Returns the refined RHS column (B, m_loc) — NOT a new tableau:
        returning the full T from inside the periodic ``lax.cond`` forced
        XLA's buffer unification to COPY the whole tableau every
        iteration (~1.8x per-pivot cost at 10240^2 in an earlier on-chip
        bench); the caller writes the column back with
        one in-place dynamic-update-slice instead.
        """
        xB_loc = T_cur[:, :, -1]
        if u_vec is not None:
            # Bounded: the residual target is b_eff = b0 - A u_U (the
            # at-upper nonbasic columns sit AT their bound).
            b_eff = b0_loc - _einsum("bmn,bn->bm", T0_loc, u_vec)
        else:
            b_eff = b0_loc
        basis_full = _gather_rows(basis_cur)
        xfull = _scatter_cols(basis_full, _gather_rows(xB_loc))
        r0_loc = b_eff - _einsum("bmn,bn->bm", T0_loc, xfull)
        rfull = _scatter_cols(basis0_full, _gather_rows(r0_loc))
        xB1_loc = xB_loc + _einsum("bmn,bn->bm", T_cur, rfull)
        xfull1 = _scatter_cols(basis_full, _gather_rows(xB1_loc))
        r1_loc = b_eff - _einsum("bmn,bn->bm", T0_loc, xfull1)
        ss0 = lax.psum(jnp.sum(r0_loc * r0_loc, axis=1), axis)
        ss1 = lax.psum(jnp.sum(r1_loc * r1_loc, axis=1), axis)
        finite = lax.pmin(
            jnp.all(jnp.isfinite(xB1_loc), axis=1).astype(jnp.int32), axis
        ) > 0
        better = (ss1 < ss0) & finite
        return jnp.where(better[:, None], xB1_loc, xB_loc)

    def _reprice(T_cur, basis_cur, raw_obj):
        """Exact reduced costs for the current rows: raw - c_B' T_rows."""
        cB = jnp.take_along_axis(raw_obj, basis_cur, axis=1)
        cB = jnp.where(row_valid_loc, cB, 0.0)
        local_dot = _einsum("bm,bmn->bn", cB, T_cur)
        return raw_obj - lax.psum(local_dot, axis)

    def cond(state):
        status, iters = state[4], state[5]
        return jnp.any(status == RUNNING) & (iters < max_iters)

    def body(state):
        (T_loc, basis_loc, obj, phase, status, iters, since_ref, w,
         best_obj, no_imp, at_upper) = state
        live = status == RUNNING
        in_p1 = phase == 1
        col_mask = jnp.where(in_p1[:, None], col_mask_p1, col_mask_p2)
        raw_obj = jnp.where(in_p1[:, None], obj_row_p1, obj_row_p2)
        # Stall-gated Bland, per instance (see module docstring).
        use_bland = no_imp >= bland_after

        # ---- periodic drift resync (replicated predicate, all devices
        # branch together — collectives inside the cond are safe).  The
        # branches return ONLY the refined RHS column + objective row:
        # passing the full tableau through the cond made XLA copy it every
        # iteration to unify the identity branch's aliased output with the
        # resync branch's fresh one (~1.8x per-pivot, round-4 bench). ---- #
        def resync(args):
            T_c, obj_c = args
            if bounded:
                u_vec = jnp.concatenate(
                    [jnp.where(at_upper, ub_safe, 0.0),
                     jnp.zeros((Bl, 1), dt)], axis=1)
            else:
                u_vec = None
            xB_n = _newton_rhs(T_c, basis_loc, u_vec)
            obj_n = _reprice(T_c, basis_loc, raw_obj)
            # The objective CELL must price against the REFINED x_B
            # (plus the at-upper nonbasic contributions when bounded).
            cB = jnp.where(row_valid_loc,
                           jnp.take_along_axis(raw_obj, basis_loc, axis=1),
                           0.0)
            z_min = lax.psum(jnp.sum(cB * xB_n, axis=1), axis)
            if bounded:
                z_min = z_min + jnp.sum(
                    jnp.where(at_upper, raw_obj[:, :-1] * ub_safe, 0.0),
                    axis=1)
            obj_n = obj_n.at[:, -1].set(raw_obj[:, -1] - z_min)
            xB_n = jnp.where(live[:, None], xB_n, T_c[:, :, -1])
            obj_n = jnp.where(live[:, None], obj_n, obj_c)
            return xB_n, obj_n

        do_rf = since_ref >= refactor_every
        xB_upd, obj = lax.cond(
            do_rf, resync, lambda a: (a[0][:, :, -1], a[1]), (T_loc, obj))
        T_loc = T_loc.at[:, :, -1].set(xB_upd)

        # ---- pricing (replicated compute, no comms) -------------------- #
        rc = obj[:, :-1]
        if bounded:
            elig_lo = col_mask & ~at_upper & (rc < -tol)
            elig_up = col_mask & at_upper & (rc > tol)
            eligible = elig_lo | elig_up
            viol = jnp.where(eligible, jnp.abs(rc), -jnp.inf)
            if devex:
                score = jnp.where(eligible, (viol * viol) / w, -jnp.inf)
                s_price = jnp.argmax(score, axis=-1)
            else:
                s_price = jnp.argmax(viol, axis=-1)
        else:
            rc_m = jnp.where(col_mask, rc, jnp.inf)
            eligible = rc_m < -tol
            if devex:
                score = jnp.where(eligible, (rc_m * rc_m) / w, -jnp.inf)
                s_price = jnp.argmax(score, axis=-1)
            else:
                s_price = jnp.argmin(rc_m, axis=-1)
        s = jnp.where(use_bland, jnp.argmax(eligible, axis=-1), s_price)
        optimal = ~jnp.any(eligible, axis=-1)

        # ---- ratio test (local + pmin collectives) --------------------- #
        # Column extraction: an index gather per instance reads O(m_loc)
        # entries, exactly (no product, so no TF32 rounding).
        col_loc = jnp.take_along_axis(T_loc, s[:, None, None],
                                      axis=2)[:, :, 0]        # (B, m_loc)
        rhs_loc = T_loc[:, :, -1]
        is_art_row = jnp.take_along_axis(art_ext, basis_loc, axis=1)
        if bounded:
            # Entering direction: +1 from lower, -1 from upper (the
            # variable then decreases); basics move as x_B -= sigma d t.
            s_from_up = jnp.take_along_axis(at_upper, s[:, None],
                                            axis=1)[:, 0]
            sigma = jnp.where(s_from_up, -1.0, 1.0).astype(dt)   # (B,)
            rc_s = jnp.take_along_axis(obj, s[:, None], axis=1)[:, 0]
            ub_s = jnp.take_along_axis(ub, s[:, None], axis=1)[:, 0]
            ub_s_safe = jnp.where(jnp.isfinite(ub_s), ub_s, 0.0)
            dd_loc = sigma[:, None] * col_loc
            ub_B_loc = jnp.take_along_axis(
                jnp.concatenate([ub, jnp.full((Bl, 1), jnp.inf, dt)],
                                axis=1), basis_loc, axis=1)
        else:
            sigma = jnp.ones((Bl,), dt)
            dd_loc = col_loc
        positive = (dd_loc > tol) & row_valid_loc
        # Phase 2 only: artificial-basic rows (at zero level after a
        # feasible phase 1) with any nonzero entry leave at ratio 0.  In
        # phase 1 artificials carry the RHS and must obey the normal test.
        art_exit = ((~in_p1)[:, None] & is_art_row
                    & (jnp.abs(dd_loc) > tol) & row_valid_loc)
        # Backward-step clamp — see ops/tableau.select_pivot.
        rhs_c = jnp.maximum(rhs_loc, 0.0)
        t_lo = jnp.where(positive, rhs_c / jnp.where(positive, dd_loc,
                                                     1.0), jnp.inf)
        t_lo = jnp.where(art_exit, 0.0, t_lo)
        if bounded:
            negd = (dd_loc < -tol) & row_valid_loc                 & jnp.isfinite(ub_B_loc)
            span_c = jnp.maximum(ub_B_loc - rhs_loc, 0.0)
            t_hi = jnp.where(negd, span_c / jnp.where(negd, -dd_loc, 1.0),
                             jnp.inf)
            ratios = jnp.minimum(t_lo, t_hi)
            cand = positive | negd | art_exit
        else:
            t_hi = None
            ratios = t_lo
            cand = positive | art_exit

        local_min = jnp.min(ratios, axis=1)                  # (B,)
        global_min = lax.pmin(local_min, axis)
        if bounded:
            theta_all = jnp.minimum(global_min, ub_s)
            unbounded = (~optimal) & jnp.isinf(theta_all)
            do_flip = (~optimal) & (~unbounded) & (ub_s <= global_min)
            theta_safe = jnp.where(jnp.isfinite(theta_all), theta_all, 0.0)
        else:
            unbounded = (~optimal) & jnp.isinf(global_min)

        # Harris two-pass row selection (default mode) — the single-chip
        # kernels' stabilization (ops/tableau.py:73-87) ported across the
        # mesh: pass 1 bounds the step by the tol-relaxed minimum ratio
        # (one extra pmin), pass 2 admits rows whose exact ratio fits under
        # the bound and prefers the LARGEST pivot element (one pmax).
        # Tiny pivots are what turn f32 bases singular, and this kernel has
        # the least drift control (Newton resync only), so it needs the
        # stabilized choice most.  Artificial-exit rows get a value bonus
        # that dominates any pivot magnitude, preserving
        # "artificials leave first".
        delta = tol * (1.0 + jnp.abs(rhs_loc))
        theta_relax = jnp.where(
            positive, (rhs_c + delta) / jnp.where(positive, dd_loc, 1.0),
            jnp.inf)
        if bounded:
            delta_hi = tol * (1.0 + jnp.abs(ub_B_loc - rhs_loc))
            theta_relax = jnp.minimum(
                theta_relax,
                jnp.where(negd, (span_c + delta_hi)
                          / jnp.where(negd, -dd_loc, 1.0), jnp.inf))
        theta_max = lax.pmin(jnp.min(theta_relax, axis=1), axis)
        harris_cand = (cand & (ratios <= theta_max[:, None])) | art_exit
        hval = jnp.where(
            harris_cand,
            jnp.abs(dd_loc) + jnp.where(art_exit, jnp.asarray(1e30, dt),
                                        jnp.asarray(0.0, dt)),
            -jnp.inf)
        hmax = lax.pmax(jnp.max(hval, axis=1), axis)
        harris_rows = harris_cand & (hval == hmax[:, None])

        # Bland (stall) mode: smallest-basis-index among near-minimal
        # ratios — the row rule Bland's termination proof needs; the tie
        # window stays at round-off scale.
        eps = jnp.finfo(dt).eps
        near = cand & (
            ratios <= (global_min
                       + 64.0 * eps * (1.0 + jnp.abs(global_min)))[:, None]
        )
        sel_cand = jnp.where(use_bland[:, None], near, harris_rows)
        # Final unique-owner tie-break on the global basis index (basis
        # columns are globally distinct per instance, so exactly one row
        # survives); artificial rows get a large negative bonus so they win
        # ties and leave the basis.
        key = jnp.where(
            sel_cand,
            basis_loc - jnp.where(is_art_row, _ART_BONUS, 0),
            _INT_MAX,
        )
        local_key = jnp.min(key, axis=1)
        global_key = lax.pmin(local_key, axis)

        owner_rows = sel_cand & (
            (basis_loc - jnp.where(is_art_row, _ART_BONUS, 0))
            == global_key[:, None]
        )
        has_owner = jnp.any(owner_rows, axis=1)              # (B,)
        r_loc = jnp.argmax(owner_rows, axis=1)               # (B,)

        # ---- pivot-row broadcast (psum of masked contribution) --------- #
        piv_row_own = jnp.take_along_axis(
            T_loc, r_loc[:, None, None], axis=1)[:, 0, :]     # (B, N+1)
        pivot_own = jnp.take_along_axis(piv_row_own, s[:, None],
                                        axis=1)[:, 0]
        safe = jnp.where(has_owner & (jnp.abs(pivot_own) > 0), pivot_own, 1.0)
        contrib = jnp.where(has_owner[:, None], piv_row_own / safe[:, None],
                            0.0)
        piv_row = lax.psum(contrib, axis)                    # (B, N+1)
        # Execute the clamped step theta = max(rhs_r, 0)/pivot — see
        # ops/tableau.pivot_update (round-4 backward-step fix); artificial-
        # exit rows sit at ~0 so the clamp keeps them degenerate too.
        piv_row = piv_row.at[:, -1].set(jnp.maximum(piv_row[:, -1], 0.0))
        if bounded:
            # Owner row's limits decide whether the leaving variable exits
            # at its LOWER or UPPER bound, and the executed step length.
            t_lo_own = lax.psum(
                jnp.sum(jnp.where(owner_rows, t_lo, 0.0), axis=1), axis)
            t_hi_own = lax.psum(
                jnp.sum(jnp.where(owner_rows,
                                  jnp.where(jnp.isfinite(t_hi), t_hi, 0.0),
                                  0.0), axis=1), axis)
            t_hi_inf = lax.psum(
                jnp.sum(jnp.where(owner_rows & ~jnp.isfinite(t_hi),
                                  1.0, 0.0), axis=1), axis) > 0
            t_hi_own = jnp.where(t_hi_inf, jnp.inf, t_hi_own)
            leave_up = t_hi_own < t_lo_own
            step = jnp.minimum(jnp.minimum(t_lo_own, t_hi_own), theta_safe)
            step = jnp.where(jnp.isfinite(step), step, 0.0)
            j_out_b = lax.psum(
                jnp.sum(jnp.where(owner_rows, basis_loc, 0), axis=1), axis)

        # ---- decide action per instance -------------------------------- #
        want_stop = (optimal | unbounded) & live
        p1_done = want_stop & in_p1
        p1_obj = -obj[:, -1]
        infeasible = p1_done & (p1_obj > feas_tol * b_scale)
        to_p2 = p1_done & ~infeasible

        finish_p2 = want_stop & ~in_p1
        status = jnp.where(
            infeasible, STATUS_INFEASIBLE,
            jnp.where(finish_p2 & optimal, STATUS_OPTIMAL,
                      jnp.where(finish_p2 & unbounded, STATUS_UNBOUNDED,
                                status)),
        )
        active = live & ~want_stop
        if bounded:
            do_flip_now = active & do_flip
            do_pivot_now = active & ~do_flip
        else:
            do_pivot_now = active

        # ---- Devex weight update (replicated; pre-pivot pivot row) ----- #
        if devex:
            # Leaving variable's column = basis at the owner row, one psum.
            j_out = lax.psum(
                jnp.sum(jnp.where(owner_rows, basis_loc, 0), axis=1), axis
            )
            w_s = jnp.sum(jnp.where(col_idx == s[:, None], w, 0.0), axis=1)
            alpha = piv_row[:, :-1]
            w_new = jnp.maximum(w, (alpha * alpha) * w_s[:, None])
            w_new = jnp.where(col_idx == j_out[:, None],
                              jnp.maximum(w_s, 1.0)[:, None], w_new)
            w_new = jnp.where(col_idx == s[:, None], 1.0, w_new)
            w_new = jnp.where(
                jnp.max(w_new, axis=1, keepdims=True) > 1e8,
                jnp.ones_like(w_new), w_new)
            w = jnp.where(do_pivot_now[:, None], w_new, w)

        # ---- rank-1 update (row-parallel, no comms) -------------------- #
        T_new = T_loc - col_loc[:, :, None] * piv_row[:, None, :]
        own_hot = owner_rows  # (B, m_loc) — at most one True per instance
        T_new = jnp.where(own_hot[:, :, None], piv_row[:, None, :], T_new)
        if bounded:
            # Explicit bounded RHS: x_B -= sigma d theta; the entering
            # variable lands at theta (from lower) or ub_s - theta (from
            # upper); everything clipped into [0, ub_basis].
            z_old = -obj[:, -1]
            x_enter = jnp.where(s_from_up, ub_s_safe - step, step)
            rhs_piv = rhs_loc - dd_loc * step[:, None]
            rhs_piv = jnp.where(own_hot, x_enter[:, None], rhs_piv)
            basis_piv = jnp.where(own_hot,
                                  s[:, None].astype(basis_loc.dtype),
                                  basis_loc)
            ub_B_new = jnp.take_along_axis(
                jnp.concatenate([ub, jnp.full((Bl, 1), jnp.inf, dt)],
                                axis=1), basis_piv, axis=1)
            rhs_piv = jnp.clip(rhs_piv, 0.0, ub_B_new)
            # Bound FLIP: no basis change; x_B -= sigma d ub_s, clipped.
            rhs_flip = jnp.clip(rhs_loc - dd_loc * ub_s_safe[:, None],
                                0.0, ub_B_loc)
            rhs_out = jnp.where(
                do_pivot_now[:, None], rhs_piv,
                jnp.where(do_flip_now[:, None], rhs_flip, rhs_loc))
            T_new = T_new.at[:, :, -1].set(
                jnp.where(do_pivot_now[:, None], rhs_out[:, :],
                          T_new[:, :, -1]))
            T_loc = jnp.where(do_pivot_now[:, None, None], T_new, T_loc)
            T_loc = T_loc.at[:, :, -1].set(rhs_out)
            basis_loc = jnp.where(do_pivot_now[:, None] & own_hot,
                                  s[:, None].astype(basis_loc.dtype),
                                  basis_loc)
        else:
            T_loc = jnp.where(active[:, None, None], T_new, T_loc)
            basis_loc = jnp.where(active[:, None] & own_hot,
                                  s[:, None].astype(basis_loc.dtype),
                                  basis_loc)

        # Objective-row update (replicated, consistent across devices).
        obj_s = jnp.take_along_axis(obj, s[:, None], axis=1)[:, 0]
        obj_new = obj - obj_s[:, None] * piv_row
        if bounded:
            z_piv = z_old + sigma * rc_s * step
            z_flip = z_old + sigma * rc_s * ub_s_safe
            obj_new = obj_new.at[:, -1].set(-z_piv)
            obj = jnp.where(do_pivot_now[:, None], obj_new, obj)
            obj = obj.at[:, -1].set(
                jnp.where(do_pivot_now, -z_piv,
                          jnp.where(do_flip_now, -z_flip, obj[:, -1])))
            # at-upper bookkeeping (replicated): leaving column exits at
            # its bound; entering/flipping column toggles.
            jout_hot = col_idx == j_out_b[:, None]
            shot_n = col_idx == s[:, None]
            at_up_piv = jnp.where(jout_hot, leave_up[:, None], at_upper)
            at_up_piv = jnp.where(shot_n, False, at_up_piv)
            at_up_flip = jnp.where(shot_n, ~at_upper, at_upper)
            at_upper = jnp.where(
                do_pivot_now[:, None], at_up_piv,
                jnp.where(do_flip_now[:, None], at_up_flip, at_upper))
        else:
            obj = jnp.where(active[:, None], obj_new, obj)

        # ---- objective-progress tracking (stall-gated Bland) ----------- #
        obj_val = -obj[:, -1]
        improved = obj_val < best_obj - tol * (1.0 + jnp.abs(best_obj))
        best_obj = jnp.minimum(best_obj, obj_val)
        no_imp = jnp.where(improved, 0, no_imp + active.astype(no_imp.dtype))

        # ---- phase flip: install + price out the phase-2 objective ----- #
        # Gated: the O(B·m_loc·N) contraction + psum only run on iterations
        # where some instance actually flips.  ``to_p2`` derives from
        # replicated state and pmin-reduced values, so every device takes
        # the same branch — the collective inside the cond is safe.
        def flip(args):
            obj, phase = args
            priced = _reprice(T_loc, basis_loc, obj_row_p2)
            if bounded:
                # The generic reprice puts -c_B x_B in the cell; add the
                # at-upper nonbasic contributions.
                z_up = jnp.sum(
                    jnp.where(at_upper, obj_row_p2[:, :-1] * ub_safe, 0.0),
                    axis=1)
                priced = priced.at[:, -1].add(-z_up)
            obj = jnp.where(to_p2[:, None], priced, obj)
            phase = jnp.where(to_p2, jnp.int32(2), phase)
            return obj, phase

        obj, phase = lax.cond(jnp.any(to_p2), flip, lambda a: a,
                              (obj, phase))
        # A phase flip installs a fresh objective: reset progress + weights.
        inf_ = jnp.asarray(jnp.inf, dt)
        best_obj = jnp.where(to_p2, inf_, best_obj)
        no_imp = jnp.where(to_p2, 0, no_imp)
        if devex:
            w = jnp.where(to_p2[:, None], 1.0, w)

        since_ref = jnp.where(do_rf, jnp.int32(1), since_ref + 1)
        return (T_loc, basis_loc, obj, phase, status, iters + 1, since_ref,
                w, best_obj, no_imp, at_upper)

    state0 = (T_loc, basis_loc, obj, phase0,
              jnp.full((Bl,), RUNNING, jnp.int32), jnp.int32(0),
              jnp.int32(1), jnp.ones((Bl, N), dt),
              jnp.full((Bl,), jnp.inf, dt), jnp.zeros((Bl,), jnp.int32),
              jnp.zeros((Bl, N), bool))
    (T_loc, basis_loc, obj, phase, status, iters, _, _, _, _,
     at_upper) = lax.while_loop(cond, body, state0)
    status = jnp.where(status == RUNNING, STATUS_ITERATION_LIMIT, status)

    # Final polish: Newton-refine x_B and recompute the objective value from
    # the refined solution, so reported numbers are drift-free
    # (the sharded counterpart of ops/batched._refine_solution_b).
    if bounded:
        u_vec_f = jnp.concatenate(
            [jnp.where(at_upper, ub_safe, 0.0), jnp.zeros((Bl, 1), dt)],
            axis=1)
    else:
        u_vec_f = None
    T_loc = T_loc.at[:, :, -1].set(_newton_rhs(T_loc, basis_loc, u_vec_f))
    raw_obj = jnp.where((phase == 1)[:, None], obj_row_p1, obj_row_p2)
    cB = jnp.where(row_valid_loc,
                   jnp.take_along_axis(raw_obj, basis_loc, axis=1), 0.0)
    z_min = lax.psum(jnp.sum(cB * T_loc[:, :, -1], axis=1), axis)
    if bounded:
        z_min = z_min + jnp.sum(
            jnp.where(at_upper, raw_obj[:, :-1] * ub_safe, 0.0), axis=1)
    obj = obj.at[:, -1].set(-z_min)

    return T_loc, basis_loc, obj, status, iters, at_upper


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tol", "feas_tol", "max_iters", "bland_after",
                     "refactor_every", "devex", "bounded"),
)
def solve_tableau_sharded(T_rows, basis, obj, col_mask_p1, col_mask_p2,
                          art_mask, obj_row_p1, obj_row_p2, need_p1,
                          row_valid, ub, mesh: Mesh,
                          tol: float = 1e-6, feas_tol: float = 1e-5,
                          max_iters: int = 4096, bland_after: int = 1024,
                          refactor_every: int = 64, devex: bool = True,
                          bounded: bool = False):
    """Solve LPs with constraint rows sharded over ``mesh`` axis ``row`` and
    instances sharded over ``batch``.

    Global shapes:
      T_rows:   (B, m_pad, N+1)  — constraint rows only (objective separate)
      basis:    (B, m_pad) int32
      obj:      (B, N+1)         — initial priced-out objective row
      masks:    (B, N) / (B, m_pad) as in the batched kernel
      need_p1:  (B,) bool
      row_valid:(B, m_pad) bool  — False on padding rows

    ``ub``: (B, N) replicated upper bounds in the tableau dtype (+inf
    where unbounded); pass all-+inf with ``bounded=False`` for the
    classic kernel (the static flag compiles the bound machinery out).

    Returns ``(T_rows, basis, obj, status, iters, at_upper)`` with the
    same global shapes/shardings (``at_upper``: (B, N) replicated).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    spec_T = P("batch", "row", None)
    spec_rows = P("batch", "row")
    spec_rep = P("batch", None)
    spec_b = P("batch")

    fn = shard_map(
        functools.partial(_sharded_body, tol=tol, feas_tol=feas_tol,
                          max_iters=max_iters, bland_after=bland_after,
                          refactor_every=refactor_every, devex=devex,
                          bounded=bounded),
        mesh=mesh,
        in_specs=(spec_T, spec_rows, spec_rep, spec_rep, spec_rep,
                  spec_rep, spec_rep, spec_rep, spec_b, spec_rows,
                  spec_rep),
        out_specs=(spec_T, spec_rows, spec_rep, spec_b, P(), spec_rep),
        check_vma=False,
    )
    return fn(T_rows, basis, obj, col_mask_p1, col_mask_p2, art_mask,
              obj_row_p1, obj_row_p2, need_p1, row_valid, ub)


@functools.partial(jax.jit, static_argnames=("n_vars",))
def _extract_sharded_jit(T_rows, basis, obj, row_valid, at_upper, ub,
                         n_vars: int):
    rhs = jnp.where(row_valid, T_rows[..., -1], 0.0)          # (B, m)
    onehot = basis[:, :, None] == jnp.arange(n_vars,
                                             dtype=basis.dtype)[None, None, :]
    x = jnp.sum(jnp.where(onehot, rhs[:, :, None], 0.0), axis=1)
    ub_s = jnp.where(jnp.isfinite(ub[:, :n_vars]), ub[:, :n_vars], 0.0)
    x = jnp.where(at_upper[:, :n_vars], ub_s, x)
    return x, -obj[:, -1]


def extract_solution_sharded(T_rows, basis, obj, row_valid, n_vars: int,
                             at_upper=None, ub=None):
    """Recover (x, z_min) from sharded results.

    Runs as one jitted one-hot contraction over the sharded arrays (GSPMD
    inserts the row-axis reduction), so only the (B, n_vars) result crosses
    to host — no per-instance Python loop, no full-tableau fetch.
    ``at_upper``/``ub``: bounded solves place nonbasic at-upper columns AT
    their bound.
    """
    B = T_rows.shape[0]
    if at_upper is None:
        at_upper = jnp.zeros((B, n_vars), bool)
    if ub is None:
        ub = jnp.full((B, n_vars), jnp.inf, T_rows.dtype)
    x, z_min = _extract_sharded_jit(T_rows, basis, jnp.asarray(obj),
                                    jnp.asarray(row_valid),
                                    jnp.asarray(at_upper), jnp.asarray(ub),
                                    n_vars)
    return np.asarray(x), np.asarray(z_min)


def solve_arrays_sharded(c, A, b, ops, maximize=True, mesh: Mesh = None,
                         dtype=np.float32, tol: float = 1e-6,
                         max_iters: int = 4096, bland_after: int = 1024,
                         refactor_every: int = 64, devex: bool = True,
                         certify: bool = True, ub=None):
    """Convenience driver: uniform array batch → sharded solve → results.

    Pads the batch to the ``batch`` mesh axis and rows to a multiple of the
    ``row`` axis, places shards with ``jax.device_put``, runs the sharded
    kernel, and extracts per-instance solutions on device.

    ``certify=True`` (default) routes every verdict through the same f64
    KKT certification + exact-host escalation the batched path gets
    (models/certify.py): the result dict gains ``certified``/``escalated``
    masks, and no sharded status can disagree with an exact solve.

    ``ub`` ((n,) or (B, n), entries in [0, +inf]): NATIVE upper bounds
    through the sharded bounded ratio test — a bound-heavy 100k-row LP
    keeps m at the structural row count instead of adding one dense row
    per bound (general lower bounds go through
    ``core.problem.normalize_bounds`` first, as in solve_lp_sweep).
    """
    from ..models.batched import compile_batch_uniform

    if mesh is None:
        mesh = make_mesh(batch=1, row=len(jax.devices()))
    n_batch = mesh.shape["batch"]
    n_row = mesh.shape["row"]

    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    B, m, n = A.shape

    if ub is not None:
        ub = np.broadcast_to(np.asarray(ub, np.float64), (B, n)).copy()

    B_pad = ((B + n_batch - 1) // n_batch) * n_batch
    if B_pad != B:
        # Pad with trivial feasible instances (x=0 optimal).
        A = np.concatenate([A, np.zeros((B_pad - B, m, n))])
        extra_b = np.ones((B_pad - B, m))
        b = np.concatenate([b, extra_b])
        c = np.concatenate([c, np.zeros((B_pad - B, n))])
        if ub is not None:
            ub = np.concatenate([ub, np.full((B_pad - B, n), np.inf)])

    cb = compile_batch_uniform(
        c, A, b, ops, maximize, row_pad=n_row, dtype=np.dtype(dtype),
        align_total=False, ub=ub,
    )
    m_pad = cb.basis.shape[1]
    assert m_pad % n_row == 0

    row_valid = np.zeros((B_pad, m_pad), bool)
    row_valid[:, :m] = True
    art_mask = cb.col_mask_p1 & ~cb.col_mask_p2

    sh_T = NamedSharding(mesh, P("batch", "row", None))
    sh_rows = NamedSharding(mesh, P("batch", "row"))
    sh_rep = NamedSharding(mesh, P("batch", None))
    sh_b = NamedSharding(mesh, P("batch"))

    # Stage the tableau SHARD BY SHARD straight from the numpy buffer
    # (make_array_from_callback): a whole-array jnp.asarray/device_put of
    # the non-contiguous row block would materialize a contiguous 40 GB
    # temp at the 100k-row config-5 shape — peak memory here is one host
    # copy + one sharded device copy + a single shard-sized temp.  The
    # host tableau is dropped before the solve.
    obj = np.ascontiguousarray(cb.T0[:, -1, :])
    T_shape = (B_pad, m_pad, cb.T0.shape[2])
    T_dev = jax.make_array_from_callback(
        T_shape, sh_T,
        lambda idx, _T=cb.T0: np.ascontiguousarray(_T[:, :-1, :][idx]))
    cb.T0 = None
    args = (
        T_dev,
        jax.device_put(cb.basis, sh_rows),
        jax.device_put(obj, sh_rep),
        jax.device_put(cb.col_mask_p1, sh_rep),
        jax.device_put(cb.col_mask_p2, sh_rep),
        jax.device_put(art_mask, sh_rep),
        jax.device_put(cb.obj_row_p1, sh_rep),
        jax.device_put(cb.obj_row_p2, sh_rep),
        jax.device_put(cb.need_p1, sh_b),
        jax.device_put(row_valid, sh_rows),
    )
    n_pad_cols = cb.col_mask_p1.shape[1]
    bounded = cb.ub_ext is not None
    ub_dev = jax.device_put(
        jnp.asarray(cb.ub_ext if bounded
                    else np.full((B_pad, n_pad_cols), np.inf,
                                 np.dtype(dtype))), sh_rep)
    T_out, basis_out, obj_out, status, iters, at_up = solve_tableau_sharded(
        *args, ub_dev, mesh=mesh, tol=tol, max_iters=max_iters,
        bland_after=bland_after, refactor_every=refactor_every, devex=devex,
        bounded=bounded,
    )
    x, z_min = extract_solution_sharded(
        T_out, basis_out, obj_out, row_valid, cb.n_vars,
        at_upper=(at_up if bounded else None),
        ub=(ub_dev[:, : cb.n_vars] if bounded else None))
    x = np.maximum(x[:B], 0.0)
    fun = z_min[:B]
    status = np.asarray(status)[:B]
    maxi = np.asarray(cb.maximize[:B])
    z = np.where(maxi, -fun, fun) + 0.0
    ok = status == STATUS_OPTIMAL
    out = {
        "x": np.where(ok[:, None], x, np.nan),
        "z": np.where(ok, z, np.nan),
        "status": status,
        "iters": int(iters),
        # How many devices hold the tableau (observability of the mesh).
        "tableau_devices": len(T_out.sharding.device_set),
    }
    if certify:
        # Same f64 safety net as the batched path, via the STRUCTURED
        # certifier (models/certify.certify_and_escalate_raw): each basis's
        # KKT systems collapse to a k×k LU (k = structural basic columns,
        # <= n) + one O(m·n) reduced-cost matvec, so certification stays
        # milliseconds even at the m=16k..100k row-sharded regime where a
        # dense f64 LU of B costs ~45 s (VERDICT r3 item 2).  No m×N f64
        # standard form is materialized.
        from ..models.certify import certify_and_escalate_raw

        basis_np = np.asarray(basis_out)[:B]
        fix = certify_and_escalate_raw(
            status, basis_np, c[:B], A[:B], b[:B], ops, maxi,
            ub=(None if ub is None else ub[:B]),
            at_upper=(None if not bounded
                      else np.asarray(at_up)[:B]))
        out.update(
            x=fix["x"], z=fix["z"], status=fix["status"],
            certified=fix["certified"], escalated=fix["escalated"])
    return out
