"""Solver contract tests — the device engine vs the reference's expected optima.

Unlike the reference (which mocks ``linprog`` with canned OptimizeResults,
``tests/test_solver_controller.py:25-46``), these run the REAL engine and
assert objective parity to 1e-6 against scipy/HiGHS on the same problems —
the BASELINE.json config-1 contract (SURVEY.md §4 equivalent-strategy map).
"""
import numpy as np
import pytest
from scipy.optimize import linprog

from simplex_tpu import LinearProgram, solve_lp
from simplex_tpu.core.problem import OP_EQ, OP_GE, OP_LE


def scipy_reference(lp: LinearProgram):
    """Solve with scipy/HiGHS dual simplex exactly as the reference does
    (``solver_controller.py:78-85``, minus the redundant = duplication)."""
    c = -lp.c if lp.maximize else lp.c
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(lp.n_cons):
        if lp.ops[i] == OP_LE:
            A_ub.append(lp.A[i]); b_ub.append(lp.b[i])
        elif lp.ops[i] == OP_GE:
            A_ub.append(-lp.A[i]); b_ub.append(-lp.b[i])
        else:
            A_eq.append(lp.A[i]); b_eq.append(lp.b[i])
    return linprog(
        c,
        A_ub=np.array(A_ub) if A_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        A_eq=np.array(A_eq) if A_eq else None,
        b_eq=np.array(b_eq) if b_eq else None,
        bounds=[(0, None)] * lp.n_vars,
        method="highs-ds",
    )


def assert_matches_scipy(lp, check_x=True):
    ours = solve_lp(lp)
    ref = scipy_reference(lp)
    if ref.status == 0:
        assert ours.status == 0
        assert ours.fun == pytest.approx(ref.fun, abs=1e-6 * (1 + abs(ref.fun)))
        if check_x:
            np.testing.assert_allclose(ours.x, ref.x, atol=1e-6)
    else:
        assert ours.status == ref.status
    return ours, ref


# ----------------------- the reference's anchor problems ------------------ #
def test_max_anchor():
    """max 15x1+18x2 → x=(388.889, 222.222), Z=9833.333 (BASELINE.md)."""
    lp = LinearProgram(
        c=[15, 18],
        A=[[4, 2], [2, 6], [20, 28]],
        b=[2000, 2400, 14000],
        ops=[OP_LE] * 3,
        maximize=True,
    )
    r, _ = assert_matches_scipy(lp)
    assert r.z == pytest.approx(9833.3333333, abs=1e-4)
    assert r.x[0] == pytest.approx(388.8888888888889, abs=1e-6)
    assert r.x[1] == pytest.approx(222.22222222222223, abs=1e-6)


def test_min_anchor():
    """min 50x1+80x2 with three >= rows.

    NOTE: the reference test pins Z=108.6957 / x=(0.7826, 0.8696) — but those
    values come from a MOCKED OptimizeResult (its ``test_solver_controller.py``
    never runs scipy), and that point actually violates 4x1+6x2 >= 12.  The
    true optimum (confirmed by scipy/HiGHS here) is x=(2, 2/3), Z=153.333.
    """
    lp = LinearProgram(
        c=[50, 80],
        A=[[4, 1], [1, 6], [4, 6]],
        b=[4, 6, 12],
        ops=[OP_GE] * 3,
        maximize=False,
    )
    r, _ = assert_matches_scipy(lp)
    assert r.z == pytest.approx(153.33333333333334, abs=1e-6)
    np.testing.assert_allclose(r.x, [2.0, 2.0 / 3.0], atol=1e-6)


def test_viz_max_anchor():
    """max 3x1+5x2 s.t. x1<=4, 2x2<=12, 3x1+2x2<=18 → (2, 6), Z=36."""
    lp = LinearProgram(
        c=[3, 5], A=[[1, 0], [0, 2], [3, 2]], b=[4, 12, 18],
        ops=[OP_LE] * 3, maximize=True,
    )
    r, _ = assert_matches_scipy(lp)
    assert r.z == pytest.approx(36.0, abs=1e-6)
    np.testing.assert_allclose(r.x, [2.0, 6.0], atol=1e-6)


def test_viz_min_anchor():
    """min 2x1+3x2 with two >= rows.

    The reference pins Z=14 / x=(3,2) via a MOCKED OptimizeResult — values
    that are internally inconsistent (2·3+3·2 = 12, not 14) and not optimal.
    The true optimum (confirmed by scipy/HiGHS) is x=(5, 0), Z=10.
    """
    lp = LinearProgram(
        c=[2, 3], A=[[1, 1], [2, 1]], b=[5, 8],
        ops=[OP_GE] * 2, maximize=False,
    )
    r, _ = assert_matches_scipy(lp)
    assert r.z == pytest.approx(10.0, abs=1e-6)
    np.testing.assert_allclose(r.x, [5.0, 0.0], atol=1e-6)


# ------------------------------ edge cases ------------------------------- #
def test_equality_constraints():
    lp = LinearProgram(
        c=[2, 3], A=[[1, 1], [1, -1]], b=[10, 2],
        ops=[OP_EQ, OP_EQ], maximize=True,
    )
    assert_matches_scipy(lp)


def test_infeasible():
    lp = LinearProgram(
        c=[1, 1], A=[[1, 1], [1, 1]], b=[1, 3],
        ops=[OP_LE, OP_GE], maximize=True,
    )
    r = solve_lp(lp)
    assert r.status == 2 and not r.success and r.x is None


def test_unbounded():
    lp = LinearProgram(c=[1, 1], A=[[-1, -1]], b=[-1], ops=[OP_LE], maximize=True)
    r = solve_lp(lp)
    assert r.status == 3 and not r.success


def test_no_constraints_unbounded():
    lp = LinearProgram(c=[1.0, 2.0], A=np.zeros((0, 2)), b=[], ops=[],
                       maximize=True)
    r = solve_lp(lp)
    assert r.status == 3


def test_no_constraints_trivial():
    lp = LinearProgram(c=[1.0, 2.0], A=np.zeros((0, 2)), b=[], ops=[],
                       maximize=False)
    r = solve_lp(lp)
    assert r.status == 0 and r.fun == 0.0


def test_zero_coefficients():
    lp = LinearProgram(
        c=[0, 5], A=[[1, 0], [0, 2]], b=[4, 12], ops=[OP_LE, OP_LE],
        maximize=True,
    )
    r, _ = assert_matches_scipy(lp, check_x=False)
    assert r.z == pytest.approx(30.0, abs=1e-6)


def test_degenerate():
    lp = LinearProgram(
        c=[2, 1], A=[[1, 1], [1, 1], [1, 0]], b=[4, 4, 2],
        ops=[OP_LE] * 3, maximize=True,
    )
    r, _ = assert_matches_scipy(lp, check_x=False)
    assert r.z == pytest.approx(6.0, abs=1e-6)


def test_negative_rhs_normalization():
    lp = LinearProgram(
        c=[1, 2], A=[[-1, -1]], b=[-4], ops=[OP_GE], maximize=True,
    )
    r, _ = assert_matches_scipy(lp, check_x=False)
    assert r.z == pytest.approx(8.0, abs=1e-6)


def test_ten_variables_numeric_order():
    # Exercises the numeric-ordering fix on an n>=10 problem, where the
    # reference's lexicographic sort would mis-map coefficients.
    problem = {
        "funcion_objetivo": {
            "type": "maximize",
            "coefficients": {f"x{i}": float(i) for i in range(1, 12)},
        },
        "restricciones": [
            {"coefficients": {f"x{i}": 1.0 for i in range(1, 12)},
             "operator": "<=", "rhs": 10.0},
        ],
    }
    lp = LinearProgram.from_problem_dict(problem)
    assert lp.variables == [f"x{i}" for i in range(1, 12)]
    r = solve_lp(lp)
    assert r.status == 0
    assert r.z == pytest.approx(110.0, abs=1e-6)  # all budget on x11


# ----------------------- randomized parity sweeps ------------------------ #
@pytest.mark.parametrize("seed", range(8))
def test_random_le_problems(seed):
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(2, 10)), int(rng.integers(2, 14))
    A = rng.normal(size=(m, n))
    x0 = rng.uniform(0.5, 2.0, size=n)
    b = A @ x0 + rng.uniform(0.1, 1.0, size=m)
    c = rng.normal(size=n)
    lp = LinearProgram(c=c, A=A, b=b, ops=np.full(m, OP_LE),
                       maximize=bool(rng.integers(0, 2)))
    assert_matches_scipy(lp, check_x=False)


@pytest.mark.parametrize("seed", range(8))
def test_random_mixed_ops(seed):
    rng = np.random.default_rng(100 + seed)
    n, m = int(rng.integers(2, 7)), int(rng.integers(2, 9))
    A = np.abs(rng.normal(size=(m, n)))
    x0 = rng.uniform(0.5, 2.0, size=n)
    ops = rng.choice([OP_LE, OP_EQ, OP_GE], size=m)
    slack = np.where(ops == OP_LE, rng.uniform(0.1, 1.0, size=m),
                     np.where(ops == OP_GE, -rng.uniform(0.1, 1.0, size=m), 0.0))
    b = A @ x0 + slack
    c = np.abs(rng.normal(size=n))
    lp = LinearProgram(c=c, A=A, b=b, ops=ops, maximize=False)
    assert_matches_scipy(lp, check_x=False)


def test_degenerate_livelock_regression():
    """Regression: confirm-refactor livelock on a degenerate 8x7 LP.

    Dantzig pricing reaches the optimum but marginal reduced costs around
    -tol flipped the optimality verdict across refactorizations forever
    (fixed by the stall counter in ops/tableau._run_phase).  Found by a
    1000-LP random sweep vs scipy HiGHS (rng seed 0, case 105).
    """
    import numpy as np
    from simplex_tpu import LinearProgram, solve_lp

    # Reconstruct case-105 data from the sweep's rng stream.
    rng = np.random.default_rng(0)
    for t in range(106):
        m, n = int(rng.integers(1, 10)), int(rng.integers(1, 10))
        A = rng.normal(size=(m, n)).round(2)
        b = rng.uniform(-5, 10, size=m).round(2)
        c = rng.normal(size=n).round(2)
        ops = rng.choice([-1, 0, 1], size=m)
        maximize = bool(rng.integers(0, 2))
    lp = LinearProgram(c=c, A=A, b=b, ops=ops, maximize=maximize)
    r = solve_lp(lp)
    assert r.status == 0, f"expected optimal, got status {r.status}"
    assert abs(r.z - (-69.34961170221177)) < 1e-4
    assert r.nit < 500


def test_warm_start_skips_phase1_and_matches():
    """Basis checkpoint/resume: re-solving a perturbed problem from a saved
    basis skips phase 1 and lands on the same optimum (SURVEY.md §5.4)."""
    import numpy as np
    from simplex_tpu import LinearProgram, solve_lp

    lp = LinearProgram(c=[50, 80], A=[[4, 1], [1, 6], [4, 6]],
                       b=[4, 6, 12], ops=[1, 1, 1], maximize=False)
    cold = solve_lp(lp)
    assert cold.success and cold.nit > 0

    # Same problem, slightly perturbed costs: warm start from saved basis.
    lp2 = LinearProgram(c=[51, 79], A=lp.A, b=lp.b, ops=lp.ops,
                        maximize=False)
    warm = solve_lp(lp2, warm_basis=cold.basis)
    assert warm.success
    assert warm.nit <= cold.nit            # no phase-1 pivots needed
    # Verify against a cold solve of the perturbed problem.
    cold2 = solve_lp(lp2)
    assert abs(warm.z - cold2.z) < 1e-6

    # A garbage basis must fall back to a cold start, not crash.
    bad = solve_lp(lp2, warm_basis=np.array([0, 0, 0], dtype=np.int32))
    assert bad.success
    assert abs(bad.z - cold2.z) < 1e-6


def test_sensitivity_duals_and_reduced_costs_match_scipy():
    """Shadow prices / reduced costs (capability the reference discards:
    HiGHS computes marginals, solver_controller.py never reads them).
    USER-sense convention: duals[i] = dZ_user/db_i; reduced_costs[j] =
    dZ_user/dx_j off the lower bound.  Cross-checked against scipy/HiGHS
    marginals with the appropriate row/sense sign maps."""
    rng = np.random.default_rng(11)
    total = 0
    for _ in range(25):
        m, n = int(rng.integers(1, 7)), int(rng.integers(1, 7))
        A = rng.uniform(0.05, 1.5, size=(m, n)).round(2)
        c = rng.uniform(0.1, 2.0, size=n).round(2)
        maximize = bool(rng.integers(0, 2))
        if maximize:
            ops = np.full(m, -1)
            b = rng.uniform(1.0, 6.0, size=m).round(2)
        else:
            ops = np.full(m, 1)
            b = rng.uniform(0.2, 1.0, size=m).round(2)
        lp = LinearProgram(c=c, A=A, b=b, ops=ops, maximize=maximize)
        r = solve_lp(lp)
        if r.status != 0 or r.duals is None:
            continue
        if maximize:
            ref = linprog(-c, A_ub=A, b_ub=b, method="highs",
                          options={"presolve": False})
            sgn_row = 1.0
        else:
            ref = linprog(c, A_ub=-A, b_ub=-b, method="highs",
                          options={"presolve": False})
            sgn_row = -1.0
        if ref.status != 0:
            continue
        total += 1
        us = -1.0 if maximize else 1.0
        assert np.allclose(r.duals, us * ref.ineqlin.marginals * sgn_row,
                           atol=1e-5)
        assert np.allclose(r.reduced_costs, us * ref.lower.marginals,
                           atol=1e-5)
    assert total >= 15          # enough non-degenerate instances checked


def test_sensitivity_textbook_shadow_prices():
    """max 3x1+5x2 s.t. x1<=4, 2x2<=12, 3x1+2x2<=18 (the reference's own
    test problem): binding rows 2 and 3 have shadow prices 3/2 and 1."""
    lp = LinearProgram(c=[3, 5], A=[[1, 0], [0, 2], [3, 2]],
                       b=[4, 12, 18], ops=[-1, -1, -1], maximize=True)
    r = solve_lp(lp)
    assert r.success
    assert r.duals == pytest.approx([0.0, 1.5, 1.0], abs=1e-6)
    assert r.reduced_costs == pytest.approx([0.0, 0.0], abs=1e-6)


def test_dual_reoptimize_after_rhs_change():
    """Dual-simplex reoptimization: RHS changes keep the old basis
    dual-feasible but may break primal feasibility — the exact regime the
    dual loop repairs (the reference's HiGHS engine is 'highs-ds')."""
    from simplex_tpu import reoptimize

    lp = LinearProgram(c=[3, 5], A=[[1, 0], [0, 2], [3, 2]],
                       b=[4, 12, 18], ops=[-1, -1, -1], maximize=True)
    r0 = solve_lp(lp)
    assert r0.success

    # Tightened b2: old basis goes primal-infeasible (slack1 < 0).
    lp2 = LinearProgram(c=lp.c, A=lp.A, b=[4, 2, 18], ops=lp.ops,
                        maximize=True)
    r1 = reoptimize(lp2, r0.basis)
    cold = solve_lp(lp2)
    assert r1.success and r1.nit >= 1
    assert abs(r1.z - cold.z) < 1e-6
    assert r1.duals is not None

    # Relaxed rhs: basis stays optimal -> zero dual pivots.
    lp3 = LinearProgram(c=lp.c, A=lp.A, b=[5, 12, 18], ops=lp.ops,
                        maximize=True)
    r2 = reoptimize(lp3, r0.basis)
    assert r2.success and r2.nit == 0
    assert abs(r2.z - solve_lp(lp3).z) < 1e-6


def test_dual_reoptimize_random_agrees_with_cold():
    from simplex_tpu import reoptimize

    rng = np.random.default_rng(3)
    agree = tried = 0
    for _ in range(20):
        m, n = int(rng.integers(2, 7)), int(rng.integers(2, 7))
        A = rng.uniform(0.1, 1.5, size=(m, n)).round(2)
        b = rng.uniform(1.0, 6.0, size=m).round(2)
        c = rng.uniform(0.1, 2.0, size=n).round(2)
        lp = LinearProgram(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True)
        r = solve_lp(lp)
        if not r.success:
            continue
        b2 = (b * rng.uniform(0.6, 1.4, size=m)).round(2)
        lp2 = LinearProgram(c=c, A=A, b=b2, ops=np.full(m, -1),
                            maximize=True)
        rr = reoptimize(lp2, r.basis)
        cc = solve_lp(lp2)
        tried += 1
        assert rr.status == cc.status
        if rr.success:
            assert abs(rr.z - cc.z) < 1e-5
        agree += 1
    assert tried >= 15 and agree == tried


def test_dual_reoptimize_devex_and_dantzig_agree():
    """Dual Devex row pricing changes the pivot SEQUENCE, never the
    optimum: both rules must land on the same certified objective."""
    from simplex_tpu import reoptimize
    from simplex_tpu.config import SolverConfig

    rng = np.random.default_rng(19)
    for _ in range(6):
        m, n = 24, 16
        rowscale = 10.0 ** rng.uniform(-1.5, 1.5, m)
        A = rng.uniform(0.1, 1.0, size=(m, n)) * rowscale[:, None]
        b = rng.uniform(m * 0.3, m * 0.6, size=m) * rowscale
        c = rng.uniform(0.1, 1.0, size=n)
        lp = LinearProgram(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True)
        r0 = solve_lp(lp)
        assert r0.success
        b2 = b * rng.uniform(0.6, 1.0, m)
        lp2 = LinearProgram(c=c, A=A, b=b2, ops=np.full(m, -1),
                            maximize=True)
        r_dx = reoptimize(lp2, r0.basis, SolverConfig(pivot_rule="devex"))
        r_dz = reoptimize(lp2, r0.basis, SolverConfig(pivot_rule="dantzig"))
        assert r_dx.success and r_dz.success
        assert abs(r_dx.z - r_dz.z) <= 1e-6 * (1 + abs(r_dz.z))


def test_dual_reoptimize_stale_basis_falls_back():
    from simplex_tpu import reoptimize

    lp = LinearProgram(c=[3, 5], A=[[1, 0], [0, 2], [3, 2]],
                       b=[4, 12, 18], ops=[-1, -1, -1], maximize=True)
    bad = np.array([0, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32)
    r = reoptimize(lp, bad)
    assert r.success and abs(r.z - 36.0) < 1e-6


def test_devex_pricing_matches_dantzig():
    """Devex (approximate steepest-edge) pricing: same optima, typically
    fewer pivots; Bland anti-cycling still overrides."""
    from simplex_tpu.config import SolverConfig

    devex = SolverConfig(pivot_rule="devex")
    rng = np.random.default_rng(42)
    for _ in range(40):
        m, n = int(rng.integers(2, 10)), int(rng.integers(2, 10))
        A = rng.normal(size=(m, n)).round(2)
        ops = rng.choice([-1, 0, 1], size=m)
        x0 = rng.uniform(0, 3, size=n).round(2)
        slack = rng.uniform(0.1, 2.0, size=m).round(2)
        b = (A @ x0 + np.where(ops == -1, slack,
                               np.where(ops == 1, -slack, 0.0))).round(4)
        lp = LinearProgram(c=rng.normal(size=n).round(2), A=A, b=b, ops=ops,
                           maximize=bool(rng.integers(0, 2)))
        r1 = solve_lp(lp)
        r2 = solve_lp(lp, devex)
        assert r1.status == r2.status
        if r1.success:
            assert abs(r1.z - r2.z) <= 1e-5 * (1 + abs(r1.z))


def test_pad_plan_gentle_buckets():
    """The padding plan must bound overhead (<= ~12.5% per axis) and count
    exact slack/artificial columns — a 2048-row all-<= LP must NOT get the
    old 4096x8192 power-of-two tableau."""
    from simplex_tpu.models.dense import _bucket_gentle, _pad_plan
    from simplex_tpu.core.problem import compile_standard_form

    assert _bucket_gentle(2049, 8) <= 2049 * 1.13
    assert _bucket_gentle(5, 8) == 8
    assert _bucket_gentle(129, 128) % 128 == 0

    rng = np.random.default_rng(0)
    m = n = 256
    lp = LinearProgram(c=rng.uniform(0.1, 1, n),
                       A=rng.uniform(0.05, 1, (m, n)),
                       b=rng.uniform(50, 100, m),
                       ops=np.full(m, -1), maximize=True)
    row_pad, col_pad = _pad_plan(lp)
    sf = compile_standard_form(lp, row_pad=row_pad, col_pad=col_pad)
    assert sf.m_pad + 1 <= (m + 1) * 1.13
    # all-<= LP: n decision + m slack + padding units + RHS, no artificials
    assert sf.n_pad + 1 <= ((n + m) + (sf.m_pad - m) + 1) * 1.2 + 128


def test_beale_cycling_example():
    """Beale's classic cycling LP (Dantzig pricing cycles forever without
    anti-cycling).  The stall-gated Bland switch must terminate it at the
    true optimum z = -1/20."""
    lp = LinearProgram(
        c=[-0.75, 150.0, -0.02, 6.0],
        A=[[0.25, -60.0, -1.0 / 25.0, 9.0],
           [0.5, -90.0, -1.0 / 50.0, 3.0],
           [0.0, 0.0, 1.0, 0.0]],
        b=[0.0, 0.0, 1.0],
        ops=[-1, -1, -1],
        maximize=False,
    )
    res = solve_lp(lp)
    assert res.status == 0
    assert res.z == pytest.approx(-0.05, abs=1e-9)
    from scipy.optimize import linprog
    ref = linprog(lp.c, A_ub=lp.A, b_ub=lp.b, method="highs")
    assert res.z == pytest.approx(ref.fun, abs=1e-9)


@pytest.mark.parametrize("refactor_every", [4, 8, 64])
def test_lu_drift_control_reaches_scipy_optimum(refactor_every):
    """Drift control is the exact on-device LU refactorization at any
    cadence: a two-phase LP refactorized every few pivots reaches scipy's
    optimum, and the final basis passes the host f64 certification."""
    import jax.numpy as jnp
    from scipy.optimize import linprog
    from simplex_tpu.core.problem import compile_standard_form
    from simplex_tpu.models.dense import _finalize_on_host
    from simplex_tpu.ops import tableau as tops

    rng = np.random.default_rng(1)
    m, n = 48, 32
    A = rng.uniform(0.05, 1.0, (m, n))
    x0 = rng.uniform(0.5, 1.5, n)
    ops = np.concatenate([np.full(m - 8, -1), np.full(8, 1)])
    b = A @ x0 + np.where(ops == -1, 0.5, -0.5)
    lp = LinearProgram(c=rng.uniform(0.1, 1, n), A=A, b=b, ops=ops,
                       maximize=True)
    sf = compile_standard_form(lp, dtype=np.float32)
    args = [jnp.asarray(x) for x in
            (sf.tableau, sf.basis, sf.col_mask_p1, sf.col_mask_p2,
             sf.obj_row_p1, sf.obj_row_p2)]
    T, basis, status, _ = tops.solve_tableau(
        *args, need_phase1=sf.need_phase1, refactor_every=refactor_every,
        devex=True)
    assert int(status) == 0
    _, z_min = tops.extract_solution(T, basis, sf.n_vars)
    ref = linprog(-lp.c, A_ub=np.vstack([A[ops == -1], -A[ops == 1]]),
                  b_ub=np.concatenate([b[ops == -1], -b[ops == 1]]),
                  method="highs")
    assert float(z_min) == pytest.approx(ref.fun, rel=1e-4)
    certified, _, _, _ = _finalize_on_host(sf, lp, np.asarray(basis))
    assert certified
