"""Distributed-path tests on the 8-virtual-device CPU mesh (conftest.py).

The reference has no distributed code to mirror (SURVEY.md §2.4); these
tests validate the row-block sharded solver against scipy and
against the single-chip batched engine, plus the driver entry points.
"""
import os
import numpy as np
import pytest
from scipy.optimize import linprog

import jax

from simplex_tpu.parallel.sharded import make_mesh, solve_arrays_sharded


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def _scipy_ref(c, A, b, ops, maximize):
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for j in range(len(b)):
        if ops[j] == -1:
            A_ub.append(A[j]); b_ub.append(b[j])
        elif ops[j] == 1:
            A_ub.append(-A[j]); b_ub.append(-b[j])
        else:
            A_eq.append(A[j]); b_eq.append(b[j])
    cs = np.asarray(c) * (-1 if maximize else 1)
    return linprog(cs, A_ub=A_ub or None, b_ub=b_ub or None,
                   A_eq=A_eq or None, b_eq=b_eq or None,
                   method="highs", options={"presolve": False})


@needs_8
@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (4, 2)])
def test_sharded_matches_scipy(mesh_shape):
    mesh = make_mesh(batch=mesh_shape[0], row=mesh_shape[1])
    rng = np.random.default_rng(5)
    B, m, n = 4, 12, 6
    A = rng.normal(size=(B, m, n)).round(2)
    b = rng.uniform(-2, 9, size=(B, m)).round(2)
    c = rng.normal(size=(B, n)).round(2)
    ops = rng.choice([-1, 0, 1], size=m)
    res = solve_arrays_sharded(c, A, b, ops, maximize=False, mesh=mesh)
    for i in range(B):
        ref = _scipy_ref(c[i], A[i], b[i], ops, False)
        if ref.status == 0 and res["status"][i] == 0:
            assert res["z"][i] == pytest.approx(ref.fun, rel=1e-3, abs=1e-3)
        else:
            assert ref.status == res["status"][i], i


@needs_8
def test_sharded_agrees_with_batched_engine():
    from simplex_tpu.models.batched import BatchedSimplexSolver

    mesh = make_mesh(batch=2, row=4)
    rng = np.random.default_rng(7)
    B, m, n = 6, 8, 5
    A = rng.uniform(0.1, 2.0, size=(B, m, n))
    b = rng.uniform(1.0, 8.0, size=(B, m))
    c = rng.uniform(0.1, 2.0, size=(B, n))
    ops = np.full((m,), -1)
    sharded = solve_arrays_sharded(c, A, b, ops, maximize=True, mesh=mesh)
    local = BatchedSimplexSolver().solve_arrays(c, A, b, ops, maximize=True)
    np.testing.assert_array_equal(sharded["status"], local.status)
    np.testing.assert_allclose(sharded["z"], local.z, rtol=1e-4, atol=1e-4)


@needs_8
def test_sharded_tall_lp_matches_scipy():
    """Genuinely tall sharded solve (m=1024 split 4 ways, B=8 split 2 ways).

    VERDICT r1 next-steps #1 acceptance: a B=8, m=1024 batch sharded (2,4)
    matches scipy to 1e-4 (with the Devex + stall-gated-Bland + drift-resync
    numerics, the measured error is ~1e-7)."""
    mesh = make_mesh(batch=2, row=4)
    rng = np.random.default_rng(11)
    B, m, n = 8, 1024, 32
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    b = rng.uniform(m * 0.3, m * 0.6, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    res = solve_arrays_sharded(c, A, b, ops, maximize=True, mesh=mesh)
    assert np.all(res["status"] == 0)
    for i in range(B):
        ref = _scipy_ref(c[i], A[i], b[i], ops, True)
        assert res["z"][i] == pytest.approx(-ref.fun, rel=1e-4, abs=1e-4)


@needs_8
def test_sharded_tall_two_phase_matches_batched_and_scipy():
    """Tall TWO-PHASE solve (>= and = rows at m=512): the sharded kernel must
    agree with scipy to 1e-4 and with the single-chip batched engine
    status-for-status (VERDICT r1 next-steps #1)."""
    from simplex_tpu.models.batched import BatchedSimplexSolver

    mesh = make_mesh(batch=2, row=4)
    rng = np.random.default_rng(3)
    B, m, n = 8, 512, 24
    A = rng.normal(size=(B, m, n)).round(3)
    x0 = rng.uniform(0.1, 2.0, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0)
    ops = rng.choice([-1, 1, 0], size=m, p=[0.7, 0.2, 0.1])
    slack = rng.uniform(0.1, 1.0, size=(B, m))
    b = np.where(ops == -1, b + slack, np.where(ops == 1, b - slack, b))
    c = (np.abs(rng.normal(size=(B, n))) + 0.01).round(3)

    res = solve_arrays_sharded(c, A, b, ops, maximize=False, mesh=mesh)
    local = BatchedSimplexSolver().solve_arrays(c, A, b, ops, maximize=False)
    np.testing.assert_array_equal(res["status"], local.status)
    for i in range(B):
        ref = _scipy_ref(c[i], A[i], b[i], ops, False)
        assert ref.status == 0 and res["status"][i] == 0
        assert res["z"][i] == pytest.approx(ref.fun, rel=1e-4, abs=1e-4)


@needs_8
def test_sharded_verdicts_are_certified():
    """VERDICT r2 item 2/5: sharded results carry f64 certification — every
    optimum KKT-checked, untrusted claims escalated to the exact host
    engine — so no sharded status can disagree with an exact solve."""
    mesh = make_mesh(batch=2, row=4)
    rng = np.random.default_rng(21)
    B, m, n = 8, 10, 6
    A = rng.normal(size=(B, m, n)).round(2)
    b = rng.uniform(-2, 8, size=(B, m)).round(2)
    c = rng.normal(size=(B, n)).round(2)
    ops = rng.choice([-1, 0, 1], size=m)
    res = solve_arrays_sharded(c, A, b, ops, maximize=False, mesh=mesh)
    assert "certified" in res and "escalated" in res
    for i in range(B):
        ref = _scipy_ref(c[i], A[i], b[i], ops, False)
        assert ref.status == res["status"][i], i
        if ref.status == 0:
            assert res["z"][i] == pytest.approx(ref.fun, rel=1e-6, abs=1e-6)
        assert res["certified"][i] or res["status"][i] == 1
    # And certification is skippable for raw-throughput benchmarking.
    raw = solve_arrays_sharded(c, A, b, ops, maximize=False, mesh=mesh,
                               certify=False)
    assert "certified" not in raw


@needs_8
def test_sharded_16k_rows_on_8way_row_mesh():
    """VERDICT r2 item 5 acceptance: a ≥16k-row LP on a (1,8) mesh.

    2048 rows per device; few pivots by construction (interior b keeps the
    initial slack basis near-optimal) so the mechanism test stays fast —
    the point is exercising the collectives + Harris window at a row count
    where per-device blocks are genuinely large.  Certification is ON
    (VERDICT r3 item 2): the structured certifier collapses the m=16k KKT
    systems to a k×k LU (~0.1 s) instead of the dense f64 LU (~45 s), so
    the f64 safety net now covers the 100k-row north-star regime."""
    mesh = make_mesh(batch=1, row=8)
    rng = np.random.default_rng(33)
    B, m, n = 1, 16384, 8
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    b = rng.uniform(m * 0.3, m * 0.6, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    res = solve_arrays_sharded(c, A, b, ops, maximize=True, mesh=mesh,
                               max_iters=64, certify=True)
    assert res["status"][0] == 0
    assert res["certified"][0] and not res["escalated"][0]
    ref = _scipy_ref(c[0], A[0], b[0], ops, True)
    assert res["z"][0] == pytest.approx(-ref.fun, rel=1e-5, abs=1e-5)


@needs_8
def test_sharded_many_pivots_large_m():
    """VERDICT r3 item 1: a large-m sharded solve that must SUSTAIN pivots
    — b = A x0 with ~n tight rows forces the kernel through hundreds of
    Devex/Harris pivots with drift resync at m=8192, instead of the
    near-optimal interior start of the 16k mechanism test.  The certified
    answer must match scipy HiGHS and the single-chip dense engine."""
    from simplex_tpu import LinearProgram, solve_lp

    mesh = make_mesh(batch=1, row=8)
    rng = np.random.default_rng(71)
    B, m, n = 1, 8192, 192
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    x0 = rng.uniform(0.5, 1.5, size=n)
    tight = A[0] @ x0
    slack = np.where(rng.random(m) < n / m * 1.5, 0.0,
                     rng.uniform(0.5, 5.0, size=m))
    b = (tight + slack)[None, :]
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    res = solve_arrays_sharded(c, A, b, ops, maximize=True, mesh=mesh,
                               max_iters=2048, certify=True)
    assert res["status"][0] == 0
    assert res["certified"][0], "large-m verdict must carry f64 certification"
    assert res["iters"] >= 150, f"expected a many-pivot run, got {res['iters']}"
    ref = _scipy_ref(c[0], A[0], b[0], ops, True)
    assert res["z"][0] == pytest.approx(-ref.fun, rel=1e-6, abs=1e-6)
    dense = solve_lp(LinearProgram(c=c[0], A=A[0], b=b[0], ops=ops,
                                   maximize=True))
    assert dense.success
    assert res["z"][0] == pytest.approx(dense.z, rel=1e-6, abs=1e-6)


@needs_8
def test_sharded_native_bounds_vs_scipy():
    """Round 4: the SHARDED kernel handles 0 <= x <= ub natively (bounded
    ratio test with pmin/pmax collectives, bound flips, replicated
    at-upper state) — a bound-heavy sharded LP keeps m at the structural
    row count.  Certified, scipy parity, mixed operators."""
    mesh = make_mesh(batch=2, row=4)
    rng = np.random.default_rng(77)
    B, m, n = 8, 16, 6
    A = rng.normal(size=(B, m, n)).round(2)
    x0 = rng.uniform(0.2, 2.0, size=(B, n))
    ops = rng.choice([-1, 0, 1], size=m, p=[0.6, 0.1, 0.3])
    slack = rng.uniform(0.1, 1.0, size=(B, m))
    b = np.einsum("bmn,bn->bm", A, x0) + np.where(
        ops == -1, slack, np.where(ops == 1, -slack, 0.0))
    c = rng.normal(size=(B, n)).round(2)
    has_ub = rng.random((B, n)) < 0.6
    ub = np.where(has_ub,
                  x0 + rng.uniform(-0.3, 1.5, size=(B, n)).clip(0.01),
                  np.inf)
    res = solve_arrays_sharded(c, A, b, ops, maximize=False, mesh=mesh,
                               ub=ub)
    assert np.all(res["certified"])
    for i in range(B):
        A_ub = [A[i, j] for j in range(m) if ops[j] == -1] + \
               [-A[i, j] for j in range(m) if ops[j] == 1]
        b_ub = [b[i, j] for j in range(m) if ops[j] == -1] + \
               [-b[i, j] for j in range(m) if ops[j] == 1]
        A_eq = [A[i, j] for j in range(m) if ops[j] == 0]
        b_eq = [b[i, j] for j in range(m) if ops[j] == 0]
        bounds = [(0.0, None if np.isinf(ub[i, j]) else ub[i, j])
                  for j in range(n)]
        from scipy.optimize import linprog
        ref = linprog(c[i], A_ub=A_ub or None, b_ub=b_ub or None,
                      A_eq=A_eq or None, b_eq=b_eq or None, bounds=bounds,
                      method="highs", options={"presolve": False})
        assert ref.status == res["status"][i], i
        if ref.status == 0:
            assert res["z"][i] == pytest.approx(
                ref.fun, abs=1e-6 * (1 + abs(ref.fun))), i


@needs_8
def test_sharded_bound_flip_tall():
    """A TALL bounded sharded solve whose optimum sits at upper bounds —
    reached through sharded bound flips — must agree with the batched
    bounded kernel and scipy."""
    from simplex_tpu.models.batched import BatchedSimplexSolver

    mesh = make_mesh(batch=1, row=8)
    rng = np.random.default_rng(13)
    B, m, n = 2, 256, 12
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    x0 = rng.uniform(0.5, 1.5, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0) + rng.uniform(0.1, 0.8, (B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ub = np.where(rng.random((B, n)) < 0.7,
                  x0 * rng.uniform(0.7, 1.3, (B, n)), np.inf)
    res = solve_arrays_sharded(c, A, b, np.full(m, -1), maximize=True,
                               mesh=mesh, ub=ub)
    local = BatchedSimplexSolver().solve_arrays(
        c, A, b, np.full(m, -1), maximize=True, ub=ub)
    np.testing.assert_array_equal(res["status"], local.status)
    assert np.all(res["certified"])
    np.testing.assert_allclose(res["z"], local.z, rtol=1e-6, atol=1e-6)


@needs_8
def test_graft_entry_and_dryrun():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out[2].shape == (4,)          # per-instance statuses
    mod.dryrun_multichip(8)
    mod.dryrun_multichip(4)


@pytest.mark.skipif(
    os.environ.get("SIMPLEX_RUN_100K") != "1",
    reason="config-5 100k-row regime: ~30 min + ~115 GB host RAM on the "
           "virtual mesh; opt in with SIMPLEX_RUN_100K=1 (on four GPUs: "
           "python chip_smoke.py --four-cards)")
def test_sharded_100k_rows_certified():
    """BASELINE config 5: a 100,000-constraint LP solved end-to-end
    through the row-sharded kernel with a certified verdict.

    Uses a (1,2) mesh: XLA's CPU in-process collectives kill a rendezvous
    after a hard-coded 40 s, and 8 device threads timesharing this host's
    2 cores exceed that window at the 40 GB-tableau shape ((1,8) passes
    up to m=32768 here — exercised by the bench artifact)."""
    from simplex_tpu.parallel.sharded import make_mesh, solve_arrays_sharded

    m, n = 100_000, 20
    rng = np.random.default_rng(42)
    A = rng.uniform(0.05, 1.0, size=(1, m, n))
    x0 = rng.uniform(0.5, 1.5, size=n)
    b = (A[0] @ x0 + rng.uniform(0.05, 0.5, size=m))[None, :]
    c = rng.uniform(0.1, 1.0, size=(1, n))
    mesh = make_mesh(batch=1, row=2)
    res = solve_arrays_sharded(c, A, b, np.full(m, -1), maximize=True,
                               mesh=mesh, max_iters=512, certify=True)
    assert res["status"][0] == 0
    assert res["certified"][0]
    assert np.isfinite(res["z"][0])
