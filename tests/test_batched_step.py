"""The batched XLA step (ops/batched.py) against the exact host engine.

One parametrised case per instance family: <= only, mixed <=/>=/=, Bland
pricing from the start, Devex, tiny and 30x50 shapes, native upper bounds
(alone and with mixed rows, Bland, Devex) and the ``phase2_only`` fast
driver.  Statuses must equal ``models.dense.solve_lp_host_exact``'s and
optimal objectives agree to f32 round-off (the raw device result, before
any host certification).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from simplex_tpu.core.problem import LinearProgram, STATUS_OPTIMAL
from simplex_tpu.models.batched import compile_batch_uniform
from simplex_tpu.models.dense import solve_lp_host_exact
from simplex_tpu.ops import batched as bops

_MIXED = np.array([-1, -1, -1, -1, 1, 1, 0, 0, -1])


def _random_batch(seed, B=12, m=9, n=13, ops=None):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.1, 2.0, (B, m, n))
    c = rng.uniform(0.5, 3.0, (B, n))
    b = rng.uniform(5.0, 25.0, (B, m))
    if ops is None:
        ops = np.full(m, -1)
    return c, A, b, np.asarray(ops)


def _solve_xla(c, A, b, ops, ub=None, **kw):
    cb = compile_batch_uniform(c, A, b, ops, maximize=True, ub=ub)
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
    if ub is None:
        T, basis, status, _, _ = bops.solve_tableau_batch(*args, **kw)
        _, z_min = bops.extract_solution_batch(T, basis, cb.n_vars)
        at_upper = None
    else:
        T, basis, at_upper, status, _, _ = bops.solve_tableau_batch_bounded(
            *args, jnp.asarray(cb.ub_ext), **kw)
        _, z_min = bops.extract_solution_batch_bounded(
            T, basis, at_upper, jnp.asarray(cb.ub_ext), cb.n_vars)
    return np.asarray(status), -np.asarray(z_min, np.float64), at_upper


_FAMILIES = {
    "le_only": dict(seed=0),
    "mixed_ops": dict(seed=1, ops=_MIXED),
    "bland": dict(seed=2, kw=dict(bland_after=0)),
    "devex": dict(seed=5, ops=_MIXED, kw=dict(devex=True)),
    "tiny_4x3x2": dict(seed=4, B=4, m=3, n=2),
    "shape_16x30x50": dict(seed=4, B=16, m=30, n=50),
    "bounded_le_only": dict(seed=10, ub=(0.5, 6.0)),
    "bounded_mixed_ops": dict(seed=11, ops=_MIXED, ub=(2.0, 30.0)),
    "bounded_bland": dict(seed=12, ub=(0.5, 8.0), kw=dict(bland_after=0)),
    "bounded_devex": dict(seed=13, ops=_MIXED, ub=(1.0, 20.0),
                          kw=dict(devex=True)),
    "phase2_only": dict(seed=20, B=16, m=12, n=18,
                        kw=dict(phase2_only=True, devex=True)),
    "phase2_only_bounded": dict(seed=21, ub=(0.5, 6.0),
                                kw=dict(phase2_only=True)),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_xla_step_matches_host_engine(family):
    f = _FAMILIES[family]
    c, A, b, ops = _random_batch(f["seed"], B=f.get("B", 12),
                                 m=f.get("m", 9), n=f.get("n", 13),
                                 ops=f.get("ops"))
    ub = None
    if "ub" in f:
        lo, hi = f["ub"]
        ub = np.random.default_rng(100 + f["seed"]).uniform(lo, hi, c.shape)
    status, z, at_upper = _solve_xla(c, A, b, ops, ub=ub, **f.get("kw", {}))
    for i in range(c.shape[0]):
        ref = solve_lp_host_exact(LinearProgram(
            c=c[i], A=A[i], b=b[i], ops=ops, maximize=True,
            ub=None if ub is None else ub[i]))
        assert int(status[i]) == int(ref.status), (family, i)
        if ref.status == STATUS_OPTIMAL:
            assert abs(z[i] - ref.z) <= 1e-4 * (1.0 + abs(ref.z)), (family, i)
    if family == "bounded_le_only":
        # The bounded machinery must actually engage on this batch.
        assert np.asarray(at_upper).any(), "no at-upper columns exercised"


def test_devex_reduces_pivots_batched():
    """Devex pricing must not exceed Dantzig's pivot counts on a non-trivial
    batch (it typically cuts them substantially on larger LPs)."""
    c, A, b, ops = _random_batch(6, B=8, m=24, n=40)
    cb = compile_batch_uniform(c, A, b, ops, maximize=True)
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
    out_dv = bops.solve_tableau_batch(*args, devex=True)
    out_dz = bops.solve_tableau_batch(*args, devex=False)
    assert (np.asarray(out_dv[2]) == 0).all()
    assert (np.asarray(out_dz[2]) == 0).all()
    assert np.asarray(out_dv[4]).sum() <= np.asarray(out_dz[4]).sum()


def test_phase2_only_matches_default_unbounded():
    """The chunked no-cond fast path (phase2_only=True) must agree with
    the default driver on all-<= batches (statuses exact, objectives to
    solver tolerance — the refactor cadence differs by one step)."""
    c, A, b, ops = _random_batch(20, B=16, m=12, n=18)
    cb = compile_batch_uniform(c, A, b, ops, maximize=True)
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
    out_d = bops.solve_tableau_batch(*args, phase2_only=False)
    out_f = bops.solve_tableau_batch(*args, phase2_only=True)
    np.testing.assert_array_equal(np.asarray(out_d[2]),
                                  np.asarray(out_f[2]))
    zd = np.asarray(out_d[0][:, -1, -1])
    zf = np.asarray(out_f[0][:, -1, -1])
    np.testing.assert_allclose(zd, zf, rtol=1e-5, atol=1e-5)


def test_phase2_only_matches_default_bounded():
    c, A, b, ops = _random_batch(21, B=12, m=9, n=13)
    rng = np.random.default_rng(210)
    ub = rng.uniform(0.5, 6.0, c.shape)
    cb = compile_batch_uniform(c, A, b, ops, maximize=True, ub=ub)
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1, cb.ub_ext)]
    out_d = bops.solve_tableau_batch_bounded(*args, phase2_only=False)
    out_f = bops.solve_tableau_batch_bounded(*args, phase2_only=True)
    np.testing.assert_array_equal(np.asarray(out_d[3]),
                                  np.asarray(out_f[3]))
    np.testing.assert_allclose(np.asarray(out_d[0][:, -1, -1]),
                               np.asarray(out_f[0][:, -1, -1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out_d[2]),
                                  np.asarray(out_f[2]))  # at_upper


def test_phase2_only_long_run_crosses_refactor_boundary():
    """A batch needing >refactor_every pivots exercises the chunk
    boundary refactor of the fast path; verdicts must match scipy."""
    from scipy.optimize import linprog

    rng = np.random.default_rng(22)
    B, m, n = 4, 24, 40
    A = rng.uniform(0.1, 2.0, (B, m, n))
    c = rng.uniform(0.5, 3.0, (B, n))
    b = rng.uniform(5.0, 25.0, (B, m))
    ops = np.full(m, -1)
    cb = compile_batch_uniform(c, A, b, ops, maximize=True)
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
    out = bops.solve_tableau_batch(*args, phase2_only=True, refactor_every=8)
    st = np.asarray(out[2])
    assert (st == 0).all()
    for i in range(B):
        ref = linprog(-c[i], A_ub=A[i], b_ub=b[i], method="highs")
        # -T[-1,-1] is the min-form objective == ref.fun (c negated).
        np.testing.assert_allclose(-np.asarray(out[0][i, -1, -1]),
                                   ref.fun, rtol=1e-4)


@pytest.mark.parametrize("clamp_rhs", [False, True])
def test_pivot_update_matches_numpy_rank1(clamp_rhs):
    """ops.tableau.pivot_update (the large-tableau pivot) against a float64
    NumPy rank-1 elimination on the same f32 input."""
    from simplex_tpu.ops.tableau import pivot_update

    rng = np.random.default_rng(9)
    R, W = 257, 300
    T = rng.normal(size=(R, W)).astype(np.float32)
    T[4, -1] = -0.5                      # a negative RHS for the clamp
    basis = jnp.arange(R - 1, dtype=jnp.int32)
    Tj = jnp.asarray(T)
    ref = T.astype(np.float64)
    for r, s in [(3, 7), (0, 0), (R - 2, W - 2), (4, 11)]:
        Tj, basis = pivot_update(Tj, basis, jnp.int32(r), jnp.int32(s),
                                 clamp_rhs=clamp_rhs)
        prow = ref[r] / ref[r, s]
        if clamp_rhs:
            prow[-1] = max(prow[-1], 0.0)
        ref = ref - np.outer(ref[:, s], prow)
        ref[r] = prow
        ref[:, s] = 0.0
        ref[r, s] = 1.0
        assert int(basis[r]) == s
    np.testing.assert_allclose(np.asarray(Tj, np.float64), ref,
                               atol=1e-4 * np.max(np.abs(ref)))
