"""No device solve path contracts at default precision.

A float32 ``dot_general`` at default precision may run in TF32 on a GPU
(about 10 mantissa bits); every contraction left on a solve path states
``precision=HIGHEST``.  The checks scan the traced jaxprs, sub-jaxprs
(while/cond bodies, shard_map, custom_linear_solve) included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from simplex_tpu.core.problem import LinearProgram, compile_standard_form
from simplex_tpu.models.batched import compile_batch_uniform

_HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def _dot_precisions(jaxpr):
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(x, "eqns"):
                    found += _dot_precisions(x)
                elif hasattr(x, "jaxpr") and hasattr(x.jaxpr, "eqns"):
                    found += _dot_precisions(x.jaxpr)
    return found


def _assert_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "expected at least one contraction on this path"
    bad = [p for p in precs if p != _HIGHEST]
    assert not bad, f"{len(bad)} of {len(precs)} dot_generals not HIGHEST"


def _small_lp(seed=0, m=6, n=5):
    rng = np.random.default_rng(seed)
    return LinearProgram(c=rng.uniform(0.1, 1, n),
                         A=rng.uniform(0.1, 1, (m, n)),
                         b=rng.uniform(1, 5, m),
                         ops=np.array([-1] * (m - 2) + [1, 0]),
                         maximize=True)


def _batch_args(ub=False):
    rng = np.random.default_rng(1)
    B, m, n = 4, 6, 5
    cb = compile_batch_uniform(
        rng.uniform(0.1, 1, (B, n)), rng.uniform(0.1, 1, (B, m, n)),
        rng.uniform(1, 5, (B, m)), np.array([-1] * (m - 2) + [1, 0]),
        maximize=True, ub=(rng.uniform(1, 3, (B, n)) if ub else None))
    args = [jnp.asarray(x) for x in
            (cb.T0, cb.basis, cb.col_mask_p1, cb.col_mask_p2,
             cb.obj_row_p1, cb.obj_row_p2, cb.need_p1)]
    if ub:
        args.append(jnp.asarray(cb.ub_ext))
    return args


@pytest.mark.parametrize("need_phase1", [False, True])
def test_solve_tableau_contractions_are_highest(need_phase1):
    from simplex_tpu.ops.tableau import solve_tableau

    sf = compile_standard_form(_small_lp(), dtype=np.float32)
    args = [jnp.asarray(x) for x in
            (sf.tableau, sf.basis, sf.col_mask_p1, sf.col_mask_p2,
             sf.obj_row_p1, sf.obj_row_p2)]
    _assert_highest(functools.partial(
        solve_tableau, need_phase1=need_phase1, devex=True), *args)


def test_dual_kernels_contractions_are_highest():
    from simplex_tpu.ops.tableau import (solve_tableau_dual,
                                         solve_tableau_dual_bounded)

    sf = compile_standard_form(_small_lp(), dtype=np.float32)
    T0 = jnp.asarray(sf.tableau)
    basis = jnp.asarray(sf.basis)
    mask = jnp.asarray(sf.col_mask_p2)
    _assert_highest(solve_tableau_dual, T0, basis, mask)
    ub = jnp.full((sf.n_pad,), jnp.inf, jnp.float32)
    at_up = jnp.zeros((sf.n_pad,), bool)
    _assert_highest(solve_tableau_dual_bounded, T0, basis, mask, ub, at_up)


@pytest.mark.parametrize("phase2_only", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
def test_batched_contractions_are_highest(bounded, phase2_only):
    from simplex_tpu.ops import batched as bops

    fn = (bops.solve_tableau_batch_bounded if bounded
          else bops.solve_tableau_batch)
    _assert_highest(functools.partial(fn, devex=True,
                                      phase2_only=phase2_only),
                    *_batch_args(ub=bounded))


@pytest.mark.parametrize("bounded", [False, True])
def test_sharded_body_contractions_are_highest(bounded):
    from simplex_tpu.parallel.sharded import make_mesh, solve_tableau_sharded

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices (tests/conftest.py provides 8)")
    rng = np.random.default_rng(2)
    B, m, n = 2, 8, 5
    cb = compile_batch_uniform(
        rng.uniform(0.1, 1, (B, n)), rng.uniform(0.1, 1, (B, m, n)),
        rng.uniform(1, 5, (B, m)), np.full(m, -1), True, row_pad=2,
        align_total=False)
    m_pad = cb.basis.shape[1]
    args = (jnp.asarray(cb.T0[:, :-1, :]), jnp.asarray(cb.basis),
            jnp.asarray(cb.T0[:, -1, :]), jnp.asarray(cb.col_mask_p1),
            jnp.asarray(cb.col_mask_p2),
            jnp.asarray(cb.col_mask_p1 & ~cb.col_mask_p2),
            jnp.asarray(cb.obj_row_p1), jnp.asarray(cb.obj_row_p2),
            jnp.asarray(cb.need_p1), jnp.ones((B, m_pad), bool),
            jnp.full((B, cb.col_mask_p1.shape[1]), jnp.inf, jnp.float32))
    _assert_highest(functools.partial(
        solve_tableau_sharded, mesh=make_mesh(batch=1, row=2),
        bounded=bounded), *args)


def test_pdhg_and_revised_contractions_are_highest():
    from simplex_tpu.models.pdhg import _pdhg_solve
    from simplex_tpu.models.revised import _refactor, _run_phase_revised

    rng = np.random.default_rng(3)
    B, m, n = 3, 4, 6
    _assert_highest(functools.partial(_pdhg_solve, max_iters=8),
                    jnp.asarray(rng.uniform(0.1, 1, (B, m, n)), jnp.float32),
                    jnp.ones((B, m), jnp.float32),
                    -jnp.ones((B, n), jnp.float32),
                    jnp.zeros((B, m), bool))
    A = jnp.asarray(np.hstack([rng.uniform(0.1, 1, (m, n)), np.eye(m)]),
                    jnp.float32)
    b = jnp.ones((m,), jnp.float32)
    basis = jnp.arange(n, n + m, dtype=jnp.int32)
    B_inv, x_B = _refactor(A, b, basis)
    cost = jnp.concatenate([-jnp.ones((n,)), jnp.zeros((m + 1,))])
    _assert_highest(
        functools.partial(_run_phase_revised, devex=True),
        A, b, cost, jnp.ones((n + m,), bool), jnp.zeros((n + m + 1,), bool),
        B_inv, x_B, basis, jnp.zeros((n + m,), bool),
        jnp.full((n + m,), jnp.inf), jnp.int32(0), jnp.bool_(True))
