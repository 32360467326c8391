"""Batched first-order LP solver (PDHG / PDLP-style).

BASELINE.json's 1M-instance regime: simplex pivots are sequential and
per-instance convergence varies wildly, but PDHG iterations are pure
matrix-vector products over the whole batch, with every instance
advancing in lockstep.  This is the "batched first-order path" SURVEY.md §7
prescribes (cf. PAPERS.md first-order-LP survey: restarted PDHG is the
production approach behind PDLP).

Formulation (after normalizing ``>=`` rows to ``<=`` by negation):

    min c'x  s.t.  A x (<=|=) b,  x >= 0

saddle form  min_x max_y  c'x + y'(Ax - b)  with  y_i >= 0 on inequality
rows, free on equality rows.  Chambolle-Pock updates with extrapolation:

    x+ = max(0, x - tau (c + A'y))
    y+ = proj(y + sigma (A (2x+ - x) - b))

step sizes tau = sigma = 0.9 / ||A||_2 (power iteration), per instance.
Termination: primal feasibility, dual feasibility, and duality-gap residuals
below tol for every instance (masked), or the iteration cap.

This is an approximate solver (1e-4-ish residuals in f32); the exact-vertex
path remains the simplex engines.  For scenario sweeps ("solve these 1M
perturbed LPs approximately") it is the right tool and runs at matmul speed.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..core.problem import OP_EQ, OP_GE, OP_LE

# Every device contraction states its precision: a float32 product may run
# in TF32 on the GPU (about 10 mantissa bits).
_einsum = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)


@dataclasses.dataclass
class PdhgResult:
    x: np.ndarray           # (B, n)
    y: np.ndarray           # (B, m) duals
    objective: np.ndarray   # (B,) c'x in the USER sense
    primal_residual: np.ndarray
    dual_residual: np.ndarray
    gap: np.ndarray
    converged: np.ndarray   # (B,) bool
    iters: int
    solve_time: float = 0.0
    # Filled by solve_arrays_stream(crossover=...): instance index →
    # SimplexResult with the exact vertex recovered by PDHG→simplex
    # crossover (models/crossover.py).
    exact: Optional[dict] = None


def _power_iter_sigma_max(A, iters: int = 30):
    """Largest singular value per instance via power iteration on A'A.

    The Rayleigh-quotient estimate ``||A v|| / ||v||`` on the converged
    (normalized) iterate is the returned value — one extra matvec, no
    second power-iteration pass.
    """
    B, m, n = A.shape
    key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (B, n), dtype=A.dtype)

    def body(_, v):
        v = v / (jnp.linalg.norm(v, axis=1, keepdims=True) + 1e-30)
        w = _einsum("bmn,bn->bm", A, v)
        v = _einsum("bmn,bm->bn", A, w)
        return v

    v = lax.fori_loop(0, iters, body, v)
    v = v / (jnp.linalg.norm(v, axis=1, keepdims=True) + 1e-30)
    Av = _einsum("bmn,bn->bm", A, v)
    return jnp.linalg.norm(Av, axis=1)


def _ruiz_equilibrate(A, iters: int = 8):
    """Batched Ruiz scaling: returns (A_scaled, d_row, d_col) with
    ``A_scaled = diag(d_row) A diag(d_col)`` and near-unit row/col inf-norms.
    Diagonal preconditioning is the single highest-leverage PDHG accelerator
    in PDLP (cf. PAPERS.md first-order-LP survey)."""
    dt = A.dtype
    B, m, n = A.shape
    d_r = jnp.ones((B, m), dt)
    d_c = jnp.ones((B, n), dt)

    def body(_, state):
        As, d_r, d_c = state
        rn = jnp.sqrt(jnp.maximum(jnp.max(jnp.abs(As), axis=2), 1e-12))
        As = As / rn[:, :, None]
        d_r = d_r / rn
        cn = jnp.sqrt(jnp.maximum(jnp.max(jnp.abs(As), axis=1), 1e-12))
        As = As / cn[:, None, :]
        d_c = d_c / cn
        return As, d_r, d_c

    return lax.fori_loop(0, iters, body, (A, d_r, d_c))


@functools.partial(jax.jit, static_argnames=("max_iters", "tol",
                                             "check_every", "bounded"))
def _pdhg_solve(A, b, c, is_eq, ub=None, max_iters: int = 10000,
                tol: float = 1e-4, check_every: int = 40,
                bounded: bool = False):
    """Core batched restarted-averaged PDHG loop (PDLP-style).

    A: (B, m, n); b: (B, m); c: (B, n); is_eq: (B, m) bool;
    ub: (B, n) with +inf where unbounded (``bounded=True`` activates the
    box projection ``x ∈ [0, ub]`` — the prox step clips to the box, the
    dual residual splits per bound status, and the duality gap adds the
    finite-ub multiplier terms; round 4, completing native bounds on the
    first-order path).

    Accelerations over vanilla Chambolle-Pock (each batched, per instance):
    * Ruiz diagonal preconditioning of A (b, c rescaled accordingly;
      convergence is tested in the ORIGINAL space, so ``tol`` semantics are
      unchanged).
    * Iterate averaging with sufficient-decay adaptive restarts (the PDLP
      scheme): every ``check_every`` iterations, restart from the better of
      (current iterate, running average) when its KKT error either decayed
      below half the error at the last restart OR stopped improving.  This
      upgrades PDHG's O(1/k) tail to the restarted linear-convergence
      regime on LPs — measured ~5x fewer iterations to 1e-4 on random
      dense batches vs vanilla.
    """
    B, m, n = A.shape
    dt = A.dtype

    A_s, d_r, d_c = _ruiz_equilibrate(A)
    b_s = b * d_r
    c_s = c * d_c
    if bounded:
        ub_s = ub / d_c              # scaled-space box (inf stays inf)
    else:
        ub = jnp.full((B, n), jnp.inf, dt)
        ub_s = ub
    ub_fin = jnp.isfinite(ub)

    sig_max = _power_iter_sigma_max(A_s)
    base = jnp.asarray(0.9, dt) / jnp.maximum(sig_max, 1e-12)   # (B,)

    # PDLP primal weight ω (per instance): τ = η/ω, σ = η·ω with
    # η = 0.9/σ_max, so τσ‖A‖² < 1 holds for any ω.  Initialization is
    # HYBRID: ω⁰ = 1 for mildly-imbalanced instances (‖c‖/‖b‖ ∈
    # [0.1, 10] — the balanced weight wins there) and sqrt(‖c‖/‖b‖) for
    # genuinely skewed ones (the square root pulls toward 1 while
    # correcting the scale).  Chosen over the r3 scheme (raw ‖c‖/‖b‖ +
    # per-restart ‖Δy‖/‖Δx‖ rebalancing) empirically: on the well-scaled
    # uniform sweep family the r3 rebalancing RANDOM-WALKED ω off the
    # balance point and halved convergence (1022/2048 at 1e-4/10k iters
    # vs r2's 2035/2048 — a regression no test pinned; round 4).
    # Variants measured on (uniform 2048 @ 1e-4, skewed-b×300 32 @ 1e-5,
    # skewed-b×20 32 @ 1e-5):
    #   ω=1 fixed (r2)              2035/2048   0/32    –
    #   ω⁰=‖c‖/‖b‖ + rebal (r3)     1022/2048  25/32    –
    #   ω⁰=‖c‖/‖b‖, no rebal        1898/2048  28/32    –
    #   ω⁰=sqrt(‖c‖/‖b‖), no rebal  2013/2048  26/32  30/32
    #   HYBRID, no rebal (shipped)  2035/2048  26/32  30/32
    w0 = (1e-12 + jnp.linalg.norm(c_s, axis=1)) \
        / (1e-12 + jnp.linalg.norm(b_s, axis=1))
    mild = (w0 >= 0.1) & (w0 <= 10.0)
    omega0 = jnp.where(mild, 1.0, jnp.clip(jnp.sqrt(w0), 1e-4, 1e4))

    scale = 1.0 + jnp.maximum(
        jnp.max(jnp.abs(b), axis=1), jnp.max(jnp.abs(c), axis=1))

    def residuals(x_s, y_s):
        """KKT errors in the ORIGINAL space (x = d_c*x_s, y = d_r*y_s)."""
        x = x_s * d_c
        y = y_s * d_r
        Ax = _einsum("bmn,bn->bm", A, x)
        r_p = Ax - b
        viol = jnp.where(is_eq, jnp.abs(r_p), jnp.maximum(r_p, 0.0))
        primal = jnp.max(viol, axis=1)
        g = c + _einsum("bmn,bm->bn", A, y)
        if bounded:
            # Dual feasibility per bound status: g >= 0 at the lower
            # bound, g <= 0 at the upper, g = 0 strictly inside.
            xs = 1e-6 * (1.0 + jnp.where(ub_fin, ub, 0.0))
            at_lo = x <= xs
            at_hi = ub_fin & (x >= ub - xs)
            dviol = jnp.where(at_lo, jnp.maximum(-g, 0.0),
                              jnp.where(at_hi, jnp.maximum(g, 0.0),
                                        jnp.abs(g)))
            dual = jnp.max(dviol, axis=1)
            # Duality gap with the finite-ub multiplier terms:
            # D(y) = -b'y - Σ_fin u_j max(-g_j, 0).
            lam_u = jnp.where(ub_fin, jnp.maximum(-g, 0.0), 0.0)
            gap = jnp.abs(_einsum("bn,bn->b", c, x)
                          + _einsum("bm,bm->b", b, y)
                          + _einsum("bn,bn->b",
                                       jnp.where(ub_fin, ub, 0.0), lam_u))
        else:
            dual = jnp.max(jnp.maximum(-g, 0.0), axis=1)
            gap = jnp.abs(_einsum("bn,bn->b", c, x)
                          + _einsum("bm,bm->b", b, y))
        return primal, dual, gap

    def kkt(x_s, y_s):
        primal, dual, gap = residuals(x_s, y_s)
        return jnp.maximum(jnp.maximum(primal, dual), 0.1 * gap)

    tau = (base / omega0)[:, None]
    sigma = (base * omega0)[:, None]

    def body(state):
        x, y, xsum, ysum, navg, err_last, k, done = state
        grad_x = c_s + _einsum("bmn,bm->bn", A_s, y)
        if bounded:
            x_new = jnp.clip(x - tau * grad_x, 0.0,
                             jnp.where(ub_fin, ub_s, jnp.inf))
        else:
            x_new = jnp.maximum(x - tau * grad_x, 0.0)
        x_bar = 2.0 * x_new - x
        y_new = y + sigma * (_einsum("bmn,bn->bm", A_s, x_bar) - b_s)
        y_new = jnp.where(is_eq, y_new, jnp.maximum(y_new, 0.0))

        # Freeze converged instances.
        live = ~done
        x = jnp.where(live[:, None], x_new, x)
        y = jnp.where(live[:, None], y_new, y)
        xsum = xsum + jnp.where(live[:, None], x, 0.0)
        ysum = ysum + jnp.where(live[:, None], y, 0.0)
        navg = navg + live.astype(dt)

        def check(args):
            x, y, xsum, ysum, navg, err_last, done = args
            nac = jnp.maximum(navg, 1.0)[:, None]
            x_avg = xsum / nac
            y_avg = ysum / nac
            err_cur = kkt(x, y)
            err_avg = kkt(x_avg, y_avg)
            avg_better = err_avg < err_cur
            err_best = jnp.minimum(err_avg, err_cur)

            # Sufficient decay since the last restart, or stalled: restart
            # from the best candidate and reset the average.
            do = (err_best <= 0.5 * err_last) | (err_best >= err_last)
            x_cand = jnp.where(avg_better[:, None], x_avg, x)
            y_cand = jnp.where(avg_better[:, None], y_avg, y)
            x = jnp.where(do[:, None], x_cand, x)
            y = jnp.where(do[:, None], y_cand, y)
            err_last = jnp.where(do, err_best, err_last)
            xsum = jnp.where(do[:, None], 0.0, xsum)
            ysum = jnp.where(do[:, None], 0.0, ysum)
            navg = jnp.where(do, 0.0, navg)

            primal, dual, gap = residuals(x, y)
            newly = (primal <= tol * scale) & (dual <= tol * scale) & \
                    (gap <= 10.0 * tol * scale)
            done = done | newly
            return x, y, xsum, ysum, navg, err_last, done

        do_check = (k > 0) & ((k % check_every) == 0)
        x, y, xsum, ysum, navg, err_last, done = lax.cond(
            do_check, check, lambda a: a,
            (x, y, xsum, ysum, navg, err_last, done))
        return x, y, xsum, ysum, navg, err_last, k + 1, done

    def cond(state):
        done = state[-1]
        k = state[-2]
        return (~jnp.all(done)) & (k < max_iters)

    x0 = jnp.zeros((B, n), dt)
    y0 = jnp.zeros((B, m), dt)
    done0 = jnp.zeros((B,), bool)
    state = (x0, y0, jnp.zeros_like(x0), jnp.zeros_like(y0),
             jnp.zeros((B,), dt), kkt(x0, y0), jnp.int32(0), done0)
    x, y, _, _, _, _, iters, done = lax.while_loop(cond, body, state)
    primal, dual, gap = residuals(x, y)
    return x * d_c, y * d_r, primal, dual, gap, done, iters


def solve_arrays_stream(batches, tol: float = 1e-4, max_iters: int = 20000,
                        dtype=np.float32, maximize=False,
                        crossover: str = "none", config=None, ub=None):
    """Pipelined PDHG sweep over an iterable of ``(c, A, b, ops)`` batches.

    The production driver for the 1M-instance regime: JAX dispatch is
    asynchronous, so canonicalizing + staging batch k+1 into device memory
    is issued while batch k's `_pdhg_solve` still runs — end-to-end
    throughput approaches ``max(transfer, solve)`` instead of their sum
    (mirrors ``models/batched.solve_arrays_stream``: without the overlap
    a 1M sweep's wall time is mostly generation + staging).

    ``crossover``: ``"none"`` (yield raw PDHG results), ``"unconverged"``
    (exact-solve the instances PDHG could not converge — failure recovery),
    or ``"all"`` (recover an exact vertex for every instance via the
    PDHG→simplex crossover, ``models/crossover.py``).  With crossover on,
    each yielded :class:`PdhgResult` gains an ``exact`` attribute: a dict
    of instance-index → :class:`SimplexResult`.

    Yields one :class:`PdhgResult` per input batch, in order.  All batches
    must share (m, n) and the ``ops`` layout so one compiled program
    serves the whole sweep.  ``ub`` ((n,) shared across batches): native
    box constraints, applied to the PDHG projection AND to the exact
    crossover/recovery engines.
    """
    import time as _time

    from ..config import DEFAULT_CONFIG

    dtype = np.dtype(dtype)
    bounded = ub is not None and bool(
        np.any(np.isfinite(np.asarray(ub, np.float64))))

    def stage(batch):
        c, A, b, ops = batch
        c = np.asarray(c, np.float64)
        A = np.asarray(A, np.float64)
        b = np.asarray(b, np.float64)
        ops = np.asarray(ops)
        B, m, n = A.shape
        maxi = np.broadcast_to(np.asarray(maximize, bool), (B,))
        c_min = np.where(maxi[:, None], -c, c)
        flip = (ops == OP_GE)[None, :]
        A_n = np.where(flip[:, :, None], -A, A)
        b_n = np.where(flip, -b, b)
        is_eq = np.broadcast_to((ops == OP_EQ)[None, :], (B, m))
        ub_dev = None
        if bounded:
            ub_dev = jnp.asarray(
                np.broadcast_to(np.asarray(ub, np.float64), (B, n)), dtype)
        dev = (jnp.asarray(A_n, dtype), jnp.asarray(b_n, dtype),
               jnp.asarray(c_min, dtype), jnp.asarray(is_eq), ub_dev)
        return (c, A, b, ops, maxi, c_min), dev

    it = iter(batches)
    try:
        current = stage(next(it))
    except StopIteration:
        return

    while current is not None:
        (c, A, b, ops, maxi, c_min), dev = current
        t0 = _time.perf_counter()
        out = _pdhg_solve(*dev, max_iters=max_iters, tol=tol,
                          bounded=bounded)
        # Stage the NEXT batch while this solve runs on device.
        try:
            current = stage(next(it))
        except StopIteration:
            current = None

        x, y, primal, dual, gap, done, iters = out
        x = np.asarray(x, np.float64)
        obj_min = np.einsum("bn,bn->b", c_min, x)
        res = PdhgResult(
            x=x, y=np.asarray(y, np.float64),
            objective=np.where(maxi, -obj_min, obj_min) + 0.0,
            primal_residual=np.asarray(primal, np.float64),
            dual_residual=np.asarray(dual, np.float64),
            gap=np.asarray(gap, np.float64),
            converged=np.asarray(done),
            iters=int(iters),
            solve_time=_time.perf_counter() - t0,
        )
        if crossover != "none":
            # Host-side exact recovery, overlapped with the next batch's
            # device solve (it was dispatched above).
            # Device-backed arrays are read-only views; the crossover
            # patches them per instance.
            res.converged = np.array(res.converged)
            res.objective = np.array(res.objective)
            if crossover == "all":
                idx = list(range(x.shape[0]))
            else:
                idx = [int(i) for i in np.nonzero(~res.converged)[0]]
            if len(idx) >= 64 or bounded:
                # Many instances: ONE certified batched device solve
                # beats a per-instance host crossover loop (each
                # per-instance reoptimize is its own device dispatch and
                # host round trip; at 1M instances with ~0.5% unconverged
                # that loop is thousands of round trips, while the
                # batched engine clears them all in one call).
                # The warm-start advantage of the guessed basis is
                # negligible at sweep shapes (~tens of rows).
                exact = _crossover_via_batched(
                    c, A, b, ops, maxi, idx, config or DEFAULT_CONFIG,
                    ub=(ub if bounded else None))
            else:
                from .crossover import crossover_batch

                exact = crossover_batch(
                    c, A, b, ops, maxi, x, indices=idx,
                    config=config or DEFAULT_CONFIG)
            res.exact = dict(zip(idx, exact))
            for i, r in res.exact.items():
                if r.success:
                    res.x[i] = r.x
                    res.objective[i] = r.z
                    res.converged[i] = True
        yield res


def _crossover_via_batched(c, A, b, ops, maxi, idx, config, ub=None):
    """Exact recovery for MANY selected instances: one batched device
    solve (f64-certified like any batched result) repackaged as
    per-instance :class:`SimplexResult`s — the vectorized alternative to
    ``crossover_batch``'s per-instance host loop (VERDICT r3 weak #5)."""
    from ..core.problem import STATUS_MESSAGES, STATUS_OPTIMAL
    from .batched import BatchedSimplexSolver
    from .dense import SimplexResult

    idx = np.asarray(idx, np.int64)
    # Pad the subset to a multiple of 256 (repeat the last instance) so
    # the Pallas fused kernel gets a well-factored batch count; the
    # padded tail is dropped below.
    n_real = idx.shape[0]
    pad = (-n_real) % 256
    idx_p = np.concatenate([idx, np.full(pad, idx[-1])]) if pad else idx
    ub_sub = None
    if ub is not None:
        ub_sub = np.broadcast_to(np.asarray(ub, np.float64),
                                 (A.shape[0], A.shape[2]))[idx_p]
    sub = BatchedSimplexSolver(config).solve_arrays(
        c[idx_p], A[idx_p], b[idx_p], ops, maximize=maxi[idx_p],
        ub=ub_sub)
    out = []
    for k in range(n_real):
        ok = bool(sub.success[k])
        out.append(SimplexResult(
            x=(np.asarray(sub.x[k], np.float64) if ok else None),
            fun=(float(sub.fun[k]) if ok else None),
            status=int(sub.status[k]), success=ok,
            message=STATUS_MESSAGES.get(int(sub.status[k]), ""),
            nit=int(sub.nit),
            basis=(None if sub.basis is None else sub.basis[k]),
            z=(float(sub.z[k]) if ok else None),
            solve_time=sub.solve_time / max(n_real, 1),
        ))
    return out


class PdhgSolver:
    """Batched first-order solver over uniform-shape array batches."""

    def __init__(self, tol: float = 1e-4, max_iters: int = 20000,
                 dtype=np.float32):
        self.tol = tol
        self.max_iters = max_iters
        self.dtype = np.dtype(dtype)

    def solve_arrays(self, c, A, b, ops, maximize=False,
                     ub=None) -> PdhgResult:
        """``ub`` ((n,) or (B, n), entries in [0, +inf]): native box
        constraints ``0 <= x <= ub`` — the PDHG prox step projects onto
        the box and the KKT criteria use the bounded dual conditions
        (round 4; lower bounds go through normalize_bounds upstream)."""
        t0 = time.perf_counter()
        A = np.asarray(A, np.float64)
        b = np.asarray(b, np.float64)
        c = np.asarray(c, np.float64)
        ops = np.asarray(ops)
        B, m, n = A.shape
        maximize = np.broadcast_to(np.asarray(maximize, bool), (B,))

        c_min = np.where(maximize[:, None], -c, c)
        # Normalize >= rows to <=.
        flip = (ops == OP_GE)[None, :]
        A_n = np.where(flip[:, :, None], -A, A)
        b_n = np.where(flip, -b, b)
        is_eq = np.broadcast_to((ops == OP_EQ)[None, :], (B, m))

        bounded = ub is not None and bool(
            np.any(np.isfinite(np.asarray(ub, np.float64))))
        ub_dev = None
        if bounded:
            ub_b = np.broadcast_to(np.asarray(ub, np.float64), (B, n))
            if np.any(ub_b < 0):
                raise ValueError("ub debe cumplir ub >= 0.")
            ub_dev = jnp.asarray(ub_b, self.dtype)
        x, y, primal, dual, gap, done, iters = _pdhg_solve(
            jnp.asarray(A_n, self.dtype), jnp.asarray(b_n, self.dtype),
            jnp.asarray(c_min, self.dtype), jnp.asarray(is_eq),
            ub_dev,
            max_iters=self.max_iters, tol=self.tol, bounded=bounded,
        )
        x = np.asarray(x, np.float64)
        obj_min = np.einsum("bn,bn->b", c_min, x)
        objective = np.where(maximize, -obj_min, obj_min) + 0.0
        return PdhgResult(
            x=x, y=np.asarray(y, np.float64),
            objective=objective,
            primal_residual=np.asarray(primal, np.float64),
            dual_residual=np.asarray(dual, np.float64),
            gap=np.asarray(gap, np.float64),
            converged=np.asarray(done),
            iters=int(iters),
            solve_time=time.perf_counter() - t0,
        )
