"""On-chip smoke test: simplex_tpu's main paths on one NVIDIA GPU.

Run from the repository root on a machine with one GPU::

    python chip_smoke.py

and, for the row-sharded path alone, on four GPUs of one host::

    python chip_smoke.py --four-cards

Everything runs in this one process (a JAX process reserves most of a
card's memory).  Each phase drives the system through the entry points a
user calls, at the sizes its users run, and checks the result against a
plain reference — scipy's HiGHS or an f64 NumPy computation — printing the
tolerance and the device precision beside each comparison.  Any failed
check raises, so the script exits non-zero; it never falls back to the CPU
and prints its result line only when every phase passed.  The last line of
standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rel_err(a, b):
    return abs(float(a) - float(b)) / (1.0 + abs(float(b)))


class Phase:
    """Prints a phase's wall time; exceptions propagate."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: passed in "
                f"{time.perf_counter() - self.t0:.1f} s")


def scipy_max(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, ub=None):
    """max c'x by HiGHS; returns (status, objective) in scipy's codes."""
    from scipy.optimize import linprog

    bounds = (None if ub is None else
              [(0.0, None if not np.isfinite(u) else float(u)) for u in ub])
    r = linprog(-np.asarray(c, np.float64), A_ub=A_ub, b_ub=b_ub,
                A_eq=A_eq, b_eq=b_eq, bounds=bounds if bounds else (0, None),
                method="highs")
    return r.status, (-r.fun if r.status == 0 else None)


# --------------------------------------------------------------------- #
# Phase 0                                                                #
# --------------------------------------------------------------------- #
def phase_device(expect_count):
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"JAX found no GPU (platform {d.platform!r})")
    check(len(devs) >= expect_count,
          f"need {expect_count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    log(f"nvidia-smi: {smi}")
    # Does an f32 one-hot einsum at DEFAULT precision gather exactly on
    # this card (TF32 would round every entry)?  Informational: the
    # package gathers by index and pins HIGHEST on its contractions.
    rng = np.random.default_rng(0)
    T = rng.normal(size=(1024, 32, 128)).astype(np.float32)
    s = rng.integers(0, 128, size=1024)
    hot = jax.nn.one_hot(jnp.asarray(s), 128, dtype=jnp.float32)
    got = np.asarray(jax.jit(
        lambda a, h: jnp.einsum("bmn,bn->bm", a, h))(jnp.asarray(T), hot))
    exact = bool(np.array_equal(got, T[np.arange(1024), :, s]))
    log(f"f32 one-hot einsum gather at default precision bit-exact: {exact}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# --------------------------------------------------------------------- #
# Phase 1: single LP (solve_lp, the web /solve engine)                   #
# --------------------------------------------------------------------- #
def dense_family(size, seed=0):
    """bench.py's dense single-LP family: A x <= b, A, b > 0, max c'x."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(size, size))
    b = rng.uniform(size * 0.3, size * 0.6, size=size)
    c = rng.uniform(0.1, 1.0, size=size)
    return c, A, b


def phase_single_lp(size=2048):
    from simplex_tpu import LinearProgram, solve_lp
    from simplex_tpu.models.dense import reoptimize

    tol = 1e-6
    anchor = LinearProgram(c=[15, 18], A=[[4, 2], [2, 6], [20, 28]],
                           b=[2000, 2400, 14000], ops=[-1, -1, -1],
                           maximize=True)
    r = solve_lp(anchor)
    check(r.success, f"anchor status {r.status}")
    e = rel_err(r.z, 29500.0 / 3.0)
    log(f"anchor: Z={r.z:.10f} vs 9833.3333333333 rel_err={e:.2e} "
        f"(tol {tol:g}; device f32, host f64 certification)")
    check(e <= tol, "anchor objective")

    c, A, b = dense_family(size)
    m = A.shape[0]
    lp = LinearProgram(c=c, A=A, b=b, ops=np.full(m, -1), maximize=True)
    t0 = time.perf_counter()
    res = solve_lp(lp)
    t_cold = time.perf_counter() - t0
    st, z_ref = scipy_max(c, A_ub=A, b_ub=b)
    check(res.success and st == 0, f"{size} status {res.status} vs {st}")
    e = rel_err(res.z, z_ref)
    log(f"{size}x{size} solve_lp: Z={res.z:.9f} scipy={z_ref:.9f} "
        f"rel_err={e:.2e} (tol {tol:g}) pivots={res.nit} "
        f"wall={t_cold:.2f}s incl. compile")
    check(e <= tol, f"{size} objective")

    # Warm start: new costs keep the old vertex primal-feasible.
    rng = np.random.default_rng(1)
    c2 = c * rng.uniform(0.95, 1.05, size=c.shape)
    lp2 = LinearProgram(c=c2, A=A, b=b, ops=np.full(m, -1), maximize=True)
    t0 = time.perf_counter()
    rw = solve_lp(lp2, warm_basis=res.basis)
    tw = time.perf_counter() - t0
    st, z2 = scipy_max(c2, A_ub=A, b_ub=b)
    check(rw.success and st == 0, f"warm status {rw.status} vs {st}")
    e = rel_err(rw.z, z2)
    log(f"{size} warm start (cost perturbation): Z={rw.z:.9f} "
        f"scipy={z2:.9f} rel_err={e:.2e} (tol {tol:g}) pivots={rw.nit} "
        f"wall={tw:.2f}s")
    check(e <= tol, "warm-start objective")

    # Dual reoptimize: an RHS change keeps the old basis dual-feasible.
    b3 = b * rng.uniform(0.97, 1.03, size=b.shape)
    lp3 = LinearProgram(c=c, A=A, b=b3, ops=np.full(m, -1), maximize=True)
    t0 = time.perf_counter()
    rr = reoptimize(lp3, res.basis)
    tr = time.perf_counter() - t0
    st, z3 = scipy_max(c, A_ub=A, b_ub=b3)
    check(rr.success and st == 0, f"reoptimize status {rr.status} vs {st}")
    e = rel_err(rr.z, z3)
    log(f"{size} reoptimize (RHS perturbation): Z={rr.z:.9f} "
        f"scipy={z3:.9f} rel_err={e:.2e} (tol {tol:g}) pivots={rr.nit} "
        f"wall={tr:.2f}s")
    check(e <= tol, "reoptimize objective")


# --------------------------------------------------------------------- #
# Phase 2: large tableau                                                 #
# --------------------------------------------------------------------- #
def phase_large_tableau(R=10241, size=10240):
    import jax
    import jax.numpy as jnp
    from simplex_tpu import LinearProgram, solve_lp
    from simplex_tpu.ops.tableau import pivot_update

    rng = np.random.default_rng(2)
    T64 = rng.normal(size=(R, R))
    T = jnp.asarray(T64.astype(np.float32))
    T64 = np.asarray(T, np.float64)            # the f32 input, exactly
    basis = jnp.arange(R - 1, dtype=jnp.int32)
    step = jax.jit(pivot_update)
    pivots = []
    for k in range(8):
        r = int(rng.integers(0, R - 1))
        s = int(np.argmax(np.abs(T64[r, :-1])))   # a well-sized pivot
        pivots.append((r, s))
        T, basis = step(T, basis, jnp.int32(r), jnp.int32(s))
        col = T64[:, s].copy()
        prow = T64[r] / T64[r, s]
        T64 -= np.outer(col, prow)
        T64[r] = prow
        T64[:, s] = 0.0
        T64[r, s] = 1.0
    T.block_until_ready()
    got = np.asarray(T, np.float64)
    err = float(np.max(np.abs(got - T64)) / np.max(np.abs(T64)))
    tol = 1e-5
    log(f"pivot_update {R}x{R} f32, 8 pivots vs NumPy f64 rank-1: "
        f"max_abs_err/max|T|={err:.2e} (tol {tol:g}; f32 elementwise, "
        f"no contraction)")
    check(err <= tol, "pivot_update vs f64 reference")
    del T, got, T64

    c, A, b = dense_family(size)
    lp = LinearProgram(c=c, A=A, b=b, ops=np.full(size, -1), maximize=True)
    t0 = time.perf_counter()
    res = solve_lp(lp)
    wall = time.perf_counter() - t0
    check(res.success, f"{size} status {res.status}")
    x, y = res.x, res.duals
    check(x is not None and y is not None, f"{size}: no primal/dual")
    # Independent f64 KKT check of max c'x, Ax <= b, x >= 0:
    # primal feasibility, dual feasibility (y >= 0, A'y >= c), zero gap.
    scale = 1.0 + np.max(np.abs(b))
    p_inf = max(float(np.max(A @ x - b)) / scale, float(-np.min(x)), 0.0)
    d_inf = max(float(np.max(c - A.T @ y)) / (1.0 + np.max(np.abs(c))),
                float(-np.min(y)), 0.0)
    pz, dz = float(c @ x), float(b @ y)
    gap = abs(pz - dz) / (1.0 + abs(pz))
    # Infeasibilities are held to the certifier's stated tolerance (1e-7
    # relative); the gap of an exact basis solution is round-off.
    inf_tol, gap_tol = 1e-7, 1e-9
    log(f"{size}x{size} solve_lp: Z={res.z:.9f} pivots={res.nit} "
        f"wall={wall:.2f}s incl. compile; f64 KKT (NumPy): primal_inf="
        f"{p_inf:.2e} dual_inf={d_inf:.2e} (tol {inf_tol:g}) gap={gap:.2e} "
        f"(tol {gap_tol:g}); device f32, certified basis re-solved in f64")
    check(p_inf <= inf_tol and d_inf <= inf_tol and gap <= gap_tol,
          f"{size} KKT check")


# --------------------------------------------------------------------- #
# Phase 3: batched                                                       #
# --------------------------------------------------------------------- #
def batch_family(B, m=30, n=50, seed=0, bounded=False, mixed=False):
    """bench.py's batched families (30x50, b > 0); ``bounded`` puts upper
    bounds on ~60% of the variables; ``mixed`` has <=, >= and = rows and
    is feasible by construction (b from a nonnegative x0)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ub = None
    if mixed:
        ops = np.array([-1] * (m - 10) + [1] * 5 + [0] * 5)
        x0 = rng.uniform(0.0, 0.2, size=(B, n))
        ax = np.einsum("bmn,bn->bm", A, x0)
        b = np.where(ops == -1, ax + rng.uniform(0.5, 2.0, (B, m)),
                     np.where(ops == 1, ax - rng.uniform(0.0, 0.3, (B, m)),
                              ax))
    else:
        ops = np.full((m,), -1)
        b = rng.uniform(1.0, 5.0, size=(B, m))
    if bounded:
        ub = np.where(rng.random((B, n)) < 0.6,
                      rng.uniform(1.0, 3.0, (B, n)), np.inf)
    return c, A, b, ops, ub


def check_sample_vs_scipy(name, res, c, A, b, ops, ub, k, seed=5):
    idx = np.random.default_rng(seed).choice(A.shape[0], size=k,
                                             replace=False)
    worst = 0.0
    for i in idx:
        le, ge, eq = ops == -1, ops == 1, ops == 0
        A_ub = np.vstack([A[i][le], -A[i][ge]])
        b_ub = np.concatenate([b[i][le], -b[i][ge]])
        st, z = scipy_max(c[i], A_ub=A_ub, b_ub=b_ub,
                          A_eq=A[i][eq] if eq.any() else None,
                          b_eq=b[i][eq] if eq.any() else None,
                          ub=None if ub is None else ub[i])
        check(int(res.status[i]) == st,
              f"{name}: instance {i} status {res.status[i]} vs scipy {st}")
        if st == 0:
            worst = max(worst, rel_err(res.z[i], z))
    log(f"{name}: {k} sampled instances vs scipy: statuses equal, "
        f"max objective rel_err={worst:.2e} (tol 1e-6; device f32, "
        f"f64-certified)")
    check(worst <= 1e-6, f"{name}: objective vs scipy")


def phase_batched(big=16384, small=1024, sample=256):
    from simplex_tpu.models.batched import BatchedSimplexSolver

    solver = BatchedSimplexSolver()
    for name, B, kw in ((f"B={big} 30x50", big, {}),
                        (f"B={big} 30x50 bounded", big, {"bounded": True}),
                        (f"B={small} 30x50 mixed <=/>=/=", small,
                         {"mixed": True})):
        c, A, b, ops, ub = batch_family(B, **kw)
        t0 = time.perf_counter()
        res = solver.solve_arrays(c, A, b, ops, maximize=True, ub=ub)
        wall = time.perf_counter() - t0
        check(res.certified is not None and bool(np.all(res.certified)),
              f"{name}: {int(np.sum(~res.certified))} verdicts uncertified")
        log(f"{name}: {res.n_optimal}/{B} optimal, all {B} verdicts "
            f"certified ({res.n_escalated} escalated to the host engine), "
            f"loop trips={res.nit}, wall={wall:.2f}s incl. compile")
        check_sample_vs_scipy(name, res, c, A, b, ops, ub, sample)


# --------------------------------------------------------------------- #
# Phase 4: PDHG and the certified stream                                 #
# --------------------------------------------------------------------- #
def phase_pdhg_stream(B=65536, chunks=4, chunk=65536, sample=256):
    from simplex_tpu.models.batched import solve_arrays_stream
    from simplex_tpu.models.pdhg import PdhgSolver

    m, n, tol = 20, 30, 1e-4
    rng = np.random.default_rng(0)
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    b = rng.uniform(1.0, 5.0, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    t0 = time.perf_counter()
    res = PdhgSolver(tol=tol, max_iters=10000).solve_arrays(
        c, A, b, ops, maximize=True)
    wall = time.perf_counter() - t0
    conv = np.nonzero(res.converged)[0]
    check(conv.size >= 0.9 * B, f"PDHG converged only {conv.size}/{B}")
    idx = np.random.default_rng(6).choice(conv, size=sample, replace=False)
    # The stop rule bounds 0.1 * |duality gap| by tol * scale, scale =
    # 1 + max(|b|, |c|) per instance: the objective is held to that gap.
    worst = 0.0
    for i in idx:
        st, z = scipy_max(c[i], A_ub=A[i], b_ub=b[i])
        check(st == 0, f"PDHG sample {i}: scipy status {st}")
        allowed = 10.0 * tol * (1.0 + max(np.max(b[i]), np.max(c[i])))
        worst = max(worst, abs(res.objective[i] - z) / allowed)
    log(f"PDHG B={B} {m}x{n} tol={tol:g}: {conv.size}/{B} converged in "
        f"{res.iters} iterations, wall={wall:.2f}s incl. compile; {sample} "
        f"converged samples vs scipy: max |obj - scipy| / (10 tol "
        f"(1 + max(|b|,|c|))) = {worst:.3f} (tol 1; f32 matvecs at "
        f"precision HIGHEST)")
    check(worst <= 1.0, "PDHG objectives vs scipy")

    m, n = 30, 50

    def gen():
        for k in range(chunks):
            c_, A_, b_, ops_, _ = batch_family(chunk, m, n, seed=300 + k)
            yield c_, A_, b_, ops_

    t0 = time.perf_counter()
    total = certified = optimal = escalated = 0
    for res in solve_arrays_stream(gen(), maximize=True):
        total += res.status.shape[0]
        certified += int(np.sum(res.certified))
        optimal += res.n_optimal
        escalated += res.n_escalated
    wall = time.perf_counter() - t0
    log(f"certified stream: {chunks} chunks x {chunk} of {m}x{n} (the "
        f"1,048,576-instance sweep cut to {chunks} chunks for time): "
        f"{optimal}/{total} optimal, {certified}/{total} f64-certified, "
        f"{escalated} escalated, wall={wall:.2f}s incl. compile")
    check(total == chunks * chunk and certified == total,
          "stream: not every instance certified")


# --------------------------------------------------------------------- #
# Phase 5: served path                                                   #
# --------------------------------------------------------------------- #
def _form(c, A, b):
    m, n = A.shape
    data = {"problem_type": "maximize",
            "objective[]": [repr(float(v)) for v in c],
            "constraint_sign[]": ["<="] * m,
            "constraint_rhs[]": [repr(float(v)) for v in b]}
    for j in range(n):
        data[f"constraint_{j + 1}[]"] = [repr(float(v)) for v in A[:, j]]
    return data


def phase_served():
    from simplex_tpu import cli, config
    from simplex_tpu.services.storage import StorageService
    from simplex_tpu.web.app import init_app
    from simplex_tpu.web.microweb import TestClient

    store = StorageService(config.OUTPUT_DIR)
    client = TestClient(init_app(storage=store))
    rng = np.random.default_rng(7)
    cases = [("anchor 2x3", np.array([15.0, 18.0]),
              np.array([[4.0, 2.0], [2.0, 6.0], [20.0, 28.0]]),
              np.array([2000.0, 2400.0, 14000.0]))]
    A2 = np.round(rng.uniform(0.05, 1.0, size=(100, 200)), 4)
    cases.append(("200 variables x 100 rows",
                  np.round(rng.uniform(0.1, 1.0, size=200), 4), A2,
                  np.round(rng.uniform(30.0, 60.0, size=100), 4)))
    for name, c, A, b in cases:
        r = client.post("/new", data=_form(c, A, b))
        check(r.status_code == 200, f"{name}: /new HTTP {r.status_code}")
        r = client.post("/solve")
        check(r.status_code == 200, f"{name}: /solve HTTP {r.status_code}")
        check("Solucion Factible" in r.text, f"{name}: no feasible report")
        page = re.search(r'class="z-row"><th>Z</th><th>([-0-9.]+)</th>',
                         r.text)
        check(page is not None, f"{name}: no Z on the page")
        report = store.load_solution()
        z = report["solucion_encontrada"]["valor_optimo_z"]
        st, z_ref = scipy_max(c, A_ub=A, b_ub=b)
        e = rel_err(z, z_ref)
        log(f"web POST /solve {name}: HTTP 200, page Z={page.group(1)}, "
            f"report Z={z:.9f} scipy={z_ref:.9f} rel_err={e:.2e} "
            f"(tol 1e-6)")
        check(st == 0 and e <= 1e-6, f"{name}: web Z vs scipy")
        check(abs(float(page.group(1)) - z_ref) <= 1e-4 * (1 + abs(z_ref)),
              f"{name}: page Z")
    r = client.get("/metrics")
    check(r.status_code == 200, f"/metrics HTTP {r.status_code}")
    metrics = json.loads(r.text)
    log(f"web GET /metrics: HTTP 200, JSON keys {sorted(metrics)}")

    problem = {"problema_definicion": {
        "funcion_objetivo": {"type": "maximize",
                             "coefficients": {"x1": 15.0, "x2": 18.0}},
        "restricciones": [
            {"coefficients": {"x1": 4.0, "x2": 2.0}, "operator": "<=",
             "rhs": 2000.0},
            {"coefficients": {"x1": 2.0, "x2": 6.0}, "operator": "<=",
             "rhs": 2400.0},
            {"coefficients": {"x1": 20.0, "x2": 28.0}, "operator": "<=",
             "rhs": 14000.0}]}}
    os.makedirs(config.OUTPUT_DIR, exist_ok=True)
    path = os.path.join(config.OUTPUT_DIR, "chip_smoke_problem.json")
    with open(path, "w") as f:
        json.dump(problem, f)
    rc = cli.main(["solve", path])
    log(f"cli.main(['solve', ...]) exit code {rc}")
    check(rc == 0, f"cli exit code {rc}")


# --------------------------------------------------------------------- #
# --four-cards: the row-sharded path                                     #
# --------------------------------------------------------------------- #
def phase_four_cards(m=100_000, n=20):
    import jax
    from simplex_tpu.models.batched import BatchedSimplexSolver
    from simplex_tpu.parallel.sharded import make_mesh, solve_arrays_sharded

    rng = np.random.default_rng(42)
    A = rng.uniform(0.05, 1.0, size=(1, m, n))
    x0 = rng.uniform(0.5, 1.5, size=n)
    b = (A[0] @ x0 + rng.uniform(0.05, 0.5, size=m))[None, :]
    c = rng.uniform(0.1, 1.0, size=(1, n))
    mesh = make_mesh(batch=1, row=4)
    t0 = time.perf_counter()
    res = solve_arrays_sharded(c, A, b, np.full(m, -1), maximize=True,
                               mesh=mesh, max_iters=512, certify=True)
    wall = time.perf_counter() - t0
    st, z_ref = scipy_max(c[0], A_ub=A[0], b_ub=b[0])
    e = rel_err(res["z"][0], z_ref) if st == 0 else float("inf")
    log(f"row-sharded {m}x{n} on a (batch=1, row=4) mesh: status "
        f"{res['status'][0]}, Z={res['z'][0]:.9f} scipy={z_ref} "
        f"rel_err={e:.2e} (tol 1e-6; device f32, f64-certified), "
        f"certified={bool(res['certified'][0])}, tableau on "
        f"{res['tableau_devices']} devices, loop trips={res['iters']}, "
        f"wall={wall:.2f}s incl. assembly and compile")
    check(res["status"][0] == 0 and st == 0, "sharded status")
    check(e <= 1e-6, "sharded objective vs scipy")
    check(bool(res["certified"][0]), "sharded verdict not certified")
    check(res["tableau_devices"] == 4, "tableau not on 4 devices")
    del res

    B, m, n = 8, 64, 20
    rng = np.random.default_rng(43)
    A = rng.uniform(0.05, 1.0, size=(B, m, n))
    b = rng.uniform(1.0, 5.0, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    res = solve_arrays_sharded(c, A, b, ops, maximize=True,
                               mesh=make_mesh(batch=2, row=2))
    with jax.default_device(jax.devices()[0]):
        ref = BatchedSimplexSolver().solve_arrays(c, A, b, ops,
                                                  maximize=True)
    ok = ref.status == 0
    zr = float(np.max(np.abs(res["z"][ok] - ref.z[ok])
                      / (1.0 + np.abs(ref.z[ok]))))
    log(f"(batch=2, row=2) mesh, B={B} {m}x{n}: statuses equal to the "
        f"one-card batched solve={np.array_equal(res['status'], ref.status)}"
        f", max objective rel_err={zr:.2e} (tol 1e-6), all certified="
        f"{bool(np.all(res['certified']))}, tableau on "
        f"{res['tableau_devices']} devices")
    check(np.array_equal(res["status"], ref.status), "(2,2) statuses")
    check(zr <= 1e-6, "(2,2) objectives")
    check(bool(np.all(res["certified"])), "(2,2) certification")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the row-sharded path on four GPUs")
    args = p.parse_args(argv)

    from simplex_tpu.config import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    with Phase("phase 0: device"):
        device = phase_device(4 if args.four_cards else 1)
    if args.four_cards:
        with Phase("four cards: row-sharded solve"):
            phase_four_cards()
    else:
        for name, fn in (("phase 1: single LP", phase_single_lp),
                         ("phase 2: large tableau", phase_large_tableau),
                         ("phase 3: batched", phase_batched),
                         ("phase 4: PDHG and certified stream",
                          phase_pdhg_stream),
                         ("phase 5: served path", phase_served)):
            with Phase(name):
                fn()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
