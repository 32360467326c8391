"""Load/stress tests — the reference's ``tests/test_performance_load.py``
strategy (threaded fake users vs the in-process client, latency/success
thresholds, memory growth) scaled to CI-friendly sizes.
"""
import json
import threading
import time

import pytest

import simplex_tpu.config as config
from simplex_tpu.services.storage import StorageService
from simplex_tpu.web.app import init_app
from simplex_tpu.web.microweb import TestClient

FORM = {
    "problem_type": "maximize",
    "objective[]": ["3", "5"],
    "constraint_1[]": ["1", "0", "3"],
    "constraint_2[]": ["0", "2", "2"],
    "constraint_sign[]": ["<=", "<=", "<="],
    "constraint_rhs[]": ["4", "12", "18"],
}


@pytest.fixture
def app(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "OUTPUT_DIR", str(tmp_path))
    return init_app(storage=StorageService(str(tmp_path)))


def _solve_roundtrip(app):
    client = TestClient(app)           # fresh cookie jar per fake user
    t0 = time.perf_counter()
    r1 = client.post("/new", data=FORM)
    r2 = client.post("/solve")
    elapsed = time.perf_counter() - t0
    ok = (r1.status_code == 200 and r2.status_code == 200
          and "Solucion Factible" in r2.text)
    return ok, elapsed


def test_concurrent_users(app):
    """10 concurrent fake users; all succeed; mean latency < 5 s
    (reference threshold, test_performance_load.py:100)."""
    _solve_roundtrip(app)              # warm the jit cache first
    results = []
    lock = threading.Lock()

    def user():
        out = _solve_roundtrip(app)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=user) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    assert len(results) == 10
    success = sum(1 for ok, _ in results if ok)
    mean_latency = sum(dt for _, dt in results) / len(results)
    assert success == 10
    assert mean_latency < 5.0


def test_sequential_load_no_degradation(app):
    """30 sequential solves; last-10 mean must stay within 50% of the
    first-10 mean (reference threshold :145)."""
    _solve_roundtrip(app)
    times = []
    for _ in range(30):
        ok, dt = _solve_roundtrip(app)
        assert ok
        times.append(dt)
    first = sum(times[:10]) / 10
    last = sum(times[-10:]) / 10
    assert last < first * 1.5 + 0.05


def test_memory_stays_bounded(app):
    """RSS growth over 20 solves < 500 MB (reference threshold :223)."""
    psutil = pytest.importorskip("psutil")
    proc = psutil.Process()
    _solve_roundtrip(app)
    rss0 = proc.memory_info().rss
    for _ in range(20):
        ok, _ = _solve_roundtrip(app)
        assert ok
    growth = proc.memory_info().rss - rss0
    assert growth < 500 * 1024 * 1024


def test_error_rate_under_mixed_load(app):
    """Mixed valid/invalid traffic: valid requests must all succeed and
    invalid ones must fail gracefully (flash, not 500)."""
    _solve_roundtrip(app)
    bad_client = TestClient(app)
    errors = 0
    for i in range(12):
        if i % 3 == 2:
            r = bad_client.post(
                "/load", files={"problem_file": ("x.json", "{broken")},
                follow_redirects=True)
            if r.status_code >= 500:
                errors += 1
        else:
            ok, _ = _solve_roundtrip(app)
            if not ok:
                errors += 1
    assert errors == 0


def test_sustained_load_p95(app):
    """Sustained-load tier (reference test_performance_load.py:225-300,
    CI-scaled: 12 s at ~2 users/s instead of 120 s): error rate < 20 %
    and p95 latency < 5 s."""
    _solve_roundtrip(app)              # warm the jit cache
    results = []
    lock = threading.Lock()
    threads = []

    def user():
        out = _solve_roundtrip(app)
        with lock:
            results.append(out)

    t_end = time.perf_counter() + 12.0
    while time.perf_counter() < t_end:
        t = threading.Thread(target=user)
        t.start()
        threads.append(t)
        time.sleep(0.5)                # ~2 users/s
    for t in threads:
        t.join()

    assert len(results) >= 20
    failures = sum(1 for ok, _ in results if not ok)
    assert failures / len(results) < 0.20
    lat = sorted(dt for _, dt in results)
    p95 = lat[int(len(lat) * 0.95) - 1]
    assert p95 < 5.0


def test_simultaneous_users_success_rate(app):
    """30 simultaneous threads (reference :149-223): success rate >= 80 %
    and bounded memory growth."""
    psutil = pytest.importorskip("psutil")
    proc = psutil.Process()
    _solve_roundtrip(app)
    rss0 = proc.memory_info().rss
    results = []
    lock = threading.Lock()

    def user():
        out = _solve_roundtrip(app)
        with lock:
            results.append(out)

    threads = [threading.Thread(target=user) for _ in range(30)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    assert len(results) == 30
    success = sum(1 for ok, _ in results if ok)
    assert success / 30 >= 0.80
    growth = proc.memory_info().rss - rss0
    assert growth < 500 * 1024 * 1024


def test_batched_throughput_smoke():
    """Batched-engine throughput sanity: 256 LPs in one device call should
    beat 256 sequential web solves by a wide margin (the batched
    analogue of the reference's pytest-benchmark microbench)."""
    import numpy as np
    from simplex_tpu.models.batched import BatchedSimplexSolver

    rng = np.random.default_rng(0)
    B, m, n = 256, 6, 4
    A = rng.uniform(0.1, 1.0, size=(B, m, n))
    b = rng.uniform(1.0, 5.0, size=(B, m))
    c = rng.uniform(0.1, 1.0, size=(B, n))
    ops = np.full((m,), -1)
    solver = BatchedSimplexSolver()
    solver.solve_arrays(c, A, b, ops, maximize=True)       # compile
    t0 = time.perf_counter()
    res = solver.solve_arrays(c, A, b, ops, maximize=True)
    dt = time.perf_counter() - t0
    assert res.n_optimal == B
    assert B / dt > 100            # conservative floor even on CPU
