"""Multi-host distributed runtime (jax.distributed + global meshes).

The reference is strictly single-process (SURVEY.md §2.4: gunicorn workers
are share-nothing request concurrency, ``dockerfile:34``).  This module is
the BASELINE north-star path the reference never had: one LP's constraint
rows block-sharded across the GPUs of SEVERAL hosts (config 5: a
100k-constraint LP row-block sharded across devices), with the per-pivot
pmin/psum collectives of ``parallel/sharded.py`` riding NVLink between the
cards of one host and the network between hosts.

Design:

* mesh axes       — ``("batch", "row")``.  The mesh follows the algorithm
  only: ``row`` carries the per-pivot collectives (two scalar reductions +
  one pivot-row psum per iteration), so by default it is laid out WITHIN a
  process, whose cards are joined all to all by NVLink, and ``batch`` —
  which needs no collectives at all — spans processes (the network).
  Asking for ``row`` larger than one process's device count deliberately
  spills the row axis onto the network: the 100k-row regime where one host
  cannot hold the tableau, per-pivot latency then pays one network
  round-trip.
* array creation  — every process materializes ONLY its addressable shards
  (``jax.make_array_from_callback``); nothing assembles the global tableau
  in one host's memory.
* results         — reduced per-instance vectors (x, z, status) are
  returned replicated, so every process can read them without a gather.

Runtime bring-up: call :func:`initialize` once per process before any JAX
computation (the standard ``jax.distributed.initialize`` contract), driven
by flags or ``SIMPLEX_TPU_COORDINATOR`` / ``SIMPLEX_TPU_NUM_PROCESSES`` /
``SIMPLEX_TPU_PROCESS_ID`` env vars (``jax.distributed.initialize`` needs
all three where no cluster manager announces them).  Verified end-to-end by
``tests/test_distributed.py``, which runs 2 OS processes × 2 CPU devices on
localhost and checks that the row-axis collectives cross the process
boundary (Gloo) with scipy-parity results.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.problem import STATUS_OPTIMAL


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Bring up the JAX distributed runtime for this process.

    Returns True when multi-process mode is active.  No-ops (returns False)
    when neither arguments nor env vars request more than one process —
    single-process callers never pay coordinator startup.  Safe to call
    twice (the second call is a no-op if already initialized).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "SIMPLEX_TPU_COORDINATOR")
    env_np = os.environ.get("SIMPLEX_TPU_NUM_PROCESSES")
    env_pid = os.environ.get("SIMPLEX_TPU_PROCESS_ID")
    if num_processes is None and env_np:
        num_processes = int(env_np)
    if process_id is None and env_pid:
        process_id = int(env_pid)

    if not coordinator_address and (num_processes is None
                                    or num_processes <= 1):
        return False
    # NOTE: must run before anything touches the XLA backend (including
    # jax.devices()/process_count()), per the jax.distributed contract —
    # so "already initialized" is detected by the error, not a pre-check.
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e):
            raise
    return jax.process_count() > 1


def make_global_mesh(row: Optional[int] = None, batch: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(batch, row)`` mesh over ALL processes' devices.

    ``jax.devices()`` orders devices process-major, so:

    * ``row <= local_device_count`` (default: exactly one process's
      devices) keeps each row group inside one process — the per-pivot
      collectives stay on NVLink and ``batch`` spans the network;
    * ``row > local_device_count`` spans the row axis across processes
      (contiguous process blocks), for single LPs too large for one host.
    """
    devices = list(devices if devices is not None else jax.devices())
    local = (jax.local_device_count() if jax.process_count() > 1
             else len(devices))
    if row is None:
        row = min(local, len(devices) // max(batch, 1)) or 1
    need = batch * row
    assert need <= len(devices), (
        f"mesh {batch}x{row} needs {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(batch, row)
    return Mesh(arr, axis_names=("batch", "row"))


def put_global(x: np.ndarray, sharding: NamedSharding):
    """Create a (possibly multi-process) global array from host data.

    Each process materializes only the shards it addresses; under a single
    process this degrades to a plain ``device_put``.
    """
    x = np.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def solve_arrays_distributed(c, A, b, ops, maximize=True,
                             mesh: Optional[Mesh] = None,
                             dtype=np.float32, tol: float = 1e-6,
                             max_iters: int = 4096,
                             bland_after: int = 1024,
                             refactor_every: int = 64,
                             devex: bool = True):
    """Row-sharded batched solve that works across processes.

    The multi-host twin of ``parallel.sharded.solve_arrays_sharded``:
    identical kernel and collectives, but arrays are created shard-local
    (no process ever holds the whole tableau) and the per-instance results
    come back replicated so every process reads the same
    ``{"x", "z", "status", "iters"}`` dict.

    Every process must call this function with the SAME global arrays
    (SPMD contract — typically each process generates or loads the same
    problem set deterministically).
    """
    from ..models.batched import compile_batch_uniform
    from .sharded import solve_tableau_sharded

    if mesh is None:
        mesh = make_global_mesh()
    n_batch = mesh.shape["batch"]
    n_row = mesh.shape["row"]

    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    B, m, n = A.shape

    B_pad = ((B + n_batch - 1) // n_batch) * n_batch
    if B_pad != B:
        A = np.concatenate([A, np.zeros((B_pad - B, m, n))])
        b = np.concatenate([b, np.ones((B_pad - B, m))])
        c = np.concatenate([c, np.zeros((B_pad - B, n))])

    cb = compile_batch_uniform(
        c, A, b, ops, maximize, row_pad=n_row, dtype=np.dtype(dtype),
        align_total=False,
    )
    m_pad = cb.basis.shape[1]
    assert m_pad % n_row == 0

    T_rows = cb.T0[:, :-1, :]
    obj = cb.T0[:, -1, :]
    row_valid = np.zeros((B_pad, m_pad), bool)
    row_valid[:, :m] = True
    art_mask = cb.col_mask_p1 & ~cb.col_mask_p2

    sh_T = NamedSharding(mesh, P("batch", "row", None))
    sh_rows = NamedSharding(mesh, P("batch", "row"))
    sh_rep = NamedSharding(mesh, P("batch", None))
    sh_b = NamedSharding(mesh, P("batch"))

    args = (
        put_global(T_rows, sh_T),
        put_global(cb.basis, sh_rows),
        put_global(obj, sh_rep),
        put_global(cb.col_mask_p1, sh_rep),
        put_global(cb.col_mask_p2, sh_rep),
        put_global(art_mask, sh_rep),
        put_global(cb.obj_row_p1, sh_rep),
        put_global(cb.obj_row_p2, sh_rep),
        put_global(cb.need_p1, sh_b),
        put_global(row_valid, sh_rows),
        put_global(np.full((B_pad, cb.col_mask_p1.shape[1]), np.inf,
                           np.dtype(dtype)), sh_rep),
    )
    T_out, basis_out, obj_out, status, iters, _ = solve_tableau_sharded(
        *args, mesh=mesh, tol=tol, max_iters=max_iters,
        bland_after=bland_after, refactor_every=refactor_every, devex=devex,
    )

    # Per-instance extraction with fully-replicated outputs: the (B, n) /
    # (B,) results are tiny next to the tableau, and replication makes them
    # addressable on every process without a host-side gather.
    rep = NamedSharding(mesh, P())

    @jax.jit
    def _extract(T_rows, basis, obj, row_valid, status):
        rhs = jnp.where(row_valid, T_rows[..., -1], 0.0)
        onehot = basis[:, :, None] == jnp.arange(
            cb.n_vars, dtype=basis.dtype)[None, None, :]
        x = jnp.sum(jnp.where(onehot, rhs[:, :, None], 0.0), axis=1)
        z_min = -obj[:, -1]
        return (jax.lax.with_sharding_constraint(x, rep),
                jax.lax.with_sharding_constraint(z_min, rep),
                jax.lax.with_sharding_constraint(status, rep))

    x_g, z_g, st_g = _extract(T_out, basis_out, obj_out,
                              put_global(row_valid, sh_rows), status)
    x = np.asarray(x_g.addressable_shards[0].data)[:B]
    fun = np.asarray(z_g.addressable_shards[0].data)[:B]
    status = np.asarray(st_g.addressable_shards[0].data)[:B]

    x = np.maximum(x, 0.0)
    z = np.where(np.asarray(cb.maximize[:B]), -fun, fun) + 0.0
    ok = status == STATUS_OPTIMAL
    return {
        "x": np.where(ok[:, None], x, np.nan),
        "z": np.where(ok, z, np.nan),
        "status": status,
        "iters": int(iters),
        "mesh": (n_batch, n_row),
        "processes": jax.process_count(),
    }
