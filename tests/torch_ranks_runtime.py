"""Rank programs of the runtime services' parity tests.

Each function runs on every rank of a ``mpi4jax_tpu_torch.parallel.launch``
world of gloo ranks on the CPU (or, with ``size`` 1, in the test process
itself); like ``torch_ranks.py`` this module imports no JAX, since every
rank imports it afresh.  ``tests/test_torch_telemetry.py`` and
``tests/test_torch_runtime_solve.py`` compare the results with the JAX
package's on the same seeded inputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch import resilience, telemetry
from mpi4jax_tpu_torch.models import shallow_water as P
from mpi4jax_tpu_torch.telemetry import journal

MODES = ("off", "counters", "events")
WIDE_SIZE = (64, 32)  # nx, ny of the wide modes (the JAX suite's)
HALO_SIZE = (48, 24)  # nx, ny of the split-phase mode
SOLVE_T1_STEPS, SOLVE_MULTI = 23, 5  # solve_fused(23 dt, 5): 26 steps
HALO_STEPS = 6
UNROLL = 4


def world(size: int) -> tpx.Comm:
    return tpx.Comm("x", mesh=tpx.make_world_mesh((size,), ("x",), device="cpu"))


def eager_inputs(size: int) -> dict:
    """Every rank's inputs, ``(size, ...)``, from a fixed seed."""
    rng = np.random.default_rng(7)
    return {"f": rng.standard_normal((size, 3, 4), dtype=np.float32),
            "i": rng.integers(-5, 5, (size, 3, 4)).astype(np.int32),
            "blocks": rng.standard_normal((size, size, 2), dtype=np.float32)}


def eager_ops(comm, inp: dict, rank: int) -> None:
    """Every collective once, eagerly (outside any region), on this rank's
    inputs: the JAX package's eager global-array calls, one a call."""
    f = torch.from_numpy(inp["f"][rank])
    i = torch.from_numpy(inp["i"][rank])
    blocks = torch.from_numpy(inp["blocks"][rank])
    tpx.allreduce(f, op=tpx.SUM, comm=comm)
    tpx.allreduce(i, op=tpx.MAX, comm=comm)
    tpx.allgather(f, comm=comm)
    tpx.alltoall(blocks, comm=comm)
    tpx.barrier(comm=comm)
    tpx.bcast(f, 0, comm=comm)
    tpx.gather(i, 0, comm=comm)
    tpx.reduce(f, tpx.SUM, 0, comm=comm)
    tpx.reduce_scatter(blocks, tpx.SUM, comm=comm)
    tpx.scan(i, tpx.SUM, comm=comm)
    tpx.scatter(blocks, 0, comm=comm)
    tpx.sendrecv(f, f, dest=tpx.shift(1), comm=comm)


def counts_by_op_dtype(snap: dict) -> dict:
    """``{(op, dtype): (calls, bytes)}`` of a snapshot, summed over comms
    and algorithms."""
    out = {}
    for row in snap["ops"].values():
        key = (row["op"], row["dtype"])
        calls, nbytes = out.get(key, (0, 0))
        out[key] = (calls + row["calls"], nbytes + row["bytes"])
    return out


def counters_program(rank: int, size: int) -> dict:
    """The eager ops under ``counters``: this rank's counts by (op,
    dtype), and the region case: an ``spmd`` function with one allreduce
    called three times."""
    comm = world(size)
    telemetry.reset()
    telemetry.set_telemetry_mode("counters")
    try:
        eager_ops(comm, eager_inputs(size), rank)
        eager = counts_by_op_dtype(telemetry.snapshot())
        telemetry.reset()
        f = tpx.spmd(lambda v: tpx.allreduce(v, op=tpx.SUM)[0], comm=comm)
        for _ in range(3):
            f(torch.ones(2))
        region = counts_by_op_dtype(telemetry.snapshot())
    finally:
        telemetry.set_telemetry_mode(None)
        telemetry.reset()
    return {"eager": eager, "region": region}


def _solve(cfg, mode: str, device, rank: int, tdir: str, **kw) -> dict:
    """One ``solve_fused`` under telemetry ``mode``: the final state, the
    counters of the timed run's process, the journal's records and what
    is still pending."""
    telemetry.reset()
    telemetry.set_telemetry_mode(mode)
    saved = os.environ.get("MPI4JAX_TPU_TELEMETRY_DIR")
    if mode == "events":
        os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = tdir
    try:
        info = {}
        _, n, final = P.solve_fused(cfg, SOLVE_T1_STEPS * cfg.dt,
                                    num_multisteps=SOLVE_MULTI, device=device,
                                    return_state=True, info=info, **kw)
        journal.flush()
        snap = telemetry.snapshot(include_events=True)
        pending = sum(len(d) for d in journal._journal.pending.values())
    finally:
        telemetry.set_telemetry_mode(None)
        if saved is None:
            os.environ.pop("MPI4JAX_TPU_TELEMETRY_DIR", None)
        else:
            os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = saved
        journal.reset()
    return {"final": tuple(final), "n": n, "runs": info["runs"],
            "counts": counts_by_op_dtype(snap), "events": snap.get("events", []),
            "meters": snap["meters"], "pending": pending}


def solve_program(rank: int, size: int, tdir: str) -> dict:
    """``solve_fused`` under every telemetry mode: on one rank the
    megastep path (``fast="wide2"``, ``unroll=4``), on (2,2) the wide-halo
    run (``fast="wide2"``) and the split-phase one (``fast="pallas_halo"``).
    Journals go to ``tdir/<case>-<mode>``."""
    grid = (1, 1) if size == 1 else (2, size // 2)
    out = {}
    cases = {"wide2": (WIDE_SIZE, dict(fast="wide2")),
             "halo": (HALO_SIZE, dict(fast="pallas_halo"))}
    if size == 1:
        cases["wide2"][1]["unroll"] = UNROLL
    for case, (size_xy, kw) in cases.items():
        cfg = P.Config(nx=size_xy[0], ny=size_xy[1], nproc_y=grid[0],
                       nproc_x=grid[1])
        for mode in MODES:
            out[f"{case}/{mode}"] = _solve(
                cfg, mode, "cpu", rank, os.path.join(tdir, f"{case}-{mode}"), **kw)
    return out


def megastep_watchdog_program(timeout: float) -> dict:
    """On one rank: ``solve_fused(unroll=4)`` with the watchdog at
    ``timeout`` and the Python registry, recording every arm (name and
    deadline) through a wrapper."""
    from mpi4jax_tpu_torch.resilience import watchdog

    arms = []
    real_arm = watchdog._registry.arm

    def arm(opname, call_id, rank, axes, t):
        arms.append((opname, t))
        real_arm(opname, call_id, rank, axes, t)

    watchdog._registry.arm = arm
    watchdog.force_python_fallback(True)
    resilience.set_watchdog_timeout(timeout)
    try:
        cfg = P.Config(nx=WIDE_SIZE[0], ny=WIDE_SIZE[1])
        info = {}
        P.solve_fused(cfg, SOLVE_T1_STEPS * cfg.dt, num_multisteps=SOLVE_MULTI,
                      device="cpu", fast="wide2", unroll=UNROLL, info=info)
        left = len(watchdog.inflight_snapshot())
    finally:
        del watchdog._registry.arm
        resilience.reset_overrides()
        watchdog.force_python_fallback(False)
        watchdog.drain_registry()
    return {"arms": arms, "left": left, "runs": info["runs"]}
