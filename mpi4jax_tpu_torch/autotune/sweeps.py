"""The measurements the autotuner runs, as a library.

The JAX package's runner calls sweeps of ``benchmarks/micro.py``; the port
keeps the ones it can run here, each over a comm of the port (every rank
of the comm calls it; a time is the slowest rank's, agreed by a MAX
``allreduce``) and returning rows of the JAX sweeps' shapes:

- :func:`bench_sendrecv_ring` and :func:`fit_alpha_beta`: the one-hop
  latency of a ``sendrecv`` ring over a payload ladder, and the alpha-beta
  line through it (the ``ici`` class);
- :func:`fold_gb_per_s`: the device's fold throughput (``a.add_(b)``),
  the cost model's gamma;
- :func:`copy_gb_per_s`: the device's memory-streaming rate (bytes a
  ``copy_`` writes per second), the cost model's compute rate;
- :func:`dispatch_us`: the host time of one region step whose body is one
  elementwise op, the cost model's fixed dispatch per step;
- :func:`bench_fusion`: N small allreduces a region, fused
  (``set_fusion_mode('auto')``) against unfused;
- :func:`bench_overlap`: ``allreduce_start``/``_wait`` around an
  independent matmul chain against the blocking allreduce and the same
  chain.

The algorithm, hierarchy and alltoall sweeps of the JAX package time
lowerings the port does not have (``ops/_algos.py``,
``ops/_hierarchy.py``: ROADMAP, Blocked); the runner records them as
skipped.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def slowest(comm, seconds: float) -> float:
    """The largest of every rank's ``seconds`` (one MAX allreduce)."""
    if comm.Get_size() == 1:
        return seconds
    from ..ops import MAX, allreduce

    t = torch.tensor([seconds], dtype=torch.float64, device=comm.device)
    out, _ = allreduce(t, MAX, comm=comm)
    return float(out[0])


def _time(comm, fn, iters: int) -> float:
    """Seconds per call of ``fn()`` over ``iters`` calls after one warm-up,
    the slowest rank's."""
    from ..ops import barrier

    fn()
    _sync(comm.device)
    barrier(comm=comm)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(comm.device)
    return slowest(comm, (time.perf_counter() - t0) / iters)


def bench_sendrecv_ring(comm, sizes_kb: Sequence[float], iters: int = 10):
    """One hop of a ``sendrecv`` ring (each rank sends to its successor)
    per payload: rows ``{size_kb, hop_us, link_gb_s}``."""
    from ..ops import sendrecv
    from ..parallel.rankspec import shift
    from ..parallel.region import spmd

    n = comm.Get_size()
    rows = []
    for kb in sizes_kb:
        nelem = max(1, int(kb * 1e3 / 4))
        x = torch.ones(nelem, dtype=torch.float32, device=comm.device)

        @spmd(comm=comm)
        def hop(v):
            r, _ = sendrecv(v, v, source=shift(-1), dest=shift(1))
            return r

        t = _time(comm, lambda: hop(x), iters)
        rows.append({
            "size_kb": round(nelem * 4 / 1e3, 2),
            "hop_us": round(t * 1e6, 2),
            "link_gb_s": round(nelem * 4 / t / 1e9, 2) if n > 1 else None,
        })
    return rows


def fit_alpha_beta(points):
    """Least-squares fit of ``t_us = alpha_us + bytes / (gb_per_s * 1e3)``
    over ``[(bytes, us), ...]``: ``(alpha_us, gb_per_s)``, clamped into
    the cost-model schema's valid ranges (the JAX package's
    ``benchmarks/micro.py:fit_alpha_beta``)."""
    xs = np.asarray([p[0] for p in points], dtype=float)
    ys = np.asarray([p[1] for p in points], dtype=float)
    if len(points) >= 2 and float(np.ptp(xs)) > 0:
        slope, intercept = np.polyfit(xs, ys, 1)
    else:  # single size: all latency, analytic bandwidth
        slope, intercept = 0.0, float(ys.mean()) if len(points) else 0.0
    alpha_us = max(float(intercept), 0.001)
    # slope is us/byte; 1 GB/s == 1000 bytes/us
    gb_per_s = (1.0 / (float(slope) * 1e3)) if slope > 0 else 1e4
    gb_per_s = min(max(gb_per_s, 0.001), 1e4)
    return alpha_us, gb_per_s


def fold_gb_per_s(comm, nbytes: int = 64 << 20, iters: int = 10) -> float:
    """Payload bytes a rank folds per second (``a.add_(b)`` on its
    device): the gamma term, which prices ``nbytes`` of a reduction."""
    n = max(1, nbytes // 4)
    a = torch.ones(n, dtype=torch.float32, device=comm.device)
    b = torch.ones(n, dtype=torch.float32, device=comm.device)
    t = _time(comm, lambda: a.add_(b), iters)
    return n * 4 / t / 1e9


def copy_gb_per_s(comm, nbytes: int = 256 << 20, iters: int = 10) -> float:
    """Bytes a rank's device writes per second in a ``copy_``: the rate
    the compute estimate divides a program's written bytes by."""
    n = max(1, nbytes // 4)
    src = torch.ones(n, dtype=torch.float32, device=comm.device)
    dst = torch.empty_like(src)
    t = _time(comm, lambda: dst.copy_(src), iters)
    return n * 4 / t / 1e9


def dispatch_us(comm, iters: int = 200) -> float:
    """Host microseconds of one region step on this rank alone whose body
    is one elementwise op on one element (synchronised each call)."""
    from ..parallel.comm import Comm
    from ..parallel.mesh import ProcessGrid
    from ..parallel.region import spmd

    one = Comm("self", mesh=ProcessGrid((1,), ("self",), comm.device, rank=0))
    x = torch.zeros(1, device=comm.device)
    step = spmd(lambda v: v + 1, comm=one)
    step(x)
    _sync(comm.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(x)
        _sync(comm.device)
    return slowest(comm, (time.perf_counter() - t0) / iters) * 1e6


def bench_fusion(comm, counts=(16,), size_kb: float = 64, iters: int = 3):
    """N small SUM allreduces a region, unfused (``off``) and fused
    (``auto``, issue the batch then consume): rows ``{count, size_kb,
    unfused_us_per_op, fused_us_per_op, fused_speedup}``.  The fusion
    bucket cap is the caller's (``MPI4JAX_TPU_FUSION_BUCKET_BYTES``)."""
    from ..ops import SUM, allreduce
    from ..ops._fusion import set_fusion_mode
    from ..parallel.region import spmd

    n = comm.Get_size()
    nelem = max(1, int(size_kb * 1e3 / 4))
    rows = []
    for count in counts:
        row = {"count": count, "size_kb": round(nelem * 4 / 1e3, 2)}
        xs = [torch.full((nelem,), float(i % 5 + 1), device=comm.device)
              for i in range(count)]

        @spmd(comm=comm)
        def prog(*vs):
            red = [allreduce(v, SUM)[0] for v in vs]
            return [r * (1.0 / n) for r in red]

        for label, mode in (("unfused", "off"), ("fused", "auto")):
            set_fusion_mode(mode)
            try:
                t = _time(comm, lambda: prog(*xs), iters)
            finally:
                set_fusion_mode(None)
            row[f"{label}_us_per_op"] = round(t / count * 1e6, 2)
        row["fused_speedup"] = round(
            row["unfused_us_per_op"] / row["fused_us_per_op"], 2)
        rows.append(row)
    return rows


def bench_overlap(comm, sizes_mb=(0.25,), iters: int = 5,
                  compute_dim: int = 64):
    """The blocking SUM allreduce then an independent ``tanh(m @ m)``,
    against ``allreduce_start``, the same compute, ``allreduce_wait``, in
    ``MPI4JAX_TPU_OVERLAP_CHUNKS`` pieces: rows ``{size_mb, chunks,
    monolithic_us, overlap_us, overlap_speedup}``."""
    from ..ops import SUM, allreduce
    from ..ops._async import allreduce_start, allreduce_wait
    from ..parallel.region import spmd
    from ..utils.config import overlap_chunks

    n = comm.Get_size()
    rows = []
    for mb in sizes_mb:
        nelem = max(1, int(mb * 1e6 / 4))
        x = torch.ones(nelem, device=comm.device)
        w = torch.full((compute_dim, compute_dim), 0.01, device=comm.device)

        @spmd(comm=comm)
        def mono(v, m):
            s, _ = allreduce(v, SUM)
            return s * (1.0 / n), torch.tanh(m @ m)

        @spmd(comm=comm)
        def ovl(v, m):
            h, _ = allreduce_start(v, SUM)
            m = torch.tanh(m @ m)  # independent: overlaps the exchange
            s, _ = allreduce_wait(h)
            return s * (1.0 / n), m

        t_mono = _time(comm, lambda: mono(x, w), iters)
        t_ovl = _time(comm, lambda: ovl(x, w), iters)
        rows.append({
            "size_mb": round(nelem * 4 / 1e6, 3),
            "chunks": overlap_chunks(nelem * 4),
            "monolithic_us": round(t_mono * 1e6, 1),
            "overlap_us": round(t_ovl * 1e6, 1),
            "overlap_speedup": round(t_mono / t_ovl, 2),
        })
    return rows
