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
  chain;
- :func:`bench_allreduce_algos` and :func:`measured_ring_crossover`: a
  PROD allreduce forced through the butterfly and the ring over a payload
  ladder, and the payload where the ring first wins;
- :func:`bench_hierarchy`: the same PROD allreduce through the flat ring
  and the two-level lowering, per topology spec (faked with
  ``MPI4JAX_TPU_TOPOLOGY``);
- :func:`bench_alltoall`: the flat, the hierarchical and the chunked
  async alltoall with compute in the gap, per topology, with the modeled
  inter-host bytes and messages;
- :func:`bench_compression`: the codecs' modeled inter-host bytes and
  time of the hierarchical allreduce and their measured round-trip
  error.

After ``benchmarks/micro.py:151,193,251,460`` of the JAX package.  On one
host the topology is faked, so the hierarchy sweeps time four processes
on one device, not a hierarchy's gain: the runner's ``provenance`` says
so.
"""

from __future__ import annotations

import os
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


class env_patch:
    """Knobs set for one measurement (``None`` unsets one), the caller's
    values restored on exit."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        for k, v in self.env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def _prod_step(comm, x):
    """One PROD allreduce, clipped so that the carry stays finite."""
    from ..ops import PROD, allreduce

    s, _ = allreduce(x, PROD, comm=comm)
    return torch.clamp(s, 0.5, 2.0)


def bench_allreduce_algos(comm, sizes_mb, iters: int = 5):
    """A PROD allreduce (no native collective: the algorithm layer itself)
    forced through the butterfly and the ring per payload: rows
    ``{size_mb, butterfly_us, ring_us, ring_speedup}`` (speedup ``None``
    on one rank)."""
    n = comm.Get_size()
    rows = []
    for mb in sizes_mb:
        nelem = max(1, int(mb * 1e6 / 4))
        x = torch.ones(nelem, dtype=torch.float32, device=comm.device)
        row = {"size_mb": round(nelem * 4 / 1e6, 3)}
        for algo in ("butterfly", "ring"):
            with env_patch(MPI4JAX_TPU_COLLECTIVE_ALGO=algo):
                t = _time(comm, lambda: _prod_step(comm, x), iters)
            row[f"{algo}_us"] = round(t * 1e6, 1)
        row["ring_speedup"] = (round(row["butterfly_us"] / row["ring_us"], 2)
                               if n > 1 else None)
        rows.append(row)
    return rows


def measured_ring_crossover(algo_rows):
    """The payload (bytes) where the measured ring first beats the
    butterfly, interpolated (``fit.measured_crossover``); ``None`` on one
    rank or when the ring never wins."""
    from .fit import measured_crossover

    if any(row.get("ring_speedup") is None for row in algo_rows):
        return None
    return measured_crossover(algo_rows, "size_mb", "butterfly_us", "ring_us")


def _covers(spec, n: int) -> bool:
    from ..utils.config import parse_topology_spec

    counts = parse_topology_spec(spec) if spec else None
    return counts is None or sum(counts) == n


def bench_hierarchy(comm, sizes_mb=(1, 4), topologies=("2x2",),
                    iters: int = 5):
    """The flat ring against the forced two-level lowering for the same
    PROD allreduce, per payload and topology spec: rows ``{size_mb,
    topology, flat_us, hier_us, hier_speedup}``.  A spec of another rank
    count is skipped."""
    n = comm.Get_size()
    rows = []
    for topo in topologies:
        if not _covers(topo, n):
            continue
        for mb in sizes_mb:
            nelem = max(1, int(mb * 1e6 / 4))
            x = torch.ones(nelem, dtype=torch.float32, device=comm.device)
            row = {"size_mb": round(nelem * 4 / 1e6, 3), "topology": topo}
            for label, algo in (("flat", "ring"), ("hier", "hier")):
                with env_patch(MPI4JAX_TPU_TOPOLOGY=topo,
                          MPI4JAX_TPU_COLLECTIVE_ALGO=algo):
                    t = _time(comm, lambda: _prod_step(comm, x), iters)
                row[f"{label}_us"] = round(t * 1e6, 1)
            row["hier_speedup"] = (round(row["flat_us"] / row["hier_us"], 2)
                                   if n > 1 else None)
            rows.append(row)
    return rows


def bench_alltoall(comm, sizes_mb=(0.25, 1), topologies=(None,),
                   iters: int = 5, compute_dim: int = 64):
    """The flat alltoall, the forced two-level one, and the chunked async
    start/wait with ``tanh(m @ m)`` in the gap, per payload and topology
    (``None``: the derived one): rows ``{size_mb, topology, flat_us,
    hier_us, async_us, hier_speedup}``, and for a uniform spec the modeled
    inter-host bytes and messages of flat and hier
    (``ops/_hierarchy.py``)."""
    from ..ops import _hierarchy
    from ..ops import alltoall
    from ..ops._async import alltoall_start, alltoall_wait
    from ..parallel.region import spmd
    from ..utils.config import parse_topology_spec

    n = comm.Get_size()
    huge = 1 << 60  # flat: the crossover can never trip
    rows = []
    for topo in topologies:
        if not _covers(topo, n):
            continue
        counts = parse_topology_spec(topo) if topo else None
        for mb in sizes_mb:
            per = max(1, int(mb * 1e6 / 4 / n))
            nbytes = n * per * 4
            x = torch.ones(n, per, dtype=torch.float32, device=comm.device)
            w = torch.full((compute_dim, compute_dim), 0.01,
                           device=comm.device)
            row = {"size_mb": round(nbytes / 1e6, 4),
                   "topology": topo or "derived"}

            @spmd(comm=comm)
            def sync(v, m):
                r, _ = alltoall(v)
                return r, torch.tanh(m @ m)

            @spmd(comm=comm)
            def split(v, m):
                h, _ = alltoall_start(v)
                m = torch.tanh(m @ m)  # overlaps the exchange
                r, _ = alltoall_wait(h)
                return r, m

            for label, algo, fn in (("flat", "auto", sync),
                                    ("hier", "hier", sync),
                                    ("async", "auto", split)):
                with env_patch(MPI4JAX_TPU_TOPOLOGY=topo,
                          MPI4JAX_TPU_COLLECTIVE_ALGO=algo,
                          MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES=(
                              huge if algo == "auto" else None)):
                    t = _time(comm, lambda: fn(x, w), iters)
                row[f"{label}_us"] = round(t * 1e6, 1)
            row["hier_speedup"] = (round(row["flat_us"] / row["hier_us"], 2)
                                   if n > 1 and row["hier_us"] else None)
            if counts is not None and len(set(counts)) == 1:
                h, r = len(counts), counts[0]
                row["dcn_bytes_flat"] = _hierarchy.flat_link_bytes(
                    "alltoall", "native", nbytes, n, h)[1]
                row["dcn_bytes_hier"] = _hierarchy.hier_link_bytes(
                    "alltoall", nbytes, h, r)[1]
                mf, mh = _hierarchy.alltoall_dcn_messages(h, r)
                row["dcn_msgs_flat"] = mf
                row["dcn_msgs_hier"] = mh
                row["dcn_msg_reduction"] = r
            rows.append(row)
    return rows


def bench_compression(comm, sizes_mb=(0.25, 1, 4), topology: str = "2x4",
                      iters: int = 3):
    """Per codec (off, bf16, fp8) and payload: the logical and wire
    inter-host bytes of the hierarchical allreduce (the byte models and
    the codec's arithmetic), its modeled inter-host time (the cost model,
    codec priced in) and the codec's measured round-trip relative error
    on gradient-scale data from a seed: rows ``{size_mb, codec, topology,
    logical_dcn_bytes, wire_dcn_bytes, modeled_dcn_us, rel_err}``.  The
    times are modeled, not measured: one host has no inter-host link."""
    from ..analysis import costmodel
    from ..ops import _hierarchy
    from ..ops._codec import wire_bytes
    from ..ops._compress import roundtrip
    from ..utils.config import parse_topology_spec

    counts = parse_topology_spec(topology)
    h, r = len(counts), counts[0]
    k = h * r
    model = costmodel.load_model()
    rows = []
    for mb in sizes_mb:
        n_elems = max(1, int(mb * 1e6 / 4))
        nbytes = n_elems * 4
        logical = _hierarchy.hier_link_bytes("allreduce", nbytes, h, r)[1]
        for codec in ("off", "bf16", "fp8"):
            c = None if codec == "off" else codec
            cost_c = costmodel.collective_cost(
                "allreduce", "hier", nbytes, k, hosts=h, hier=(h, r), codec=c)
            err = 0.0
            if c is not None:
                gen = torch.Generator().manual_seed(0)
                for _ in range(iters):
                    x = (torch.randn(n_elems, generator=gen) * 0.02).to(
                        comm.device)
                    y = roundtrip(x, c)
                    denom = max(float(x.abs().max()), 1e-30)
                    err = max(err, float((y - x).abs().max()) / denom)
            rows.append({
                "size_mb": round(nbytes / 1e6, 4),
                "codec": codec,
                "topology": topology,
                "logical_dcn_bytes": int(logical),
                "wire_dcn_bytes": int(wire_bytes(int(logical), c)),
                "modeled_dcn_us": round(model.link_time_us(
                    "dcn", cost_c.dcn.rounds, cost_c.dcn.nbytes), 2),
                "rel_err": round(err, 8),
            })
    return rows
