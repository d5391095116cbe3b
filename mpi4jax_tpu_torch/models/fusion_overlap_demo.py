"""Fusion and async overlap: the throughput layer end to end.

The twin of ``examples/fusion_overlap_demo.py``, three forms on one comm
over the world, each held against the plain allreduce:

1. fusion: sixteen small allreduces issued before any is used, under
   ``set_fusion_mode("auto")``, go out as one packed collective (counted
   from ``ops/_staging.stats``; the JAX example reads its telemetry
   meters, which the port does not have yet);
2. an explicit ``allreduce_start``, independent compute (a 32x32 matmul
   and ``tanh``), ``allreduce_wait``;
3. the same inside ``overlap()``, the wait deferred to the result's use.

``main`` runs on every rank of a world that ``parallel/launch.py:run``
started, or alone as a world of one:

    python -m mpi4jax_tpu_torch.models.fusion_overlap_demo --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from .. import (
    SUM,
    Comm,
    allreduce,
    allreduce_start,
    allreduce_wait,
    make_world_mesh,
    overlap,
)
from ..ops import _staging
from ..ops._fusion import set_fusion_mode
from ..parallel.region import spmd


def demo_leaves(device) -> list:
    """Sixteen leaves of 64, 128 or 192 elements, leaf i full of i + 1."""
    return [torch.full((64 * (i % 3 + 1),), float(i + 1), device=device)
            for i in range(16)]


def fused_mean(comm: Comm, leaves: list) -> list:
    """Every leaf's mean over the ranks: all allreduces issued, then used."""
    n = comm.Get_size()

    @spmd(comm=comm)
    def f(xs):
        red = [allreduce(x, op=SUM)[0] for x in xs]
        return [r * (1.0 / n) for r in red]

    return f(leaves)


def split_step(comm: Comm, g: torch.Tensor, m: torch.Tensor):
    """``g``'s mean over the ranks by start and wait, with ``tanh(m @ m)``
    computed in the gap."""
    n = comm.Get_size()

    @spmd(comm=comm)
    def f(g, m):
        h, tok = allreduce_start(g, op=SUM)
        m = torch.tanh(m @ m)  # independent of g: overlaps the exchange
        s, _ = allreduce_wait(h, token=tok)
        return s * (1.0 / n), m

    return f(g, m)


def overlap_step(comm: Comm, g: torch.Tensor, m: torch.Tensor):
    """``split_step`` through ``overlap()``: the start at the call, the
    wait at the first use."""
    n = comm.Get_size()

    @spmd(comm=comm)
    def f(g, m):
        with overlap():
            s, _ = allreduce(g, op=SUM)
            m = torch.tanh(m @ m)
            out = s * (1.0 / n)
        return out, m

    return f(g, m)


def main(device=None):
    """The three forms on this rank; raises where one differs from the
    plain allreduce (every value here is a small integer times 1/n, so
    bit for bit).  Returns each form's result beside the plain one and
    the exchanges of the fused and the unfused batch."""
    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    n, dev = comm.Get_size(), mesh.device
    leaves = demo_leaves(dev)
    out = {}
    for mode in ("auto", "off"):
        set_fusion_mode(mode)
        try:
            _staging.stats.reset()
            out[f"fused/{mode}"] = fused_mean(comm, leaves)
            out[f"fused/{mode}/calls"] = _staging.stats.calls
        finally:
            set_fusion_mode(None)
    for got, want in zip(out["fused/auto"], out["fused/off"]):
        if not torch.equal(got, want):
            raise AssertionError("fused mean differs from the unfused one")
    if out["fused/auto"][2][0].item() != 3.0:
        raise AssertionError(f"leaf 2's mean is {out['fused/auto'][2][0].item()}")
    g = torch.ones(4096, device=dev)
    m = torch.full((32, 32), 0.01, device=dev)
    plain = allreduce(g, op=SUM, comm=comm)[0] * (1.0 / n)
    out["plain"] = plain
    out["split"], m_split = split_step(comm, g, m)
    out["overlap"], m_over = overlap_step(comm, g, m)
    for form in ("split", "overlap"):
        if not torch.equal(out[form], plain):
            raise AssertionError(f"{form} mean differs from the plain allreduce's")
    if not torch.equal(m_split, m_over):
        raise AssertionError("the compute in the gap differs between the forms")
    if comm.Get_rank() == 0:
        print(f"fusion: {len(leaves)} member allreduces -> "
              f"{out['fused/auto/calls']} packed collective(s) "
              f"({out['fused/off/calls']} unfused)")
        print(f"start/wait: allreduce of {g.numel()} floats with a "
              f"{m.shape[-1]}x{m.shape[-1]} matmul in the gap")
        print(f"overlap(): same result, wait at first use ({n} rank(s))")
    return out


def rank_main(rank: int, device):
    """``main`` on one rank of a ``launch.run`` world."""
    return main(device)


if __name__ == "__main__":
    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device every rank shares")
    a = ap.parse_args()
    launch.run(rank_main, a.ranks, backend="gloo", device=a.device,
               args=(a.device,))
