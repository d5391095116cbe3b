"""Topology-aware collectives: the two-level layer end to end.

The twin of ``examples/hierarchical_demo.py``.  Run plain (one host: the
hierarchy stays out of the way and the flat algorithms run) or under a
faked topology, as the JAX example runs on its CPU mesh:

    MPI4JAX_TPU_TOPOLOGY=2x2 python -m mpi4jax_tpu_torch.models.hierarchical_demo --launch 4 --device cpu

Three stages, printed on rank 0:

1. **plan**: the host partition derived for the world comm and whether
   the two-level decomposition exists (``ops/_hierarchy.py:hier_plan``);
2. **equivalence**: the same PROD ``allreduce``, ``bcast`` and
   ``reduce_scatter`` forced through the flat ring and the two-level
   lowering agree (rtol 1e-6, as the JAX example holds them: the PROD's
   two fold orders differ in the last bits);
3. **telemetry**: the counters' per-link-class bytes of the hierarchical
   (or, without a plan, the ring) allreduce.

``main`` runs on every rank of a world that ``parallel/launch.py:run``
started (``--launch N``), or alone as a world of one.  ``--device`` is
``cpu`` or a CUDA device every rank shares (default: the card).
"""

from __future__ import annotations

import argparse
import os

import torch

from .. import (PROD, SUM, Comm, allreduce, bcast, make_world_mesh,
                reduce_scatter, telemetry)
from ..ops._hierarchy import hier_plan


class forced_algo:
    """``MPI4JAX_TPU_COLLECTIVE_ALGO`` set to ``algo`` for a block."""

    def __init__(self, algo: str):
        self.algo = algo

    def __enter__(self):
        self.saved = os.environ.get("MPI4JAX_TPU_COLLECTIVE_ALGO")
        os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = self.algo

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("MPI4JAX_TPU_COLLECTIVE_ALGO", None)
        else:
            os.environ["MPI4JAX_TPU_COLLECTIVE_ALGO"] = self.saved
        return False


def plan_line(comm: Comm) -> str:
    """Stage 1's line, the JAX example's words."""
    spec = os.environ.get("MPI4JAX_TPU_TOPOLOGY", "")
    n = comm.Get_size()
    plan = hier_plan(comm)
    if plan is None:
        return (f"topology: {spec or 'derived from mesh'} -> no multi-host "
                f"hierarchy for this {n}-device comm (flat algorithms "
                "everywhere — the correct no-op)")
    return (f"topology: {spec or 'derived from mesh'} -> "
            f"{plan.h} hosts x {plan.r} ranks/host; two-level "
            "lowerings available")


def equivalence(comm: Comm, device) -> dict:
    """Stage 2: each algorithm's (allreduce PROD, bcast from root 1,
    reduce_scatter SUM) on this rank's inputs."""
    n, rank = comm.Get_size(), comm.Get_rank()
    x = torch.full((4096,), 1.0 + 0.001 * rank, dtype=torch.float32,
                   device=device)
    blocks = (torch.arange(n * 8, dtype=torch.float32, device=device)
              .reshape(n, 8) + rank)
    results = {}
    for algo in ("ring", "hier"):
        with forced_algo(algo):
            s, _ = allreduce(x, PROD, comm=comm)
            c, _ = bcast(blocks[0], 1 % n, comm=comm)
            d, _ = reduce_scatter(blocks, SUM, comm=comm)
            results[algo] = (s, c, d)
    return results


def link_rows(comm: Comm, device) -> list:
    """Stage 3: the counters' rows of one PROD allreduce under ``hier``
    (``ring`` without a plan)."""
    n, rank = comm.Get_size(), comm.Get_rank()
    x = torch.full((4096,), 1.0 + 0.001 * rank, dtype=torch.float32,
                   device=device)
    telemetry.set_telemetry_mode("counters")
    try:
        telemetry.reset()
        with forced_algo("hier" if hier_plan(comm) is not None else "ring"):
            allreduce(x, PROD, comm=comm)
        return [row for _key, row in sorted(telemetry.snapshot()["ops"].items())]
    finally:
        telemetry.set_telemetry_mode(None)
        telemetry.reset()


def main(device=None) -> dict:
    """The three stages on this rank; raises where the lowerings disagree.
    Returns the plan line, each algorithm's results and the rows."""
    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    line = plan_line(comm)
    results = equivalence(comm, mesh.device)
    for flat, hier in zip(results["ring"], results["hier"]):
        torch.testing.assert_close(hier, flat, rtol=1e-6, atol=0.0)
    rows = link_rows(comm, mesh.device)
    if comm.Get_rank() == 0:
        print(line)
        print("equivalence: PROD allreduce + bcast + reduce_scatter agree "
              "between the flat ring and the two-level lowering")
        for row in rows:
            print(f"telemetry: {row['op']} algo={row['algo']} "
                  f"intra_host={row['intra_bytes']} B "
                  f"inter_host={row['inter_bytes']} B "
                  f"(payload {row['bytes']} B)")
    return {"plan": line, "results": results, "rows": rows}


def rank_main(rank: int, device):
    """``main`` on one rank of a ``launch.run`` world."""
    return main(device)


if __name__ == "__main__":
    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launch", type=int, default=0, metavar="N",
                    help="start N gloo ranks (0: run as a world of one)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device every rank shares")
    a = ap.parse_args()
    if a.launch:
        launch.run(rank_main, a.launch, backend="gloo", device=a.device,
                   timeout=600, args=(a.device,))
    else:
        main(a.device)
