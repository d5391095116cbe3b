"""Runtime telemetry walkthrough.

The twin of ``examples/telemetry_demo.py``: a small collective workload
under the ``events`` tier, then the cross-rank ``report()`` table (per op
its calls and bytes, latency percentiles, the skew and straggler
columns), with each process's JSONL journal left for the merge command::

    MPI4JAX_TPU_TELEMETRY_DIR=/tmp/mpx-tel \\
      python -m mpi4jax_tpu_torch.models.telemetry_demo --ranks 4 --device cpu
    python -m mpi4jax_tpu_torch.telemetry merge /tmp/mpx-tel --perfetto trace.json

The step is the example's: a SUM ``allreduce``, a ``bcast`` from rank 0
and a ring hop (``sendrecv`` to ``shift(1)``), three rows of the table,
called five times on (1024,) f32 ones a rank.  The port counts every call
(the JAX package counts once a trace), so each row's calls are the five
executions its ``execs`` column counts a rank.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from .. import (SUM, allreduce, bcast, get_default_comm, sendrecv,
                set_telemetry_mode, shift, spmd, telemetry, varying)

CALLS = 5
WIDTH = 1024


def main(calls: int = CALLS, width: int = WIDTH) -> dict:
    """Run the step ``calls`` times on the default comm under ``events``,
    print the report and return ``{"report", "snapshot", "dir"}`` (this
    process's snapshot, taken before the report's own exchanges)."""
    if not os.environ.get("MPI4JAX_TPU_TELEMETRY_DIR"):
        os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = tempfile.mkdtemp(
            prefix="mpx-telemetry-")
    set_telemetry_mode("events")
    try:
        comm = get_default_comm()

        @spmd(comm=comm)
        def step(x):
            # a reduction, a broadcast and a ring hop: three rows of the
            # report's table
            s, tok = allreduce(x, op=SUM)
            b, tok = bcast(varying(s), 0, token=tok)
            r, _ = sendrecv(b, b, dest=shift(1), token=tok)
            return r

        x = torch.ones(width, dtype=torch.float32, device=comm.device)
        for _ in range(calls):
            out = step(x)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        snap = telemetry.snapshot()
        if comm.Get_rank() == 0:
            print(f"journal dir: {os.environ['MPI4JAX_TPU_TELEMETRY_DIR']}")
            text = telemetry.report(comm=comm)
        else:
            # every rank joins the report's exchanges; rank 0 prints
            with open(os.devnull, "w") as quiet:
                text = telemetry.report(comm=comm, file=quiet)
    finally:
        set_telemetry_mode(None)
    return {"report": text, "snapshot": snap,
            "dir": os.environ["MPI4JAX_TPU_TELEMETRY_DIR"]}


def rank_main(rank: int, device, calls: int = CALLS, width: int = WIDTH,
              tdir: str = "") -> dict:
    """``main`` on one rank of a ``launch.run`` world (its journal under
    ``tdir`` when given)."""
    from ..parallel.mesh import make_world_mesh, set_default_mesh

    if tdir:
        os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = tdir
    set_default_mesh(make_world_mesh(device=device))
    return main(calls, width)


if __name__ == "__main__":
    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device every rank shares")
    a = ap.parse_args()
    tdir = os.environ.get("MPI4JAX_TPU_TELEMETRY_DIR") or tempfile.mkdtemp(
        prefix="mpx-telemetry-")
    launch.run(rank_main, a.ranks, backend="gloo", device=a.device,
               args=(a.device, CALLS, WIDTH, tdir))
