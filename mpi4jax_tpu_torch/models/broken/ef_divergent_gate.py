"""Seeded EF-residual schedule gate: INTENTIONALLY BROKEN (MPX141).

Twin of ``examples/broken/ef_divergent_gate.py``.  The error-feedback
residual (``compress.ef_allreduce``) is rank-local by design: each rank
accumulates its own quantization error.  Gating a branch on it gates on
a value that differs across ranks, and when the arms issue different
collective schedules the program deadlocks the first step the residuals
disagree: some ranks take the two-collective resync arm while the rest
take the one-collective arm, and the second reduce waits forever.

MPX108 stays silent (both arms communicate), and the per-rank re-runs
cannot concretize the predicate (it is data, not a rank).  Only the
dataflow pass sees it, by following the rank-local lineage from the
residual into the predicate of ``cond`` (``parallel/control.py``) and
comparing the arms' schedules.  Under a lossy codec the MPX142
approximate-lineage advisory rides along::

    python -m mpi4jax_tpu_torch.models.broken.ef_divergent_gate \
        [--launch 4 --device cpu]

runs ``analyze(ranks='all')`` and the ambient ``error`` mode on a virtual
grid of 4 ranks (and on 4 gloo ranks with ``--launch 4``) with
``MPI4JAX_TPU_COMPRESS=bf16`` unless it is set, and asserts each flags
MPX141.
"""

import os
import sys

import torch

from mpi4jax_tpu_torch import SUM, allreduce, compress
from mpi4jax_tpu_torch.models.broken import drill
from mpi4jax_tpu_torch.parallel.control import cond

CODES = {"MPX141"}


def build(comm, device=None):
    def step(g, res):
        total, new_res, _ = compress.ef_allreduce(g, res, comm=comm)
        # BUG: drift comes from the rank-LOCAL residual: every rank
        # computes a different value.  Replicate it first (allreduce with
        # MAX) if it must steer the schedule.
        drift = new_res.abs().max()

        def resync(v):
            # two collectives: re-reduce, then re-center
            s, _ = allreduce(v, SUM, comm=comm)
            m, _ = allreduce(s.mean() * torch.ones_like(s), SUM, comm=comm)
            return s - m / comm.Get_size()

        def keep(v):
            # one collective: both arms communicate, so MPX108 stays silent,
            # but the schedules differ, which is the hang
            s, _ = allreduce(v, SUM, comm=comm)
            return s

        return cond(drift > 0.05, resync, keep, total), new_res

    return step


def example(comm, device):
    g = torch.full((64,), 1.0, device=device)
    return g, torch.zeros_like(g)


def main(argv=None):
    os.environ.setdefault("MPI4JAX_TPU_COMPRESS", "bf16")
    return drill("ef_divergent_gate", argv)


if __name__ == "__main__":
    main(sys.argv[1:])
