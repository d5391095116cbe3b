"""Seeded rank-divergent MoE capacity split: INTENTIONALLY BROKEN (MPX120).

Twin of ``examples/broken/moe_divergent_capacity.py``.  The MoE dispatch
and combine contract (``parallel/moe.py``) is that every rank derives the
same capacity bucketing from shared static structure.  This program
derives the combine's chunking from the rank: even ranks split it into
two half-capacity alltoalls, odd ranks issue one full-capacity exchange.
At the second collective position on the comm the even ranks sit in an
``alltoall`` while the odd ranks are already in the gate-stats
``allreduce``: a cross-rank order mismatch that hangs at run time::

    python -m mpi4jax_tpu_torch.models.broken.moe_divergent_capacity \
        [--launch 4 --device cpu]

runs both front-ends on a virtual grid of 4 ranks (and on 4 gloo ranks
with ``--launch 4``) and asserts each flags MPX120.
"""

import sys

import torch

from mpi4jax_tpu_torch import SUM, allreduce, alltoall
from mpi4jax_tpu_torch.models.broken import drill

CODES = {"MPX120"}
CAPACITY = 4
D = 8


def build(comm, device=None):
    """The combine stage with rank-derived chunking, then the allreduce of
    the gate load stats: the schedules disagree at the second collective
    position on the comm."""

    def combine(buckets):
        # buckets: (k, CAPACITY, D), this rank's processed expert output
        if comm.Get_rank() % 2 == 0:
            half = CAPACITY // 2
            lo, _ = alltoall(buckets[:, :half], comm=comm)
            hi, _ = alltoall(buckets[:, half:], comm=comm)
            combined = torch.cat([lo, hi], dim=1)
        else:
            combined, _ = alltoall(buckets, comm=comm)
        load, _ = allreduce(combined.sum(), op=SUM, comm=comm)
        return combined, load

    return combine


def example(comm, device):
    return (torch.zeros((comm.Get_size(), CAPACITY, D), device=device),)


def main(argv=None):
    return drill("moe_divergent_capacity", argv)


if __name__ == "__main__":
    main(sys.argv[1:])
