"""Seeded rank-divergent deadlock: INTENTIONALLY BROKEN (MPX121).

Twin of ``examples/broken/rank_divergent_deadlock.py``.  A Python branch
on the rank's parity where both branches communicate, but even and odd
ranks issue their point-to-point ops in cycle-forming order: every rank
posts its *receive* first, and the matching send lives after the peer's
receive.  Each even/odd pair is a two-rank wait cycle, a hang under any
buffering.

Only the cross-rank schedule pass catches it, by re-running the program
once per rank (``comm.Get_rank()`` returns that rank, so the branch
takes its real per-rank path), matching the per-rank schedules and
walking the wait-for graph::

    python -m mpi4jax_tpu_torch.models.broken.rank_divergent_deadlock \
        [--launch 4 --device cpu]

runs ``analyze(ranks='all')`` and the ambient ``error`` mode on a virtual
grid of 4 ranks (and on 4 gloo ranks with ``--launch 4``), and asserts
each flags MPX121.
"""

import sys

import torch

from mpi4jax_tpu_torch import recv, send
from mpi4jax_tpu_torch.models.broken import drill

CODES = {"MPX121"}


def build(comm, device=None):
    """Neighbor exchange over even/odd pairs, recv before send on both
    sides: the textbook head-to-head deadlock, written rank-divergently."""
    k = comm.Get_size()
    up = tuple((i, i + 1) for i in range(0, k - 1, 2))    # even -> odd
    down = tuple((i + 1, i) for i in range(0, k - 1, 2))  # odd -> even

    def exchange(x):
        if comm.Get_rank() % 2 == 0:
            # wait for the odd neighbor's message... which it only sends
            # after ITS recv completes: a two-rank cycle
            got, t = recv(x, source=down, tag=0, comm=comm)
            send(x, up, tag=1, comm=comm, token=t)
            return got
        got, t = recv(x, source=up, tag=1, comm=comm)
        send(x, down, tag=0, comm=comm, token=t)
        return got

    return exchange


def example(comm, device):
    return (torch.zeros(16, device=device),)


def main(argv=None):
    return drill("rank_divergent_deadlock", argv)


if __name__ == "__main__":
    main(sys.argv[1:])
