"""Seeded interleaved-pipeline deadlock: INTENTIONALLY BROKEN (MPX121).

Twin of ``examples/broken/pipeline_interleave_deadlock.py``.  One
boundary tick of an interleaved pipeline over the wrap ring, with the
chunk order rank-divergent: even ranks ship chunk 0 (tag 0) then chunk 1
(tag 1), odd ranks the reverse.  Each rank's first receive waits on a
message its predecessor sends only after its own first receive: a cycle
around the whole ring::

    python -m mpi4jax_tpu_torch.models.broken.pipeline_interleave_deadlock \
        [--launch 4 --device cpu]

runs both front-ends on a virtual grid of 4 ranks (and on 4 gloo ranks
with ``--launch 4``) and asserts each flags MPX121 (or MPX122).
"""

import sys

import torch

from mpi4jax_tpu_torch import recv, send
from mpi4jax_tpu_torch.models.broken import drill

CODES = {"MPX121", "MPX122"}


def build(comm, device=None):
    """One interleave boundary tick over the wrap ring, chunk order
    rank-divergent."""
    n = comm.Get_size()
    ring = tuple((i, (i + 1) % n) for i in range(n))

    def boundary(h):
        if comm.Get_rank() % 2 == 0:
            t = send(h, ring, tag=0, comm=comm)
            c0, t = recv(h, source=ring, tag=0, comm=comm, token=t)
            t = send(c0, ring, tag=1, comm=comm, token=t)
            c1, _t = recv(c0, source=ring, tag=1, comm=comm, token=t)
            return c1
        t = send(h, ring, tag=1, comm=comm)
        c1, t = recv(h, source=ring, tag=1, comm=comm, token=t)
        t = send(c1, ring, tag=0, comm=comm, token=t)
        c0, _t = recv(c1, source=ring, tag=0, comm=comm, token=t)
        return c0

    return boundary


def example(comm, device):
    return (torch.zeros(16, device=device),)


def main(argv=None):
    return drill("pipeline_interleave_deadlock", argv)


if __name__ == "__main__":
    main(sys.argv[1:])
