"""Seeded async-span donation race: INTENTIONALLY BROKEN (MPX139).

Twin of ``examples/broken/overlap_donation_race.py``.  An
``allreduce_start`` puts its input buffer on the wire: the exchange reads
it until the matching ``allreduce_wait``.  Handing that buffer's storage
to a pinned program in the gap (``compile(..., donate_argnums=(0,))``
donates the argument, so the program may overwrite it in place) is a
write-after-start race: the wire can ship the scaled bytes instead of
the originals.

Nothing structural is wrong with the schedule (start and wait pair up,
the cross-rank matcher is happy), so only the donation hazard checker
catches it, by joining the recorded span with the pin's donation
record::

    python -m mpi4jax_tpu_torch.models.broken.overlap_donation_race \
        [--launch 4 --device cpu]

runs both front-ends on a virtual grid of 4 ranks (and on 4 gloo ranks
with ``--launch 4``) and asserts each flags MPX139.
"""

import sys

import torch

from mpi4jax_tpu_torch import SUM, allreduce_start, allreduce_wait, compile
from mpi4jax_tpu_torch.models.broken import drill

CODES = {"MPX139"}


def build(comm, device=None):
    """One training-ish step: overlap a gradient allreduce with a pinned
    rescale that donates the gradient buffer mid-span."""
    local = torch.zeros(16, device=device)
    # the donating pinned helper (eager convention: no region of its own)
    scale = compile(lambda v: v * 2.0, local, wrap=False, donate_argnums=(0,))

    def step(x):
        handle, t = allreduce_start(x, SUM, comm=comm)
        # BUG: x is still held by the open span; donating its storage here
        # lets the program overwrite bytes the exchange is about to ship.
        # The fix is to call scale() after the wait (or on a copy).
        y = scale(x)
        total, t = allreduce_wait(handle, token=t)
        return total + y

    return step


def example(comm, device):
    return (torch.zeros(16, device=device),)


def main(argv=None):
    return drill("overlap_donation_race", argv)


if __name__ == "__main__":
    main(sys.argv[1:])
