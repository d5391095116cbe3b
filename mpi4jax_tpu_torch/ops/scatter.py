"""scatter: root's slices, one to each rank.

PyTorch counterpart of ``mpi4jax_tpu/ops/scatter.py``: every rank passes a
``(size, *s)`` tensor (only root's contents matter) and rank r receives
root's ``x[r]``.  As in the JAX package it is one ``alltoall`` and a
selection of the row that came from root, so it differentiates through
``alltoall``: root's gradient holds every rank's cotangent in its row.
"""

from __future__ import annotations

from typing import Optional

from ..parallel.comm import Comm
from ._base import check_comm, check_root, meta_like, run_body
from .alltoall import alltoall
from .token import Token, produce


def scatter(x, root: int, *, comm: Optional[Comm] = None,
            token: Optional[Token] = None):
    """Scatter ``x`` (shape ``(size, *s)``, significant on root only) so
    rank r receives root's ``x[r]``.  Returns ``(result, token)``."""
    comm = check_comm(comm, "scatter")
    size = comm.Get_size()
    check_root(root, size, "scatter")
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"scatter input must have leading axis == comm size ({size}), "
            f"got shape {tuple(x.shape)}"
        )

    def body(comm, arrays, token):
        (x,) = arrays
        if size == 1:
            return x[0].clone(), produce(token)
        rows, _ = alltoall(x, comm=comm)
        return rows[root], produce(token)

    return run_body("scatter", comm, body, (x,), token, ana={"root": root},
                    abstract=lambda a, t: (meta_like(a[0], a[0].shape[1:]),
                                           produce(t)))
