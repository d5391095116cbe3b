"""Shared validation for the ops: MPX-tagged errors, buffer checks, roots.

PyTorch counterpart of the subset of ``mpi4jax_tpu/ops/_base.py`` and
``mpi4jax_tpu/analysis/report.py`` that ``sendrecv`` and ``gather`` need.
The codes keep the JAX package's meaning, so a message greps the same.
"""

from __future__ import annotations

# the codes this package raises: bare-int routing, root out of range,
# send/recv type-signature mismatch
CODES = frozenset({"MPX103", "MPX105", "MPX106"})


def mpx_error(exc_type, code: str, message: str):
    """Build an exception tagged with a stable MPX code: the code rides
    along as ``exc.mpx_code`` and is appended to the message."""
    if code not in CODES:
        raise KeyError(f"unknown MPX code {code}")
    exc = exc_type(f"{message} [{code}]")
    exc.mpx_code = code
    return exc


def check_send_recv(sendbuf, recvbuf, what: str) -> None:
    """MPI's type-signature rule: equal dtypes, and shapes that differ only
    where the element counts match (the result takes ``recvbuf``'s shape)."""
    if sendbuf.dtype != recvbuf.dtype:
        raise mpx_error(
            ValueError, "MPX106",
            f"{what} requires matching send/recv dtypes (MPI type-signature "
            f"rule); got {sendbuf.dtype} vs {recvbuf.dtype}",
        )
    if sendbuf.shape != recvbuf.shape and sendbuf.numel() != recvbuf.numel():
        raise mpx_error(
            ValueError, "MPX106",
            f"{what}: send/recv buffers may differ in shape only when their "
            f"element counts match (the output is typed by recvbuf); got "
            f"{tuple(sendbuf.shape)} vs {tuple(recvbuf.shape)}",
        )


def check_root(root: int, size: int, what: str) -> None:
    """A static root must name a rank of the communicator (MPX105)."""
    if not 0 <= root < size:
        raise mpx_error(
            ValueError, "MPX105",
            f"{what} root {root} out of range for size {size}",
        )
