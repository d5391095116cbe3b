"""Tokens: ordering handles kept for API parity.

PyTorch counterpart of ``mpi4jax_tpu/ops/token.py``.  There a token is a
data dependency that pins the order of collectives inside one traced
program.  Eager PyTorch runs each op when it is called, in program order,
so a token orders nothing; ops still take and return one so that code
written as ``result, token = op(..., token=token)`` reads the same.
"""

from __future__ import annotations


class Token:
    """An ordering handle; carries no data."""

    __slots__ = ()

    def __repr__(self):
        return "Token()"


def create_token(_arg=None) -> Token:
    """A fresh token.  The optional argument is accepted for drop-in
    compatibility and ignored."""
    return Token()


def produce(token):
    """The token an op returns: the one it was given, or a new one."""
    return token if token is not None else Token()
