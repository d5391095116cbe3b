"""Status: what a ``recv`` or ``sendrecv`` received.

PyTorch counterpart of ``mpi4jax_tpu/ops/status.py``, the optional
``status=`` out-parameter: ``source`` is the sender's rank in the comm
(the group rank on a color split), ``-1`` where nothing arrived (the
MPI_PROC_NULL analog); ``tag`` is the tag the message was sent with;
``count`` its element count and ``dtype`` its torch dtype.  ``Get_error``
always reports success (0): a failed transfer raises instead, so a Status
that exists describes a completed receive.
"""

from __future__ import annotations

import numpy as np
import torch

#: MPI_SUCCESS analog, the only error a completed receive can have
SUCCESS = 0


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


class Status:
    __slots__ = ("source", "tag", "count", "dtype", "error")

    def __init__(self):
        self.source = None
        self.tag = None
        self.count = None
        self.dtype = None
        self.error = SUCCESS

    def Get_source(self):
        return self.source

    def Get_tag(self):
        return self.tag

    def Get_count(self):
        return self.count

    def Get_error(self):
        """Always ``SUCCESS`` (0); see the module docstring."""
        return self.error

    def Get_elements(self, dtype=None):
        """The received elements counted in ``dtype`` (a torch or numpy
        dtype; default: the message's own): the byte count over its item
        size, which must divide it."""
        if self.count is None:
            return None
        if dtype is None:
            dtype = self.dtype
        nbytes = self.count * _itemsize(self.dtype)
        itemsize = _itemsize(dtype)
        if nbytes % itemsize:
            raise ValueError(
                f"Get_elements: {nbytes} received bytes is not a whole "
                f"number of {dtype} elements"
            )
        return nbytes // itemsize

    def __repr__(self):
        return (f"Status(source={self.source}, tag={self.tag}, "
                f"count={self.count}, dtype={self.dtype}, "
                f"error={self.error})")
