"""mpi4jax_tpu_torch — the PyTorch/CUDA port of mpi4jax_tpu.

One process per rank; a ``Comm`` is a set of axes of a process grid, and
the ops keep the JAX package's ``(result, token)`` API.  This slice covers
the single-GPU main path: the size-1 communicator, ``sendrecv``,
``gather``, tokens, and the shallow-water solver (``models``) with its
fused step kernel written in CUDA for Hopper (``kernels/sw_steps.py``,
``csrc/sw_steps.cu``).  Nothing here imports JAX.
"""

from .ops.gather import gather  # noqa: F401
from .ops.sendrecv import sendrecv  # noqa: F401
from .ops.token import Token, create_token  # noqa: F401
from .parallel.comm import Comm  # noqa: F401
from .parallel.mesh import ProcessGrid, make_world_mesh, resolve_device  # noqa: F401
from .parallel.rankspec import shift  # noqa: F401

__all__ = [
    "Comm",
    "ProcessGrid",
    "Token",
    "create_token",
    "gather",
    "make_world_mesh",
    "resolve_device",
    "sendrecv",
    "shift",
]
