"""mpi4jax_tpu_torch — the PyTorch/CUDA port of mpi4jax_tpu.

One process per rank; a ``Comm`` is a set of axes of a process grid, and
the ops keep the JAX package's ``(result, token)`` API.  Ranks are
``torch.distributed`` processes (``parallel/launch.py`` starts them on one
host; gloo, or NCCL with a GPU per rank).  Ported so far: the
communicator with its row and column sub-communicators, ``sendrecv``,
``gather``, ``alltoall`` (differentiable), ``allreduce`` (SUM, PROD, MIN,
MAX), tokens, the shallow-water solver (``models``) on any process grid,
with its three kernels written in CUDA for Hopper (``kernels/``,
``csrc/``: the fused whole-step, split-phase and wide-halo kernels), and
long-context attention forward and backward (``attention``: ring with
its memory-efficient backward and Ulysses over the ranks, single-device
flash attention) on the four flash-attention kernels, also in CUDA,
with the dp x sp training example (``models/long_context_training.py``).
Nothing here imports JAX.
"""

from .ops.allreduce import MAX, MIN, PROD, SUM, Op, allreduce  # noqa: F401
from .ops.alltoall import alltoall  # noqa: F401
from .ops.gather import gather  # noqa: F401
from .ops.sendrecv import sendrecv  # noqa: F401
from .ops.token import Token, create_token  # noqa: F401
from .parallel.comm import Comm  # noqa: F401
from .parallel.mesh import (  # noqa: F401
    ProcessGrid,
    init_distributed,
    make_world_mesh,
    resolve_device,
)
from .parallel.rankspec import shift  # noqa: F401

__all__ = [
    "Comm",
    "MAX",
    "MIN",
    "Op",
    "PROD",
    "ProcessGrid",
    "SUM",
    "Token",
    "allreduce",
    "alltoall",
    "create_token",
    "gather",
    "init_distributed",
    "make_world_mesh",
    "resolve_device",
    "sendrecv",
    "shift",
]
