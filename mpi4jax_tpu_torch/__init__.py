"""mpi4jax_tpu_torch — the PyTorch/CUDA port of mpi4jax_tpu.

One process per rank; a ``Comm`` is a set of axes of a process grid, and
the ops keep the JAX package's ``(result, token)`` API.  Ranks are
``torch.distributed`` processes (``parallel/launch.py`` starts them on one
host; gloo, or NCCL with a GPU per rank).  Ported so far: the
communicator with its row and column sub-communicators, ``Clone``/``Dup``
and color splits (``Comm.Split``, ``GroupComm``); all 13 ops
(``allgather``, ``allreduce`` with every reduction and callables,
``alltoall``, ``barrier``, ``bcast``, ``gather``, ``recv``, ``reduce``,
``reduce_scatter``, ``scan``, ``scatter``, ``send``, ``sendrecv``) with
``Status``, ``flush``, tokens and the tokenless ``experimental.notoken``,
and the autodiff of the differentiable ones (reverse and forward mode);
the shallow-water solver (``models``) on any process grid, with its three
kernels written in CUDA for Hopper (``kernels/``, ``csrc/``: the fused
whole-step, split-phase and wide-halo kernels), and long-context
attention forward and backward (``attention``: ring with its
memory-efficient or op-by-op backward and Ulysses over the ranks,
single-device flash attention) on the four flash-attention kernels, also
in CUDA, with the dp x sp training example
(``models/long_context_training.py``); and the ``dryrun_multichip`` twin
(``entry.py``).  Nothing here imports JAX.
"""

from .ops import (  # noqa: F401
    BAND,
    BOR,
    BXOR,
    LAND,
    LOR,
    LXOR,
    MAX,
    MIN,
    PROD,
    SUM,
    Op,
    Status,
    Token,
    allgather,
    allreduce,
    alltoall,
    barrier,
    bcast,
    create_token,
    flush,
    gather,
    recv,
    reduce,
    reduce_scatter,
    scan,
    scatter,
    send,
    sendrecv,
)
from .parallel.comm import Comm, GroupComm  # noqa: F401
from .parallel.mesh import (  # noqa: F401
    ProcessGrid,
    init_distributed,
    make_world_mesh,
    resolve_device,
)
from .parallel.rankspec import shift  # noqa: F401

__all__ = [
    "BAND",
    "BOR",
    "BXOR",
    "Comm",
    "GroupComm",
    "LAND",
    "LOR",
    "LXOR",
    "MAX",
    "MIN",
    "Op",
    "PROD",
    "ProcessGrid",
    "SUM",
    "Status",
    "Token",
    "allgather",
    "allreduce",
    "alltoall",
    "barrier",
    "bcast",
    "create_token",
    "flush",
    "gather",
    "init_distributed",
    "make_world_mesh",
    "recv",
    "reduce",
    "reduce_scatter",
    "resolve_device",
    "scan",
    "scatter",
    "send",
    "sendrecv",
    "shift",
]
