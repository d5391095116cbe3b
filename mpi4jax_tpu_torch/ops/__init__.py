"""The 13 communication ops, ``Status``, ``flush`` and tokens.

PyTorch counterpart of ``mpi4jax_tpu/ops/__init__.py``.  The throughput
layer beside the ops: fusion (``_fusion.py``), the async start/wait pairs
and ``overlap()`` (``_async.py``), the codecs and error feedback
(``_codec.py``, ``_compress.py``, with its compressed inter-host leg); and
the collective algorithm layer: the ring, van de Geijn and pairwise
lowerings with the selector that picks one per call (``_algos.py``) and
the two-level host hierarchy (``_hierarchy.py``).
"""

from ._base import (  # noqa: F401
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
    OpLike,
    cache_stats,
    clear_caches,
    varying,
)
from ._async import (  # noqa: F401
    AsyncHandle,
    P2PHandle,
    allreduce_start,
    allreduce_wait,
    alltoall_start,
    alltoall_wait,
    overlap,
    p2p_wait,
    recv_start,
    reduce_scatter_start,
    reduce_scatter_wait,
    send_start,
)
from ._fusion import set_fusion_mode  # noqa: F401
from .allgather import allgather  # noqa: F401
from .allreduce import allreduce  # noqa: F401
from .alltoall import alltoall  # noqa: F401
from .barrier import barrier  # noqa: F401
from .bcast import bcast  # noqa: F401
from .gather import gather  # noqa: F401
from .recv import recv  # noqa: F401
from .reduce import reduce  # noqa: F401
from .reduce_scatter import reduce_scatter  # noqa: F401
from .scan import scan  # noqa: F401
from .scatter import scatter  # noqa: F401
from .send import flush, send  # noqa: F401
from .sendrecv import sendrecv  # noqa: F401
from .status import Status  # noqa: F401
from .token import Token, create_token  # noqa: F401
