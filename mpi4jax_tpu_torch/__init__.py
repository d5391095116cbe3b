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
(``entry.py``); the throughput layer of the data-parallel path: tensor
fusion (``set_fusion_mode``), the async ``*_start``/``*_wait`` pairs and
``overlap()``, regions (``spmd``, ``run``, ``get_default_comm``) and
error-feedback compression (``compress``), with the data-parallel
training and fusion demo examples (``models/``); and the dispatch
layer: ``compile`` (``aot/``: a pinned program, on one CUDA rank a
captured CUDA graph, stale under MPX129 when a knob moves), megastep loops
(``spmd``/``compile`` ``unroll=N``, ``parallel/megastep.py``, with its
boundary hooks) and ``models.shallow_water.solve_fused(unroll=N)``;
and the runtime services around every op's one dispatch point
(``ops/_base.py:run_body``): the native host hooks (``native.py``:
runtime tracing, ``abort_if``, the C++ watchdog), telemetry
(``telemetry/``: counters, the events journal, ``report``, the merge of
journals) and resilience (``resilience/``: the watchdog, fault
injection, numeric guards, the rendezvous retry), all off by default;
and the health plane (``telemetry/health.py``: the flight ring, the
straggler detector, postmortem bundles and their merge, Prometheus text)
with the JAX package's remaining top-level helpers (``profile_ops``,
``cache_stats``, ``clear_caches``, ``varying``, the default mesh, the
capability probes); and elastic recovery (``resilience/elastic.py``:
``elastic.run``, ``ShardStore``, ``RankFailure``, communication epochs
with MPX126, graceful drains with ``request_drain``,
``install_preemption_handler`` and MPX127, grow with
``elastic.join_and_run``, ``aot.compile_step``, the chaos drills of
``resilience/drill.py``); and the parallel workloads: the expert-parallel
MoE layer (``moe``, ``parallel/moe.py``) and the pipeline schedule
compiler (``pipeline``, ``PipelineProgram``: gpipe, 1f1b and interleaved,
``parallel/pipeline.py``), with their example twins
(``models/moe_training.py``, ``models/pipeline_parallel.py``); and the
serving runtime (``serving``: buckets, the KV slot pool, the continuous
and static schedulers, the tensor-parallel decoder, the engine with its
pinned decode megastep and drain re-admission), with its twin
(``models/serving.py``); and the collective verifier (``analysis``:
``analyze``, the ambient ``MPI4JAX_TPU_ANALYZE`` mode with
``set_analyze_mode``, the cross-rank deadlock pass, ``Report``,
``Finding``, ``AnalysisError`` and ``python -m
mpi4jax_tpu_torch.analysis``), with the broken twins of
``models/broken/``, its dataflow passes (MPX108, MPX141, MPX142 over
branches written with ``cond``/``switch``) and its cost model
(``analyze(cost=True)``); and the tuning layer (``autotune``,
``TuningFile``, ``load_tuning``, ``active_tuning``, ``python -m
mpi4jax_tpu_torch.autotune``), with the serving replay
(``serving/sim.py``); and the ops under ``torch.func``: ``vmap`` over
every op and its tokenless form, one collective a call on the physical
tensor, and ``jvp``, ``jacfwd``, ``jacrev``, ``vjp``, ``grad`` and
``hessian`` through the differentiable ones (``ops/_base.py``:
``Exchanged``, ``Lanes``), with the hybrid ensemble on a 3-axis mesh
(members on ``world.sub("py", "px")``, the mean over ``dp``) that
``chip_smoke.py`` phase 21 (``--transforms``) drives on the card; and
the kernels under ``torch.func``: a vmapped flash call is one launch of
its folded batch, ``grad``, ``vjp`` and ``jacrev`` reach the backward
kernels, and the stencils run a vmapped stepper's lanes in one launch
(``kernels/flash_attention.py:FlashPartials``,
``kernels/_build.py:StencilCall``; phase 22).
Nothing here imports JAX.
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
from . import analysis, aot, compress, resilience, serving, telemetry  # noqa: F401
from .analysis import (  # noqa: F401
    AnalysisError,
    Finding,
    Report,
    analyze,
    set_analyze_mode,
)
from .aot import PinnedProgram, StaleProgramError, compile  # noqa: F401
# the tuning layer: this rebinds the package attribute ``autotune`` to the
# function, as in the JAX package (``python -m mpi4jax_tpu_torch.autotune``
# and ``from mpi4jax_tpu_torch.autotune import ...`` reach the subpackage)
from .autotune import TuningFile, autotune  # noqa: F401
from .ops._async import (  # noqa: F401
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
from .ops._base import cache_stats, clear_caches, varying  # noqa: F401
from .ops._fusion import set_fusion_mode  # noqa: F401
from .parallel.comm import Comm, GroupComm  # noqa: F401
from .parallel.control import cond, switch  # noqa: F401
from .parallel.mesh import (  # noqa: F401
    ProcessGrid,
    get_default_mesh,
    init_distributed,
    make_world_mesh,
    resolve_device,
    set_default_mesh,
)
from .parallel import moe  # noqa: F401
from .parallel.megastep import register_boundary_hook  # noqa: F401
from .parallel.pipeline import PipelineProgram, pipeline  # noqa: F401
from .parallel.rankspec import shift  # noqa: F401
from .parallel.region import get_default_comm, run, spmd  # noqa: F401
from .resilience import (  # noqa: F401
    RankFailure,
    ShardStore,
    elastic,
    install_preemption_handler,
    request_drain,
    set_check_numerics,
    set_fault_spec,
    set_watchdog_timeout,
)
from .telemetry import set_telemetry_mode  # noqa: F401
from .utils.config import active_tuning, load_tuning  # noqa: F401
from .utils import (  # noqa: F401
    ProfileSummary,
    has_cuda_support,
    has_sycl_support,
    has_tpu_support,
    profile_ops,
)

__all__ = [
    "AnalysisError",
    "AsyncHandle",
    "BAND",
    "BOR",
    "BXOR",
    "Comm",
    "Finding",
    "GroupComm",
    "LAND",
    "LOR",
    "LXOR",
    "MAX",
    "MIN",
    "Op",
    "P2PHandle",
    "PROD",
    "PinnedProgram",
    "PipelineProgram",
    "ProcessGrid",
    "RankFailure",
    "Report",
    "ShardStore",
    "ProfileSummary",
    "SUM",
    "StaleProgramError",
    "Status",
    "Token",
    "allgather",
    "allreduce",
    "allreduce_start",
    "allreduce_wait",
    "alltoall",
    "alltoall_start",
    "alltoall_wait",
    "analyze",
    "aot",
    "barrier",
    "bcast",
    "cache_stats",
    "clear_caches",
    "compile",
    "compress",
    "cond",
    "create_token",
    "elastic",
    "flush",
    "gather",
    "get_default_comm",
    "get_default_mesh",
    "has_cuda_support",
    "has_sycl_support",
    "has_tpu_support",
    "init_distributed",
    "install_preemption_handler",
    "make_world_mesh",
    "moe",
    "overlap",
    "p2p_wait",
    "pipeline",
    "profile_ops",
    "recv",
    "recv_start",
    "reduce",
    "reduce_scatter",
    "reduce_scatter_start",
    "reduce_scatter_wait",
    "request_drain",
    "set_analyze_mode",
    "register_boundary_hook",
    "resilience",
    "resolve_device",
    "run",
    "scan",
    "scatter",
    "send",
    "send_start",
    "sendrecv",
    "serving",
    "set_check_numerics",
    "set_default_mesh",
    "set_fault_spec",
    "set_fusion_mode",
    "set_telemetry_mode",
    "set_watchdog_timeout",
    "shift",
    "spmd",
    "switch",
    "telemetry",
    "varying",
]
