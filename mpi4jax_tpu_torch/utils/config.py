"""The environment flags of the port: the declared registry and its readers.

PyTorch counterpart of ``mpi4jax_tpu/utils/config.py``.  Every
``MPI4JAX_TPU_*`` variable the port reads is declared in ``FLAGS`` (name,
type, default, what the port does with it, and the choices of a choice
flag) and read through ``_getenv``, the single read point: reading an
undeclared name raises ``RuntimeError``.  The names, types, defaults and
choices are the JAX package's, so a user's settings carry over; the port
reads 48 of its 50 (``MPI4JAX_TPU_PREFER_NOTOKEN`` and
``MPI4JAX_TPU_NO_WARN_JAX_VERSION`` switch nothing in a package that runs
eagerly and imports no JAX).  ``tests/test_torch_config.py`` holds the
registry against the JAX package's, and ``tests/test_torch_lint.py``
rejects a literal ``MPI4JAX_TPU_*`` read of an undeclared name anywhere
in the port and checks that the README's port section lists every flag.

An unset or empty variable takes the default; a value outside the
choices, or an integer below its minimum, raises ``ValueError`` with the
JAX package's message.  Each knob a tuning file carries resolves as
default < tuning < an explicitly set variable, as in the JAX package:
``fusion_bucket_bytes``, ``overlap_chunks`` and ``compress`` (both by
payload bucket when the file buckets them), the two pipeline knobs and
the three crossovers; ``auto`` compression resolves to the file's codec
for the payload, else ``bf16``.  ``MPI4JAX_TPU_DEBUG`` and
``MPI4JAX_TPU_TRACE`` are read once, at import of ``utils/debug.py``, as
in the JAX package.

A pinned program (``aot/pinning.py``) captures the configuration once:
``config_stamp()`` is the override epoch, which every programmatic
override bumps (``bump_config_epoch``; ``set_fusion_mode`` does), and the
raw values of ``FLAG_NAMES``.  The dispatch point reads
``service_stamp()``, the raw values of ``SERVICE_FLAG_NAMES``.  Both
tuples are declared flags; these stamps read their raw values in bulk,
unparsed, and every other read goes through ``_getenv``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple


class Flag(NamedTuple):
    """One declared environment flag."""

    name: str
    type: str            # "bool" | "float" | "int" | "str" | "choice"
    default: object
    doc: str
    choices: Optional[Tuple[str, ...]] = None


COLLECTIVE_ALGOS = ("auto", "butterfly", "ring", "hier")
COMPRESS_MODES = ("off", "bf16", "fp8", "auto")
FUSION_MODES = ("off", "auto", "force")
TELEMETRY_MODES = ("off", "counters", "events")
HEALTH_MODES = ("off", "on")
ANALYZE_MODES = ("off", "warn", "error")
ELASTIC_FAIL_UNITS = ("rank", "row", "col")
ELASTIC_PLACEMENTS = ("stripe", "neighbor")
ELASTIC_AGREEMENTS = ("coordinator", "gossip")
DEFAULT_ELASTIC_REDUNDANCY = 1
DEFAULT_ELASTIC_PORT_SPAN = 64
TRUTHY = ("true", "1", "on", "yes")
FALSY = ("false", "0", "off", "no", "")
DEFAULT_BOOTSTRAP_DEADLINE = 300.0
DEFAULT_BOOTSTRAP_MAX_ATTEMPTS = 0  # 0 = bounded by the deadline only
DEFAULT_DRAIN_GRACE_S = 5.0
DEFAULT_FUSION_BUCKET_BYTES = 4 << 20
DEFAULT_OVERLAP_CHUNKS = 2
DEFAULT_FLIGHT_RING = 1024
DEFAULT_MOE_CAPACITY_CHUNKS = 2
DEFAULT_PIPELINE_MICROBATCHES = 0     # 0 = unset
DEFAULT_PIPELINE_VIRTUAL_STAGES = 0   # 0 = unset
DEFAULT_COMPILE_CACHE_MAX_BYTES = 1 << 30
DEFAULT_SERVING_MAX_BATCH = 8
DEFAULT_SERVING_UNROLL = 4
DEFAULT_SERVING_SLO_P99_MS = 1000.0
DEFAULT_RING_CROSSOVER_BYTES = 1 << 20
DEFAULT_DCN_CROSSOVER_BYTES = 4 << 20
DEFAULT_ALLTOALL_CROSSOVER_BYTES = 1 << 20
DEFAULT_COMPRESS_ERROR_BUDGET = 1e-2

FLAGS = {
    f.name: f
    for f in (
        Flag("MPI4JAX_TPU_DEBUG", "bool", False,
             "Log every op call as ``r{rank} | {id} | ...`` "
             "(``utils/debug.py``; read at import, ``set_logging`` "
             "overrides it).  A pin on one CUDA rank then runs its body "
             "eagerly, so the log sees every call."),
        Flag("MPI4JAX_TPU_TRACE", "bool", False,
             "Runtime op tracing: the host library "
             "(``csrc/host_hooks.cc``, ``native.py``) logs a begin and an "
             "end line with the wall-clock latency of every collective "
             "(read at import, ``set_runtime_tracing`` overrides it)."),
        Flag("MPI4JAX_TPU_WATCHDOG_TIMEOUT", "float", None,
             "Seconds a collective may stay in flight before the host "
             "watchdog (``resilience/watchdog.py``) kills the process "
             "with every rank's in-flight ops.  Unset, empty or 0: off."),
        Flag("MPI4JAX_TPU_FAULT_SPEC", "str", "",
             "Deterministic fault injection "
             "(``resilience/faultinject.py``): semicolon-separated "
             "clauses such as ``die:rank=3:op=allreduce:after=5``, whose "
             "ranks are the launch ranks of the gloo or NCCL world.  "
             "Empty: none."),
        Flag("MPI4JAX_TPU_BOOTSTRAP_DEADLINE", "float",
             DEFAULT_BOOTSTRAP_DEADLINE,
             "Seconds ``init_distributed``'s rendezvous, and every "
             "elastic re-bootstrap of a process group, may retry before "
             "it fails (``resilience/retry.py``).  Default 300."),
        Flag("MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS", "int",
             DEFAULT_BOOTSTRAP_MAX_ATTEMPTS,
             "Attempt cap of that retry; 0 (default) leaves the deadline "
             "alone to bound it."),
        Flag("MPI4JAX_TPU_ELASTIC_REDUNDANCY", "int",
             DEFAULT_ELASTIC_REDUNDANCY,
             "Copies of each state shard that the elastic in-memory "
             "checkpoint (``resilience/elastic.py:ShardStore``) keeps "
             "beyond its owner's, in host memory: that many ranks may "
             "die at once.  Default 1."),
        Flag("MPI4JAX_TPU_ELASTIC_GROW", "bool", False,
             "Admit replacement processes at commit boundaries: rank 0 "
             "runs a join listener, ``elastic.join_and_run`` is the "
             "joiner's side, and the world's process group is made anew "
             "with it.  Off (default): no poll at any boundary."),
        Flag("MPI4JAX_TPU_DRAIN_GRACE_S", "float", DEFAULT_DRAIN_GRACE_S,
             "Seconds a drained process (a SIGTERM, or the ``preempt`` "
             "fault verb) waits for its peers to acknowledge its notice "
             "before it steps to the leave boundary.  Default 5."),
        Flag("MPI4JAX_TPU_ELASTIC_FAIL_UNIT", "choice", "rank",
             "Granularity of an elastic shrink "
             "(``parallel/mesh.py:shrink_world_mesh``): ``rank`` removes "
             "the failed ranks of a 1-D world; ``row`` and ``col`` remove "
             "every grid row or column that holds one.",
             choices=ELASTIC_FAIL_UNITS),
        Flag("MPI4JAX_TPU_ELASTIC_PLACEMENT", "choice", "stripe",
             "Where the shard store puts each replica: ``stripe`` on "
             "another host than the owner where the topology says so, "
             "``neighbor`` on the next ranks of the ring.  Must match "
             "across processes.",
             choices=ELASTIC_PLACEMENTS),
        Flag("MPI4JAX_TPU_ELASTIC_AGREEMENT", "choice", "coordinator",
             "Transport of the failure agreement: ``coordinator`` "
             "through rank 0 over TCP, falling back to peer gossip when "
             "rank 0 is a suspect; ``gossip`` all pairs.  Must match "
             "across processes.",
             choices=ELASTIC_AGREEMENTS),
        Flag("MPI4JAX_TPU_ELASTIC_PORT_SPAN", "int",
             DEFAULT_ELASTIC_PORT_SPAN,
             "Width of the per-epoch port window: epoch e's listeners "
             "take ``port_base + (e % span)``.  Default 64."),
        Flag("MPI4JAX_TPU_CHECK_NUMERICS", "bool", False,
             "Guard every op's floating inputs and outputs against NaN "
             "and Inf on the device, aborting through ``abort_if`` with "
             "the op's name (``resilience/numerics.py``)."),
        Flag("MPI4JAX_TPU_COLLECTIVE_ALGO", "choice", "auto",
             "Algorithm of the reduction family (``ops/_algos.py``): "
             "``auto`` picks per call from the payload bytes, the group "
             "size and the hosts; ``butterfly``, ``ring`` and ``hier`` "
             "(the two-level lowering of ``ops/_hierarchy.py``) force "
             "one where it is expressible.",
             choices=COLLECTIVE_ALGOS),
        Flag("MPI4JAX_TPU_RING_CROSSOVER_BYTES", "int",
             DEFAULT_RING_CROSSOVER_BYTES,
             "Payload bytes at and above which ``auto`` takes the ring "
             "lowerings, or the hierarchy on a comm of several hosts.  "
             "Default 1 MiB; a tuning file may set it."),
        Flag("MPI4JAX_TPU_TOPOLOGY", "str", "",
             "Ranks per host: ``<hosts>x<ranks_per_host>`` (``2x4``) or "
             "per-host counts (``3,5``).  Empty (default): each rank's "
             "host name, published in the rendezvous store at "
             "``init_distributed``."),
        Flag("MPI4JAX_TPU_DCN_CROSSOVER_BYTES", "int",
             DEFAULT_DCN_CROSSOVER_BYTES,
             "Shard bytes at and above which the hierarchy's inter-host "
             "phase takes the ring (``ops/_algos.py:resolve_dcn_algo``).  "
             "Default 4 MiB; a tuning file may set it."),
        Flag("MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", "int",
             DEFAULT_ALLTOALL_CROSSOVER_BYTES,
             "Payload bytes at and above which ``auto`` takes the "
             "two-level alltoall on a comm of several hosts (the same "
             "bits as the flat one).  Default 1 MiB."),
        Flag("MPI4JAX_TPU_COMPRESS", "choice", "off",
             "Codec of the inter-host leg and of "
             "``compress.ef_allreduce``'s roundtrip (``ops/_compress.py``): "
             "``bf16``, ``fp8`` with a per-chunk scale, or ``auto``, the "
             "tuning file's codec for the payload (``bf16`` without "
             "one).  A codec changes values, not the bytes gloo moves.",
             choices=COMPRESS_MODES),
        Flag("MPI4JAX_TPU_COMPRESS_ERROR_BUDGET", "float",
             DEFAULT_COMPRESS_ERROR_BUDGET,
             "Largest round-trip relative error the autotuner's codec "
             "sweep accepts (``python -m mpi4jax_tpu_torch.autotune``).  "
             "Default 1e-2."),
        Flag("MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", "int",
             DEFAULT_MOE_CAPACITY_CHUNKS,
             "Capacity chunks of the MoE layer (``parallel/moe.py``): "
             "chunk i's combine ``alltoall_start`` overlaps chunk i+1's "
             "expert MLP; 1 is the synchronous layer.  Default 2."),
        Flag("MPI4JAX_TPU_PIPELINE_MICROBATCHES", "int",
             DEFAULT_PIPELINE_MICROBATCHES,
             "Microbatches ``split_microbatches`` cuts a batch into "
             "without an explicit count (``parallel/pipeline.py``).  0 "
             "(default): the tuning file's count, else no split."),
        Flag("MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES", "int",
             DEFAULT_PIPELINE_VIRTUAL_STAGES,
             "Stage-chunks a rank of the interleaved schedule owns "
             "without an explicit ``virtual``.  0 (default): the tuning "
             "file's, else derived from the stage functions."),
        Flag("MPI4JAX_TPU_ANALYZE", "choice", "off",
             "Ambient collective verifier (``analysis/``): a region or an "
             "eager op is run abstractly on ``meta`` tensors at its first "
             "call for each key, before it runs; ``warn`` warns on "
             "findings, ``error`` raises ``AnalysisError``.  "
             "``set_analyze_mode`` overrides it.",
             choices=ANALYZE_MODES),
        Flag("MPI4JAX_TPU_TUNING", "str", "",
             "An ``mpx-tuning/1`` file, as ``python -m "
             "mpi4jax_tpu_torch.autotune`` writes it, served between the "
             "defaults and the environment; its stamp stales every pin "
             "made before it (MPX129).  ``load_tuning`` wins over it."),
        Flag("MPI4JAX_TPU_COST_MODEL", "str", "",
             "Cost-model file (``mpx-cost-model/1`` or ``mpx-tuning/1``) "
             "for ``analyze(cost=True)`` (``analysis/costmodel.py``).  "
             "Empty: the tuning file's links section, else the card's "
             "defaults."),
        Flag("MPI4JAX_TPU_ANALYZE_COST", "choice", "off",
             "``on``: the ambient verifier's cross-rank pass also runs "
             "the critical-path cost pass (``analysis/cost.py``) and "
             "reports MPX131-MPX135.",
             choices=("off", "on")),
        Flag("MPI4JAX_TPU_ANALYZE_RANKS", "str", "auto",
             "The ambient verifier's cross-rank pass: ``auto`` (default) "
             "for every comm, ``off``, or a positive cap on the comm "
             "sizes it covers (it re-runs a region once a rank).  The "
             "analysis command's ``--ranks N`` sets it."),
        Flag("MPI4JAX_TPU_TELEMETRY", "choice", "off",
             "Telemetry tier (``telemetry/``): ``counters`` counts calls "
             "and bytes per op, comm, algorithm and dtype, and a pin "
             "keeps its CUDA graph; ``events`` also journals a begin and "
             "end record a call, and a pin on one CUDA rank runs "
             "eagerly.  ``set_telemetry_mode`` overrides it.",
             choices=TELEMETRY_MODES),
        Flag("MPI4JAX_TPU_TELEMETRY_DIR", "str", "",
             "Directory of the ``events`` tier's per-process JSONL "
             "journals and the health plane's bundles, merged by "
             "``python -m mpi4jax_tpu_torch.telemetry merge``.  Empty: "
             "in memory only."),
        Flag("MPI4JAX_TPU_FUSION", "choice", "off",
             "Collective fusion in a region (``ops/_fusion.py``): "
             "``auto`` queues ``allreduce`` and ``bcast`` calls and "
             "flushes them packed by bucket; ``force`` also ignores the "
             "byte cap and packs single members.  ``set_fusion_mode`` "
             "overrides it.",
             choices=FUSION_MODES),
        Flag("MPI4JAX_TPU_FUSION_BUCKET_BYTES", "int",
             DEFAULT_FUSION_BUCKET_BYTES,
             "Byte cap of a fusion bucket, per dtype.  Default 4 MiB; a "
             "tuning file may set it."),
        Flag("MPI4JAX_TPU_COMPILE_CACHE_DIR", "str", "",
             "The persistent tier (``aot/diskcache.py``): built kernel "
             "libraries and pin records, so a fresh process loads its "
             "kernels instead of running ``nvcc`` (a CUDA graph is "
             "captured anew).  Empty (default): off."),
        Flag("MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES", "int",
             DEFAULT_COMPILE_CACHE_MAX_BYTES,
             "Byte cap of the persistent tier, least recently used "
             "evicted first.  Default 1 GiB; 0: no cap."),
        Flag("MPI4JAX_TPU_OVERLAP_CHUNKS", "int",
             DEFAULT_OVERLAP_CHUNKS,
             "Pieces an async collective (``ops/_async.py``, "
             "``async_op=True``) is split into, each staged through a "
             "pinned host buffer.  Default 2; a tuning file may set it "
             "by payload."),
        Flag("MPI4JAX_TPU_UNROLL_DEFAULT", "int", 1,
             "Megastep trip count of an ``spmd`` or ``compile`` call "
             "without ``unroll=`` (``parallel/megastep.py``): on one CUDA "
             "rank one graph of N iterations.  1 (default): no loop."),
        Flag("MPI4JAX_TPU_SERVING_MAX_BATCH", "int",
             DEFAULT_SERVING_MAX_BATCH,
             "Decode batch cap of the serving engine (``serving/``): the "
             "largest bucket of its batch-shape table.  Default 8."),
        Flag("MPI4JAX_TPU_SERVING_BUCKETS", "str", "",
             "Explicit bucket table, ascending batch sizes such as "
             "``1,2,4,8``; each bucket and phase is one pinned program.  "
             "Empty (default): powers of two up to the cap."),
        Flag("MPI4JAX_TPU_SERVING_KV_SLOTS", "int", 0,
             "KV slots of the serving engine: sequences that may hold a "
             "KV cache at once.  0 (default): twice the batch cap."),
        Flag("MPI4JAX_TPU_SERVING_UNROLL", "int", DEFAULT_SERVING_UNROLL,
             "Tokens a decode megastep runs (one CUDA graph on one CUDA "
             "rank); the scheduler admits and evicts between "
             "megasteps.  Default 4."),
        Flag("MPI4JAX_TPU_SERVING_SLO_P99_MS", "float",
             DEFAULT_SERVING_SLO_P99_MS,
             "The p99 latency bound, in milliseconds, that the serving "
             "twin reports tokens/s/chip at.  Default 1000."),
        Flag("MPI4JAX_TPU_CPP_DISPATCH", "bool", True,
             "A pin on one CUDA rank replays its CUDA graph "
             "(``aot/fastpath.py``); false runs its body eagerly and "
             "names this flag in ``program.info``.  Never stales a pin."),
        Flag("MPI4JAX_TPU_HEALTH", "choice", "off",
             "The health plane (``telemetry/health.py``): ``on`` arms "
             "the flight ring, the straggler detector at "
             "``on_boundary`` and postmortem bundles; it records only "
             "where telemetry commits.",
             choices=HEALTH_MODES),
        Flag("MPI4JAX_TPU_HEALTH_INTERVAL", "int", 1,
             "Every N-th boundary runs the detector's digest exchange "
             "(a MAX ``allreduce`` and an ``allgather``).  Default 1."),
        Flag("MPI4JAX_TPU_FLIGHT_RING", "int", DEFAULT_FLIGHT_RING,
             "Records the flight ring keeps; older ones are overwritten "
             "and counted as dropped.  Default 1024."),
        Flag("MPI4JAX_TPU_HEALTH_SUSPECTS", "bool", False,
             "Hand persistent stragglers and stalled collectives to the "
             "elastic agreement as suspects.  Off (default): the "
             "detector only journals and meters them."),
        Flag("MPI4JAX_TPU_HEALTH_PROM", "bool", False,
             "Write ``prometheus_text()`` to ``prom-p<process>.prom`` in "
             "the telemetry directory at every detector boundary."),
    )
}

# every variable that shapes what the port runs, and the persistent tier's
# storage-only and dispatch-only knobs (``compile_cache_dir``,
# ``compile_cache_max_bytes``, ``cpp_dispatch``; aot/invalidation.py
# exempts those three from a pin's stamp, as the JAX package does)
FLAG_NAMES = (
    "MPI4JAX_TPU_COMPRESS",
    "MPI4JAX_TPU_FUSION",
    "MPI4JAX_TPU_FUSION_BUCKET_BYTES",
    "MPI4JAX_TPU_OVERLAP_CHUNKS",
    "MPI4JAX_TPU_UNROLL_DEFAULT",
    "MPI4JAX_TPU_COMPILE_CACHE_DIR",
    "MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES",
    "MPI4JAX_TPU_CPP_DISPATCH",
    "MPI4JAX_TPU_TELEMETRY",
    "MPI4JAX_TPU_TELEMETRY_DIR",
    "MPI4JAX_TPU_WATCHDOG_TIMEOUT",
    "MPI4JAX_TPU_FAULT_SPEC",
    "MPI4JAX_TPU_CHECK_NUMERICS",
    "MPI4JAX_TPU_TOPOLOGY",
    "MPI4JAX_TPU_BOOTSTRAP_DEADLINE",
    "MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS",
    "MPI4JAX_TPU_DRAIN_GRACE_S",
    "MPI4JAX_TPU_ELASTIC_REDUNDANCY",
    "MPI4JAX_TPU_ELASTIC_GROW",
    "MPI4JAX_TPU_ELASTIC_FAIL_UNIT",
    "MPI4JAX_TPU_ELASTIC_PLACEMENT",
    "MPI4JAX_TPU_ELASTIC_AGREEMENT",
    "MPI4JAX_TPU_ELASTIC_PORT_SPAN",
    "MPI4JAX_TPU_HEALTH",
    "MPI4JAX_TPU_HEALTH_INTERVAL",
    "MPI4JAX_TPU_FLIGHT_RING",
    "MPI4JAX_TPU_HEALTH_SUSPECTS",
    "MPI4JAX_TPU_HEALTH_PROM",
    "MPI4JAX_TPU_MOE_CAPACITY_CHUNKS",
    "MPI4JAX_TPU_PIPELINE_MICROBATCHES",
    "MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES",
    "MPI4JAX_TPU_SERVING_MAX_BATCH",
    "MPI4JAX_TPU_SERVING_BUCKETS",
    "MPI4JAX_TPU_SERVING_KV_SLOTS",
    "MPI4JAX_TPU_SERVING_UNROLL",
    "MPI4JAX_TPU_SERVING_SLO_P99_MS",
    "MPI4JAX_TPU_ANALYZE",
    "MPI4JAX_TPU_ANALYZE_RANKS",
    "MPI4JAX_TPU_TUNING",
    "MPI4JAX_TPU_COST_MODEL",
    "MPI4JAX_TPU_ANALYZE_COST",
    "MPI4JAX_TPU_RING_CROSSOVER_BYTES",
    "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
    "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES",
    "MPI4JAX_TPU_COLLECTIVE_ALGO",
    "MPI4JAX_TPU_COMPRESS_ERROR_BUDGET",
)

_config_epoch = 0
# bumped when a host-side observer that shapes no program turns on or off
# (``profile_ops``): the dispatch point re-reads its services, a pin stays
# valid
_service_epoch = 0


def config_epoch() -> int:
    """The count of programmatic overrides applied so far."""
    return _config_epoch


def bump_config_epoch() -> None:
    """Called by every programmatic override: a pin captured before it
    goes stale.  A change of the environment needs no bump (the stamp
    reads the variables themselves)."""
    global _config_epoch
    _config_epoch += 1


def bump_service_epoch() -> None:
    """Called when a service that no pin captures turns on or off
    (``utils/profiling.py``): ``service_stamp()`` moves, ``config_stamp()``
    does not."""
    global _service_epoch
    _service_epoch += 1


# the variables the runtime services read at an op call (which services
# are on, ``ops/_base.py:hooks``, and an op's resilience plan,
# ``resilience/runtime.py:plan_for``) and the verifier's mode;
# ``MPI4JAX_TPU_DEBUG`` and ``MPI4JAX_TPU_TRACE`` are read at import and
# their setters bump the epoch
SERVICE_FLAG_NAMES = (
    "MPI4JAX_TPU_TELEMETRY",
    "MPI4JAX_TPU_WATCHDOG_TIMEOUT",
    "MPI4JAX_TPU_FAULT_SPEC",
    "MPI4JAX_TPU_CHECK_NUMERICS",
    "MPI4JAX_TPU_ANALYZE",
)

# the stamps below read these names without ``_getenv``: each must be
# declared
_undeclared = sorted(set(FLAG_NAMES + SERVICE_FLAG_NAMES) - set(FLAGS))
if _undeclared:
    raise RuntimeError(f"stamped flags not declared in FLAGS: {_undeclared}")


def service_stamp() -> tuple:
    """``(config_epoch(), the service epoch, raw values of
    SERVICE_FLAG_NAMES)``: equal stamps, the same runtime services."""
    return (_config_epoch, _service_epoch,
            tuple(map(os.environ.get, SERVICE_FLAG_NAMES)))


def env_fingerprint() -> tuple:
    """The raw value of every variable of ``FLAG_NAMES``, unparsed."""
    return tuple(map(os.environ.get, FLAG_NAMES))


def config_stamp() -> tuple:
    """``(config_epoch(), env_fingerprint())``: equal stamps, equal
    configuration."""
    return (_config_epoch, env_fingerprint())


def _getenv(name: str) -> Optional[str]:
    """The single environment read point: the flag must be declared."""
    if name not in FLAGS:
        raise RuntimeError(
            f"environment flag {name} is not declared in "
            "mpi4jax_tpu_torch.utils.config.FLAGS; declare it (name, type, "
            "default, docstring) before reading it"
        )
    return os.environ.get(name)


def _text(name: str) -> str:
    """A string flag, stripped ('' when unset)."""
    return (_getenv(name) or "").strip()


def _choice(name: str) -> str:
    """A declared choice flag (unset or empty: its default)."""
    flag = FLAGS[name]
    raw = _getenv(name)
    if raw is None or not raw.strip():
        return flag.default
    val = raw.lower().strip()
    if val not in flag.choices:
        raise ValueError(f"Environment variable {name}={raw!r} must be one of "
                         f"{flag.choices}")
    return val


def _int(name: str, default: int, minimum: int = 0) -> int:
    raw = _getenv(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = int(raw)
    except ValueError as e:
        raise ValueError(f"Environment variable {name}={raw!r} could not be "
                         "parsed as an integer") from e
    if val < minimum:
        raise ValueError(f"Environment variable {name}={raw!r} must be >= "
                         f"{minimum}")
    return val


def _explicit(name: str) -> bool:
    return bool(_text(name))


def _env_or_tuned(name: str, knob: str, default: int, minimum: int = 0,
                  payload_bytes: Optional[int] = None) -> int:
    """One tuned int knob, default < tuning < env: an explicitly set
    variable wins without consulting the tuning layer (a malformed file
    never masks it), else the layer's value, else the default."""
    if _explicit(name):
        return _int(name, default, minimum)
    tuned = _tuned_knob(knob, payload_bytes=payload_bytes)
    return tuned if tuned is not None else default


def compress_mode(payload_bytes: Optional[int] = None) -> str:
    """The codec (``MPI4JAX_TPU_COMPRESS``): ``off``, ``bf16`` or ``fp8``,
    default < tuning (by ``payload_bytes`` bucket) < env; ``auto`` takes
    the tuned codec for the payload, else ``bf16``."""
    mode = _choice("MPI4JAX_TPU_COMPRESS")
    if not _explicit("MPI4JAX_TPU_COMPRESS") or mode == "auto":
        tuned = _tuned_knob("compress", payload_bytes=payload_bytes)
        if tuned is not None and str(tuned).lower() != "auto":
            return str(tuned).lower()
    return "bf16" if mode == "auto" else mode


def fusion_mode() -> str:
    """The fusion mode (``MPI4JAX_TPU_FUSION``): ``off``, ``auto`` or
    ``force``."""
    return _choice("MPI4JAX_TPU_FUSION")


def fusion_bucket_bytes() -> int:
    """The byte cap of a fusion bucket (``MPI4JAX_TPU_FUSION_BUCKET_BYTES``;
    default < tuning < env)."""
    return _env_or_tuned("MPI4JAX_TPU_FUSION_BUCKET_BYTES",
                         "fusion_bucket_bytes", DEFAULT_FUSION_BUCKET_BYTES)


def overlap_chunks(payload_bytes: Optional[int] = None) -> int:
    """The chunks of an async collective (``MPI4JAX_TPU_OVERLAP_CHUNKS``;
    default < tuning, by ``payload_bytes`` bucket, < env)."""
    return _env_or_tuned("MPI4JAX_TPU_OVERLAP_CHUNKS", "overlap_chunks",
                         DEFAULT_OVERLAP_CHUNKS, minimum=1,
                         payload_bytes=payload_bytes)


def collective_algo() -> str:
    """The reduction family's algorithm (``MPI4JAX_TPU_COLLECTIVE_ALGO``):
    ``auto`` picks per call (``ops/_algos.py:resolve_algo``);
    ``butterfly``, ``ring`` and ``hier`` force one lowering where it is
    expressible."""
    return _choice("MPI4JAX_TPU_COLLECTIVE_ALGO")


def ring_crossover_bytes() -> int:
    """The ring crossover (``MPI4JAX_TPU_RING_CROSSOVER_BYTES``; 1 MiB;
    default < tuning < env): ``auto`` takes the ring, or the hierarchy on
    a comm of several hosts, at and above it."""
    return _env_or_tuned("MPI4JAX_TPU_RING_CROSSOVER_BYTES",
                         "ring_crossover_bytes", DEFAULT_RING_CROSSOVER_BYTES)


def dcn_crossover_bytes() -> int:
    """The DCN-phase ring crossover (``MPI4JAX_TPU_DCN_CROSSOVER_BYTES``;
    4 MiB; default < tuning < env): the hierarchy's inter-host phase
    takes the ring at and above it (``ops/_algos.py:resolve_dcn_algo``)."""
    return _env_or_tuned("MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
                         "dcn_crossover_bytes", DEFAULT_DCN_CROSSOVER_BYTES)


def alltoall_crossover_bytes() -> int:
    """The alltoall hierarchy crossover
    (``MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES``; 1 MiB; default < tuning <
    env): ``auto`` takes the hierarchical alltoall at and above it on a
    comm of several hosts."""
    return _env_or_tuned("MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES",
                         "alltoall_crossover_bytes",
                         DEFAULT_ALLTOALL_CROSSOVER_BYTES)


def compress_error_budget() -> float:
    """The largest round-trip relative error the autotuner's codec sweep
    accepts (``MPI4JAX_TPU_COMPRESS_ERROR_BUDGET``; default 1e-2)."""
    val = parse_env_float("MPI4JAX_TPU_COMPRESS_ERROR_BUDGET",
                          DEFAULT_COMPRESS_ERROR_BUDGET)
    if val is None or val <= 0:
        raise ValueError(
            "MPI4JAX_TPU_COMPRESS_ERROR_BUDGET must be a positive "
            f"relative error bound, got {val!r}")
    return val


# ---------------------------------------------------------------------------
# the tuning layer (default < tuning file < explicitly set variable)
# ---------------------------------------------------------------------------

_tuning_override = None  # the autotune.schema.TuningFile of load_tuning()


def load_tuning(spec=None):
    """Install a tuning layer: ``spec`` is a file path, a parsed
    ``mpx-tuning/1`` dict or a ``TuningFile``; ``None`` clears it (an
    ``MPI4JAX_TPU_TUNING`` file, if set, becomes active again).  Returns
    the installed ``TuningFile`` (or ``None``).  Bumps the configuration
    epoch, so a pin made before it is stale (MPX129), as
    ``set_analyze_mode`` does."""
    global _tuning_override
    if spec is None:
        _tuning_override = None
        bump_config_epoch()
        return None
    from ..autotune.schema import as_tuning

    tf = as_tuning(spec, fresh=True)
    _tuning_override = tf
    bump_config_epoch()
    from ..telemetry.core import meter

    meter("autotune.loads")
    return tf


def active_tuning():
    """The active ``TuningFile``, or ``None``.  Raises ``ValueError`` on a
    malformed ``MPI4JAX_TPU_TUNING`` file."""
    if _tuning_override is not None:
        return _tuning_override
    path = _text("MPI4JAX_TPU_TUNING")
    if not path:
        return None
    from ..autotune.schema import load_tuning_file_memo

    return load_tuning_file_memo(path)


def tuning_stamp() -> Optional[str]:
    """The active layer's content stamp (``tuned@<stamp>``), or ``None``."""
    tf = active_tuning()
    return tf.stamp if tf is not None else None


def _tuned_knob(name: str, payload_bytes: Optional[int] = None):
    """The active layer's value for one knob (``None``: untuned), for the
    current topology override and payload bucket."""
    tf = active_tuning()
    if tf is None:
        return None
    return tf.knob(name, topology=topology_spec() or None,
                   payload_bytes=payload_bytes)


def tuning_snapshot() -> Optional[dict]:
    """The active layer for telemetry: stamp, path and per knob its tuned,
    default and effective value with an ``env_wins`` marker; ``None``
    without a layer."""
    try:
        tf = active_tuning()
    except ValueError:
        return None
    if tf is None:
        return None
    from ..autotune.schema import KNOB_FLAGS

    defaults = {
        "ring_crossover_bytes": DEFAULT_RING_CROSSOVER_BYTES,
        "dcn_crossover_bytes": DEFAULT_DCN_CROSSOVER_BYTES,
        "alltoall_crossover_bytes": DEFAULT_ALLTOALL_CROSSOVER_BYTES,
        "fusion_bucket_bytes": DEFAULT_FUSION_BUCKET_BYTES,
        "overlap_chunks": DEFAULT_OVERLAP_CHUNKS,
        "compress": "off",
        "pipeline_microbatches": DEFAULT_PIPELINE_MICROBATCHES,
        "pipeline_virtual_stages": DEFAULT_PIPELINE_VIRTUAL_STAGES,
    }
    getters = {
        "ring_crossover_bytes": ring_crossover_bytes,
        "dcn_crossover_bytes": dcn_crossover_bytes,
        "alltoall_crossover_bytes": alltoall_crossover_bytes,
        "fusion_bucket_bytes": fusion_bucket_bytes,
        "overlap_chunks": overlap_chunks,
        "compress": compress_mode,
        "pipeline_microbatches": pipeline_microbatches,
        "pipeline_virtual_stages": pipeline_virtual_stages,
    }
    knobs = {}
    for name, flag in KNOB_FLAGS.items():
        knobs[name] = {
            "tuned": tf.knob(name, topology=topology_spec() or None),
            "default": defaults[name],
            "effective": getters[name](),
            "env_wins": _explicit(flag),
        }
    return {"stamp": tf.stamp, "path": tf.path, "knobs": knobs,
            "commit": dict(tf.payload.get("tuned", {}).get("commit", {}))}


def unroll_default() -> int:
    """The megastep trip count of a call without ``unroll=``
    (``MPI4JAX_TPU_UNROLL_DEFAULT``; 1, no loop, by default)."""
    return _int("MPI4JAX_TPU_UNROLL_DEFAULT", 1, minimum=1)


def compile_cache_dir() -> str:
    """The persistent tier's directory (``MPI4JAX_TPU_COMPILE_CACHE_DIR``;
    '' = the tier is off): built kernel libraries and pin records
    (``aot/diskcache.py``)."""
    return _text("MPI4JAX_TPU_COMPILE_CACHE_DIR")


def compile_cache_max_bytes() -> int:
    """The persistent tier's byte cap
    (``MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES``; 1 GiB by default, 0 =
    unbounded)."""
    return _int("MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES",
                DEFAULT_COMPILE_CACHE_MAX_BYTES)


def cpp_dispatch() -> bool:
    """Whether a pin on one CUDA rank replays its CUDA graph
    (``MPI4JAX_TPU_CPP_DISPATCH``; default on).  The JAX package's switch
    of its C++ fast-path call; the port's counterpart of that call is the
    graph replay (``aot/fastpath.py``), so off runs the pin eagerly."""
    return parse_env_bool("MPI4JAX_TPU_CPP_DISPATCH", True)


# ---------------------------------------------------------------------------
# the runtime services' knobs
# ---------------------------------------------------------------------------


def parse_env_bool(name: str, default: bool = False) -> bool:
    """A truthy/falsy variable; anything else raises ``ValueError``."""
    raw = _getenv(name)
    if raw is None:
        return default
    val = raw.lower().strip()
    if val in TRUTHY:
        return True
    if val in FALSY:
        return False
    raise ValueError(
        f"Environment variable {name}={raw!r} could not be parsed as a boolean "
        f"(truthy values: {TRUTHY}, falsy values: {FALSY})"
    )


def parse_env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """A finite number of seconds >= 0 (unset or empty: ``default``)."""
    raw = _getenv(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = float(raw)
    except ValueError as e:
        raise ValueError(
            f"Environment variable {name}={raw!r} could not be parsed as a "
            "number of seconds"
        ) from e
    # NaN would defeat every comparison downstream (a NaN watchdog timeout
    # never expires while still instrumenting each op)
    if not math.isfinite(val) or val < 0:
        raise ValueError(
            f"Environment variable {name}={raw!r} must be a finite "
            "number >= 0"
        )
    return val


def debug_enabled() -> bool:
    return parse_env_bool("MPI4JAX_TPU_DEBUG", False)


def trace_enabled() -> bool:
    return parse_env_bool("MPI4JAX_TPU_TRACE", False)


def telemetry_mode() -> str:
    """The telemetry tier (``MPI4JAX_TPU_TELEMETRY``): ``off``,
    ``counters`` or ``events``."""
    return _choice("MPI4JAX_TPU_TELEMETRY")


def telemetry_dir() -> str:
    """Where the events tier writes its JSONL journal
    (``MPI4JAX_TPU_TELEMETRY_DIR``; '' = in memory only)."""
    return _text("MPI4JAX_TPU_TELEMETRY_DIR")


def watchdog_timeout() -> Optional[float]:
    """The collective watchdog's timeout in seconds; ``None`` (unset, empty
    or 0) is off."""
    val = parse_env_float("MPI4JAX_TPU_WATCHDOG_TIMEOUT", None)
    if val is None or val == 0:
        return None
    return val


def fault_spec() -> str:
    """The raw ``MPI4JAX_TPU_FAULT_SPEC`` ('' = no injection), parsed by
    ``resilience.parse_fault_spec``."""
    return _text("MPI4JAX_TPU_FAULT_SPEC")


def check_numerics() -> bool:
    """Whether ops guard their floating inputs and outputs against NaN/Inf
    (``MPI4JAX_TPU_CHECK_NUMERICS``)."""
    return parse_env_bool("MPI4JAX_TPU_CHECK_NUMERICS", False)


def topology_spec() -> str:
    """The raw ``MPI4JAX_TPU_TOPOLOGY`` string ('' = none declared)."""
    return _text("MPI4JAX_TPU_TOPOLOGY")


def parse_topology_spec(raw: str) -> Optional[Tuple[int, ...]]:
    """Per-host rank counts of a topology spec: ``<hosts>x<ranks>`` (``2x4``
    -> ``(4, 4)``) or comma-separated counts (``3,5`` -> ``(3, 5)``); '' ->
    ``None``; a malformed spec raises ``ValueError``."""
    if raw is None:
        return None
    raw = raw.strip().lower()
    if not raw:
        return None
    try:
        if "x" in raw:
            hosts_s, _, per_s = raw.partition("x")
            hosts, per = int(hosts_s), int(per_s)
            if hosts < 1 or per < 1:
                raise ValueError
            return (per,) * hosts
        counts = tuple(int(c) for c in raw.split(","))
        if not counts or any(c < 1 for c in counts):
            raise ValueError
        return counts
    except ValueError:
        raise ValueError(
            f"Environment variable MPI4JAX_TPU_TOPOLOGY={raw!r} could not "
            "be parsed: expected '<hosts>x<ranks_per_host>' (e.g. '2x4') "
            "or comma-separated per-host rank counts (e.g. '3,5'), all "
            "positive integers"
        ) from None


def bootstrap_deadline() -> float:
    """Total seconds ``init_distributed``'s rendezvous may retry
    (``MPI4JAX_TPU_BOOTSTRAP_DEADLINE``; 300 by default)."""
    val = parse_env_float("MPI4JAX_TPU_BOOTSTRAP_DEADLINE",
                          DEFAULT_BOOTSTRAP_DEADLINE)
    if val is None or val <= 0:
        raise ValueError(
            "MPI4JAX_TPU_BOOTSTRAP_DEADLINE must be a positive number of "
            f"seconds, got {val!r}"
        )
    return val


def bootstrap_max_attempts() -> int:
    """The attempt cap of that retry (``MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS``;
    0 = the deadline alone)."""
    return _int("MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS",
                DEFAULT_BOOTSTRAP_MAX_ATTEMPTS)


def drain_grace_s() -> float:
    """The drain notice window in seconds (``MPI4JAX_TPU_DRAIN_GRACE_S``;
    5 by default)."""
    val = parse_env_float("MPI4JAX_TPU_DRAIN_GRACE_S", DEFAULT_DRAIN_GRACE_S)
    if val is None or val <= 0:
        raise ValueError(
            "MPI4JAX_TPU_DRAIN_GRACE_S must be a positive number of "
            f"seconds, got {val!r}"
        )
    return val


# ---------------------------------------------------------------------------
# the elastic layer's knobs
# ---------------------------------------------------------------------------


def elastic_redundancy() -> int:
    """The copies of each state shard beyond its owner's
    (``MPI4JAX_TPU_ELASTIC_REDUNDANCY``; 1 by default: each shard lives on
    its owner plus one more rank, tolerating one simultaneous loss)."""
    return _int("MPI4JAX_TPU_ELASTIC_REDUNDANCY", DEFAULT_ELASTIC_REDUNDANCY)


def elastic_grow() -> bool:
    """Whether the elastic loop admits replacement ranks
    (``MPI4JAX_TPU_ELASTIC_GROW``; off by default)."""
    return parse_env_bool("MPI4JAX_TPU_ELASTIC_GROW", False)


def elastic_fail_unit() -> str:
    """The granularity of an elastic shrink
    (``MPI4JAX_TPU_ELASTIC_FAIL_UNIT``): ``rank`` (default), ``row`` or
    ``col`` (``parallel/mesh.py:shrink_world_mesh``)."""
    return _choice("MPI4JAX_TPU_ELASTIC_FAIL_UNIT")


def elastic_placement() -> str:
    """The shard-replica placement (``MPI4JAX_TPU_ELASTIC_PLACEMENT``):
    ``stripe`` (default) or ``neighbor``."""
    return _choice("MPI4JAX_TPU_ELASTIC_PLACEMENT")


def elastic_agreement() -> str:
    """The failure agreement's transport
    (``MPI4JAX_TPU_ELASTIC_AGREEMENT``): ``coordinator`` (default) or
    ``gossip``."""
    return _choice("MPI4JAX_TPU_ELASTIC_AGREEMENT")


def elastic_port_span() -> int:
    """The width of the per-epoch port window
    (``MPI4JAX_TPU_ELASTIC_PORT_SPAN``; 64 by default, at least 1)."""
    return _int("MPI4JAX_TPU_ELASTIC_PORT_SPAN", DEFAULT_ELASTIC_PORT_SPAN,
                minimum=1)


# ---------------------------------------------------------------------------
# the health plane's knobs
# ---------------------------------------------------------------------------


def health_mode() -> str:
    """The health plane (``MPI4JAX_TPU_HEALTH``): ``off`` or ``on``."""
    return _choice("MPI4JAX_TPU_HEALTH")


def health_interval() -> int:
    """The boundary stride of the detector's digest exchange
    (``MPI4JAX_TPU_HEALTH_INTERVAL``; 1, every boundary, by default)."""
    return _int("MPI4JAX_TPU_HEALTH_INTERVAL", 1, minimum=1)


def flight_ring_capacity() -> int:
    """The flight ring's capacity in records (``MPI4JAX_TPU_FLIGHT_RING``;
    1024 by default, at least 1)."""
    return _int("MPI4JAX_TPU_FLIGHT_RING", DEFAULT_FLIGHT_RING, minimum=1)


def health_suspects_enabled() -> bool:
    """Whether the detector hands persistent stragglers to the elastic
    agreement (``MPI4JAX_TPU_HEALTH_SUSPECTS``; off by default)."""
    return parse_env_bool("MPI4JAX_TPU_HEALTH_SUSPECTS", False)


def health_prom_enabled() -> bool:
    """Whether detector boundaries also write the Prometheus text under the
    telemetry directory (``MPI4JAX_TPU_HEALTH_PROM``; off by default)."""
    return parse_env_bool("MPI4JAX_TPU_HEALTH_PROM", False)


# ---------------------------------------------------------------------------
# the workloads' knobs
# ---------------------------------------------------------------------------


def moe_capacity_chunks() -> int:
    """The capacity chunks of the MoE layer's combine pipeline
    (``MPI4JAX_TPU_MOE_CAPACITY_CHUNKS``; 2 by default, at least 1)."""
    return _int("MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", DEFAULT_MOE_CAPACITY_CHUNKS,
                minimum=1)


def pipeline_microbatches(payload_bytes: Optional[int] = None) -> int:
    """The microbatch count of the pipeline schedule compiler
    (``MPI4JAX_TPU_PIPELINE_MICROBATCHES``; 0, unset, by default; default
    < tuning < env)."""
    return _env_or_tuned("MPI4JAX_TPU_PIPELINE_MICROBATCHES",
                         "pipeline_microbatches",
                         DEFAULT_PIPELINE_MICROBATCHES,
                         payload_bytes=payload_bytes)


def pipeline_virtual_stages(payload_bytes: Optional[int] = None) -> int:
    """The stage-chunks a rank of the interleaved schedule owns
    (``MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES``; 0, unset, by default; default
    < tuning < env)."""
    return _env_or_tuned("MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES",
                         "pipeline_virtual_stages",
                         DEFAULT_PIPELINE_VIRTUAL_STAGES,
                         payload_bytes=payload_bytes)


# ---------------------------------------------------------------------------
# the serving runtime's knobs
# ---------------------------------------------------------------------------


def serving_max_batch() -> int:
    """The decode batch cap of the serving runtime
    (``MPI4JAX_TPU_SERVING_MAX_BATCH``; 8 by default, at least 1)."""
    return _int("MPI4JAX_TPU_SERVING_MAX_BATCH", DEFAULT_SERVING_MAX_BATCH,
                minimum=1)


def serving_buckets() -> str:
    """The raw ``MPI4JAX_TPU_SERVING_BUCKETS`` spec ('' = powers of two up
    to :func:`serving_max_batch`), parsed by
    ``serving/buckets.py:BucketTable.from_spec``."""
    return _text("MPI4JAX_TPU_SERVING_BUCKETS")


def serving_kv_slots() -> int:
    """The KV slot budget of the serving runtime
    (``MPI4JAX_TPU_SERVING_KV_SLOTS``; 0, twice the batch cap, by
    default)."""
    return _int("MPI4JAX_TPU_SERVING_KV_SLOTS", 0)


def serving_unroll() -> int:
    """The decode megastep's trip count (``MPI4JAX_TPU_SERVING_UNROLL``; 4
    by default, at least 1)."""
    return _int("MPI4JAX_TPU_SERVING_UNROLL", DEFAULT_SERVING_UNROLL,
                minimum=1)


def serving_slo_p99_ms() -> float:
    """The serving p99 latency objective in milliseconds
    (``MPI4JAX_TPU_SERVING_SLO_P99_MS``; 1000 by default)."""
    val = parse_env_float("MPI4JAX_TPU_SERVING_SLO_P99_MS",
                          DEFAULT_SERVING_SLO_P99_MS)
    if val is None or val <= 0:
        raise ValueError(
            "MPI4JAX_TPU_SERVING_SLO_P99_MS must be a positive number of "
            f"milliseconds, got {val!r}"
        )
    return val


def analyze_mode() -> str:
    """The collective verifier's ambient mode (``MPI4JAX_TPU_ANALYZE``):
    ``off`` (default), ``warn`` or ``error``."""
    return _choice("MPI4JAX_TPU_ANALYZE")


def analyze_ranks():
    """The cross-rank pass setting (``MPI4JAX_TPU_ANALYZE_RANKS``):
    ``"auto"`` (default), ``"off"``, or a positive int cap on the comm
    sizes the ambient per-rank re-runs cover."""
    raw = _text("MPI4JAX_TPU_ANALYZE_RANKS").lower()
    if not raw or raw == "auto":
        return "auto"
    if raw == "off":
        return "off"
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"Environment variable MPI4JAX_TPU_ANALYZE_RANKS={raw!r} must "
            "be 'auto', 'off', or a positive integer rank cap"
        ) from None
    if val < 1:
        raise ValueError(
            f"Environment variable MPI4JAX_TPU_ANALYZE_RANKS={raw!r} must "
            "be 'auto', 'off', or a positive integer rank cap"
        )
    return val


def cost_model_path() -> str:
    """The cost-model file (``MPI4JAX_TPU_COST_MODEL``; '' : the tuning
    layer's links section, else the analytic defaults of
    ``analysis/costmodel.py``)."""
    return _text("MPI4JAX_TPU_COST_MODEL")


def analyze_cost_enabled() -> bool:
    """Whether the ambient verifier's cross-rank pass also runs the cost
    pass (``MPI4JAX_TPU_ANALYZE_COST``: ``off``, the default, or
    ``on``)."""
    return _choice("MPI4JAX_TPU_ANALYZE_COST") == "on"
