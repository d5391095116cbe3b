"""The knobs of the throughput and dispatch layers, read from the JAX
package's variables.

PyTorch counterpart of the part of ``mpi4jax_tpu/utils/config.py`` that
fusion, the async collectives, the codec and the megastep loops read; the
names, choices and defaults are the same, so a user's settings carry over:

- ``MPI4JAX_TPU_COMPRESS``: ``off`` (default), ``bf16``, ``fp8`` or
  ``auto``, the codec of ``compress.ef_allreduce``'s roundtrip;
- ``MPI4JAX_TPU_FUSION``: ``off`` (default), ``auto`` or ``force``
  (``ops/_fusion.py``; ``set_fusion_mode`` overrides it);
- ``MPI4JAX_TPU_FUSION_BUCKET_BYTES``: the byte cap of a fusion bucket,
  4 MiB by default;
- ``MPI4JAX_TPU_OVERLAP_CHUNKS``: the chunks an async collective is split
  into, 2 by default, at least 1;
- ``MPI4JAX_TPU_UNROLL_DEFAULT``: the megastep trip count of an ``spmd``
  or ``compile`` call without ``unroll=`` (``parallel/megastep.py``), 1
  (no loop) by default, at least 1;

and the runtime services' (``telemetry/``, ``resilience/``):

- ``MPI4JAX_TPU_TELEMETRY``: ``off`` (default), ``counters`` or
  ``events``; ``MPI4JAX_TPU_TELEMETRY_DIR``: where the events tier writes
  its per-process JSONL journal ('' keeps it in memory);
- ``MPI4JAX_TPU_WATCHDOG_TIMEOUT``: seconds a collective may stay in
  flight (unset, empty or 0: off); ``MPI4JAX_TPU_FAULT_SPEC``: the fault
  injection spec (``resilience/faultinject.py``);
  ``MPI4JAX_TPU_CHECK_NUMERICS``: guard every op's floating inputs and
  outputs against NaN/Inf;
- ``MPI4JAX_TPU_TOPOLOGY``: ranks per host (``2x4`` or ``3,5``), which
  the fault spec's host clauses read;
- ``MPI4JAX_TPU_BOOTSTRAP_DEADLINE`` (300 s) and
  ``MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS`` (0: the deadline alone): the
  retry of ``init_distributed``'s rendezvous;
- ``MPI4JAX_TPU_DRAIN_GRACE_S`` (5 s): how long a drained rank (a
  SIGTERM, or the ``preempt`` fault verb) waits for its peers' acks of
  its notice (part of the elastic cache token);

and the elastic layer's (``resilience/elastic.py``):

- ``MPI4JAX_TPU_ELASTIC_REDUNDANCY``: the copies of each state shard
  beyond its owner's, 1 by default, at least 0;
- ``MPI4JAX_TPU_ELASTIC_FAIL_UNIT``: ``rank`` (default), ``row`` or
  ``col``, the granularity of a shrink;
- ``MPI4JAX_TPU_ELASTIC_PLACEMENT``: ``stripe`` (default) or
  ``neighbor``, the replica placement;
- ``MPI4JAX_TPU_ELASTIC_AGREEMENT``: ``coordinator`` (default) or
  ``gossip``, the failure agreement's transport;
- ``MPI4JAX_TPU_ELASTIC_PORT_SPAN``: the per-epoch port window, 64 by
  default, at least 1;
- ``MPI4JAX_TPU_ELASTIC_GROW``: admit replacement ranks at a commit
  boundary (off by default; ``elastic.join_and_run`` is the joiner's
  side);

and the health plane's (``telemetry/health.py``):

- ``MPI4JAX_TPU_HEALTH``: ``off`` (default) or ``on``, the flight ring,
  the straggler detector and postmortem bundles;
- ``MPI4JAX_TPU_HEALTH_INTERVAL``: the boundary stride of the detector's
  exchange, 1 (every boundary) by default, at least 1;
- ``MPI4JAX_TPU_FLIGHT_RING``: the ring's capacity in records, 1024 by
  default, at least 1;
- ``MPI4JAX_TPU_HEALTH_SUSPECTS``: hand persistent stragglers to the
  elastic agreement (off by default);
- ``MPI4JAX_TPU_HEALTH_PROM``: write the Prometheus text at every
  detector boundary (off by default).

and the workloads' (``parallel/moe.py``, ``parallel/pipeline.py``):

- ``MPI4JAX_TPU_MOE_CAPACITY_CHUNKS``: the capacity chunks of the MoE
  layer's overlapped combine, 2 by default, at least 1 (1: the
  synchronous layer);
- ``MPI4JAX_TPU_PIPELINE_MICROBATCHES``: the microbatches
  ``split_microbatches`` cuts a batch into without an explicit count, 0
  (unset: no split) by default;
- ``MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES``: the stage-chunks a rank of the
  interleaved schedule owns without an explicit ``virtual``, 0 (unset)
  by default;

and the serving runtime's (``serving/``):

- ``MPI4JAX_TPU_SERVING_MAX_BATCH``: the decode batch cap (the largest
  bucket), 8 by default, at least 1;
- ``MPI4JAX_TPU_SERVING_BUCKETS``: an explicit bucket table
  (comma-separated ascending batch sizes; empty, the default: powers of
  two up to the cap);
- ``MPI4JAX_TPU_SERVING_KV_SLOTS``: the KV slot budget, 0 (twice the
  cap) by default;
- ``MPI4JAX_TPU_SERVING_UNROLL``: the decode megastep's trip count, 4 by
  default, at least 1;
- ``MPI4JAX_TPU_SERVING_SLO_P99_MS``: the p99 latency objective in
  milliseconds, 1000 by default, positive;

and the persistent tier's (``aot/diskcache.py``):

- ``MPI4JAX_TPU_COMPILE_CACHE_DIR``: where built kernel libraries and pin
  records are kept ('' by default: the tier is off);
  ``MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES``: its byte cap, 1 GiB by
  default, 0 for none;
- ``MPI4JAX_TPU_CPP_DISPATCH``: a pin on one CUDA rank replays its graph
  (on by default; off runs it eagerly, ``aot/fastpath.py``).

and the collective verifier's (``analysis/``):

- ``MPI4JAX_TPU_ANALYZE``: ``off`` (default), ``warn`` or ``error``: a
  region (or an eager op) is verified abstractly at its first call for
  each key, before it runs; ``warn`` warns on findings, ``error`` raises
  ``AnalysisError`` (``set_analyze_mode`` overrides it);
- ``MPI4JAX_TPU_ANALYZE_RANKS``: ``auto`` (default), ``off`` or a
  positive rank cap: the cross-rank schedule pass of that verification
  runs for comms of at most that many ranks (``auto``: every comm).

``MPI4JAX_TPU_DEBUG`` and ``MPI4JAX_TPU_TRACE`` are read once, at import
of ``utils/debug.py``, as in the JAX package.

and the tuning layer's and the cost model's (``autotune/``,
``analysis/costmodel.py``):

- ``MPI4JAX_TPU_TUNING``: an ``mpx-tuning/1`` file (what ``python -m
  mpi4jax_tpu_torch.autotune`` writes), served between the defaults and
  the environment (``load_tuning`` is the programmatic form and wins);
- ``MPI4JAX_TPU_COST_MODEL``: a cost-model file (``mpx-cost-model/1`` or
  ``mpx-tuning/1``) for ``analyze(cost=True)`` ('' : the tuning layer's
  links section if it has one, else the analytic defaults);
- ``MPI4JAX_TPU_ANALYZE_COST``: ``off`` (default) or ``on``, the cost
  pass of the ambient verifier's cross-rank pass;
- ``MPI4JAX_TPU_RING_CROSSOVER_BYTES`` (1 MiB),
  ``MPI4JAX_TPU_DCN_CROSSOVER_BYTES`` (4 MiB) and
  ``MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES`` (1 MiB): the algorithm
  crossovers the selector of ``ops/_algos.py`` reads (the tuning layer
  tunes them); ``MPI4JAX_TPU_COMPRESS_ERROR_BUDGET`` (1e-2): the
  round-trip error the autotuner's codec sweep accepts;

and the collective algorithm layer's (``ops/_algos.py``,
``ops/_hierarchy.py``):

- ``MPI4JAX_TPU_COLLECTIVE_ALGO``: ``auto`` (default), ``butterfly``,
  ``ring`` or ``hier``: ``auto`` picks per call from the payload bytes,
  the group size and the host topology; the others force one lowering
  where it is expressible (``hier``, the two-level lowering, falls back to
  the ``auto`` rules where no plan exists).

Each knob a tuning file carries resolves as default < tuning < an
explicitly set variable, as in the JAX package: ``fusion_bucket_bytes``,
``overlap_chunks`` and ``compress`` (both by payload bucket when the file
buckets them), the two pipeline knobs and the three crossovers; ``auto``
compression resolves to the file's codec for the payload, else ``bf16``.
An unset or empty variable takes the default; a value outside the
choices, or an integer below its minimum, raises ``ValueError`` with the
JAX package's message.

A pinned program (``aot/pinning.py``) captures the configuration once:
``config_stamp()`` is the override epoch, which every programmatic
override bumps (``bump_config_epoch``; ``set_fusion_mode`` does), and the
raw values of ``FLAG_NAMES``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

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


def _choice(name: str, choices, default: str) -> str:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    val = raw.lower().strip()
    if val not in choices:
        raise ValueError(f"Environment variable {name}={raw!r} must be one of "
                         f"{choices}")
    return val


def _int(name: str, default: int, minimum: int = 0) -> int:
    raw = os.environ.get(name)
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
    raw = os.environ.get(name)
    return raw is not None and bool(raw.strip())


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
    mode = _choice("MPI4JAX_TPU_COMPRESS", COMPRESS_MODES, "off")
    if not _explicit("MPI4JAX_TPU_COMPRESS") or mode == "auto":
        tuned = _tuned_knob("compress", payload_bytes=payload_bytes)
        if tuned is not None and str(tuned).lower() != "auto":
            return str(tuned).lower()
    return "bf16" if mode == "auto" else mode


def fusion_mode() -> str:
    """The fusion mode (``MPI4JAX_TPU_FUSION``): ``off``, ``auto`` or
    ``force``."""
    return _choice("MPI4JAX_TPU_FUSION", FUSION_MODES, "off")


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
    return _choice("MPI4JAX_TPU_COLLECTIVE_ALGO", COLLECTIVE_ALGOS, "auto")


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
    path = (os.environ.get("MPI4JAX_TPU_TUNING") or "").strip()
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
    return (os.environ.get("MPI4JAX_TPU_COMPILE_CACHE_DIR") or "").strip()


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
    raw = os.environ.get(name)
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
    raw = os.environ.get(name)
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
    return _choice("MPI4JAX_TPU_TELEMETRY", TELEMETRY_MODES, "off")


def telemetry_dir() -> str:
    """Where the events tier writes its JSONL journal
    (``MPI4JAX_TPU_TELEMETRY_DIR``; '' = in memory only)."""
    return (os.environ.get("MPI4JAX_TPU_TELEMETRY_DIR") or "").strip()


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
    return (os.environ.get("MPI4JAX_TPU_FAULT_SPEC") or "").strip()


def check_numerics() -> bool:
    """Whether ops guard their floating inputs and outputs against NaN/Inf
    (``MPI4JAX_TPU_CHECK_NUMERICS``)."""
    return parse_env_bool("MPI4JAX_TPU_CHECK_NUMERICS", False)


def topology_spec() -> str:
    """The raw ``MPI4JAX_TPU_TOPOLOGY`` string ('' = none declared)."""
    return (os.environ.get("MPI4JAX_TPU_TOPOLOGY") or "").strip()


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
    return _choice("MPI4JAX_TPU_ELASTIC_FAIL_UNIT", ELASTIC_FAIL_UNITS, "rank")


def elastic_placement() -> str:
    """The shard-replica placement (``MPI4JAX_TPU_ELASTIC_PLACEMENT``):
    ``stripe`` (default) or ``neighbor``."""
    return _choice("MPI4JAX_TPU_ELASTIC_PLACEMENT", ELASTIC_PLACEMENTS,
                   "stripe")


def elastic_agreement() -> str:
    """The failure agreement's transport
    (``MPI4JAX_TPU_ELASTIC_AGREEMENT``): ``coordinator`` (default) or
    ``gossip``."""
    return _choice("MPI4JAX_TPU_ELASTIC_AGREEMENT", ELASTIC_AGREEMENTS,
                   "coordinator")


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
    return _choice("MPI4JAX_TPU_HEALTH", HEALTH_MODES, "off")


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
    return (os.environ.get("MPI4JAX_TPU_SERVING_BUCKETS") or "").strip()


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
    return _choice("MPI4JAX_TPU_ANALYZE", ANALYZE_MODES, "off")


def analyze_ranks():
    """The cross-rank pass setting (``MPI4JAX_TPU_ANALYZE_RANKS``):
    ``"auto"`` (default), ``"off"``, or a positive int cap on the comm
    sizes the ambient per-rank re-runs cover."""
    raw = (os.environ.get("MPI4JAX_TPU_ANALYZE_RANKS") or "").strip().lower()
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
    return (os.environ.get("MPI4JAX_TPU_COST_MODEL") or "").strip()


def analyze_cost_enabled() -> bool:
    """Whether the ambient verifier's cross-rank pass also runs the cost
    pass (``MPI4JAX_TPU_ANALYZE_COST``: ``off``, the default, or
    ``on``)."""
    return _choice("MPI4JAX_TPU_ANALYZE_COST", ("off", "on"), "off") == "on"
