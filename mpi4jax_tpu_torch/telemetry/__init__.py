"""Runtime telemetry of the port: per-op counters, the events journal,
the cross-rank report and the merge of journals.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/``, in the JAX package's
three tiers, gated by ``MPI4JAX_TPU_TELEMETRY`` or
``set_telemetry_mode``:

- ``off`` (default): nothing is collected, and the dispatch point calls
  each op's body directly;
- ``counters``: per-(op, comm, algorithm, dtype) calls and bytes, and the
  meters of the machinery around the ops; a pinned CUDA graph keeps its
  graph and counts each replay;
- ``events``: also a begin/end journal record per op call and rank, in
  memory and, with ``MPI4JAX_TPU_TELEMETRY_DIR``, in per-process JSONL
  files.  A pin then runs its body eagerly (a graph replay runs no host
  code), and says so (``program.info``).

Read it back with :func:`snapshot` (this process), :func:`report` (every
rank's, gathered through the port's collectives), :func:`dump`, or merge
the journals of every rank into one Perfetto timeline::

    python -m mpi4jax_tpu_torch.telemetry merge $MPI4JAX_TPU_TELEMETRY_DIR \\
        --perfetto trace.json

``MPI4JAX_TPU_HEALTH=on`` also arms the health plane (``health.py``):
a bounded flight ring (:func:`flight_snapshot`), an online straggler
detector at megastep or commit boundaries (``health.on_boundary``),
postmortem bundles (:func:`dump_postmortem`, merged by ``python -m
mpi4jax_tpu_torch.telemetry postmortem <dir>``) and
:func:`prometheus_text`.
"""

from . import health  # noqa: F401
from .core import (  # noqa: F401
    effective_mode,
    meter,
    reset,
    set_telemetry_mode,
    snapshot,
    telemetry_cache_token,
)
from .health import (  # noqa: F401
    dump_postmortem,
    flight_snapshot,
    prometheus_text,
)
from .hist import Histogram  # noqa: F401
from .merge import chrome_trace, merge_dir, skew_table  # noqa: F401
from .report import dump, gather_snapshots, report  # noqa: F401

__all__ = [
    "set_telemetry_mode",
    "effective_mode",
    "telemetry_cache_token",
    "meter",
    "snapshot",
    "report",
    "dump",
    "reset",
    "gather_snapshots",
    "Histogram",
    "merge_dir",
    "chrome_trace",
    "skew_table",
    "health",
    "flight_snapshot",
    "dump_postmortem",
    "prometheus_text",
]
