"""Serving runtime: continuous batching under a p99 latency objective.

PyTorch counterpart of ``mpi4jax_tpu/serving/``, with the JAX package's
names.  A tensor-parallel transformer decode loop (``model.py``) behind
an iteration-level (continuous) batching scheduler (``scheduler.py``):
requests are admitted and evicted BETWEEN decode megasteps against a
bucketed batch-shape table (``buckets.py``), a KV slot budget
(``kvcache.py``) and a p99 latency objective (``metrics.py``), with one
program per ``(phase, bucket)`` and decode run as a megastep
(``engine.py``: on one CUDA rank a CUDA graph of N token steps).
``models/serving.py`` is the runnable deployment, benchmark and elastic
drain drill (the twin of ``examples/serving/serve.py``).

The cost-model replay of the JAX package (``serving/sim.py``) waits for
the port's cost model (ROADMAP Queue 1 item 6).
"""

from .buckets import (  # noqa: F401
    BucketTable,
    bucket_payload_bytes,
    clear_declared_buckets,
    declare_buckets,
    declared_buckets,
    powers_of_two,
)
from .engine import ServingConfig, ServingEngine, warm_manifest  # noqa: F401
from .kvcache import SlotAllocator  # noqa: F401
from .metrics import BENCH_SCHEMA, bench_payload, summarize  # noqa: F401
from .scheduler import (  # noqa: F401
    ContinuousScheduler,
    Request,
    Sequence,
    StaticScheduler,
    poisson_trace,
)

__all__ = [
    "BENCH_SCHEMA",
    "BucketTable",
    "ContinuousScheduler",
    "Request",
    "Sequence",
    "ServingConfig",
    "ServingEngine",
    "SlotAllocator",
    "StaticScheduler",
    "bench_payload",
    "bucket_payload_bytes",
    "clear_declared_buckets",
    "declare_buckets",
    "declared_buckets",
    "poisson_trace",
    "powers_of_two",
    "summarize",
    "warm_manifest",
]
