"""Serving metrics: per-request latency, the SLO verdict, the bench payload.

PyTorch counterpart of ``mpi4jax_tpu/serving/metrics.py``, pure Python
and the same code.  The serving number is *tokens/s/chip at a p99
latency bound*: raw throughput means nothing if the tail waits without
bound (a static batch keeps the device busy and still starves late
arrivals), so the metric pairs the token rate with the p99 request
latency it was reached at and the bound it is judged against
(``MPI4JAX_TPU_SERVING_SLO_P99_MS``).  ``bench_payload`` carries both
schedulers' numbers over the same trace, with the continuous-over-static
speedup; its schema string is the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["BENCH_SCHEMA", "bench_payload", "percentile", "summarize"]

BENCH_SCHEMA = "mpx-serving-bench/1"


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (``q`` in [0, 1]); ``None`` on empty."""
    if not values:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def summarize(finished, *, wall_s: float, chips: int, slo_p99_ms: float,
              failed: int = 0, scheduler: str = "continuous") -> Dict:
    """One scheduler run -> its metric block.

    ``finished`` is the scheduler's finished-sequence list; request
    latency is ``finish_s - arrival_s`` (queueing included: the SLO is
    the USER'S latency, not the device's), first-token latency
    ``first_token_s - arrival_s``."""
    lat = [s.finish_s - s.request.arrival_s for s in finished
           if s.finish_s is not None]
    ttft = [s.first_token_s - s.request.arrival_s for s in finished
            if s.first_token_s is not None]
    tokens = sum(len(s.generated) for s in finished)
    p99 = percentile(lat, 0.99)
    p99_ms = p99 * 1e3 if p99 is not None else None
    p50 = percentile(lat, 0.5)
    return {
        "scheduler": scheduler,
        "completed": len(lat),
        "failed": int(failed),
        "tokens": int(tokens),
        "wall_s": round(float(wall_s), 6),
        "tokens_per_s_per_chip": (
            round(tokens / wall_s / chips, 3) if wall_s > 0 else None
        ),
        "p50_ms": round(p50 * 1e3, 3) if p50 is not None else None,
        "p99_ms": round(p99_ms, 3) if p99_ms is not None else None,
        "ttft_p99_ms": (
            round(percentile(ttft, 0.99) * 1e3, 3) if ttft else None
        ),
        "slo_p99_ms": float(slo_p99_ms),
        "slo_met": bool(p99_ms is not None and p99_ms <= slo_p99_ms),
        "preempt_readmissions": sum(s.preempt_readmissions
                                    for s in finished),
    }


def bench_payload(*, workload: Dict, trace_meta: Dict, chips: int,
                  continuous: Dict, static: Optional[Dict],
                  environment: str, provenance: Optional[Dict] = None
                  ) -> Dict:
    """The serving benchmark's document (``schema`` ``BENCH_SCHEMA``):
    both schedulers' numbers over one trace, the SLO they were judged
    at, and the speedup."""
    payload = {
        "schema": BENCH_SCHEMA,
        "metric": "serving tokens/s/chip at a p99 latency bound",
        "workload": dict(workload),
        "trace": dict(trace_meta),
        "chips": int(chips),
        "slo_p99_ms": continuous["slo_p99_ms"],
        "continuous": dict(continuous),
        "environment": environment,
    }
    if static is not None:
        payload["static"] = dict(static)
        c, s = (continuous.get("tokens_per_s_per_chip"),
                static.get("tokens_per_s_per_chip"))
        if c and s:
            payload["speedup_tokens_per_s"] = round(c / s, 3)
    if provenance:
        payload["provenance"] = dict(provenance)
    return payload
