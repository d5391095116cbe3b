"""Cost-model-driven serving replay: the scheduler under a virtual clock.

PyTorch counterpart of ``mpi4jax_tpu/serving/sim.py``.  The replay runs
the real scheduler (``serving/scheduler.py``, the admission and eviction
code the engine drives) against an arrival trace, with each device
dispatch replaced by its predicted latency from the cost model
(``analysis/costmodel.py``: alpha-beta per link class, the compute rate
and the host dispatch): per decode step, the two tensor-parallel
allreduces of ``[bucket, dim]`` and the attention and MLP bytes; per
megastep, one host dispatch amortized over ``unroll`` steps.  The clock
is deterministic and the replay runs no device.  ``models/serving.py
--simulate`` prints it beside nothing measured; the card's numbers are
the benchmark's.
"""


from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .engine import ServingConfig
from .kvcache import SlotAllocator
from .metrics import bench_payload, summarize
from .scheduler import ContinuousScheduler, Request, StaticScheduler

__all__ = ["replay", "replay_bench", "step_costs_us"]


def step_costs_us(cfg: ServingConfig, k: int, model=None) -> Dict[str, float]:
    """Predicted per-dispatch costs (microseconds) at world size ``k``:
    ``decode_step(bucket)`` (one token step: 2 allreduces + compute),
    ``dispatch`` (host cost per megastep), ``prefill(bucket)``."""
    from ..analysis import costmodel

    m = model if model is not None else costmodel.load_model()
    weights = (cfg.vocab * cfg.dim + 3 * cfg.dim * cfg.dim
               + cfg.dim * cfg.dim + 2 * cfg.dim * cfg.ffn) * 4
    out: Dict[str, float] = {"dispatch": m.dispatch_us}
    for bucket in cfg.table().buckets:
        nbytes = cfg.collective_payload_bytes(bucket)
        if k > 1:
            wire = 2 * m.time_us(costmodel.collective_cost(
                "allreduce", None, nbytes, k))
        else:
            wire = 0.0
        # roofline compute: the weight streaming dominates at tiny
        # batches (every step reads all local weights), KV read scales
        # with bucket * max_len
        kv_read = bucket * cfg.max_len * cfg.heads // k * cfg.head_dim * 4 * 2
        compute = m.compute_us(weights // k + kv_read)
        out[f"decode.b{bucket}"] = wire + compute
        # prefill: the same pattern over the padded prompt width at once
        width = cfg.max_prompt
        pre_wire = 2 * m.time_us(costmodel.collective_cost(
            "allreduce", None, nbytes * width, k)) if k > 1 else 0.0
        out[f"prefill.b{bucket}"] = (
            pre_wire + m.compute_us(weights // k
                                    + bucket * width * cfg.dim * 4)
        )
    return out


def replay(cfg: ServingConfig, trace: List[Request], *, k: int,
           scheduler: str = "continuous", model=None) -> Dict:
    """One scheduler policy over ``trace`` on the virtual clock; returns
    the serving metric block (metrics.summarize schema)."""
    costs = step_costs_us(cfg, k, model=model)
    table = cfg.table()
    sched_cls = (ContinuousScheduler if scheduler == "continuous"
                 else StaticScheduler)
    sched = sched_cls(table, SlotAllocator(cfg.slots()))
    for r in trace:
        cfg.budget_check(r.prompt_len, r.max_new_tokens)

    now = 0.0
    boundaries = 0
    guard = 200_000
    while not sched.idle(trace) and boundaries < guard:
        sched.offer(trace, now)
        new = sched.admit(now)
        if new:
            bucket = table.bucket_for(len(new))
            now += (costs[f"prefill.b{bucket}"] + costs["dispatch"]) * 1e-6
            for s in new:
                s.record([0], now)   # the prefill's first sampled token
        if sched.running:
            bucket = table.bucket_for(len(sched.running))
            now += (cfg.unroll * costs[f"decode.b{bucket}"]
                    + costs["dispatch"]) * 1e-6
            for s in sched.running:
                s.record([0] * cfg.unroll, now)
        elif not sched.waiting:
            nxt = sched.next_arrival_s(trace)
            if nxt is None:
                break
            now = max(now, nxt)
        sched.finish_ready(now)
        boundaries += 1
    finished = sched.finished
    out = summarize(finished, wall_s=now, chips=k,
                    slo_p99_ms=cfg.slo_p99_ms,
                    failed=len(trace) - len(finished), scheduler=scheduler)
    out["boundaries"] = boundaries
    return out


def replay_bench(cfg: ServingConfig, trace: List[Request], *, k: int,
                 trace_meta: Dict, model=None,
                 environment: Optional[str] = None) -> Tuple[Dict, Dict, Dict]:
    """Both policies over one trace -> the BENCH_serving payload."""
    cont = replay(cfg, trace, k=k, scheduler="continuous", model=model)
    stat = replay(cfg, trace, k=k, scheduler="static", model=model)
    payload = bench_payload(
        workload=cfg.workload_meta(k), trace_meta=trace_meta, chips=k,
        continuous=cont, static=stat,
        environment=environment or (
            "simulated: cost-model-driven replay of the shipped "
            "scheduler (analysis/costmodel.py); capture protocol in "
            "docs/serving.md"
        ),
    )
    return payload, cont, stat
