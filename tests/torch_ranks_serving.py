"""Rank programs of the serving runtime's tests (``tests/test_torch_serving.py``).

Every rank imports this module afresh, so it imports only torch, numpy
and the port.  The config and traces are ``tests/test_serving.py``'s
(``_tiny_cfg``, ``_tiny_trace``), built here with the port's classes;
the test module builds the JAX package's twins with the same numbers and
holds the results against them.  Knobs are set in the rank process's own
``os.environ`` and through the port's setters.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi4jax_tpu_torch import Comm, make_world_mesh, spmd, telemetry
from mpi4jax_tpu_torch.serving import (
    Request,
    ServingConfig,
    ServingEngine,
    poisson_trace,
)
from mpi4jax_tpu_torch.serving import model as smodel

# tests/test_serving.py:77-82
TINY = dict(vocab=32, heads=8, head_dim=2, ffn=32, max_len=32,
            max_prompt=8, max_batch=4, kv_slots=8, unroll=2,
            slo_p99_ms=60_000.0, clock="virtual", seed=11)
# (scheduler, unroll) of the engine runs held against the JAX engine
VARIANTS = (("continuous", 1), ("continuous", 2), ("static", 1),
            ("static", 2))
# decode single steps after the manual prefill
STEPS = 4


def tiny_cfg(**overrides) -> ServingConfig:
    return ServingConfig(**dict(TINY, **overrides))


def tiny_trace(n=6, rate=300.0, seed=5):
    """tests/test_serving.py:85-87."""
    return poisson_trace(n, rate, seed=seed, prompt_len=(2, 4),
                         max_new=(2, 6), long_frac=0.0, vocab=32)


def late_trace():
    """tests/test_serving.py:test_admission_lands_on_megastep_boundaries's
    trace: one request up front, one arriving between two boundaries."""
    late = poisson_trace(1, 1e6, seed=9, prompt_len=(2, 3), max_new=(2, 4),
                         vocab=32)[0]
    late = Request(rid=99, arrival_s=0.015, prompt=late.prompt,
                   max_new_tokens=late.max_new_tokens)
    return tiny_trace(n=1, rate=1e6) + [late]


def bucket_trace():
    """tests/test_serving.py:test_one_program_per_bucket's trace: live
    batches 4 and 3 share bucket 4."""
    return [Request(rid=i, arrival_s=0.0, prompt=(1, 2), max_new_tokens=b)
            for i, b in enumerate([2, 4, 4, 4])]


def manual_lanes(cfg: ServingConfig, n_live: int = 2):
    """tests/test_serving.py:_manual_args as one rank's numpy lanes: ``n_live``
    prompts in bucket ``bucket_for(n_live)`` on freshly allocated slots."""
    bucket = cfg.table().bucket_for(n_live)
    rng = np.random.default_rng(3)
    plens = [3, 2][:n_live]
    prompts = np.zeros((bucket, cfg.max_prompt), np.int32)
    for i, pl in enumerate(plens):
        prompts[i, :pl] = rng.integers(1, cfg.vocab, pl)
    plens = np.asarray(plens + [1] * (bucket - n_live), np.int32)
    slots = np.asarray(list(range(n_live)) + [cfg.slots()] * (bucket - n_live),
                       np.int32)
    return bucket, prompts, plens, slots


def world_comm(device="cpu") -> Comm:
    mesh = make_world_mesh(device=device)
    return Comm(mesh.axes[0], mesh=mesh)


def _streams(engine) -> dict:
    return {s.rid: list(s.generated) for s in engine._sched.finished}


def _kv_and_tokens(engine) -> dict:
    """The engine's KV pair and token table (copies)."""
    return {"kk": engine._state[5].clone(), "vv": engine._state[6].clone(),
            "tok": engine._state[7].clone()}


def _steps(engine, cfg, comm):
    """The manual prefill, then ``STEPS`` single decode steps through
    ``spmd``, each step's state kept; and the pinned decode megastep from
    the prefill's state against ``cfg.unroll`` of those steps, bit for
    bit.  Also checks that one call leaves its arguments as they were."""
    bucket, prompts, plens, slots = manual_lanes(cfg)
    lanes = tuple(torch.from_numpy(a) for a in (prompts, plens, slots))
    before = [t.clone() for t in engine._state + lanes]
    kk, vv, tok, first = spmd(smodel.prefill_step, comm=comm)(
        *(engine._state + lanes))
    untouched = all(torch.equal(a, b) for a, b in
                    zip(before, engine._state + lanes))
    out = {"prefill": {"kk": kk, "vv": vv, "tok": tok, "first": first}}
    cur = engine._state[:5] + (kk, vv, tok, first, lanes[1], lanes[2])
    start = cur
    step = spmd(smodel.decode_step, comm=comm, unroll=1)
    for i in range(STEPS):
        prev = cur
        snap = [t.clone() for t in prev]
        cur = step(*prev)
        untouched = untouched and all(torch.equal(a, b)
                                      for a, b in zip(snap, prev))
        out[f"step{i}"] = {"kk": cur[5], "vv": cur[6], "tok": cur[7],
                           "nxt": cur[8], "lens": cur[9]}
    meg = engine._program("decode", bucket, start)(*start)
    ref = start
    for _ in range(cfg.unroll):
        ref = step(*ref)
    out["megastep_bitwise"] = all(torch.equal(a, b) for a, b in zip(meg, ref))
    out["untouched"] = untouched
    return out


def serving_program(rank, device="cpu"):
    """The k-rank world's runs: each variant's ``run()`` dict, streams and
    final KV; the manual steps; one program per bucket; admission at
    boundaries; and a run under ``counters`` and one under ``events``
    with their snapshots (journal included) and meters."""
    from mpi4jax_tpu_torch.aot import pinning
    from mpi4jax_tpu_torch.telemetry import journal

    torch.set_num_threads(1)
    comm = world_comm(device)
    out = {"rank": rank, "world": comm.Get_size()}
    trace = tiny_trace()
    for sched, unroll in VARIANTS:
        engine = ServingEngine(tiny_cfg(unroll=unroll), comm)
        res = engine.run(trace, scheduler=sched)
        out[f"{sched}/u{unroll}"] = {"result": res,
                                     "streams": _streams(engine),
                                     "state": _kv_and_tokens(engine),
                                     "pin": engine.pin}

    cfg = tiny_cfg()
    out["steps"] = _steps(ServingEngine(cfg, comm), cfg, comm)

    pinning.reset_stats()
    engine = ServingEngine(tiny_cfg(unroll=1), comm)
    res = engine.run(bucket_trace(), scheduler="continuous")
    out["buckets"] = {"result": res, "pins": pinning.stats()["pins"]}

    engine = ServingEngine(tiny_cfg(unroll=2, tick_s=0.01), comm)
    res = engine.run(late_trace(), scheduler="continuous")
    out["admission"] = {
        "result": res,
        "admitted_s": {s.rid: s.admitted_s for s in engine._sched.finished}}

    for mode in ("counters", "events"):
        telemetry.reset()
        telemetry.set_telemetry_mode(mode)
        try:
            engine = ServingEngine(tiny_cfg(), comm)
            res = engine.run(trace, scheduler="continuous")
            snap = telemetry.snapshot(include_events=True)
            recs = [r for r in journal.snapshot_events()
                    if str(r.get("op", "")).startswith("serving.")]
        finally:
            telemetry.set_telemetry_mode(None)
            telemetry.reset()
        out[mode] = {"result": res, "snapshot": snap, "serving_records": recs}
    return out
