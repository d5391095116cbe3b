"""Continuous-batching serving: the deployment, benchmark and drain drill.

The twin of ``examples/serving/serve.py``: the serving runtime end to
end (``serving/``), a tensor-parallel decoder served by the
iteration-level batching scheduler, one program per (phase, bucket)
(on one CUDA rank each a captured CUDA graph, decode a megastep of
``unroll`` token steps), admission and eviction at megastep boundaries,
KV slots scatter-updated so that churn builds no program.  Two modes:

- **benchmark** (default): serve one synthetic Poisson trace with the
  CONTINUOUS scheduler and again with the STATIC batch baseline, and
  print both numbers (tokens/s/chip at the p99 latency bound) in the
  JAX example's payload (``serving.bench_payload``), to ``--out`` as
  well::

      python -m mpi4jax_tpu_torch.models.serving --scheduler both --json

  One engine serves every run: a first, untimed pass over the trace
  builds (on the card: captures) each program the trace needs, as the
  JAX example's second engine finds its programs compiled already;
  ``warmup`` in the payload is that pass.  ``--device cpu`` runs on the
  CPU; the default is the GPU.

- **drain drill** (``--launch N``): N gloo ranks (one process each,
  output in the run directory's files) serve one trace in lockstep on
  the virtual clock; at the first boundary from ``--drain-boundary`` on
  with sequences in flight, the drained rank posts its preemption notice
  from a boundary hook (``request_drain()``, the path a SIGTERM takes),
  the world executes the planned shrink at the next boundary, the
  survivors re-shard the committed parameters, RE-ADMIT every in-flight
  sequence from its committed history and finish the trace with ZERO
  failed requests::

      python -m mpi4jax_tpu_torch.models.serving --launch 3 \\
          --drain-rank 2 --device cpu

  Each worker prints ``SERVING_DONE`` or ``SERVING_DRAINED`` and asserts
  the example's conditions; the launcher exits 0 iff every worker exited
  0, exactly one drained and the others completed.  Each epoch has its
  own rendezvous file (``<dir>/rendezvous.e<epoch>``), and every
  survivor barriers and destroys its process group before it exits.
  ``--drain-rank -2`` runs the same world with no notice (the clean run
  the drill's streams are held against).

``--simulate`` is the JAX example's cost-model replay
(``serving/sim.py``): the real scheduler on a virtual clock priced by
``analysis/costmodel.py`` (the active tuning layer's or cost-model file's
parameters, else the card's defaults) at ``--ranks`` ranks (default 1),
both policies, the benchmark payload printed; nothing runs on a device::

    python -m mpi4jax_tpu_torch.models.serving --model bench --simulate
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

DONE_TAG = "SERVING_DONE"
DRAINED_TAG = "SERVING_DRAINED"
NO_DRAIN = -2
# the drill's process groups: a collective's timeout, and the rendezvous's
# (ranks started together on a loaded host reach it seconds apart)
PG_TIMEOUT_S = 60.0
CONNECT_TIMEOUT_S = 120.0

# the JAX example's presets: "tiny" matches ServingConfig's defaults; "bench"
# is the serving-number workload (d 1536, 113.6 MB of f32 parameters)
PRESETS = {
    "tiny": dict(heads=24, head_dim=4, ffn=384, max_len=48, max_prompt=16),
    "bench": dict(heads=24, head_dim=64, ffn=6144, max_len=160,
                  max_prompt=16),
}


def make_config(model: str = "tiny", *, seed: int = 7, unroll: int = 0,
                max_batch: int = 0, slo_ms: float = 0.0,
                virtual_clock: bool = False):
    """The example's ``_config``: the preset, the seed, and the flags that
    override the ``MPI4JAX_TPU_SERVING_*`` defaults where non-zero."""
    from ..serving import ServingConfig

    overrides = dict(PRESETS[model], seed=seed)
    if unroll:
        overrides["unroll"] = unroll
    if max_batch:
        overrides["max_batch"] = max_batch
    if slo_ms:
        overrides["slo_p99_ms"] = slo_ms
    if virtual_clock:
        overrides["clock"] = "virtual"
    return ServingConfig.from_env(**overrides)


def make_trace(cfg, *, requests: int = 24, rate: float = 50.0, seed: int = 7,
               long_frac: float = 0.25):
    """The example's ``_trace``: budgets scale with the model's KV row, so
    every preset saturates its lanes, short answers for most requests and
    a heavy tail of long ones.  Returns ``(trace, meta)``."""
    from ..serving import poisson_trace

    short_hi = max(4, (cfg.max_len - cfg.max_prompt) // 8)
    long_hi = cfg.max_len - cfg.max_prompt - cfg.unroll - 1
    trace = poisson_trace(
        requests, rate, seed=seed,
        prompt_len=(2, min(6, cfg.max_prompt)),
        max_new=(4, short_hi),
        long_frac=long_frac,
        long_new=(max(short_hi + 1, 3 * long_hi // 4), long_hi),
        vocab=cfg.vocab,
    )
    meta = {
        "requests": requests, "rate_rps": rate,
        "seed": seed, "long_frac": long_frac,
        "span_s": round(trace[-1].arrival_s, 4),
        "tokens_budgeted": sum(r.max_new_tokens for r in trace),
    }
    return trace, meta


def streams(engine) -> dict:
    """Each finished request's generated tokens, by request id."""
    return {s.rid: list(s.generated) for s in engine._sched.finished}


def serve_streams(cfg, trace, comm, scheduler: str = "continuous"):
    """One fresh engine's run of ``trace`` over ``comm``: ``(result,
    streams)``."""
    from ..serving import ServingEngine

    engine = ServingEngine(cfg, comm)
    result = engine.run(trace, scheduler=scheduler)
    return result, streams(engine)


def first_differences(a: dict, b: dict) -> dict:
    """For each request whose streams differ, the index of the first token
    that differs (the shorter length where one is a prefix)."""
    out = {}
    for rid in sorted(set(a) | set(b)):
        sa, sb = list(a.get(rid, ())), list(b.get(rid, ()))
        if sa != sb:
            out[rid] = next((i for i, (x, y) in enumerate(zip(sa, sb))
                             if x != y), min(len(sa), len(sb)))
    return out


def top2_gap(cfg, history, comm) -> dict:
    """The decoder's logits for the token after ``history`` (a prompt and
    the tokens generated so far) on one rank of ``comm``'s device, through
    the prefill block: the two largest, their gap and the largest
    magnitude.  A gap inside f32 rounding of those logits is a tie that
    the last bit of a sum decides."""
    import numpy as np
    import torch

    from ..parallel.region import spmd
    from ..serving import model

    master = model.init_master(cfg.vocab, cfg.dim, cfg.heads, cfg.head_dim,
                               cfg.ffn, cfg.seed)
    params = model.shard_params(master, 1, 0, comm.device)
    prompts = torch.tensor([list(history)], dtype=torch.int32,
                           device=comm.device)
    plens = torch.tensor([len(history)], dtype=torch.int32,
                         device=comm.device)
    logits = spmd(model.prefill_logits, comm=comm)(
        *params, prompts, plens, head_dim=cfg.head_dim)
    row = np.sort(logits[0].double().cpu().numpy())
    return {"top1": float(row[-1]), "top2": float(row[-2]),
            "gap": float(row[-1] - row[-2]),
            "max_abs": float(np.abs(row).max())}


def benchmark(cfg, trace, meta, comm, schedulers=("continuous", "static")):
    """Serve ``trace`` once untimed (the warm-up pass) and then once per
    scheduler on one engine over ``comm``; returns ``(payload, engine,
    runs)``, ``runs`` each scheduler's ``run()`` result and streams."""
    import torch

    from ..aot import pinning
    from ..serving import ServingEngine, bench_payload

    engine = ServingEngine(cfg, comm)
    k = comm.Get_size()
    warm = engine.run(trace, scheduler=schedulers[0])
    runs = {}
    for sched in schedulers:
        res = engine.run(trace, scheduler=sched)
        runs[sched] = {"result": res, "streams": streams(engine)}
    dev = comm.device
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    payload = bench_payload(
        workload=cfg.workload_meta(k), trace_meta=meta, chips=k,
        continuous=runs.get("continuous", runs[schedulers[0]])["result"],
        static=runs.get("static", {}).get("result"),
        environment=(f"measured: {k} rank(s) on {where} "
                     "(mpi4jax_tpu_torch.models.serving)"),
    )
    payload["warmup"] = warm
    payload["compile_cache"] = {"aot": pinning.stats()}
    payload["graphs"] = {f"{p}.b{b}": bool(getattr(prog, "graph", False))
                         for (p, b), prog in sorted(engine._programs.items())}
    return payload, engine, runs


def simulate(cfg, trace, meta, k: int = 1, model=None):
    """The cost-model replay of both policies over ``trace`` at ``k``
    ranks (``serving/sim.py:replay_bench``): ``(payload, continuous,
    static)``."""
    from ..serving import sim

    cfg.validate_world(k)
    return sim.replay_bench(cfg, trace, k=k, trace_meta=meta, model=model)


def run_simulate(args) -> int:
    cfg = make_config(args.model, seed=args.seed, unroll=args.unroll,
                      max_batch=args.max_batch, slo_ms=args.slo_ms)
    trace, meta = make_trace(cfg, requests=args.requests, rate=args.rate,
                             seed=args.seed, long_frac=args.long_frac)
    payload, cont, stat = simulate(cfg, trace, meta, k=args.ranks)
    if not args.json:
        for sched, r in (("continuous", cont), ("static", stat)):
            print(f"{sched:>10}: {r['tokens_per_s_per_chip']} tok/s/chip "
                  f"predicted, p99 {r['p99_ms']} ms (slo "
                  f"{r['slo_p99_ms']} ms), {r['completed']} completed over "
                  f"{r['boundaries']} boundaries", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(payload) if args.json else json.dumps(payload, indent=2))
    return 0


def run_benchmark(args) -> int:
    from .. import Comm, make_world_mesh

    if args.simulate:
        return run_simulate(args)
    cfg = make_config(args.model, seed=args.seed, unroll=args.unroll,
                      max_batch=args.max_batch, slo_ms=args.slo_ms,
                      virtual_clock=args.virtual_clock)
    trace, meta = make_trace(cfg, requests=args.requests, rate=args.rate,
                             seed=args.seed, long_frac=args.long_frac)
    mesh = make_world_mesh(device=args.device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    scheds = (("continuous", "static") if args.scheduler == "both"
              else (args.scheduler,))
    payload, _engine, runs = benchmark(cfg, trace, meta, comm, scheds)
    if not args.json:
        for sched, run in runs.items():
            r = run["result"]
            print(f"{sched:>10}: {r['tokens_per_s_per_chip']} tok/s/chip, "
                  f"p99 {r['p99_ms']} ms (slo {r['slo_p99_ms']} ms, "
                  f"met={r['slo_met']}), {r['completed']} completed / "
                  f"{r['failed']} failed over {r['boundaries']} "
                  "boundaries", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(payload) if args.json
          else json.dumps(payload, indent=2))
    return 0


# ---------------------------------------------------------------------------
# the drain drill: the launcher and a worker
# ---------------------------------------------------------------------------


def run_worker(args) -> int:
    """One rank of the drill world; returns its exit code."""
    import torch
    import torch.distributed as dist

    from .. import Comm, make_world_mesh, request_drain
    from ..parallel import megastep
    from ..parallel.mesh import init_distributed
    from ..resilience import elastic
    from ..serving import ServingEngine

    dev = init_distributed(
        "gloo", init_method=elastic.rendezvous_for(args.rendezvous, 0),
        world_size=args.num_processes, rank=args.process_id,
        device=args.device, timeout=PG_TIMEOUT_S,
        connect_timeout=CONNECT_TIMEOUT_S)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    cfg = make_config(args.model, seed=args.seed, unroll=args.unroll,
                      max_batch=args.max_batch, slo_ms=args.slo_ms,
                      virtual_clock=True)
    trace, _ = make_trace(cfg, requests=args.requests, rate=args.rate,
                          seed=args.seed, long_frac=args.long_frac)
    mesh = make_world_mesh(device=dev)
    comm = Comm(mesh.axes[0], mesh=mesh)
    store = elastic.ShardStore(comm, bootstrap={
        "rendezvous": args.rendezvous, "host": "localhost",
        "port_base": args.port_base, "agree_port_base": args.port_base + 100,
        "process_id": args.process_id, "num_processes": args.num_processes,
        "timeout": PG_TIMEOUT_S})
    engine = ServingEngine(cfg, comm, store=store)
    if args.drain_rank == NO_DRAIN:
        drain_rank = None
    elif args.drain_rank < 0:
        drain_rank = args.num_processes - 1
    else:
        drain_rank = args.drain_rank

    posted, seen = [], {}

    def preemption_notice(step, **info):
        # the notice lands ONCE, at the first boundary from --drain-boundary
        # on with sequences IN FLIGHT (the same boundary on every rank: the
        # scheduler state is replicated), so the drill always exercises
        # the re-admission path; request_drain() is the path a SIGTERM
        # (BoundaryControl installs the handler) feeds
        eng = info.get("engine")
        if eng is None:
            return
        if eng.world != args.num_processes and "first" not in seen:
            # the first boundary at the new world: its megastep ran there
            seen["first"] = {"boundary": step, "at": time.time()}
        if (not posted and drain_rank == args.process_id
                and step >= args.drain_boundary and eng._sched.running):
            posted.append({"boundary": step, "at": time.time()})
            request_drain()

    unregister = megastep.register_boundary_hook("drill-preempt",
                                                 preemption_notice)
    t0 = time.perf_counter()
    try:
        result = engine.run(trace, scheduler="continuous")
    finally:
        unregister()
    wall = time.perf_counter() - t0

    tag = DRAINED_TAG if engine.drained else DONE_TAG
    if args.workdir:
        rec = {"rank": args.process_id, "result": result,
               "drained": engine.drained, "wall": wall,
               "streams": {str(k): v for k, v in streams(engine).items()},
               "finish_s": {str(s.rid): s.finish_s
                            for s in engine._sched.finished},
               "posted": posted, "first_at_new_world": seen.get("first"),
               "world_changes": engine.world_changes,
               "drains": store.drains, "tick_s": cfg.tick_s}
        with open(os.path.join(args.workdir,
                               f"result-p{args.process_id}.json"), "w") as f:
            json.dump(rec, f, indent=2, default=str)
    print(f"{tag} world={result['world']} completed={result['completed']} "
          f"failed={result['failed']} "
          f"readmissions={result['preempt_readmissions']}", flush=True)
    if result["failed"] != 0:
        raise RuntimeError(f"failed requests: {result}")
    if not engine.drained:
        want = args.num_processes - (drain_rank is not None)
        if result["completed"] != len(trace) or result["world"] != want:
            raise RuntimeError(f"the survivor did not finish the trace at "
                               f"world {want}: {result}")
        if drain_rank is not None and result["preempt_readmissions"] <= 0:
            raise RuntimeError("the drain boundary should have re-admitted "
                               f"in-flight sequences: {result}")
        # every rank of the final world ends here: leave it together (a
        # process group left to the interpreter's exit can abort a rank)
        dist.barrier()
        dist.destroy_process_group()
    return 0


def launch(n: int, *, model: str = "tiny", drain_rank: int = -1,
           drain_boundary: int = 4, device=None, requests: int = 24,
           rate: float = 50.0, seed: int = 7, long_frac: float = 0.25,
           unroll: int = 0, max_batch: int = 0, limit: float = 540.0) -> dict:
    """Start ``n`` ranks of the drill, wait for them and judge it; returns
    ``{"ok", "exit", "stdout", "stderr", "results", "completed",
    "drained", "seconds", "dir"}`` (``results``: each rank's
    ``result-p<rank>.json``, ``None`` where it wrote none).
    ``drain_rank=-1`` drains the last rank, ``NO_DRAIN`` (-2) none.  A
    rank still running at ``limit`` seconds is killed and fails the
    drill."""
    from ..parallel.mesh import resolve_device
    from .elastic_training import _read, free_port_base

    device = str(resolve_device(device))
    workdir = tempfile.mkdtemp(prefix="mpx-serving-")
    port_base = free_port_base(n)
    run_env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run_env["PYTHONPATH"] = root + os.pathsep + run_env.get("PYTHONPATH", "")
    common = ["--rendezvous", "file://" + os.path.join(workdir, "rendezvous"),
              "--port-base", str(port_base), "--num-processes", str(n),
              "--device", device, "--model", model,
              "--requests", str(requests), "--rate", repr(rate),
              "--seed", str(seed), "--long-frac", repr(long_frac),
              "--unroll", str(unroll), "--max-batch", str(max_batch),
              "--drain-rank", str(drain_rank),
              "--drain-boundary", str(drain_boundary),
              "--workdir", workdir]
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            fo = open(os.path.join(workdir, f"rank{r}.out"), "w")
            fe = open(os.path.join(workdir, f"rank{r}.err"), "w")
            files.append((fo, fe))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mpi4jax_tpu_torch.models.serving",
                 "--process-id", str(r)] + common,
                env=run_env, stdout=fo, stderr=fe, cwd=root))
        deadline = time.monotonic() + limit
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in files:
            fo.close()
            fe.close()
    res = {"exit": [p.returncode for p in procs], "stdout": [], "stderr": [],
           "results": [], "seconds": time.perf_counter() - t0,
           "dir": workdir}
    for r in range(n):
        res["stdout"].append(_read(os.path.join(workdir, f"rank{r}.out")))
        res["stderr"].append(_read(os.path.join(workdir, f"rank{r}.err")))
        path = os.path.join(workdir, f"result-p{r}.json")
        res["results"].append(json.loads(_read(path))
                              if os.path.exists(path) else None)
    res["completed"] = [r for r in range(n) if res["exit"][r] == 0
                        and DONE_TAG in res["stdout"][r]]
    res["drained"] = [r for r in range(n) if res["exit"][r] == 0
                      and DRAINED_TAG in res["stdout"][r]]
    want_drained = 0 if drain_rank == NO_DRAIN else 1
    res["ok"] = (all(rc == 0 for rc in res["exit"])
                 and len(res["drained"]) == want_drained
                 and len(res["completed"]) == n - want_drained)
    return res


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(PRESETS), default="tiny")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rate", type=float, default=50.0,
                   help="Poisson arrival rate (requests/s)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--long-frac", type=float, default=0.25,
                   help="fraction of requests drawing the heavy-tail "
                        "generation budget")
    p.add_argument("--unroll", type=int, default=0,
                   help="decode megastep trip count (0 = the "
                        "MPI4JAX_TPU_SERVING_UNROLL default)")
    p.add_argument("--max-batch", type=int, default=0,
                   help="0 = the MPI4JAX_TPU_SERVING_MAX_BATCH default")
    p.add_argument("--slo-ms", type=float, default=0.0,
                   help="p99 latency bound (0 = the "
                        "MPI4JAX_TPU_SERVING_SLO_P99_MS default)")
    p.add_argument("--scheduler", choices=("continuous", "static", "both"),
                   default="both")
    p.add_argument("--simulate", action="store_true",
                   help="cost-model replay (serving/sim.py): no device")
    p.add_argument("--ranks", type=int, default=1,
                   help="--simulate: the world size priced (default 1)")
    p.add_argument("--virtual-clock", action="store_true",
                   help="advance arrivals one tick per megastep boundary "
                        "(deterministic across ranks; implied by --launch)")
    p.add_argument("--json", action="store_true",
                   help="print ONLY the JSON payload")
    p.add_argument("--out", default="",
                   help="write the benchmark payload here")
    p.add_argument("--device", default=None,
                   help="the device (default: the GPU; 'cpu' for the CPU)")
    p.add_argument("--launch", type=int, default=0, metavar="N",
                   help="launch an N-process drill world")
    p.add_argument("--drain-rank", type=int, default=-1,
                   help="drill: rank that receives the preemption notice "
                        "(-1 = last, -2 = none)")
    p.add_argument("--drain-boundary", type=int, default=4,
                   help="drill: megastep boundary from which the notice "
                        "lands")
    p.add_argument("--drill-timeout", type=float, default=540.0,
                   help="--launch: seconds before the drill fails")
    p.add_argument("--process-id", type=int, default=-1,
                   help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--port-base", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default="", help=argparse.SUPPRESS)
    p.add_argument("--workdir", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.launch:
        res = launch(args.launch, model=args.model,
                     drain_rank=args.drain_rank,
                     drain_boundary=args.drain_boundary, device=args.device,
                     requests=args.requests, rate=args.rate, seed=args.seed,
                     long_frac=args.long_frac, unroll=args.unroll,
                     max_batch=args.max_batch, limit=args.drill_timeout)
        for r, (rc, out) in enumerate(zip(res["exit"], res["stdout"])):
            sys.stdout.write(f"--- worker {r} (exit {rc}) ---\n{out}")
        print(f"drill: {len(res['completed'])} survivor(s) done, "
              f"{len(res['drained'])} drained, "
              f"{sum(rc != 0 for rc in res['exit'])} failure(s) in "
              f"{res['seconds']:.1f}s -> {'OK' if res['ok'] else 'FAILED'}",
              flush=True)
        return 0 if res["ok"] else 1
    if args.process_id >= 0:
        return run_worker(args)
    return run_benchmark(args)


if __name__ == "__main__":
    sys.exit(main())
