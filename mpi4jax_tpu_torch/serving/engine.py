"""The serving engine: per-bucket programs under the scheduler.

PyTorch counterpart of ``mpi4jax_tpu/serving/engine.py``, where the
stack converges on one loop:

- each ``(phase, bucket)`` pair maps to ONE program, prefill and decode
  separately, decode run as a **megastep** (``unroll=cfg.unroll``) so
  one host call generates N tokens a live lane;
- the scheduler (``serving/scheduler.py``) admits and evicts ONLY at
  megastep boundaries: the batch changes between calls, never inside
  one, and the bucket table pads the live batch up, so churn cannot ask
  for a new program;
- KV state lives in a slot pool (``serving/kvcache.py``) split over the
  tensor-parallel comm by heads; admission binds slot ids, eviction
  frees them: scatters, never a reshape;
- every shape-derived knob is consulted with the PADDED bucket payload
  (``serving/buckets.py:bucket_payload_bytes``);
- elastic drains: a ``resilience.elastic.BoundaryControl`` is polled at
  every megastep boundary.  A preempted rank leaves at the boundary; the
  survivors adopt the store's rebuilt comm, re-shard the committed
  master parameters at the new world size, drop every program, and
  RE-ADMIT every in-flight sequence by re-prefilling it from its
  committed token history (prompt + generated so far, which IS the KV
  state's content): no failed request.

``pin="auto"`` pins when the world has one process (the JAX rule
``jax.process_count() == 1``, with one process a rank): ``compile``
(``aot/pinning.py``), on one CUDA rank a captured CUDA graph, the decode
megastep's N steps in one graph with its carry donated.  On a world of
several processes the programs are ``spmd(comm=, unroll=)`` regions run
eagerly, as a pin there would run them.  The port holds rank-local
tensors (rank ``r`` holds what the JAX engine calls ``global[r]``), so
:meth:`ServingConfig.program_args` gives a rank's shapes, without the
JAX package's leading rank axis.

:class:`ServingConfig` and :func:`warm_manifest` are pure.
"""

from __future__ import annotations

import itertools
import time
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from .buckets import BucketTable, bucket_payload_bytes, declare_buckets
from .kvcache import SlotAllocator, kv_shape
from .metrics import summarize
from .scheduler import ContinuousScheduler, Request, StaticScheduler

__all__ = ["ServingConfig", "ServingEngine", "warm_manifest"]

PHASES = ("prefill", "decode")
# + the elastic replay prefill (a full-width prompt buffer), built at a
# drain boundary
ALL_PHASES = ("prefill", "decode", "replay")

_engine_ids = itertools.count()


@dataclass(frozen=True)
class ServingConfig:
    """Static shape of one serving deployment (pure; hashable).

    ``heads`` and ``ffn`` must divide by every world size the deployment
    can shrink to (24 and 384 cover 1, 2, 3, 4, 6 and 8); ``max_len``
    bounds prompt + generated + a megastep's overshoot.  ``clock`` is
    ``"wall"`` (real time) or ``"virtual"`` (one ``tick_s`` per megastep
    boundary: the deterministic clock a multi-process world needs, since
    every rank of a lockstep host loop must make the same admission
    decisions, which wall clocks cannot promise).
    """

    vocab: int = 64
    heads: int = 24
    head_dim: int = 4
    ffn: int = 384
    max_len: int = 48
    max_prompt: int = 16
    max_batch: int = 8
    buckets: Tuple[int, ...] = ()
    kv_slots: int = 0
    unroll: int = 4
    slo_p99_ms: float = 1000.0
    seed: int = 0
    clock: str = "wall"
    tick_s: float = 0.01

    @property
    def dim(self) -> int:
        return self.heads * self.head_dim

    @classmethod
    def from_env(cls, **overrides) -> "ServingConfig":
        """Defaults from the ``MPI4JAX_TPU_SERVING_*`` variables
        (``utils/config.py``), explicit keyword overrides winning."""
        from ..utils import config

        base = cls(
            max_batch=config.serving_max_batch(),
            kv_slots=config.serving_kv_slots(),
            unroll=config.serving_unroll(),
            slo_p99_ms=config.serving_slo_p99_ms(),
        )
        spec = config.serving_buckets()
        if spec:
            base = replace(base, buckets=BucketTable.from_spec(spec).buckets)
        return replace(base, **overrides) if overrides else base

    def table(self) -> BucketTable:
        if self.buckets:
            t = BucketTable(self.buckets)
            if t.max_batch != self.max_batch:
                raise ValueError(
                    f"bucket table {t.buckets} must top out at max_batch "
                    f"({self.max_batch})"
                )
            return t
        return BucketTable.from_spec("", self.max_batch)

    def slots(self) -> int:
        return self.kv_slots or 2 * self.max_batch

    def validate_world(self, k: int) -> None:
        if k < 1:
            raise ValueError(f"world size must be >= 1, got {k}")
        if self.heads % k or self.ffn % k:
            raise ValueError(
                f"serving config (heads={self.heads}, ffn={self.ffn}) "
                f"cannot shard over {k} ranks: both must divide by every "
                "world size the deployment runs at"
            )
        if self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")
        if not 1 <= self.max_prompt <= self.max_len:
            raise ValueError(
                f"max_prompt ({self.max_prompt}) must be in "
                f"[1, max_len={self.max_len}]"
            )

    def budget_check(self, prompt_len: int, max_new: int) -> None:
        """A request must fit the prompt buffer AND the KV row: prompt +
        generated + one megastep's overshoot + the trailing token
        column."""
        if prompt_len > self.max_prompt:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds max_prompt "
                f"({self.max_prompt}), the admission prefill's padded "
                "width"
            )
        need = prompt_len + max_new + self.unroll + 1
        if need > self.max_len:
            raise ValueError(
                f"request needs up to {need} KV positions (prompt "
                f"{prompt_len} + max_new {max_new} + unroll "
                f"{self.unroll} + 1) but max_len is {self.max_len}"
            )

    # -- program shapes (pure: shared by the engine and the manifest) ------

    def _param_shapes(self, k: int) -> List[Tuple[Tuple[int, ...], str]]:
        hl, fl = self.heads // k, self.ffn // k
        d, dh = self.dim, self.head_dim
        return [
            ((self.vocab, d), "float32"),              # emb
            ((d, 3 * hl * dh), "float32"),             # wqkv
            ((hl * dh, d), "float32"),                 # wo
            ((d, fl), "float32"),                      # w1
            ((fl, d), "float32"),                      # w2
        ]

    def prompt_width(self, phase: str) -> int:
        """The padded prompt width of a prefill-family program:
        ``prefill`` (admission) pads to the tight ``max_prompt``;
        ``replay`` (elastic re-admission of an in-flight sequence from
        its committed history) to the full ``max_len``, since the
        history can be as long as the KV row."""
        return self.max_prompt if phase == "prefill" else self.max_len

    def program_args(self, phase: str, bucket: int,
                     k: int) -> List[Tuple[Tuple[int, ...], str]]:
        """One rank's argument shapes and dtypes of one (phase, bucket)
        program at world size ``k`` (the JAX package's global shapes
        without their leading rank axis)."""
        if phase not in ALL_PHASES:
            raise ValueError(
                f"phase must be one of {ALL_PHASES}, got {phase!r}")
        hl = self.heads // k
        kv = kv_shape(self.slots(), self.max_len, hl, self.head_dim)
        args = self._param_shapes(k) + [
            (kv, "float32"),                           # kk
            (kv, "float32"),                           # vv
            ((self.slots() + 1, self.max_len), "int32"),  # tok_table
        ]
        if phase in ("prefill", "replay"):
            args += [
                ((bucket, self.prompt_width(phase)), "int32"),  # prompts
                ((bucket,), "int32"),                  # plens
                ((bucket,), "int32"),                  # slots
            ]
        else:
            args += [
                ((bucket,), "int32"),                  # last_tok
                ((bucket,), "int32"),                  # lens
                ((bucket,), "int32"),                  # slots
            ]
        return args

    def collective_payload_bytes(self, bucket: int) -> int:
        """Per-collective payload of a decode step at ``bucket``: the
        PADDED bytes every payload-keyed knob is consulted with."""
        return bucket_payload_bytes(bucket, self.dim * 4)

    def workload_meta(self, k: int) -> Dict:
        return {
            "model": (f"tp-decoder d={self.dim} h={self.heads} "
                      f"ffn={self.ffn} L={self.max_len}"),
            "buckets": list(self.table().buckets),
            "kv_slots": self.slots(),
            "unroll": self.unroll,
            "tensor_parallel": k,
        }


def warm_manifest(cfg: ServingConfig, world: int) -> dict:
    """The manifest of EVERY (phase, bucket) program of a deployment, in
    the JAX package's ``aot warm`` schema (the warming command itself is
    ROADMAP Queue 1 item 5).  ``args`` are one rank's shapes.  Pure."""
    cfg.validate_world(world)
    programs = []
    for bucket in cfg.table().buckets:
        for phase in ALL_PHASES:
            fn = "decode_step" if phase == "decode" else "prefill_step"
            programs.append({
                "fn": f"mpi4jax_tpu_torch.serving.model:{fn}",
                "label": f"serving.{phase}.b{bucket}",
                "args": [
                    {"shape": list(shape), "dtype": dtype}
                    for shape, dtype in cfg.program_args(phase, bucket,
                                                         world)
                ],
                # the prefill family pins at 1, so that a fleet-wide
                # MPI4JAX_TPU_UNROLL_DEFAULT never loops a body that is not
                # carry-shaped; decode IS the megastep
                "unroll": cfg.unroll if phase == "decode" else 1,
            })
    return {"programs": programs,
            "meta": {"kind": "serving", "world": world,
                     "buckets": list(cfg.table().buckets)}}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class ServingEngine:
    """One tensor-parallel serving replica (see the module docstring).

    Every rank of ``comm`` builds one with the same config and calls
    :meth:`run` with the same trace.  ``store`` (a ``ShardStore`` built
    over ``comm``) arms the elastic boundary: drains execute between
    megasteps.  The engine computes on ``comm``'s device (the default
    comm's is the GPU)."""

    def __init__(self, cfg: ServingConfig, comm=None, *, store=None,
                 pin: object = "auto"):
        from ..aot.pinning import _one_rank_world
        from ..parallel.region import resolve_comm
        from . import model

        self.cfg = cfg
        self.comm = resolve_comm(comm)
        self.world = int(self.comm.world_size())
        cfg.validate_world(self.world)
        self.table = cfg.table()
        self.store = store
        # the store's comm IS the drain world: a store over another comm
        # would announce boundaries on one world while the engine serves
        # another (the store binds the default comm lazily, so compare uids)
        if store is not None and store.comm.uid != self.comm.uid:
            raise ValueError(
                "the elastic store must be built over the serving comm "
                f"(store comm uid {store.comm.uid} != serving comm uid "
                f"{self.comm.uid})"
            )
        self.master = model.init_master(cfg.vocab, cfg.dim, cfg.heads,
                                        cfg.head_dim, cfg.ffn, cfg.seed)
        if pin == "auto":
            pin = _one_rank_world()
        self.pin = bool(pin)
        self.drained = False
        self._uid = next(_engine_ids)
        self._programs: Dict[Tuple[str, int], object] = {}
        self._alloc = SlotAllocator(cfg.slots())
        self._phase_seq = {p: 0 for p in ALL_PHASES}
        self._boundary = 0
        self._state = None   # (emb, wqkv, wo, w1, w2, kk, vv, tok)
        # the port's record of each world change this engine lived through
        # (the boundary, the new world, the wall clock at its start, the
        # seconds of the rebuild and of the replay prefill, the sequences
        # re-admitted)
        self.world_changes: List[dict] = []
        self._build_device_state()

    @property
    def device(self):
        return self.comm.device

    # -- device state ------------------------------------------------------

    def _build_device_state(self) -> None:
        import torch

        from . import model

        k, dev = self.world, self.device
        hl = self.cfg.heads // k
        params = model.shard_params(self.master, k, self.comm.Get_rank(), dev)
        kv = kv_shape(self.cfg.slots(), self.cfg.max_len, hl,
                      self.cfg.head_dim)
        self._state = params + (
            torch.zeros(kv, dtype=torch.float32, device=dev),
            torch.zeros(kv, dtype=torch.float32, device=dev),
            torch.zeros((self.cfg.slots() + 1, self.cfg.max_len),
                        dtype=torch.int32, device=dev))

    def _prep(self, arr):
        """A host array as a program input on this rank's device."""
        import numpy as np
        import torch

        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _lane(self, values, fill):
        """A per-lane int32 tensor [bucket], padded with ``fill``."""
        import numpy as np

        bucket = self.table.bucket_for(len(values))
        row = np.full((bucket,), fill, np.int32)
        row[:len(values)] = np.asarray(values, np.int32)
        return self._prep(row)

    @staticmethod
    def _host(x):
        """A tensor on the host, as numpy."""
        return x.detach().cpu().numpy()

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- programs ----------------------------------------------------------

    def _program(self, phase: str, bucket: int, args: tuple):
        """The (phase, bucket) program, built at its first call with that
        call's arguments (a pin's warm-up and capture run on copies of
        them)."""
        key = (phase, bucket)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        from . import model

        fn = model.decode_step if phase == "decode" else model.prefill_step
        unroll = self.cfg.unroll if phase == "decode" else 1
        if self.pin:
            from ..aot.pinning import compile as aot_compile

            # the decode carry is donated: the graph writes its output
            # back into its input buffers, so a call that passes the
            # previous call's state copies nothing but the lanes
            donate = tuple(range(len(args))) if phase == "decode" else ()
            prog = aot_compile(fn, *args, comm=self.comm, unroll=unroll,
                               donate_argnums=donate)
        else:
            from ..parallel.region import spmd

            prog = spmd(comm=self.comm, unroll=unroll)(fn)
        self._programs[key] = prog
        self._meter(f"serving.programs.{phase}")
        return prog

    # -- telemetry ---------------------------------------------------------

    def _meter(self, name: str, n: int = 1) -> None:
        from ..telemetry import core as tcore

        tcore.meter(name, n)

    @contextmanager
    def _phase(self, phase: str, bucket: int, nbytes: int):
        """The per-phase serving bracket: one op-table row per (phase,
        bucket) (``serving.<phase>``, algo ``b<bucket>``) with its
        latencies, and under ``events`` a journal begin and end whose call
        id is the same on every process."""
        from ..telemetry import core as tcore

        if tcore.effective_mode() == "off":
            yield
            return
        from ..telemetry import journal

        key = tcore.op_key(f"serving.{phase}", self.comm.uid,
                           f"b{bucket}", "")
        events = tcore.events_on()
        call_id = None
        rank = journal.process_index()
        if events:
            call_id = f"srv{self._uid}.{phase}.{self._phase_seq[phase]}"
            self._phase_seq[phase] += 1
            journal.begin(call_id, rank, {
                "op": f"serving.{phase}", "comm_uid": self.comm.uid,
                "bucket": bucket, "bytes": nbytes, "dtype": "",
                "unroll": self.cfg.unroll if phase == "decode" else 1,
            })
        t0 = time.perf_counter()
        try:
            yield
        finally:
            # closed even when the call raises: an unmatched begin would
            # break the cross-process pairing of the journals
            dt = time.perf_counter() - t0
            tcore.count_host_op(key, nbytes)
            if events:
                journal.end(call_id, rank, {"algo": f"b{bucket}"})
            else:
                tcore.record_latency(key, dt)

    # -- phases ------------------------------------------------------------

    def _prefill(self, seqs, phase: str = "prefill") -> None:
        import numpy as np

        bucket = self.table.bucket_for(len(seqs))
        width = self.cfg.prompt_width(phase)
        prompts = np.zeros((bucket, width), np.int32)
        for i, s in enumerate(seqs):
            row = s.tokens
            if len(row) > width:
                raise RuntimeError(
                    f"{phase} history of {len(row)} tokens exceeds the "
                    f"padded prompt width {width}"
                )
            prompts[i, :len(row)] = row
        args = self._state + (
            self._prep(prompts),
            self._lane([len(s.tokens) for s in seqs], 1),
            self._lane([s.slot for s in seqs], self._alloc.scratch))
        nbytes = bucket_payload_bytes(bucket, width * self.cfg.dim * 4)
        with self._phase(phase, bucket, nbytes):
            out = self._program(phase, bucket, args)(*args)
            self._sync()
        kk, vv, tok, _first = out
        self._state = self._state[:5] + (kk, vv, tok)
        self._meter("serving.prefills")

    def _decode(self) -> None:
        seqs = self._sched.running
        bucket = self.table.bucket_for(len(seqs))
        args = self._state + (
            self._lane([s.tokens[-1] for s in seqs], 0),
            self._lane([len(s.tokens) - 1 for s in seqs], 0),
            self._lane([s.slot for s in seqs], self._alloc.scratch))
        with self._phase("decode", bucket,
                         self.cfg.collective_payload_bytes(bucket)):
            out = self._program("decode", bucket, args)(*args)
            self._sync()
        self._state = tuple(out[:8])
        self._meter("serving.megasteps")

    def _collect_tokens(self, seqs, stride: int, now: float) -> int:
        """Read newly generated tokens off the token table (the same on
        every rank).  A lane's token columns run through
        ``len(tokens) - 1``; the call just made appended ``stride`` more
        (1 for prefill, ``unroll`` for a decode megastep)."""
        tok = self._host(self._state[7])
        produced = 0
        for s in seqs:
            have = len(s.tokens)
            fresh = tok[s.slot][have:min(self.cfg.max_len, have + stride)]
            if len(fresh):
                s.record(fresh, now)
                produced += len(fresh)
        return produced

    # -- elastic boundary --------------------------------------------------

    def _world_changed(self) -> None:
        """Survivor side of a drain: adopt the store's rebuilt comm,
        re-shard the committed master at the new world size, drop every
        program (each was built over the old comm), and re-admit the
        in-flight sequences by re-prefilling their committed history."""
        at, t0 = time.time(), time.perf_counter()
        self.comm = self.store.comm
        self.world = int(self.comm.world_size())
        self.cfg.validate_world(self.world)
        self._programs.clear()
        self._build_device_state()
        rec = {"boundary": self._boundary, "world": self.world, "at": at,
               "rebuild_s": time.perf_counter() - t0, "readmitted": 0,
               "replay_s": None}
        self.world_changes.append(rec)
        # pull every in-flight sequence out of the OLD slot pool, then swap
        # in a fresh pool (the KV tensors were rebuilt empty) and point the
        # scheduler at it before re-seating
        moved = self._sched.requeue_running()
        self._alloc = SlotAllocator(self.cfg.slots())
        self._sched.alloc = self._alloc
        if moved:
            # at most max_batch sequences (the scheduler's residency cap),
            # so one full-width replay prefill re-seats them all: the
            # history becomes the prompt and rebuilds the KV content; the
            # token it samples is the sequence's NEXT token, which the next
            # decode megastep writes into the table again before the host
            # reads it
            self._sched.readmit(moved)
            self._meter("serving.readmissions", len(moved))
            t1 = time.perf_counter()
            self._prefill(moved, phase="replay")
            rec.update(readmitted=len(moved),
                       replay_s=time.perf_counter() - t1)

    # -- the loop ----------------------------------------------------------

    def _now(self, t0: float) -> float:
        if self.cfg.clock == "virtual":
            return self._boundary * self.cfg.tick_s
        return time.monotonic() - t0

    def run(self, trace: List[Request], *, scheduler: str = "continuous",
            max_boundaries: Optional[int] = None) -> Dict:
        """Serve ``trace`` to completion; returns the metric block of
        ``serving/metrics.summarize`` plus ``boundaries``, ``programs``,
        ``drained`` and ``world``.  A drained rank (elastic preemption)
        returns early with ``self.drained`` set: its in-flight sequences
        continue on the survivors, so it reports zero failures."""
        from ..parallel import megastep as _megastep
        from ..resilience.elastic import BoundaryControl
        from .buckets import clear_declared_buckets, declared_buckets

        if self.drained:
            raise RuntimeError(
                "this engine drained out of its world (elastic "
                "preemption); build a fresh ServingEngine over the "
                "current comm"
            )
        sched_cls = (ContinuousScheduler if scheduler == "continuous"
                     else StaticScheduler)
        self._alloc.reset()
        self._sched = sched_cls(self.table, self._alloc)
        self._boundary = 0
        for r in trace:
            self.cfg.budget_check(r.prompt_len, r.max_new_tokens)

        # the declaration is scoped to the serving loop
        prev_table = declared_buckets()
        declare_buckets(self.table)

        boundary = BoundaryControl(self.store) if self.store is not None \
            else None
        if boundary is not None and self.store.committed_step is None:
            # what a survivor re-shards after a world change; parameters
            # are static in serving, so ONE commit covers the whole run
            self.store.commit(0, {"params": self.master})

        t0 = time.monotonic()
        wall0 = time.perf_counter()
        try:
            if boundary is not None:
                boundary.__enter__()
            while not self._sched.idle(trace):
                now = self._now(t0)
                self._sched.offer(trace, now)
                new = self._sched.admit(now)
                if new:
                    self._meter("serving.requests_admitted", len(new))
                    self._prefill(new)
                    self._collect_tokens(new, 1, self._now(t0))
                if self._sched.running:
                    self._decode()
                    self._collect_tokens(self._sched.running,
                                         self.cfg.unroll, self._now(t0))
                elif self.cfg.clock == "wall":
                    nxt = self._sched.next_arrival_s(trace)
                    if nxt is not None:
                        time.sleep(min(0.05, max(0.0, nxt - now)))
                done = self._sched.finish_ready(self._now(t0))
                if done:
                    self._meter("serving.requests_completed", len(done))
                self._boundary += 1
                _megastep.run_boundary_hooks(self._boundary, engine=self)
                if boundary is not None:
                    outcome = boundary.poll(
                        self._boundary, {"params": self.master},
                        committed=True)
                    if outcome is not None:
                        if outcome[0] == "leave":
                            self.drained = True
                            break
                        self._world_changed()
                if max_boundaries is not None \
                        and self._boundary >= max_boundaries:
                    break
        finally:
            if boundary is not None:
                boundary.__exit__(None, None, None)
            if prev_table is not None:
                declare_buckets(prev_table)
            else:
                clear_declared_buckets()

        wall = time.perf_counter() - wall0
        if self.cfg.clock == "virtual":
            wall = self._boundary * self.cfg.tick_s
        finished = self._sched.finished
        failed = 0 if self.drained else len(trace) - len(finished)
        self._meter("serving.tokens_generated",
                    sum(len(s.generated) for s in finished))
        if failed:
            self._meter("serving.requests_failed", failed)
        out = summarize(finished, wall_s=wall, chips=self.world,
                        slo_p99_ms=self.cfg.slo_p99_ms, failed=failed,
                        scheduler=scheduler)
        out["boundaries"] = self._boundary
        out["programs"] = sorted(f"{p}.b{b}" for p, b in self._programs)
        out["drained"] = self.drained
        out["world"] = self.world
        return out
