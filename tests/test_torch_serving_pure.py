"""The port's serving runtime (``mpi4jax_tpu_torch/serving/``) without ranks,
against the JAX package's.

The cases of ``tests/test_serving_pure.py`` that need neither the
cost-model replay nor the analysis layer (ROADMAP Queue 1 items 5 and
6), driven against the port's modules: the bucket table and registry,
the KV slot allocator, ``poisson_trace`` (the JAX function's requests
for three seeds, exactly), both schedulers, ``summarize`` and
``bench_payload`` (equal to the JAX functions' on the same sequences),
``ServingConfig`` (the serving variables, validation, one rank's program
shapes: the JAX package's global shapes without the leading rank axis),
``warm_manifest`` (the JAX manifest's schema with the port's function
names) and the boundary hooks.  The model: ``init_master`` bit for bit
with the JAX package's, ``convert.serving_state_from_jax`` bit for bit
with the port's ``shard_params``, and ``prefill_step`` and
``decode_step`` on one CPU rank against the JAX functions on a
one-device mesh: the tokens equal, K/V and every other float within
rtol 1e-5, atol 1e-6 (XLA and PyTorch accumulate the products in
another order), the live rows only (the scratch row takes the padding
lanes' writes, whose order is unspecified), and each call leaving its
arguments as they were.  A one-rank engine run on the CPU feeds the
health plane's serving gauges.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch import Comm, convert, make_world_mesh, spmd  # noqa: E402
from mpi4jax_tpu_torch.parallel import megastep  # noqa: E402
from mpi4jax_tpu_torch.serving import (  # noqa: E402
    buckets,
    engine,
    kvcache,
    metrics,
    model,
    scheduler,
)
from mpi4jax_tpu_torch.utils import config  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

jsched = importlib.import_module("mpi4jax_tpu.serving.scheduler")
jmetrics = importlib.import_module("mpi4jax_tpu.serving.metrics")
jengine = importlib.import_module("mpi4jax_tpu.serving.engine")
jmodel = importlib.import_module("mpi4jax_tpu.serving.model")

SERVING_FLAGS = ("MPI4JAX_TPU_SERVING_MAX_BATCH",
                 "MPI4JAX_TPU_SERVING_BUCKETS",
                 "MPI4JAX_TPU_SERVING_KV_SLOTS",
                 "MPI4JAX_TPU_SERVING_UNROLL",
                 "MPI4JAX_TPU_SERVING_SLO_P99_MS")
RTOL, ATOL = 1e-5, 1e-6
# tests/test_serving.py:77-82
TINY = dict(vocab=32, heads=8, head_dim=2, ffn=32, max_len=32,
            max_prompt=8, max_batch=4, kv_slots=8, unroll=2,
            slo_p99_ms=60_000.0, clock="virtual", seed=11)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in SERVING_FLAGS:
        monkeypatch.delenv(name, raising=False)
    buckets.clear_declared_buckets()
    yield
    buckets.clear_declared_buckets()


# ---------------------------------------------------------------------------
# bucket table
# ---------------------------------------------------------------------------


def test_powers_of_two():
    assert buckets.powers_of_two(8) == (1, 2, 4, 8)
    assert buckets.powers_of_two(1) == (1,)
    assert buckets.powers_of_two(6) == (1, 2, 4, 6)
    with pytest.raises(ValueError):
        buckets.powers_of_two(0)


def test_bucket_for_and_pad():
    t = buckets.BucketTable((1, 2, 4, 8))
    assert [t.bucket_for(n) for n in (1, 2, 3, 4, 5, 8)] == \
        [1, 2, 4, 4, 8, 8]
    assert t.pad(5) == 3 and t.pad(8) == 0
    assert t.max_batch == 8
    assert 4 in t and 5 not in t
    with pytest.raises(ValueError):
        t.bucket_for(0)
    with pytest.raises(ValueError):
        t.bucket_for(9)


@pytest.mark.parametrize("bad", [(), (0, 2), (2, 1), (1, 1, 2), (1, -4)])
def test_bucket_table_rejects(bad):
    with pytest.raises(ValueError):
        buckets.BucketTable(bad)


def test_bucket_spec_parsing():
    assert buckets.BucketTable.from_spec("", 8).buckets == (1, 2, 4, 8)
    assert buckets.BucketTable.from_spec("1,3,6").buckets == (1, 3, 6)
    with pytest.raises(ValueError):
        buckets.BucketTable.from_spec("1,two")
    with pytest.raises(ValueError):
        buckets.BucketTable.from_spec("")


def test_declared_registry():
    assert buckets.declared_buckets() is None
    t = buckets.declare_buckets((1, 2, 4))
    assert buckets.declared_buckets() is t
    t2 = buckets.declare_buckets(buckets.BucketTable((1, 8)))
    assert buckets.declared_buckets() is t2
    buckets.clear_declared_buckets()
    assert buckets.declared_buckets() is None


def test_bucket_payload_bytes():
    assert buckets.bucket_payload_bytes(8, 96 * 4) == 8 * 96 * 4
    with pytest.raises(ValueError):
        buckets.bucket_payload_bytes(0, 4)


# ---------------------------------------------------------------------------
# slot allocator
# ---------------------------------------------------------------------------


def test_slot_allocator_deterministic_order():
    a = kvcache.SlotAllocator(4)
    assert [a.alloc() for _ in range(4)] == [0, 1, 2, 3]
    a.free_slot(2)
    a.free_slot(0)
    # freed slots come back lowest first, whatever the order they were freed
    assert a.alloc() == 0 and a.alloc() == 2
    assert a.free() == 0


def test_slot_allocator_errors():
    a = kvcache.SlotAllocator(1)
    with pytest.raises(ValueError):
        a.free_slot(0)          # not allocated
    s = a.alloc()
    with pytest.raises(RuntimeError):
        a.alloc()               # exhausted
    a.free_slot(s)
    assert a.scratch == 1       # outside the pool
    with pytest.raises(ValueError):
        kvcache.SlotAllocator(0)


def test_kv_writes_are_out_of_place():
    """``scatter_step`` and ``scatter_prefill`` return new tensors and leave
    their arguments as they were (the JAX package's ``.at[].set``)."""
    kv = torch.zeros(kvcache.kv_shape(3, 5, 2, 2))
    slots = torch.tensor([2, 0], dtype=torch.int32)
    lens = torch.tensor([1, 4], dtype=torch.int32)
    new = torch.ones(2, 2, 2)
    out = kvcache.scatter_step(kv, slots, lens, new)
    assert float(kv.abs().sum()) == 0.0
    assert torch.equal(out[2, 1], new[0]) and torch.equal(out[0, 4], new[1])
    assert float(out.sum()) == 8.0
    pre = kvcache.scatter_prefill(kv, slots, torch.ones(2, 3, 2, 2))
    assert float(kv.abs().sum()) == 0.0
    assert float(pre[2, :3].sum()) == 12.0 and float(pre[0, :3].sum()) == 12.0
    assert float(pre.sum()) == 24.0


# ---------------------------------------------------------------------------
# trace generator
# ---------------------------------------------------------------------------


def _req_tuple(r):
    return (r.rid, r.arrival_s, r.prompt, r.max_new_tokens)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_poisson_trace_is_the_jax_trace(seed):
    """Both packages draw from ``random.Random(seed)`` in one order: the
    same requests, bit for bit, heavy tail included."""
    kw = dict(seed=seed, prompt_len=(2, 6), max_new=(4, 18),
              long_frac=0.25, long_new=(96, 139), vocab=64)
    got = scheduler.poisson_trace(24, 50.0, **kw)
    want = jsched.poisson_trace(24, 50.0, **kw)
    assert [_req_tuple(r) for r in got] == [_req_tuple(r) for r in want]


def test_poisson_trace_deterministic():
    a = scheduler.poisson_trace(32, 100.0, seed=3, long_frac=0.25,
                                long_new=(32, 64))
    b = scheduler.poisson_trace(32, 100.0, seed=3, long_frac=0.25,
                                long_new=(32, 64))
    assert [(r.arrival_s, r.prompt, r.max_new_tokens) for r in a] == \
        [(r.arrival_s, r.prompt, r.max_new_tokens) for r in b]
    c = scheduler.poisson_trace(32, 100.0, seed=4)
    assert [r.arrival_s for r in a] != [r.arrival_s for r in c]


def test_poisson_trace_shape():
    trace = scheduler.poisson_trace(64, 100.0, seed=0, prompt_len=(2, 5),
                                    max_new=(4, 8), long_frac=0.5,
                                    long_new=(20, 30))
    arrivals = [r.arrival_s for r in trace]
    assert arrivals == sorted(arrivals) and arrivals[0] > 0
    assert all(2 <= r.prompt_len <= 5 for r in trace)
    assert all(4 <= r.max_new_tokens <= 8 or 20 <= r.max_new_tokens <= 30
               for r in trace)
    assert any(r.max_new_tokens >= 20 for r in trace)
    with pytest.raises(ValueError):
        scheduler.poisson_trace(0, 1.0)
    with pytest.raises(ValueError):
        scheduler.poisson_trace(1, 0.0)
    with pytest.raises(ValueError):
        scheduler.poisson_trace(1, 1.0, long_frac=1.5)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def _mktrace(n, arrival=0.0, max_new=4):
    return [scheduler.Request(rid=i, arrival_s=arrival, prompt=(1, 2),
                              max_new_tokens=max_new) for i in range(n)]


def _sched(cls=scheduler.ContinuousScheduler, max_batch=4, slots=8):
    table = buckets.BucketTable.from_spec("", max_batch)
    return cls(table, kvcache.SlotAllocator(slots))


def test_admission_fifo_and_bounds():
    s = _sched(max_batch=4, slots=8)
    trace = _mktrace(6)
    assert s.offer(trace, now=0.0) == 6
    new = s.admit(0.0)
    # FIFO, bounded by max_batch
    assert [q.rid for q in new] == [0, 1, 2, 3]
    assert len(s.waiting) == 2
    assert s.decode_bucket() == 4
    # a finished sequence frees its lane and slot; the next boundary admits
    s.running[0].record([9] * 4, 1.0)
    done = s.finish_ready(1.0)
    assert [q.rid for q in done] == [0]
    assert [q.rid for q in s.admit(1.0)] == [4]


def test_admission_slot_bound():
    s = _sched(max_batch=8, slots=2)
    s.offer(_mktrace(5), 0.0)
    assert len(s.admit(0.0)) == 2  # the KV budget binds before max_batch
    assert s.alloc.free() == 0


def test_static_scheduler_gates_on_drain():
    s = _sched(cls=scheduler.StaticScheduler, max_batch=4, slots=8)
    s.offer(_mktrace(8), 0.0)
    assert len(s.admit(0.0)) == 4
    s.running[0].record([9] * 4, 0.5)
    s.finish_ready(0.5)
    # the batch has not drained: nothing admitted
    assert s.admit(0.5) == []
    for q in list(s.running):
        q.record([9] * 4, 1.0)
    s.finish_ready(1.0)
    # drained: the next WHOLE batch comes in at once
    assert len(s.admit(1.0)) == 4


def test_sequence_record_caps_overshoot():
    q = scheduler.Sequence(request=_mktrace(1, max_new=3)[0], slot=0,
                           admitted_s=0.0)
    q.record([5, 6, 7, 8], 1.0)   # a megastep overshoots by one
    assert q.generated == [5, 6, 7] and q.done
    assert q.finish_s == 1.0 and q.first_token_s == 1.0
    assert q.tokens == (1, 2, 5, 6, 7)


def test_requeue_and_readmit():
    s = _sched(max_batch=4, slots=4)
    s.offer(_mktrace(3), 0.0)
    s.admit(0.0)
    moved = s.requeue_running()
    assert len(moved) == 3 and not s.running and s.alloc.free() == 4
    s.readmit(moved)
    assert [q.rid for q in s.running] == [0, 1, 2]
    assert all(q.preempt_readmissions == 1 for q in s.running)


def test_idle():
    s = _sched()
    trace = _mktrace(1, arrival=5.0)
    assert not s.idle(trace)          # not offered yet
    s.offer(trace, 10.0)
    s.admit(10.0)
    assert not s.idle(trace)
    s.running[0].record([9] * 4, 11.0)
    s.finish_ready(11.0)
    assert s.idle(trace)
    assert s.next_arrival_s(trace) is None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_percentile():
    assert metrics.percentile([], 0.5) is None
    assert metrics.percentile([3.0], 0.99) == 3.0
    vals = [float(i) for i in range(1, 101)]
    assert metrics.percentile(vals, 0.5) == 51.0
    assert metrics.percentile(vals, 0.99) == 99.0
    with pytest.raises(ValueError):
        metrics.percentile([1.0], 1.5)


def _finished(mod, n=5):
    done = []
    for i, r in enumerate(mod.poisson_trace(n, 40.0, seed=2)):
        q = mod.Sequence(request=r, slot=i, admitted_s=r.arrival_s)
        q.record([5] * r.max_new_tokens, r.arrival_s + 0.01 * (i + 1))
        done.append(q)
    return done


def test_summarize_and_bench_payload():
    trace = _mktrace(2, arrival=1.0, max_new=2)
    done = []
    for i, r in enumerate(trace):
        q = scheduler.Sequence(request=r, slot=i, admitted_s=1.0)
        q.record([5, 5], 1.0 + 0.1 * (i + 1))
        done.append(q)
    cont = metrics.summarize(done, wall_s=2.0, chips=4, slo_p99_ms=500.0)
    assert cont["completed"] == 2 and cont["failed"] == 0
    assert cont["tokens"] == 4
    assert cont["tokens_per_s_per_chip"] == round(4 / 2.0 / 4, 3)
    assert cont["p99_ms"] == pytest.approx(200.0)
    assert cont["slo_met"] is True
    stat = dict(cont, tokens_per_s_per_chip=0.25, scheduler="static")
    payload = metrics.bench_payload(
        workload={"model": "m"}, trace_meta={"requests": 2}, chips=4,
        continuous=cont, static=stat, environment="test")
    assert payload["schema"] == metrics.BENCH_SCHEMA == "mpx-serving-bench/1"
    assert payload["speedup_tokens_per_s"] == \
        round(cont["tokens_per_s_per_chip"] / 0.25, 3)
    assert payload["slo_p99_ms"] == 500.0


def test_summarize_and_payload_equal_jax():
    got = metrics.summarize(_finished(scheduler), wall_s=0.3, chips=2,
                            slo_p99_ms=150.0, failed=1, scheduler="static")
    want = jmetrics.summarize(_finished(jsched), wall_s=0.3, chips=2,
                              slo_p99_ms=150.0, failed=1, scheduler="static")
    assert got == want
    kw = dict(workload={"model": "m"}, trace_meta={"requests": 5}, chips=2,
              static=dict(got, tokens_per_s_per_chip=7.0),
              environment="e", provenance={"p": 1})
    assert metrics.bench_payload(continuous=got, **kw) == \
        jmetrics.bench_payload(continuous=want, **kw)


def test_summarize_slo_violation():
    r = _mktrace(1, arrival=0.0, max_new=1)[0]
    q = scheduler.Sequence(request=r, slot=0, admitted_s=0.0)
    q.record([5], 2.0)
    out = metrics.summarize([q], wall_s=2.0, chips=1, slo_p99_ms=100.0)
    assert out["p99_ms"] == pytest.approx(2000.0)
    assert out["slo_met"] is False


# ---------------------------------------------------------------------------
# serving config, program shapes, the manifest
# ---------------------------------------------------------------------------


def test_config_from_env(monkeypatch):
    cfg = engine.ServingConfig.from_env()
    assert cfg.max_batch == config.DEFAULT_SERVING_MAX_BATCH == 8
    assert cfg.unroll == config.DEFAULT_SERVING_UNROLL == 4
    assert cfg.slo_p99_ms == config.DEFAULT_SERVING_SLO_P99_MS == 1000.0
    assert cfg.table().buckets == (1, 2, 4, 8)
    assert cfg.slots() == 2 * cfg.max_batch
    monkeypatch.setenv("MPI4JAX_TPU_SERVING_MAX_BATCH", "4")
    monkeypatch.setenv("MPI4JAX_TPU_SERVING_BUCKETS", "2,4")
    monkeypatch.setenv("MPI4JAX_TPU_SERVING_KV_SLOTS", "5")
    monkeypatch.setenv("MPI4JAX_TPU_SERVING_UNROLL", "2")
    monkeypatch.setenv("MPI4JAX_TPU_SERVING_SLO_P99_MS", "250")
    cfg = engine.ServingConfig.from_env()
    assert cfg.max_batch == 4 and cfg.buckets == (2, 4)
    assert cfg.slots() == 5 and cfg.unroll == 2
    assert cfg.slo_p99_ms == 250.0
    jcfg = jengine.ServingConfig.from_env()
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    # explicit overrides win over the environment
    assert engine.ServingConfig.from_env(unroll=8).unroll == 8


@pytest.mark.parametrize("name,raw", [
    ("MPI4JAX_TPU_SERVING_MAX_BATCH", "0"),
    ("MPI4JAX_TPU_SERVING_MAX_BATCH", "eight"),
    ("MPI4JAX_TPU_SERVING_KV_SLOTS", "-1"),
    ("MPI4JAX_TPU_SERVING_UNROLL", "0"),
    ("MPI4JAX_TPU_SERVING_SLO_P99_MS", "0"),
    ("MPI4JAX_TPU_SERVING_SLO_P99_MS", "nan"),
    ("MPI4JAX_TPU_SERVING_BUCKETS", "4,2"),
])
def test_config_from_env_rejects_what_jax_rejects(monkeypatch, name, raw):
    """A value the JAX package refuses, the port refuses with its
    message."""
    monkeypatch.setenv(name, raw)
    with pytest.raises(ValueError) as got:
        engine.ServingConfig.from_env()
    with pytest.raises(ValueError) as want:
        jengine.ServingConfig.from_env()
    assert str(got.value) == str(want.value)


def test_serving_flags_are_config_flags():
    for name in SERVING_FLAGS:
        assert name in config.FLAG_NAMES


def test_config_validation():
    cfg = engine.ServingConfig()           # heads=24, ffn=384
    cfg.validate_world(8)
    cfg.validate_world(3)
    with pytest.raises(ValueError):
        cfg.validate_world(5)              # 24 % 5 != 0
    with pytest.raises(ValueError):
        engine.ServingConfig(max_prompt=0).validate_world(1)
    with pytest.raises(ValueError):
        # the bucket table must top out at max_batch
        engine.ServingConfig(buckets=(1, 2), max_batch=8).table()
    cfg.budget_check(8, 16)
    with pytest.raises(ValueError):
        cfg.budget_check(cfg.max_prompt + 1, 1)
    with pytest.raises(ValueError):
        cfg.budget_check(4, cfg.max_len)   # cannot fit the KV row


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("phase", ["prefill", "decode", "replay"])
def test_program_args_are_one_ranks_jax_shapes(phase, k):
    """A rank's shapes: the JAX package's global shapes without their
    leading rank axis, the same dtypes."""
    for cfg_kw in ({}, dict(TINY)):
        cfg = engine.ServingConfig(**cfg_kw)
        jcfg = jengine.ServingConfig(**cfg_kw)
        for bucket in cfg.table().buckets:
            got = cfg.program_args(phase, bucket, k)
            want = jcfg.program_args(phase, bucket, k)
            assert got == [(shape[1:], dt) for shape, dt in want]
            assert all(shape[0] == k for shape, _ in want)
    with pytest.raises(ValueError):
        engine.ServingConfig().program_args("sample", 4, k)


def test_collective_payload_is_padded():
    cfg = engine.ServingConfig()
    # the decode payload comes from the BUCKET, so two live batches of one
    # bucket consult every payload-keyed knob with the same bytes
    assert cfg.collective_payload_bytes(4) == 4 * cfg.dim * 4
    t = cfg.table()
    assert t.bucket_for(3) == t.bucket_for(4) == 4
    assert cfg.workload_meta(4) == jengine.ServingConfig().workload_meta(4)


@pytest.mark.parametrize("world", [1, 3, 8])
def test_warm_manifest_is_the_jax_schema(world):
    cfg = engine.ServingConfig()
    man = engine.warm_manifest(cfg, world)
    jman = jengine.warm_manifest(jengine.ServingConfig(), world)
    assert man["meta"] == jman["meta"]
    assert len(man["programs"]) == len(jman["programs"]) == \
        3 * len(cfg.table().buckets)
    for got, want in zip(man["programs"], jman["programs"]):
        assert set(got) == set(want) == {"fn", "label", "args", "unroll"}
        assert got["label"] == want["label"]
        assert got["unroll"] == want["unroll"] == (
            cfg.unroll if ".decode." in got["label"] else 1)
        assert got["fn"] == want["fn"].replace("mpi4jax_tpu.",
                                               "mpi4jax_tpu_torch.", 1)
        assert got["fn"].startswith("mpi4jax_tpu_torch.serving.model:")
        assert [a["dtype"] for a in got["args"]] == \
            [a["dtype"] for a in want["args"]]
        assert [a["shape"] for a in got["args"]] == \
            [a["shape"][1:] for a in want["args"]]
    with pytest.raises(ValueError):
        engine.warm_manifest(cfg, 5)     # a world that cannot shard it


# ---------------------------------------------------------------------------
# megastep boundary hooks
# ---------------------------------------------------------------------------


def test_boundary_hooks_order_and_unregister():
    calls = []
    u1 = megastep.register_boundary_hook("a", lambda s, **kw: calls.append(
        ("a", s, kw.get("engine"))))
    u2 = megastep.register_boundary_hook("b", lambda s, **kw: calls.append(
        ("b", s, None)))
    try:
        out = megastep.run_boundary_hooks(7, engine="E")
        assert [n for n, _ in out] == ["a", "b"]
        assert calls == [("a", 7, "E"), ("b", 7, None)]
    finally:
        u1()
        u2()
    assert megastep.run_boundary_hooks(8) == []
    u1()  # a second unregister does nothing
    with pytest.raises(TypeError):
        megastep.register_boundary_hook("bad", None)


def test_boundary_hook_exceptions_propagate():
    def boom(step, **kw):
        raise RuntimeError("stop the loop")

    u = megastep.register_boundary_hook("boom", boom)
    try:
        with pytest.raises(RuntimeError):
            megastep.run_boundary_hooks(1)
    finally:
        u()


# ---------------------------------------------------------------------------
# the model against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(32, 16, 8, 2, 32, 11), (64, 96, 24, 4, 384, 0),
                                  (64, 1536, 24, 64, 6144, 7)])
def test_init_master_bit_for_bit(dims):
    got = model.init_master(*dims)
    want = jmodel.init_master(*dims)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == want[name].dtype == np.float32
        assert got[name].tobytes() == want[name].tobytes()
    with pytest.raises(ValueError):
        model.init_master(32, 17, 8, 2, 32)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_shards_and_convert_bit_for_bit(k):
    """``global_params`` is the JAX package's ``shard_params``, and
    ``convert.serving_state_from_jax`` of it (the 5 parameter arrays, and
    the 8 of an engine's state) gives each rank the port's
    ``shard_params`` bit for bit."""
    master = model.init_master(32, 16, 8, 2, 32, 11)
    glob = model.global_params(master, k)
    jglob = jmodel.shard_params(master, k)
    for a, b in zip(glob, jglob):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    kv = np.random.default_rng(0).standard_normal(
        (k,) + kvcache.kv_shape(8, 32, 8 // k, 2)).astype(np.float32)
    tok = np.arange(k * 9 * 32, dtype=np.int32).reshape(k, 9, 32)
    for r in range(k):
        mine = model.shard_params(master, k, r, "cpu")
        five = convert.serving_state_from_jax(jglob, r, device="cpu")
        eight = convert.serving_state_from_jax(
            jglob + (kv, kv * 2, tok), r, device="cpu")
        assert len(five) == 5 and len(eight) == 8
        for a, b, c in zip(mine, five, eight):
            assert a.dtype == b.dtype == c.dtype == torch.float32
            assert torch.equal(a, b) and torch.equal(a, c)
        assert eight[5].numpy().tobytes() == kv[r].tobytes()
        assert eight[7].dtype == torch.int32
        assert eight[7].numpy().tobytes() == tok[r].tobytes()
    with pytest.raises(ValueError):
        convert.serving_state_from_jax(jglob[:4], 0, device="cpu")
    with pytest.raises(ValueError):
        model.shard_params(master, 3, 0)       # 8 heads over 3 ranks


def _one_rank_comm():
    mesh = make_world_mesh(device="cpu")
    return Comm(mesh.axes[0], mesh=mesh)


def _jax_one_device():
    import jax

    import mpi4jax_tpu as mpx

    mesh = mpx.make_world_mesh((1,), ("i",), devices=jax.devices()[:1])
    return jax, mpx, mpx.Comm("i", mesh=mesh)


def _lanes(cfg):
    """tests/test_serving.py:_manual_args on one rank."""
    bucket = cfg.table().bucket_for(2)
    rng = np.random.default_rng(3)
    prompts = np.zeros((bucket, cfg.max_prompt), np.int32)
    for i, pl in enumerate([3, 2]):
        prompts[i, :pl] = rng.integers(1, cfg.vocab, pl)
    plens = np.asarray([3, 2] + [1] * (bucket - 2), np.int32)
    slots = np.asarray([0, 1] + [cfg.slots()] * (bucket - 2), np.int32)
    return prompts, plens, slots


def _close(got, want, live):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind in "iu":
        np.testing.assert_array_equal(got[live], want[live])
    else:
        np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)


def test_prefill_and_decode_steps_match_jax_on_one_rank():
    """``prefill_step`` then three ``decode_step``s on one CPU rank against
    the JAX functions on a one-device mesh: tokens and the token table
    equal, K/V within the band, on every row but the scratch row; and no
    call changes its arguments."""
    jax, mpx, jcomm = _jax_one_device()
    cfg = engine.ServingConfig(**TINY)
    comm = _one_rank_comm()
    master = model.init_master(cfg.vocab, cfg.dim, cfg.heads, cfg.head_dim,
                               cfg.ffn, cfg.seed)
    params = model.shard_params(master, 1, 0, "cpu")
    kv = kvcache.kv_shape(cfg.slots(), cfg.max_len, cfg.heads, cfg.head_dim)
    state = params + (torch.zeros(kv), torch.zeros(kv),
                      torch.zeros((cfg.slots() + 1, cfg.max_len),
                                  dtype=torch.int32))
    lanes = tuple(torch.from_numpy(a) for a in _lanes(cfg))
    live = slice(0, cfg.slots())           # every row but the scratch row

    def g(t):                               # one rank's value, JAX layout
        return np.asarray(t)[None]

    jstate = tuple(g(t) for t in state)
    jlanes = tuple(g(t) for t in lanes)
    before = [t.clone() for t in state + lanes]
    out = spmd(model.prefill_step, comm=comm)(*(state + lanes))
    assert all(torch.equal(a, b) for a, b in zip(before, state + lanes))
    jout = mpx.spmd(jmodel.prefill_step, comm=jcomm)(*(jstate + jlanes))
    jout = [np.asarray(a)[0] for a in jout]
    for got, want in zip(out[:3], jout[:3]):
        _close(got, want, live)
    np.testing.assert_array_equal(out[3], jout[3])
    assert out[3].dtype == torch.int32

    cur = state[:5] + tuple(out[:3]) + (out[3], lanes[1], lanes[2])
    jcur = tuple(g(t) for t in cur)
    step = spmd(model.decode_step, comm=comm, unroll=1)
    jstep = mpx.spmd(jmodel.decode_step, comm=jcomm, unroll=1)
    for _ in range(3):
        snap = [t.clone() for t in cur]
        nxt = step(*cur)
        assert all(torch.equal(a, b) for a, b in zip(snap, cur))
        assert [t.dtype for t in nxt] == [t.dtype for t in cur]
        jnxt = [np.asarray(a)[0] for a in jstep(*jcur)]
        for got, want in zip(nxt[5:8], jnxt[5:8]):
            _close(got, want, live)
        for got, want in zip(nxt[8:], jnxt[8:]):
            np.testing.assert_array_equal(got, want)
        cur = tuple(nxt)
        jcur = tuple(g(t) for t in cur)


def test_one_rank_engine_pins_one_program_per_bucket():
    """On a world of one process ``pin="auto"`` pins (on the CPU an eager
    pin): one pin per program the engine reports, and live batches 4 and
    3 share decode bucket 4 (tests/test_serving.py:135)."""
    from mpi4jax_tpu_torch.aot import pinning

    eng = engine.ServingEngine(engine.ServingConfig(**dict(TINY, unroll=1)),
                               _one_rank_comm())
    assert eng.pin and str(eng.device) == "cpu"
    trace = [scheduler.Request(rid=i, arrival_s=0.0, prompt=(1, 2),
                               max_new_tokens=b)
             for i, b in enumerate([2, 4, 4, 4])]
    pinning.reset_stats()
    out = eng.run(trace, scheduler="continuous")
    assert out["failed"] == 0 and out["completed"] == 4
    assert [p for p in out["programs"] if p.startswith("decode.")] == \
        ["decode.b4"]
    assert pinning.stats()["pins"] == len(out["programs"])
    assert all(not p.graph for p in eng._programs.values())
    assert buckets.declared_buckets() is None   # scoped to the loop


def test_serving_gauges_from_a_live_engine(monkeypatch):
    """With the health plane armed, the boundary hook sets the KV slot and
    p99 gauges from the engine at every boundary it publishes; each is
    what the engine held then (the JAX package's p99 gauge reads an
    attribute its sequences lack, ROADMAP Queue 3)."""
    from mpi4jax_tpu_torch import telemetry
    from mpi4jax_tpu_torch.telemetry import health

    monkeypatch.setenv("MPI4JAX_TPU_HEALTH", "on")
    telemetry.set_telemetry_mode("counters")
    health.ensure_boundary_hook()
    seen = []

    def probe(step, **info):
        eng = info["engine"]
        lat = sorted(s.finish_s - s.request.arrival_s
                     for s in eng._sched.finished)
        seen.append((len(eng._alloc.used()), lat, dict(health._gauges)))

    unregister = megastep.register_boundary_hook("probe", probe)
    try:
        cfg = engine.ServingConfig(**TINY)
        eng = engine.ServingEngine(cfg, _one_rank_comm())
        trace = scheduler.poisson_trace(6, 300.0, seed=5, prompt_len=(2, 4),
                                        max_new=(2, 6), vocab=32)
        assert eng.run(trace)["completed"] == 6
    finally:
        unregister()
    assert seen and any(used for used, _, _ in seen)
    for used, lat, gauges in seen:
        assert gauges["serving_kv_slots_total"] == cfg.slots()
        assert gauges["serving_kv_slots_in_use"] == used
        assert gauges["serving_kv_occupancy"] == used / cfg.slots()
        if lat:
            p99 = metrics.percentile(lat, 0.99) * 1e3
            assert gauges["serving_p99_ms"] == p99
            assert gauges["serving_slo_headroom_ms"] == cfg.slo_p99_ms - p99
    assert "serving_p99_ms" in seen[-1][2]
    assert "serving_kv_occupancy" in health.prometheus_text()


def test_all_names_exported():
    import mpi4jax_tpu_torch as mpx_t
    from mpi4jax_tpu_torch import serving

    jserving = importlib.import_module("mpi4jax_tpu.serving")
    assert sorted(serving.__all__) == sorted(jserving.__all__)
    assert len(serving.__all__) == 18
    assert all(hasattr(serving, n) for n in serving.__all__)
    assert "serving" in mpx_t.__all__ and mpx_t.serving is serving


def _serve_example():
    """``examples/serving/serve.py``, loaded by path."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "serving" / "serve.py"
    spec = importlib.util.spec_from_file_location("_serve_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("preset", ["tiny", "bench"])
def test_twin_presets_and_trace_are_the_examples(preset):
    """The twin's presets, config and default trace (budgets scaled to the
    KV row) are ``serve.py``'s, request for request."""
    from mpi4jax_tpu.serving import engine as jeng
    from mpi4jax_tpu_torch.models import serving as MS

    ex = _serve_example()
    assert MS.PRESETS == ex.PRESETS
    assert (MS.DONE_TAG, MS.DRAINED_TAG) == (ex.DONE_TAG, ex.DRAINED_TAG)
    args = ex._parse_args(["--model", preset, "--launch", "3"])
    jserving = importlib.import_module("mpi4jax_tpu.serving")
    jcfg = ex._config(args, jserving)
    cfg = MS.make_config(preset, seed=args.seed, virtual_clock=True)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jeng.ServingConfig.__dataclass_fields__}
    jtrace, jmeta = ex._trace(args, jcfg, jserving)
    trace, meta = MS.make_trace(cfg, requests=args.requests, rate=args.rate,
                                seed=args.seed, long_frac=args.long_frac)
    assert meta == jmeta
    assert [_req_tuple(r) for r in trace] == [_req_tuple(r) for r in jtrace]


def test_twin_simulate_waits_for_the_cost_model():
    from mpi4jax_tpu_torch.models import serving as MS

    with pytest.raises(NotImplementedError, match="item 6"):
        MS.main(["--simulate", "--device", "cpu"])
