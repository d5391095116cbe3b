"""The port's telemetry (``mpi4jax_tpu_torch/telemetry/``) against the JAX
package's.

- ``hist``: bucket edges and merges equal the JAX package's on
  hypothesis-drawn latencies;
- the journal: FIFO pairing under one call id and ``seq``, record for
  record with the JAX package's journal fed the same calls;
- the merge: the port's ``merge_dir`` + ``chrome_trace`` of
  ``tests/data/telemetry/`` equal ``tests/data/telemetry_golden_trace.json``,
  journals the port writes are read by the JAX package's merge and journals
  the JAX package writes by the port's, into the same trace;
- the mode, its override and the cache token, step for step with the JAX
  package's;
- eager counters: every collective called once eagerly on 1, 2 and 4 gloo
  ranks (``tests/torch_ranks_runtime.py:counters_program``) counts the
  JAX package's calls and bytes per (op, dtype) on the same inputs.  The
  ``algo`` column is the port's own label (``native``): the JAX package's
  algorithm selector is not ported, so the comparison sums over it;
- inside ``spmd`` the JAX package counts once per trace and the port once
  per call: pinned here, both numbers side by side;
- ``render`` prints the JAX package's table, column for column, on the
  same snapshots.
"""

import json
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.telemetry import core as jcore  # noqa: E402
from mpi4jax_tpu.telemetry import hist as jhist  # noqa: E402
from mpi4jax_tpu.telemetry import journal as jjournal  # noqa: E402
from mpi4jax_tpu.telemetry import merge as jmerge  # noqa: E402
from mpi4jax_tpu.telemetry.report import render as jax_render  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_runtime as R  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.telemetry import core, hist, journal, merge  # noqa: E402
from mpi4jax_tpu_torch.telemetry.report import dump, render, report  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

DATA = pathlib.Path(__file__).resolve().parent / "data"
SIZES = [1, 2, 4]
_META = {"op": "allreduce", "comm_uid": "0", "axes": ["i"], "bytes": 64,
         "dtype": "float32"}
_CLOCKS = ("t_begin", "t_end", "mono_begin", "mono_end", "latency", "t", "mono",
           "process")


@pytest.fixture(autouse=True)
def clean_both(monkeypatch):
    """Both packages' telemetry at its defaults, and no telemetry
    variables, around every test."""
    for k in ("MPI4JAX_TPU_TELEMETRY", "MPI4JAX_TPU_TELEMETRY_DIR"):
        monkeypatch.delenv(k, raising=False)
    for c in (core, jcore):
        c.set_telemetry_mode(None)
        c.reset()
    yield
    for c in (core, jcore):
        c.set_telemetry_mode(None)
        c.reset()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "runtime-counters")


def comm1():
    return tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))


# -- hist


latencies = st.floats(min_value=-1.0, max_value=1e6, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(st.lists(latencies, min_size=1, max_size=40),
       st.lists(latencies, max_size=40))
def test_histogram_buckets_and_merge_match_jax(a, b):
    for v in a + b:
        assert hist.bucket_index(v) == jhist.bucket_index(v)
    ha, hb, ja, jb = hist.Histogram(), hist.Histogram(), jhist.Histogram(), jhist.Histogram()
    for v in a:
        ha.record(v)
        ja.record(v)
    for v in b:
        hb.record(v)
        jb.record(v)
    merged, jmerged = ha.merge(hb), ja.merge(jb)
    assert merged.to_dict() == jmerged.to_dict()
    for q in (0.0, 0.5, 0.99, 1.0):
        assert merged.quantile(q) == jmerged.quantile(q)
    back = hist.Histogram.from_dict(json.loads(json.dumps(jmerged.to_dict())))
    assert back.to_dict() == merged.to_dict()


@pytest.mark.parametrize("index", [-31, -20, -1, 0, 1, 16])
def test_bucket_value_matches_jax(index):
    assert hist.bucket_value(index) == jhist.bucket_value(index)


# -- journal


def _strip(records):
    return [{k: v for k, v in r.items() if k not in _CLOCKS} for r in records]


def test_journal_fifo_aliasing_and_seq_match_jax():
    out = []
    for c, j in ((core, journal), (jcore, jjournal)):
        c.set_telemetry_mode("events")
        # two begins under one call id before any end, then another id
        j.begin("0000000a", 0, _META)
        j.begin("0000000a", 0, _META)
        j.begin("0000000b", 1, _META)
        j.end("0000000a", 0, {"algo": "ring"})
        j.end("0000000b", 1, {"algo": "native"})
        j.end("0000000a", 0, {"algo": "ring"})
        j.end("0000000c", 0, {})  # unmatched: dropped
        recs = j.snapshot_events()
        assert all(r["latency"] >= 0 and r["t_end"] >= r["t_begin"] for r in recs)
        out.append((_strip(recs), {k: v["latency"]["count"]
                                   for k, v in c.snapshot()["ops"].items()}))
    assert out[0] == out[1]
    assert [r["seq"] for r in out[0][0]] == [0, 0, 1]


def test_journal_instants_gated_by_events_tier():
    journal.instant("fault", 1, {"detail": "x"})
    core.set_telemetry_mode("counters")
    journal.incident("faults.injected", "fault", 1, "x")
    assert journal.snapshot_events() == []
    assert core.snapshot()["meters"] == {"faults.injected": 1}
    core.set_telemetry_mode("events")
    journal.instant("fault", 1, {"detail": "x"})
    (rec,) = journal.snapshot_events()
    assert rec["type"] == "instant" and rec["name"] == "fault" and rec["rank"] == 1


# -- merge


def test_merge_golden_file():
    recs = merge.merge_dir(str(DATA / "telemetry"))
    got = merge.chrome_trace(recs)
    expected = json.loads((DATA / "telemetry_golden_trace.json").read_text())
    assert got == expected
    table = merge.skew_table(recs)
    assert table["per_op"]["allreduce"]["max_skew"] == pytest.approx(0.002, abs=1e-4)
    assert table["per_rank"][1]["last_arrivals"] == 3
    assert merge.render_skew(table) == jmerge.render_skew(jmerge.skew_table(recs))


def test_merge_cli_end_to_end(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert merge.main(["merge", str(DATA / "telemetry"), "--perfetto", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "2 rank(s)" in printed and "last arrivals" in printed
    assert json.loads(out.read_text()) == json.loads(
        (DATA / "telemetry_golden_trace.json").read_text())
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "events-p2.jsonl").write_text("garbage\n")
    assert merge.main(["merge", str(bad), "--no-skew"]) == 2
    assert "events-p2.jsonl:1" in capsys.readouterr().err


def test_port_journals_read_by_jax_merge(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY_DIR", str(tmp_path))
    core.set_telemetry_mode("events")
    comm = comm1()
    x = torch.arange(6.0)
    tpx.allreduce(x, op=tpx.SUM, comm=comm)
    tpx.sendrecv(x, x, dest=tpx.shift(1), comm=comm)
    tpx.barrier(comm=comm)
    journal.flush()
    (path,) = tmp_path.glob("events-p*.jsonl")
    assert path.name == "events-p0.jsonl"
    theirs = jmerge.merge_dir(str(tmp_path))
    ours = merge.merge_dir(str(tmp_path))
    assert theirs == ours and [r["op"] for r in ours] == ["allreduce", "sendrecv",
                                                          "barrier"]
    assert jmerge.chrome_trace(theirs) == merge.chrome_trace(ours)


def test_jax_journals_read_by_port_merge(tmp_path, monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY_DIR", str(tmp_path))
    jcore.set_telemetry_mode("events")
    mesh = mpx.make_world_mesh((4,), ("i",), devices=jax.devices()[:4])
    comm = mpx.Comm("i", mesh=mesh)

    @mpx.spmd(comm=comm)
    def f(x):
        return mpx.allreduce(x, op=mpx.SUM)[0]

    jax.block_until_ready(f(jnp.ones((4, 8))))
    deadline = time.monotonic() + 30
    while len(jjournal.snapshot_events()) < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    jjournal.flush()
    ours = merge.merge_dir(str(tmp_path))
    assert sorted(r["rank"] for r in ours) == [0, 1, 2, 3]
    assert ours == jmerge.merge_dir(str(tmp_path))
    assert merge.chrome_trace(ours) == jmerge.chrome_trace(ours)
    assert merge.skew_table(ours) == jmerge.skew_table(ours)


# -- mode, override, cache token


def test_mode_override_and_cache_token_match_jax(monkeypatch):
    def steps(c):
        seen = [(c.effective_mode(), c.telemetry_cache_token())]
        monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY", "counters")
        seen.append((c.effective_mode(), c.telemetry_cache_token()))
        c.set_telemetry_mode("events")
        seen.append((c.effective_mode(), c.telemetry_cache_token()))
        c.set_telemetry_mode("off")
        seen.append((c.effective_mode(), c.telemetry_cache_token()))
        c.set_telemetry_mode(None)
        seen.append((c.effective_mode(), c.telemetry_cache_token()))
        monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY", "  EVENTS ")
        seen.append((c.effective_mode(), c.telemetry_cache_token()))
        monkeypatch.delenv("MPI4JAX_TPU_TELEMETRY")
        return seen

    assert steps(core) == steps(jcore)
    with pytest.raises(ValueError) as ours:
        core.set_telemetry_mode("verbose")
    with pytest.raises(ValueError) as theirs:
        jcore.set_telemetry_mode("verbose")
    assert str(ours.value) == str(theirs.value)
    monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY", "loud")
    with pytest.raises(ValueError) as ours:
        core.effective_mode()
    with pytest.raises(ValueError) as theirs:
        jcore.effective_mode()
    assert str(ours.value) == str(theirs.value)


def test_meters_gated_by_mode():
    core.meter("x.y")
    assert core.snapshot()["meters"] == {}
    core.set_telemetry_mode("counters")
    core.meter("x.y")
    core.meter("x.y", 4)
    assert core.snapshot()["meters"] == {"x.y": 5}


# -- counters


def jax_eager_counts(size):
    inp = R.eager_inputs(size)
    mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
    comm = mpx.Comm("x", mesh=mesh)
    f, i, b = (jnp.asarray(inp[k]) for k in ("f", "i", "blocks"))
    jcore.set_telemetry_mode("counters")
    mpx.allreduce(f, op=mpx.SUM, comm=comm)
    mpx.allreduce(i, op=mpx.MAX, comm=comm)
    mpx.allgather(f, comm=comm)
    mpx.alltoall(b, comm=comm)
    mpx.barrier(comm=comm)
    mpx.bcast(f, 0, comm=comm)
    mpx.gather(i, 0, comm=comm)
    mpx.reduce(f, mpx.SUM, 0, comm=comm)
    mpx.reduce_scatter(b, mpx.SUM, comm=comm)
    mpx.scan(i, mpx.SUM, comm=comm)
    mpx.scatter(b, 0, comm=comm)
    mpx.sendrecv(f, f, dest=mpx.shift(1), comm=comm)
    eager = R.counts_by_op_dtype(jcore.snapshot())
    jcore.reset()
    g = mpx.spmd(lambda v: mpx.allreduce(v, op=mpx.SUM)[0], comm=comm)
    for _ in range(3):
        g(jnp.ones((size, 2)))
    region = R.counts_by_op_dtype(jcore.snapshot())
    jcore.set_telemetry_mode(None)
    jcore.reset()
    return eager, region


def port_counts(results, size):
    if size == 1:
        return [R.counters_program(0, 1)]
    return results.get(f"port-{size}", lambda: launch.run(
        R.counters_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


@pytest.mark.parametrize("size", SIZES)
def test_eager_counters_match_jax_per_op_and_dtype(results, size):
    """Each rank of the port counts what the JAX package's eager call
    counts: one call per op, the rank-local payload's bytes."""
    want, _ = jax_eager_counts(size)
    assert len(want) == 12
    for rank, got in enumerate(port_counts(results, size)):
        assert got["eager"] == want, f"rank {rank}"


@pytest.mark.parametrize("size", SIZES)
def test_spmd_counts_per_call_where_jax_counts_per_trace(results, size):
    """Three calls of an ``spmd`` function with one allreduce: the JAX
    package counts its one trace, the port its three calls (by design:
    the port has no trace; ROADMAP Queue 3)."""
    _, jax_region = jax_eager_counts(size)
    assert jax_region == {("allreduce", "float32"): (1, 8)}
    for got in port_counts(results, size):
        assert got["region"] == {("allreduce", "float32"): (3, 24)}


def test_capture_stash_counts_each_replay():
    core.set_telemetry_mode("counters")
    comm = comm1()
    cell = core.EagerCell()
    with core.capture_eager(cell, ()):
        tpx.allreduce(torch.ones(3), op=tpx.SUM, comm=comm)
        tpx.barrier(comm=comm)
    assert core.snapshot()["ops"] == {}
    for _ in range(3):
        core.count_eager_call(cell, ())
    got = {(r["op"], r["dtype"]): r["calls"] for r in core.snapshot()["ops"].values()}
    assert got == {("allreduce", "float32"): 3, ("barrier", ""): 3}
    # a capture that raises leaves the stash as it was
    with pytest.raises(RuntimeError):
        with core.capture_eager(cell, ()):
            tpx.bcast(torch.ones(2), 0, comm=comm)
            raise RuntimeError("capture failed")
    assert [r.op for r in cell.records_for(())] == ["allreduce", "barrier"]


def test_fusion_flush_meters_its_bucket():
    core.set_telemetry_mode("counters")
    comm = comm1()
    tpx.set_fusion_mode("force")
    try:
        @tpx.spmd(comm=comm)
        def f(a, b):
            return tpx.allreduce(a)[0], tpx.allreduce(b)[0]

        f(torch.ones(3), torch.ones(5))
    finally:
        tpx.set_fusion_mode(None)
    meters = core.snapshot()["meters"]
    prefix = f"fusion.allreduce.c{comm.uid}.float32"
    assert meters[f"{prefix}.buckets"] == 1
    assert meters[f"{prefix}.members"] == 2
    assert meters[f"{prefix}.bytes_packed"] == 32


# -- report


def test_render_matches_jax_on_the_same_snapshots():
    """The golden journals' records as two processes' events, beside
    counters and meters: the port's table is the JAX package's."""
    recs = merge.merge_dir(str(DATA / "telemetry"))
    snaps = []
    for p in (0, 1):
        h = hist.Histogram()
        for r in recs:
            if r["process"] == p and r["type"] == "op":
                h.record(r["latency"])
        snaps.append({
            "version": 1, "mode": "events", "process": p,
            "ops": {"allreduce|0|ring|float32": {
                "op": "allreduce", "comm_uid": "0", "algo": "ring",
                "dtype": "float32", "calls": 2, "bytes": 8192,
                "intra_bytes": 8192, "inter_bytes": 0, "wire_inter_bytes": 0,
                "latency": h.to_dict()}},
            "meters": {"watchdog.arms": 2 + p},
            "events": [r for r in recs if r["process"] == p],
        })
    text = render(snaps)
    assert text == jax_render(snaps)
    for col in ("calls", "p50 us", "p99 us", "skew us", "straggler"):
        assert col in text.splitlines()[0]


def test_report_gathers_this_process(capsys):
    core.set_telemetry_mode("events")
    comm = comm1()
    tpx.allreduce(torch.ones(4), op=tpx.SUM, comm=comm)
    text = report(comm=comm)
    assert capsys.readouterr().out.strip() == text.strip()
    row = next(ln for ln in text.splitlines() if ln.startswith("allreduce"))
    assert "float32" in row and " 1 " in row


def test_dump_writes_snapshot_json(tmp_path):
    core.set_telemetry_mode("counters")
    tpx.allreduce(torch.ones(4), op=tpx.SUM, comm=comm1())
    path = dump(str(tmp_path / "snap.json"))
    snap = json.loads(pathlib.Path(path).read_text())
    assert snap["mode"] == "counters" and snap["events"] == []
    (row,) = [r for r in snap["ops"].values() if r["op"] == "allreduce"]
    assert (row["calls"], row["bytes"]) == (1, 16)
    # the schema's keys; the sections present only when something fills
    # them (pins, drops, the JAX package's tuning and epochs) aside
    optional = {"compile_cache", "dropped", "tuning", "epochs"}
    assert set(snap) - optional == set(jcore.snapshot(include_events=True)) - optional


def test_async_pair_carries_one_span():
    """A start/wait pair: a counter record each, one journal record from
    the start to the wait, under the start's record (as the JAX package's
    ``_span_open``)."""
    core.set_telemetry_mode("events")

    @tpx.spmd(comm=comm1())
    def f(v):
        h, _ = tpx.allreduce_start(v)
        w = v * 2
        return tpx.allreduce_wait(h)[0] + w

    f(torch.ones(4))
    assert [r["op"] for r in journal.snapshot_events()] == ["allreduce_start"]
    calls = {r["op"]: r["calls"] for r in core.snapshot()["ops"].values()}
    assert calls == {"allreduce_start": 1, "allreduce_wait": 1}
