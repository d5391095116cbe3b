"""The port's health plane (``mpi4jax_tpu_torch/telemetry/health.py``, the
postmortem half of ``telemetry/merge.py``) and its remaining top-level
names, against the JAX package's.

The health plane is host arithmetic, so every parity check here is exact
equality:

- the flight ring: overwrite window, ``total`` and ``dropped``, a capacity
  change, the counters feed (per op call, per call of a CPU pin, per
  replay of a pin's stash, the bulk spill included) and the events feed
  (begins, op records, instants), snapshot for snapshot with the JAX
  package's on the same scripted records (clocks fixed or stripped);
- the detector: ``_summarize_window`` after seeded feeds, ``judge_exchange``
  on hypothesis-drawn payloads, strike promotion and interval gating;
  on four gloo ranks (``tests/torch_ranks_health.py``) the digest exchange
  names rank 2 on every rank, identically, and then marks it persistent,
  equal to the JAX package's ``judge_exchange`` on the same payloads;
- bundles: a bundle of either package renders the same text in either's
  ``postmortem``, the CLI's exit codes, the merge's warning of dropped
  records, the watchdog expiry's bundle, and the port's one bundle per
  rank process (a rank that wrote none is absent: pinned);
- ``prometheus_text`` byte for byte on the same state;
- the ``hang`` drills on four CPU ranks;
- off is free: no ring, no ``dropped`` key, the cache token and the
  services' stamp unchanged, the flags in ``env_fingerprint``;
- the top-level names: the ``__all__`` difference, ``varying``,
  ``cache_stats``/``clear_caches``, the default mesh, ``profile_ops``.
"""

import json
import pathlib
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.telemetry import core as jcore  # noqa: E402
from mpi4jax_tpu.telemetry import health as jhealth  # noqa: E402
from mpi4jax_tpu.telemetry import journal as jjournal  # noqa: E402
from mpi4jax_tpu.telemetry import merge as jmerge  # noqa: E402
from mpi4jax_tpu.utils import config as jconfig  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_health as RH  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import telemetry  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.resilience import watchdog as wd  # noqa: E402
from mpi4jax_tpu_torch.telemetry import core, health, journal, merge  # noqa: E402
from mpi4jax_tpu_torch.utils import config  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = pathlib.Path(__file__).resolve().parents[1]
HEALTH_FLAGS = ("MPI4JAX_TPU_HEALTH", "MPI4JAX_TPU_HEALTH_INTERVAL",
                "MPI4JAX_TPU_FLIGHT_RING", "MPI4JAX_TPU_HEALTH_SUSPECTS",
                "MPI4JAX_TPU_HEALTH_PROM")
_ENV = HEALTH_FLAGS + ("MPI4JAX_TPU_TELEMETRY", "MPI4JAX_TPU_TELEMETRY_DIR")
_CLOCKS = ("t_begin", "t_end", "mono_begin", "mono_end", "latency", "t", "mono",
           "process")
_META = {"op": "allreduce", "comm_uid": "0", "axes": ["i"], "bytes": 64,
         "dtype": "float32"}
# the JAX package's __all__ names whose modules are later items of the
# port's queue (ROADMAP Queue 1): none since the collective verifier
# (analysis/) landed; and the port's own extras
LEFT_TO_LATER_ITEMS = []
VERIFIER_NAMES = ("analyze", "Report", "Finding", "AnalysisError",
                  "set_analyze_mode")
# cond and switch: the port's counterpart of lax.cond / lax.switch
# (parallel/control.py), a branch the verifier sees both arms of
PORT_ONLY = sorted(["GroupComm", "ProcessGrid", "cond", "register_boundary_hook",
                    "resilience", "resolve_device", "switch"])


@pytest.fixture(autouse=True)
def clean_both(monkeypatch):
    """Both packages' telemetry and health plane at their defaults, and no
    health or telemetry variables, around every test."""
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for c in (core, jcore):
        c.set_telemetry_mode(None)
        c.reset()
    yield
    for c in (core, jcore):
        c.set_telemetry_mode(None)
        c.reset()


def _arm(monkeypatch, ring=8, interval=1, **env):
    monkeypatch.setenv("MPI4JAX_TPU_HEALTH", "on")
    monkeypatch.setenv("MPI4JAX_TPU_FLIGHT_RING", str(ring))
    monkeypatch.setenv("MPI4JAX_TPU_HEALTH_INTERVAL", str(interval))
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _fixed_clock(monkeypatch, t=1234.5):
    clock = types.SimpleNamespace(time=lambda: t)
    monkeypatch.setattr(health, "time", clock)
    monkeypatch.setattr(jhealth, "time", clock)


def _strip(records):
    return [{k: v for k, v in r.items() if k not in _CLOCKS} for r in records]


def _strip_snap(snap):
    return dict(snap, records=_strip(snap["records"]))


def comm1():
    return tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))


def _jax_oprecord(op, comm_uid, nbytes, dtype, algo="native"):
    rec = jcore.OpRecord(op, comm_uid, ("x",), nbytes, dtype, counted=True)
    rec.algo = algo
    return rec


# ---------------------------------------------------------------------------
# flight ring
# ---------------------------------------------------------------------------


def _script(h, n):
    """``n`` scripted records of the three kinds through ``h``'s feeds."""
    for i in range(n):
        if i % 3 == 0:
            h.record_dispatch(_jax_oprecord("sendrecv", i, 8 * i, "float32"))
        elif i % 3 == 1:
            h.record_begin(f"{i:08x}", i % 4, dict(_META), float(i), 100.0 + i)
        else:
            h.record_event({"type": "instant", "name": f"e{i}", "rank": i % 4,
                            "t": 100.0 + i})


@pytest.mark.parametrize("capacity,n", [(1, 5), (4, 3), (4, 10), (8, 8), (64, 50)])
def test_ring_window_total_and_dropped_match_jax(monkeypatch, capacity, n):
    _arm(monkeypatch, ring=capacity)
    _fixed_clock(monkeypatch)
    _script(health, n)
    _script(jhealth, n)
    snap = health.flight_snapshot()
    assert snap == jhealth.flight_snapshot()
    assert snap["total"] == n and snap["dropped"] == max(0, n - capacity)
    assert len(snap["records"]) == min(n, capacity)
    assert health.ring_dropped() == jhealth.ring_dropped()


def test_ring_capacity_change_recreates_it_as_jax(monkeypatch):
    _arm(monkeypatch, ring=4)
    _fixed_clock(monkeypatch)
    for h in (health, jhealth):
        _script(h, 6)
    monkeypatch.setenv("MPI4JAX_TPU_FLIGHT_RING", "8")
    for h in (health, jhealth):
        h.record_event({"name": "b"})
    snap = health.flight_snapshot()
    assert snap == jhealth.flight_snapshot()
    assert snap["capacity"] == 8 and snap["records"] == [{"name": "b"}]


def test_ring_off_is_inert_in_both():
    for c, j in ((core, journal), (jcore, jjournal)):
        c.set_telemetry_mode("events")
        j.begin("c1", 0, dict(_META))
        j.end("c1", 0, {})
    assert health.flight_snapshot() == jhealth.flight_snapshot() == {
        "version": 1, "capacity": 0, "total": 0, "dropped": 0, "records": []}
    assert health._ring is None


def _port_calls(comm, rounds):
    """A fixed sequence of op calls on a one-rank CPU comm; returns what
    each counted record holds (op, bytes, dtype)."""
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((3, 5), dtype=np.float32))
    i = torch.from_numpy(rng.integers(0, 9, (7,)).astype(np.int32))
    made = []
    for _ in range(rounds):
        tpx.allreduce(f, op=tpx.SUM, comm=comm)
        made.append(("allreduce", f.numel() * 4, "float32"))
        tpx.sendrecv(i, i, dest=tpx.shift(1), comm=comm)
        made.append(("sendrecv", i.numel() * 4, "int32"))
        tpx.allgather(f, comm=comm)
        made.append(("allgather", f.numel() * 4, "float32"))
    return made


@pytest.mark.parametrize("capacity", [4, 64])
def test_counters_feed_per_call_matches_jax(monkeypatch, capacity):
    _arm(monkeypatch, ring=capacity)
    _fixed_clock(monkeypatch)
    telemetry.set_telemetry_mode("counters")
    comm = comm1()
    made = _port_calls(comm, 3)
    for op, nbytes, dtype in made:
        jcore.close_op(_jax_oprecord(op, comm.uid, nbytes, dtype))
    snap = health.flight_snapshot()
    assert snap == jhealth.flight_snapshot()
    assert snap["total"] == len(made) == sum(
        r["calls"] for r in telemetry.snapshot()["ops"].values())
    assert [r["kind"] for r in snap["records"]] == ["dispatch"] * min(capacity, len(made))
    # the counters tier writes no journal records: the ring rides the counter
    assert journal.snapshot_events() == []


def test_counters_feed_per_call_of_a_cpu_pin_matches_jax(monkeypatch):
    _arm(monkeypatch, ring=16)
    _fixed_clock(monkeypatch)
    telemetry.set_telemetry_mode("counters")
    comm = comm1()
    x = torch.arange(6, dtype=torch.float32)

    def body(v):
        y, _ = tpx.allreduce(v, op=tpx.SUM, comm=comm)
        z, _ = tpx.sendrecv(y, y, dest=tpx.shift(1), comm=comm)
        return z * 0.5

    pin = tpx.compile(body, x, comm=comm)
    assert not pin.graph
    for _ in range(3):
        pin(x)
    for _ in range(3):
        for op in ("allreduce", "sendrecv"):
            jcore.close_op(_jax_oprecord(op, comm.uid, 24, "float32"))
    assert health.flight_snapshot() == jhealth.flight_snapshot()
    assert health.flight_snapshot()["total"] == 6


@pytest.mark.parametrize("capacity,replays", [(7, 3), (30, 1), (30, 4), (1, 2)])
def test_counters_feed_per_replay_of_a_stash_matches_jax(monkeypatch, capacity, replays):
    """A CUDA-graph replay counts its capture's stash
    (``core.count_eager_call``); the ring spills each stashed record, the
    bulk path building only the last ``capacity`` of them, and comes out
    as the JAX package's per-record spill leaves it."""
    _arm(monkeypatch, ring=capacity)
    _fixed_clock(monkeypatch)
    telemetry.set_telemetry_mode("counters")
    jcore.set_telemetry_mode("counters")
    comm = comm1()
    cell = core.EagerCell()
    with core.capture_eager(cell, ()):
        made = _port_calls(comm, 4)
    assert health.flight_snapshot()["total"] == 0  # a capture counts nothing
    jcell = jcore.EagerCell()
    jcell.by_sig[()] = [_jax_oprecord(op, comm.uid, b, d) for op, b, d in made]
    for _ in range(replays):
        core.count_eager_call(cell, ())
        jcore.count_eager_call(jcell, ())
    snap = health.flight_snapshot()
    assert snap == jhealth.flight_snapshot()
    assert snap["total"] == replays * len(made)
    assert snap["dropped"] == max(0, replays * len(made) - capacity)
    calls = sum(r["calls"] for r in telemetry.snapshot()["ops"].values())
    assert calls == snap["total"]


def test_events_feed_begins_records_and_instants_match_jax(monkeypatch):
    _arm(monkeypatch, ring=16)
    snaps = []
    for c, j in ((core, journal), (jcore, jjournal)):
        c.set_telemetry_mode("events")
        j.begin("a", 0, dict(_META))
        j.begin("b", 1, dict(_META, op="sendrecv"))
        j.end("a", 0, {"algo": "native"})
        j.instant("fault", 1, {"detail": "delay injected"})
        j.end("b", 1, {"algo": "native"})
        j.begin("c", 0, dict(_META))   # in flight: a begin, no record
        snaps.append(_strip_snap((health if c is core else jhealth).flight_snapshot()))
    assert snaps[0] == snaps[1]
    kinds = [r.get("kind") or r.get("type") for r in snaps[0]["records"]]
    assert kinds == ["begin", "begin", "op", "instant", "op", "begin"]


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def test_summarize_window_matches_jax_over_seeded_windows(monkeypatch):
    _arm(monkeypatch)
    rng = np.random.default_rng(5)
    keys = ["sendrecv|0|native|float32", "allreduce|1|native|float32",
            "gather|2|native|int32"]
    for window in range(5):
        slow = 4.0 if window == 3 else 1.0
        for key in keys:
            n = int(rng.integers(1, 7))
            for v in rng.uniform(1e-5, 1e-3, n) * slow:
                health.feed_latency(key, float(v))
                jhealth.feed_latency(key, float(v))
        got, want = health._summarize_window(), jhealth._summarize_window()
        assert got == want
    assert {k: h.to_dict() for k, h in health._detector.baseline.items()} == \
        {k: h.to_dict() for k, h in jhealth._detector.baseline.items()}


def test_summarize_window_flags_a_degraded_key_as_jax(monkeypatch):
    _arm(monkeypatch)
    key = "sendrecv|0|native|float32"
    for h in (health, jhealth):
        for v in (1e-4,) * 4:
            h.feed_latency(key, v)
        h._summarize_window()
        for v in (1e-3,) * 4:
            h.feed_latency(key, v)
    got, want = health._summarize_window(), jhealth._summarize_window()
    assert got == want and [f["kind"] for f in got["findings"]] == ["degraded"]


summary = st.fixed_dictionaries({
    "count": st.integers(0, 8),
    "mean": st.floats(0.0, 1.0, allow_nan=False),
    "p50": st.floats(0.0, 1.0, allow_nan=False),
    "max": st.floats(0.0, 1.0, allow_nan=False),
})
peer = st.builds(lambda proc, s: {"process": proc, "summary": s},
                 st.integers(0, 7),
                 st.dictionaries(st.sampled_from(["sendrecv|0|native|float32",
                                                  "allreduce|3|native|int32",
                                                  "gather|1|ring|float32"]),
                                 summary, max_size=3))


@settings(max_examples=300, deadline=None)
@given(st.lists(peer, max_size=6), st.integers(0, 7))
def test_judge_exchange_matches_jax(peers, me):
    assert health.judge_exchange(peers, me) == jhealth.judge_exchange(peers, me)


def _peer(proc, mean, count=5, key="sendrecv|0|native|float32"):
    return {"process": proc, "summary": {key: {"count": count, "mean": mean,
                                               "p50": mean, "max": mean}}}


def test_exchange_strikes_promote_to_persistent_as_jax(monkeypatch):
    _arm(monkeypatch)
    seq = [
        [_peer(0, 0.001), _peer(1, 0.001), _peer(2, 0.005), _peer(3, 0.001)],
        [_peer(0, 0.001), _peer(1, 0.001), _peer(2, 0.005), _peer(3, 0.001)],
        [_peer(0, 0.001), _peer(1, 0.001), _peer(2, 0.001), _peer(3, 0.001)],
        [_peer(0, 0.001), _peer(1, 0.009), _peer(2, 0.005), _peer(3, 0.001)],
        [_peer(0, 0.001), _peer(1, 0.009), _peer(2, 0.001), _peer(3, 0.001)],
    ]
    got, want = [], []
    for c in (core, jcore):
        c.set_telemetry_mode("counters")
    for peers in seq:
        for h, out in ((health, got), (jhealth, want)):
            monkeypatch.setattr(h, "_gather_json", lambda comm, p, _q=peers: _q)
            out.append((h._exchange(None, {}), dict(h._detector.strikes)))
    assert got == want
    assert [f["persistent"] for f in got[1][0]] == [True]
    assert got[2] == ([], {})
    for name in ("health.exchanges", "health.slow_ranks", "health.stragglers"):
        assert (core.snapshot()["meters"][name]
                == jcore.snapshot()["meters"][name])


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_on_boundary_interval_gating_matches_jax(monkeypatch, interval):
    _arm(monkeypatch, interval=interval)
    got = [health.on_boundary(i) for i in range(7)]
    want = [jhealth.on_boundary(i) for i in range(7)]
    assert got == want
    assert [g is not None for g in got] == [(i + 1) % interval == 0 for i in range(7)]
    assert health._detector.boundaries == jhealth._detector.boundaries == 7
    monkeypatch.setenv("MPI4JAX_TPU_HEALTH", "off")
    assert health.on_boundary(8) is None and health._detector.boundaries == 7


def test_suspect_handoff_is_a_no_op_without_elastic(monkeypatch):
    """``MPI4JAX_TPU_HEALTH_SUSPECTS`` needs the elastic layer: where it
    cannot be imported, a persistent straggler is flagged and nothing is
    raised (the JAX package's path without ``resilience.elastic``).  The
    port has the layer, so the test hides it (the live hand-off is
    ``tests/test_torch_elastic.py``)."""
    import mpi4jax_tpu_torch.resilience as tres

    _arm(monkeypatch, MPI4JAX_TPU_HEALTH_SUSPECTS="1")
    peers = [_peer(0, 0.001), _peer(1, 0.001), _peer(3, 0.005)]
    monkeypatch.setattr(health, "_gather_json", lambda comm, p: peers)
    # hidden for the test's body only: the teardown needs the layer back
    with monkeypatch.context() as hide:
        hide.delattr(tres, "elastic")
        hide.setitem(sys.modules, "mpi4jax_tpu_torch.resilience.elastic", None)
        health._exchange(None, {})
        found = health._exchange(None, {})
        assert [f["persistent"] for f in found] == [True]
        assert health._post_suspects([3]) is None


@pytest.fixture(scope="module")
def detector_world(tmp_path_factory):
    """Four gloo ranks of ``RH.detector_program``, once per test run."""
    def compute():
        tdir = str(tmp_path_factory.mktemp("health-detector"))
        return launch.run(RH.detector_program, 4, device="cpu",
                          timeout=R0.RANK_TIMEOUT_S, args=(4, tdir))
    return R0.shared_result(tmp_path_factory, "health-detector-4", compute)


def _jax_peers(monkeypatch, size):
    """The payloads the JAX package's detector would gather: each rank's
    window summary after its scripted feed."""
    _arm(monkeypatch)
    peers = []
    for r in range(size):
        jhealth.reset()
        for v in RH.scripted_latencies(r, size):
            jhealth.feed_latency(RH.KEY, v)
        peers.append({"process": r, "summary": jhealth._summarize_window()["summary"]})
    jhealth.reset()
    return peers


def test_four_ranks_return_identical_findings_naming_rank_2(detector_world):
    first = detector_world[0]["findings"]
    for r, res in enumerate(detector_world):
        assert res["findings"] == first, r
        assert res["exchanges"] == res["boundaries"] == RH.BOUNDARIES
    assert [[(f["kind"], f["rank"], f["persistent"]) for f in b] for b in first] == [
        [("slow_rank", 2, False)], [("slow_rank", 2, True)]]


def test_four_ranks_findings_equal_jax_judge_exchange(monkeypatch, detector_world):
    want = jhealth.judge_exchange(_jax_peers(monkeypatch, 4), 0)
    for res in detector_world:
        for b, found in enumerate(res["findings"]):
            assert [{k: v for k, v in f.items() if k != "persistent"}
                    for f in found] == want
            assert all(f["persistent"] == (b + 1 >= jhealth.STRIKE_LIMIT)
                       for f in found)


def test_four_ranks_journal_the_health_incidents(detector_world):
    for r, res in enumerate(detector_world):
        details = [(name, rank, detail) for name, rank, detail in res["incidents"]
                   if name == "health"]
        slow = [d for d in details if d[2].startswith("rank 2 slow on sendrecv")]
        persistent = [d for d in details if d[2].startswith(
            "rank 2 persistently slow: flagged in 2 consecutive")]
        assert len(slow) == 2 and len(persistent) == 1, (r, details)
        assert all(d[1] == 2 for d in slow + persistent)
        assert res["meters"]["health.slow_ranks"] == 2
        assert res["meters"]["health.stragglers"] == 1
        assert res["meters"]["health.exchanges"] == 2
        assert res["strikes"] == {2: 2}


def test_four_ranks_write_their_prometheus_files(detector_world):
    for res in detector_world:
        assert "mpx_health_exchanges_total 2" in res["prom"]
        assert "mpx_health_boundaries_total 2" in res["prom"]
        assert 'mpx_meter_total{name="health.slow_ranks"} 2' in res["prom"]


# ---------------------------------------------------------------------------
# postmortem bundles and their merge
# ---------------------------------------------------------------------------


def test_dump_postmortem_needs_a_directory(monkeypatch):
    _arm(monkeypatch)
    assert health.dump_postmortem("no dir") is None
    assert jhealth.dump_postmortem("no dir") is None


def test_dump_postmortem_accumulates_reasons_with_jax_keys(monkeypatch, tmp_path):
    _arm(monkeypatch)
    bundles = []
    for c, j, h, d in ((core, journal, health, tmp_path / "port"),
                       (jcore, jjournal, jhealth, tmp_path / "jax")):
        monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY_DIR", str(d))
        c.set_telemetry_mode("events")
        j.begin("c1", 0, dict(_META))
        j.end("c1", 0, {})
        p1 = h.dump_postmortem("first")
        assert h.dump_postmortem("second") == p1
        bundles.append(json.loads(pathlib.Path(p1).read_text()))
    port, jax_b = bundles
    assert set(port) == set(jax_b) - {"tuning", "epochs"}
    assert port["schema"] == "mpx-postmortem/1"
    assert port["reasons"] == jax_b["reasons"] == ["first", "second"]
    assert port["dropped"] == jax_b["dropped"] == {"journal": 0, "flight_ring": 0}
    assert _strip(port["flight"]["records"]) == _strip(jax_b["flight"]["records"])
    assert set(port["health"]) == set(jax_b["health"])
    assert port["config"]["env"]["MPI4JAX_TPU_HEALTH"] == "on"
    # the pin counters and the persistent tier's, as the JAX bundle has them
    assert port["compile_cache"] == tpx.aot.stats()
    assert set(port["compile_cache"]) == set(jax_b["compile_cache"])
    assert port["watchdog_inflight"] == []
    assert core.snapshot()["meters"]["health.postmortems"] == 2


def test_watchdog_expiry_journals_a_stall_and_writes_a_bundle(monkeypatch, tmp_path):
    """A Python-registry expiry: the watchdog's incident, then the health
    plane's stall incident and bundle, then the handler."""
    _arm(monkeypatch)
    monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY_DIR", str(tmp_path))
    telemetry.set_telemetry_mode("events")
    wd.force_python_fallback(True)
    seen = []
    wd.set_on_timeout(lambda entries, expired: seen.append(
        (expired, list(tmp_path.glob("postmortem-p*.json")))))
    wd._registry.arm("MPI_Allreduce", "0000002a", 0, "('x',)", 0.05)
    deadline = time.monotonic() + 10
    while not seen and time.monotonic() < deadline:
        time.sleep(0.02)
    assert seen, "the watchdog did not expire"
    expired, bundles_then = seen[0]
    assert bundles_then, "the bundle came after the handler"
    names = [(e["name"], e.get("detail", "")) for e in journal.snapshot_events()]
    assert names[0] == ("watchdog_expired", "MPI_Allreduce call 0000002a exceeded 0.05s")
    assert names[1][0] == "health" and "0000002a stalled in flight" in names[1][1]
    bundle = json.loads(bundles_then[0].read_text())
    assert bundle["reasons"] == ["watchdog_expired: MPI_Allreduce call 0000002a"]
    assert [e["call_id"] for e in bundle["watchdog_inflight"]] == ["0000002a"]
    assert telemetry.snapshot()["meters"]["health.stalls"] == 1


def _op(rank, cid, t0, dur, seq=0):
    return {"type": "op", "op": "sendrecv", "call_id": cid, "seq": seq,
            "rank": rank, "process": rank, "t_begin": t0, "t_end": t0 + dur,
            "latency": dur, "bytes": 64, "dtype": "float32", "algo": "native"}


def _begin(rank, cid, t0):
    return {"kind": "begin", "call_id": cid, "rank": rank, "op": "sendrecv",
            "t": t0, "mono": t0}


def _bundle(process, records, reasons, inflight=(), dropped=0):
    return {"schema": "mpx-postmortem/1", "process": process,
            "reason": reasons[-1], "reasons": list(reasons), "t": 150.0,
            "snapshot": {}, "dropped": {"journal": dropped, "flight_ring": 0},
            "flight": {"version": 1, "capacity": 64, "total": len(records),
                       "dropped": 0, "records": records},
            "watchdog_inflight": list(inflight)}


def _write(d, bundles):
    d.mkdir(parents=True, exist_ok=True)
    for b in bundles:
        (d / f"postmortem-p{b['process']}.json").write_text(json.dumps(b))
    return str(d)


def _render_both(d):
    port = merge.render_postmortem(merge.postmortem_report(merge.read_bundles(d)))
    ref = jmerge.render_postmortem(jmerge.postmortem_report(jmerge.read_bundles(d)))
    return port, ref


def test_bundles_of_either_package_render_identically(monkeypatch, tmp_path):
    _arm(monkeypatch, ring=32)
    written = {}
    for name, c, j, h in (("port", core, journal, health),
                          ("jax", jcore, jjournal, jhealth)):
        d = tmp_path / name
        monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY_DIR", str(d))
        c.set_telemetry_mode("events")
        for k in range(3):
            j.begin(f"{k:08x}", 0, dict(_META))
            j.end(f"{k:08x}", 0, {"algo": "native"})
        j.instant("fault", 0, {"detail": "hang injected in MPI_Allreduce"})
        j.begin("00000003", 0, dict(_META))
        written[name] = h.dump_postmortem("fault: hang injected in MPI_Allreduce on rank 0")
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    shutil.copy(written["port"], mixed / "postmortem-p0.json")
    jb = json.loads(pathlib.Path(written["jax"]).read_text())
    jb["process"] = 1
    for rec in jb["flight"]["records"]:
        rec["rank"] = 1
    (mixed / "postmortem-p1.json").write_text(json.dumps(jb))
    for d in (tmp_path / "port", tmp_path / "jax", mixed):
        port, ref = _render_both(str(d))
        assert port == ref
        assert "suspected straggler: rank 0" in port
    assert "rank 1:" in _render_both(str(mixed))[0]


def test_postmortem_report_attributes_as_jax(tmp_path):
    d = _write(tmp_path, [
        _bundle(0, [_op(0, "c2", 100.0, 0.01), _begin(0, "c3", 101.0)],
                ["watchdog_expired: sendrecv call c3"],
                inflight=[{"opname": "MPI_Sendrecv", "call_id": "c3", "rank": 0,
                           "elapsed": 31.0, "timeout": 30.0}]),
        _bundle(3, [_op(3, "c2", 100.0, 0.01),
                    {"type": "instant", "name": "fault", "rank": 3, "process": 3,
                     "t": 100.5, "detail": "hang injected"}],
                ["fault: hang injected in MPI_Sendrecv on rank 3"], dropped=2),
    ])
    assert merge.postmortem_report(merge.read_bundles(d)) == \
        jmerge.postmortem_report(jmerge.read_bundles(d))
    port, ref = _render_both(d)
    assert port == ref
    assert "MISSING: rank(s) 3" in port and "suspected straggler: rank 3" in port
    assert "2 journal record(s)" in port


def test_one_bundle_per_rank_process_leaves_a_silent_rank_out(tmp_path):
    """The port writes one bundle per rank process: a rank that wrote none
    is absent from the report, where the JAX package's one bundle holds
    every rank's ring and names the rank that never arrived.  The report
    code is the JAX package's; the difference is what the bundles hold."""
    began = [_op(r, "c1", 100.0, 0.01) for r in range(3)]
    one = _write(tmp_path / "one", [_bundle(0, began + [
        _begin(0, "c2", 101.0), _begin(2, "c2", 101.1)], ["on_demand"])])
    per_rank = _write(tmp_path / "per_rank", [
        _bundle(0, [began[0], _begin(0, "c2", 101.0)], ["on_demand"]),
        _bundle(2, [began[2], _begin(2, "c2", 101.1)], ["on_demand"])])
    for d in (one, per_rank):
        assert _render_both(d)[0] == _render_both(d)[1]
    rep_one = merge.postmortem_report(merge.read_bundles(one))
    rep_per = merge.postmortem_report(merge.read_bundles(per_rank))
    assert rep_one["frontier"]["missing"] == [1]
    assert [s["rank"] for s in rep_one["suspects"]] == [1]
    # rank 1 wrote no bundle: no rank saw it, nothing names it
    assert sorted(rep_per["processes"]) == [0, 2]
    assert rep_per["frontier"]["missing"] == []
    assert rep_per["suspects"] == []
    assert "rank 1" not in merge.render_postmortem(rep_per)


def test_postmortem_cli_exit_codes_match_jax(tmp_path, capsys):
    assert merge.main(["postmortem", str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert jmerge.main(["postmortem", str(tmp_path)]) == 2
    assert capsys.readouterr().err == err and "no postmortem-p" in err
    _write(tmp_path, [_bundle(0, [_op(0, "c1", 1.0, 0.1)], ["on_demand"])])
    out = tmp_path / "report.txt"
    assert merge.main(["postmortem", str(tmp_path), "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert jmerge.main(["postmortem", str(tmp_path)]) == 0
    assert capsys.readouterr().out == printed == out.read_text()
    (tmp_path / "postmortem-p9.json").write_text("{nope")
    assert merge.main(["postmortem", str(tmp_path)]) == 2


def test_merge_warns_of_the_bundles_dropped_records_as_jax(tmp_path, capsys):
    rec = dict(_op(0, "c1", 1.0, 0.1))
    (tmp_path / "events-p0.jsonl").write_text(json.dumps(rec) + "\n")
    _write(tmp_path, [_bundle(3, [], ["on_demand"], dropped=2)])
    assert merge.main(["merge", str(tmp_path), "--no-skew"]) == 0
    port = capsys.readouterr()
    assert jmerge.main(["merge", str(tmp_path), "--no-skew"]) == 0
    ref = capsys.readouterr()
    assert port.err == ref.err and "journal: 2" in port.err
    assert port.out == ref.out


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------


def test_prometheus_text_byte_identical_to_jax(monkeypatch):
    _arm(monkeypatch, ring=4)
    _fixed_clock(monkeypatch)
    telemetry.set_telemetry_mode("counters")
    jcore.set_telemetry_mode("counters")
    comm = comm1()
    for op, nbytes, dtype in _port_calls(comm, 2):
        jcore.close_op(_jax_oprecord(op, comm.uid, nbytes, dtype))
    rng = np.random.default_rng(9)
    for v in rng.uniform(1e-5, 1e-2, 12):
        core.record_latency("sendrecv|0|native|int32", float(v))
    core.meter("health.postmortems")
    core.meter("watchdog.arms", 3)
    for h in (health, jhealth):
        for i in range(10):
            h.record_event({"type": "instant", "name": f"e{i}", "t": 1.0})
        for step in range(3):
            h.on_boundary(step)
        h.set_gauge("serving_slo_headroom_ms", 12.5)
        h.set_gauge("serving_kv_occupancy", 0.1 + 0.2)
    snap = core.snapshot(include_events=False)
    monkeypatch.setattr(jcore, "snapshot", lambda include_events=False: snap)
    text = health.prometheus_text()
    assert text == jhealth.prometheus_text()
    assert 'mpx_dropped_records_total{source="flight_ring"} 12' in text
    assert "mpx_health_boundaries_total 3" in text
    assert "mpx_op_latency_seconds_count{" in text


def test_prom_file_at_a_due_boundary(monkeypatch, tmp_path):
    _arm(monkeypatch, interval=2, MPI4JAX_TPU_HEALTH_PROM="1")
    monkeypatch.setenv("MPI4JAX_TPU_TELEMETRY_DIR", str(tmp_path))
    health.on_boundary(0)
    assert not list(tmp_path.glob("prom-p*.prom"))
    health.on_boundary(1)
    (prom,) = tmp_path.glob("prom-p*.prom")
    assert prom.name == "prom-p0.prom"
    assert prom.read_text() == health.prometheus_text()


# ---------------------------------------------------------------------------
# drills on four CPU ranks (models/runtime_drill.py)
# ---------------------------------------------------------------------------


def _drill(name, tmp_path):
    from mpi4jax_tpu_torch.models import runtime_drill

    return runtime_drill.run_drill(name, device="cpu", timeout=0.5, limit=45.0,
                                   workdir=str(tmp_path / name))


def _cli(d):
    return subprocess.run([sys.executable, "-m", "mpi4jax_tpu_torch.telemetry",
                           "postmortem", d], capture_output=True, text=True,
                          cwd=str(REPO), timeout=60)


def test_health_hang_drill_writes_four_bundles_and_names_rank_2(tmp_path):
    res = _drill("health_hang", tmp_path)
    assert res["exit"][2] == -9, res["exit"]   # killed once the others ended
    for r in (0, 1, 3):
        assert res["exit"][r] not in (0, None), res["stderr"][r]
    # the first waiting rank to abort prints the watchdog's line; the others
    # may end on the connection it closed, after their own bundles
    assert any("FATAL: collective watchdog: MPI_Sendrecv exceeded 0.5s" in res["stderr"][r]
               for r in (0, 1, 3)), res["stderr"]
    assert res["seconds"] < 30
    d = pathlib.Path(res["dir"])
    bundles = {p.name: json.loads(p.read_text()) for p in d.glob("postmortem-p*.json")}
    assert sorted(bundles) == [f"postmortem-p{r}.json" for r in range(4)]
    assert bundles["postmortem-p2.json"]["reasons"] == [
        "fault: hang injected in MPI_Sendrecv on rank 2"]
    for r in (0, 1, 3):
        (reason,) = bundles[f"postmortem-p{r}.json"]["reasons"]
        assert reason.startswith("watchdog_expired: MPI_Sendrecv call ")
    cli = _cli(res["dir"])
    assert cli.returncode == 0, cli.stderr
    assert "suspected straggler: rank 2 — fault incident journalled on this rank: " \
        "hang injected in MPI_Sendrecv" in cli.stdout
    assert cli.stdout.rstrip("\n") == _render_both(res["dir"])[1]


def test_health_die_drill_bundle_names_rank_1(tmp_path):
    res = _drill("health_die", tmp_path)
    assert res["exit"][1] == 13, res["stderr"][1]
    d = pathlib.Path(res["dir"])
    (only,) = d.glob("postmortem-p*.json")
    assert only.name == "postmortem-p1.json"
    assert json.loads(only.read_text())["reasons"] == [
        "fatal_fault: die injected in MPI_Sendrecv on rank 1"]
    cli = _cli(res["dir"])
    assert cli.returncode == 0, cli.stderr
    assert "suspected straggler: rank 1 — fault incident journalled on this rank: " \
        "die injected in MPI_Sendrecv" in cli.stdout


def test_hang_drill_aborts_the_others_and_kills_the_hung_rank(tmp_path):
    res = _drill("hang", tmp_path)
    assert res["exit"][2] == -9
    assert "r2 | FAULT | hang injected in MPI_Sendrecv" in res["stderr"][2]
    for r in (0, 1, 3):
        assert res["exit"][r] not in (0, None)
        assert f"r{r} | FATAL: collective watchdog" in res["stderr"][r]
    assert not list(pathlib.Path(res["dir"]).glob("postmortem-p*.json"))
    assert res["seconds"] < 30


# ---------------------------------------------------------------------------
# off is free
# ---------------------------------------------------------------------------


def test_off_feeds_nothing_and_keeps_the_snapshot_shape(monkeypatch):
    token = telemetry.telemetry_cache_token()
    telemetry.set_telemetry_mode("counters")
    _port_calls(comm1(), 2)
    assert health._ring is None and health.flight_snapshot()["total"] == 0
    assert "dropped" not in telemetry.snapshot()
    assert health._hook_unregister is None
    telemetry.set_telemetry_mode(None)
    assert telemetry.telemetry_cache_token() == token
    _arm(monkeypatch)
    assert telemetry.telemetry_cache_token() == token == (telemetry.effective_mode(),)


def test_health_flags_move_no_service_stamp(monkeypatch):
    assert not set(HEALTH_FLAGS) & set(config.SERVICE_FLAG_NAMES)
    before = config.service_stamp()
    _arm(monkeypatch, MPI4JAX_TPU_HEALTH_PROM="1", MPI4JAX_TPU_HEALTH_SUSPECTS="1")
    assert config.service_stamp() == before


@pytest.mark.parametrize("name", HEALTH_FLAGS)
def test_health_flags_enter_env_fingerprint(monkeypatch, name):
    assert name in config.FLAG_NAMES
    before = config.env_fingerprint()
    jbefore = jconfig.env_fingerprint()
    monkeypatch.setenv(name, "2")
    assert config.env_fingerprint() != before
    assert jconfig.env_fingerprint() != jbefore


PARSERS = [
    ("MPI4JAX_TPU_HEALTH", "health_mode", ["", "on", "OFF", " on ", "yes"]),
    ("MPI4JAX_TPU_HEALTH_INTERVAL", "health_interval", ["", "1", "7", "0", "x"]),
    ("MPI4JAX_TPU_FLIGHT_RING", "flight_ring_capacity", ["", "1", "4096", "0", "-3", "1.5"]),
    ("MPI4JAX_TPU_HEALTH_SUSPECTS", "health_suspects_enabled", ["", "1", "off", "maybe"]),
    ("MPI4JAX_TPU_HEALTH_PROM", "health_prom_enabled", ["", "true", "0", "2"]),
]


@pytest.mark.parametrize("name,fn,value", [
    (name, fn, v) for name, fn, values in PARSERS for v in values])
def test_health_flag_parsers_match_jax(monkeypatch, name, fn, value):
    monkeypatch.setenv(name, value)
    outcomes = []
    for mod in (config, jconfig):
        try:
            outcomes.append(("value", getattr(mod, fn)()))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    monkeypatch.delenv(name)
    assert getattr(config, fn)() == getattr(jconfig, fn)()


def test_arming_health_makes_no_per_op_hook(monkeypatch):
    from mpi4jax_tpu_torch.ops._base import per_op_hook

    telemetry.set_telemetry_mode("counters")
    _arm(monkeypatch)
    assert per_op_hook() is None


def test_toggling_health_after_a_pin_is_mpx129(monkeypatch):
    comm = comm1()
    x = torch.ones(4)
    pin = tpx.compile(lambda v: tpx.allreduce(v, op=tpx.SUM, comm=comm)[0], x, comm=comm)
    pin(x)
    monkeypatch.setenv("MPI4JAX_TPU_HEALTH", "on")
    with pytest.raises(tpx.StaleProgramError, match="MPX129"):
        pin(x)


# ---------------------------------------------------------------------------
# the top-level names
# ---------------------------------------------------------------------------


def test_all_differs_from_jax_only_by_the_later_items():
    assert sorted(set(mpx.__all__) - set(tpx.__all__)) == LEFT_TO_LATER_ITEMS
    assert sorted(set(tpx.__all__) - set(mpx.__all__)) == PORT_ONLY
    for name in tpx.__all__:
        assert getattr(tpx, name) is not None, name
    for name in VERIFIER_NAMES:
        assert name in tpx.__all__ and name in mpx.__all__, name
    # the JAX package's attribute outside its __all__
    assert tpx.analysis.analyze is tpx.analyze


def test_telemetry_exports_the_health_plane():
    import mpi4jax_tpu.telemetry as jtelemetry

    for name in ("health", "flight_snapshot", "dump_postmortem", "prometheus_text"):
        assert name in telemetry.__all__ and name in jtelemetry.__all__
        assert getattr(telemetry, name) is not None
    assert telemetry.health is health


def test_varying_materialises_a_fused_result_bit_for_bit():
    comm = comm1()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 3)).astype(np.float32))
    seen = {}

    @tpx.spmd(comm=comm)
    def fused(v):
        y, _ = tpx.allreduce(v, op=tpx.SUM)
        seen["lazy"] = type(y).__name__
        return tpx.varying(y, comm=comm)

    tpx.set_fusion_mode("auto")
    try:
        got = fused(x)
    finally:
        tpx.set_fusion_mode(None)
    want, _ = tpx.allreduce(x, op=tpx.SUM, comm=comm)
    assert seen["lazy"] == "LazyResult"
    assert isinstance(got, torch.Tensor) and torch.equal(got, want)


def test_varying_is_the_identity_on_tensors_and_trees():
    a, b = torch.ones(2), torch.zeros(3)
    out = tpx.varying({"a": a, "b": (b, 1)})
    assert out["a"] is a and out["b"][0] is b and out["b"][1] == 1


def test_cache_stats_keep_jax_keys_and_clear_caches_resets():
    assert set(tpx.cache_stats()) == set(mpx.cache_stats())
    tpx.clear_caches()
    tpx.set_check_numerics(True)
    try:
        comm = comm1()
        for _ in range(3):
            tpx.allreduce(torch.ones(2), op=tpx.SUM, comm=comm)
            tpx.allgather(torch.ones(2), comm=comm)
    finally:
        tpx.set_check_numerics(False)
    stats = tpx.cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (4, 2, 2)
    assert stats["disk_cache"]["enabled"] is False
    x = torch.ones(2)
    tpx.compile(lambda v: v * 2, x, comm=comm1())(x)
    assert tpx.cache_stats()["aot"]["pins"] == 1
    tpx.clear_caches()
    stats = tpx.cache_stats()
    assert (stats["hits"], stats["misses"], stats["evictions"], stats["size"]) == (0, 0, 0, 0)
    assert not any(stats["aot"].values())


def test_default_mesh_on_two_ranks():
    res = launch.run(RH.default_mesh_program, 2, device="cpu",
                     timeout=R0.RANK_TIMEOUT_S, args=(2,))
    for r, out in enumerate(res):
        assert out["same"] and out["comm_on_default"], out
        assert out["shape"] == (2,) and out["axes"] == ("mpi4jax",)
        assert out["rank"] == r and out["device"] == "cpu"
        assert out["replaced"] and out["rebuilt_new"]
        assert out["world_key"] == (2, r)


def test_default_mesh_can_be_set_in_one_process():
    from mpi4jax_tpu_torch.parallel import mesh

    saved = mesh._default_mesh
    try:
        grid = tpx.make_world_mesh((1,), ("mpi4jax",), device="cpu")
        tpx.set_default_mesh(grid)
        assert tpx.get_default_mesh() is grid
    finally:
        mesh._default_mesh = saved


def test_profile_ops_writes_the_op_ranges_and_fences_on_raise(tmp_path):
    comm = comm1()
    x = torch.ones(8)
    with tpx.profile_ops(str(tmp_path / "ok")) as prof:
        out, _ = tpx.allreduce(x, op=tpx.SUM, comm=comm)
    assert prof.backend == "cpu" and prof.fenced_arrays >= 2
    trace = json.loads(pathlib.Path(prof.trace_file).read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "mpi4jax_tpu.allreduce" in names
    # the capture is closed: an op call runs no range again
    from mpi4jax_tpu_torch.ops._base import hooks
    assert hooks() is None
    with pytest.raises(RuntimeError, match="boom"):
        with tpx.profile_ops(str(tmp_path / "raise")) as prof2:
            tpx.sendrecv(x, x, dest=tpx.shift(1), comm=comm)
            raise RuntimeError("boom")
    assert isinstance(prof2.fenced_arrays, int) and prof2.fenced_arrays > 0
    names = [e.get("name") for e in json.loads(
        pathlib.Path(prof2.trace_file).read_text())["traceEvents"]]
    assert "mpi4jax_tpu.sendrecv" in names
    assert hooks() is None


def test_profile_ops_keeps_a_pin_valid():
    comm = comm1()
    x = torch.ones(3)
    pin = tpx.compile(lambda v: tpx.allreduce(v, op=tpx.SUM, comm=comm)[0], x, comm=comm)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with tpx.profile_ops(d):
            assert torch.equal(pin(x), x)
    assert torch.equal(pin(x), x)


def test_capability_probes():
    assert tpx.has_cuda_support() is torch.cuda.is_available()
    assert tpx.has_tpu_support() is False
    assert tpx.has_sycl_support() is False
