"""Elastic grow and graceful drain, the parts that need no gloo ranks.

- The JAX package's scripted-store tests (``tests/test_elastic_pure.py``'s
  ``_FakeStore``: a drain mid-interval, a drain with no rank, a join at the
  next commit boundary, a join and a drain at one boundary), run on both
  packages' ``elastic.run``: identical steps seen, commits, shrinks,
  grows, restores, epoch histories and errors.
- ``describe_commit`` of the same values in both packages (numpy arrays
  for the JAX package, tensors for the port): after a JSON round trip the
  two agree in every key of the JAX package's description.
- The cold-join exchange: every old rank's contribution and the joiner's
  zeros sum to the committed buffer bit for bit, bf16 included, and the
  joiner rebuilds the state with its dtypes; a structure the spec cannot
  describe is refused, and a world holding one refuses joins.
- The control and join servers on localhost, the ``preempt`` probe (also
  after a shrink), the drained-comm registry and MPX127, the SIGTERM
  handler and the handlers ``run`` restores, the launch ranks a grow
  issues, and the single-process refusals.
"""

import collections
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

import mpi4jax_tpu.resilience.elastic as jel
import mpi4jax_tpu.resilience.faultinject as jfi
import mpi4jax_tpu_torch as tpx
import torch_ranks_elastic as RE
from mpi4jax_tpu_torch.resilience import elastic as el
from mpi4jax_tpu_torch.resilience import faultinject as fi
from torch_port_isolation import isolated_reference_state  # noqa: F401


@pytest.fixture(autouse=True)
def clean_both(monkeypatch):
    """Both packages' elastic state at its defaults before and after."""
    for name in ("MPI4JAX_TPU_ELASTIC_GROW", "MPI4JAX_TPU_ELASTIC_FAIL_UNIT",
                 "MPI4JAX_TPU_ELASTIC_PORT_SPAN", "MPI4JAX_TPU_TOPOLOGY",
                 "MPI4JAX_TPU_ELASTIC_PLACEMENT", "MPI4JAX_TPU_FAULT_SPEC",
                 "MPI4JAX_TPU_TELEMETRY", "MPI4JAX_TPU_HEALTH"):
        monkeypatch.delenv(name, raising=False)
    for mod in (el, jel):
        mod._reset_epoch_for_tests()
        mod.take_pending_failure()
    fi.reset_fault_state()
    yield
    for mod in (el, jel):
        mod._reset_epoch_for_tests()
        mod.take_pending_failure()
    fi.reset_fault_state()


# ---------------------------------------------------------------------------
# the JAX package's scripted store, on both loops
# ---------------------------------------------------------------------------


class _FakeComm:
    _uids = iter(range(10_000, 20_000))

    def __init__(self, size):
        self._size = size
        self.uid = next(self._uids)

    def world_size(self):
        return self._size


class _FakeStore:
    """Scripted ShardStore double: world of 4, shrink drops the failed
    ranks, grow appends, restore replays the committed (step, state)."""

    def __init__(self, world=4):
        self.redundancy = 1
        self.bootstrap = {}
        self.comm = _FakeComm(world)
        self.commits = []
        self._committed = None
        self.shrunk_with = None
        self.shrunk_unit = None
        self.grown_by = 0
        self.restores = 0
        self.drained = False

    @property
    def committed_step(self):
        return self._committed and self._committed[0]

    def commit(self, step, state):
        self._committed = (step, state)
        self.commits.append(step)

    def multiprocess(self):
        return False

    def apply_shrink(self, failed, fail_unit="rank"):
        self.shrunk_with = frozenset(failed)
        self.shrunk_unit = fail_unit
        self.comm = _FakeComm(self.comm.world_size() - len(self.shrunk_with))

    def apply_grow(self, added):
        self.grown_by += added
        self.comm = _FakeComm(self.comm.world_size() + added)

    def restore(self, failed=(), force_exchange=False):
        self.restores += 1
        return self._committed


def _drain_mid_interval(mod, store, seen):
    def step_fn(state, step, comm):
        seen.append((step, comm.world_size()))
        if step == 2 and store.shrunk_with is None:
            mod.request_drain(rank=3)
        return state + 1

    return mod.run(step_fn, 0, store, steps=6, commit_every=2)


def _drain_without_rank(mod, store, seen):
    def step_fn(state, step, comm):
        seen.append((step, comm.world_size()))
        mod.request_drain()
        return state

    return mod.run(step_fn, 0, store, steps=2)


def _join_at_commit(mod, store, seen):
    def step_fn(state, step, comm):
        seen.append((step, comm.world_size()))
        if step == 0:
            mod.post_simulated_join(2)
        return state + 1

    return mod.run(step_fn, 0, store, steps=6, commit_every=3)


def _join_and_drain(mod, store, seen):
    def step_fn(state, step, comm):
        seen.append((step, comm.world_size()))
        if step == 0:
            mod.post_simulated_join(1)
            mod.request_drain(rank=3)
        return state + 1

    return mod.run(step_fn, 0, store, steps=4, commit_every=1)


SCENARIOS = {"drain_mid_interval": _drain_mid_interval,
             "drain_without_rank": _drain_without_rank,
             "join_at_commit": _join_at_commit,
             "join_and_drain": _join_and_drain}

# what tests/test_elastic_pure.py asserts of the JAX package, scenario by
# scenario: (result, steps seen, commits, shrunk_with, grown_by, restores,
# causes in the epoch history)
EXPECTED = {
    "drain_mid_interval": (6, [(0, 4), (1, 4), (2, 4), (3, 3), (4, 3), (5, 3)],
                           [0, 2, 3, 4, 6], frozenset({3}), 0, 0, ["drain"]),
    "drain_without_rank": (("RuntimeError", "multi-process"), [(0, 4)], [0, 1],
                           None, 0, 0, []),
    "join_at_commit": (6, [(0, 4), (1, 4), (2, 4), (3, 6), (4, 6), (5, 6)],
                       [0, 3, 6], None, 2, 1, ["join"]),
    "join_and_drain": (4, [(0, 4), (1, 3), (2, 4), (3, 4)], [0, 1, 2, 3, 4],
                       frozenset({3}), 1, 1, ["drain", "join"]),
}


def _scripted(mod, scenario):
    mod._reset_epoch_for_tests()
    store, seen = _FakeStore(), []
    try:
        result = SCENARIOS[scenario](mod, store, seen)
    except RuntimeError as e:
        result = (type(e).__name__, str(e))
    return {"result": result, "seen": seen, "commits": store.commits,
            "shrunk_with": store.shrunk_with, "shrunk_unit": store.shrunk_unit,
            "grown_by": store.grown_by, "restores": store.restores,
            "history": mod.epoch_history(), "epoch": mod.current_epoch(),
            "pending_joins": mod.pending_join_count(),
            "peer_drain": mod.peek_peer_drain()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scripted_boundaries_match_jax(scenario):
    port, ref = _scripted(el, scenario), _scripted(jel, scenario)
    assert port == ref
    result, seen, commits, shrunk, grown, restores, causes = EXPECTED[scenario]
    if isinstance(result, tuple):
        assert port["result"][0] == result[0] and result[1] in port["result"][1]
    else:
        assert port["result"] == result
    assert port["seen"] == seen and port["commits"] == commits
    assert port["shrunk_with"] == shrunk and port["grown_by"] == grown
    assert port["restores"] == restores
    assert [h["cause"] for h in port["history"]] == causes
    assert port["pending_joins"] == 0 and port["peer_drain"] is None


def test_boundary_control_on_a_scripted_store_matches_jax():
    def drive(mod):
        mod._reset_epoch_for_tests()
        store = _FakeStore()
        out = []
        with mod.BoundaryControl(store, drain_on_sigterm=False) as bc:
            for step in range(1, 5):
                if step == 2:
                    mod.request_drain(rank=1)
                if step == 3:
                    mod.post_simulated_join(1)
                res = bc.poll(step, step * 10, committed=step != 2)
                out.append(res)
        return out, store.commits, store.shrunk_with, store.grown_by, \
            mod.epoch_history()

    port = drive(el)
    assert port == drive(jel)
    # the grow restores the last commit: the drain's forced one (poll's
    # committed=True says the caller's state is already committed)
    assert port[0] == [None, ("continue", 2, 20), ("continue", 2, 20), None]
    assert [h["detail"] for h in port[4]] == [
        "drained rank(s) [1] of 4", "admitted 1 replacement rank(s) -> world 4"]


@pytest.mark.parametrize("cause,failed,added", [
    ("failure", {3}, 0), ("drain", {2, 3}, 0), ("join", (), 2), ("revoke", {1}, 0)])
def test_revoke_epoch_details_match_jax(cause, failed, added):
    for mod in (el, jel):
        mod._reset_epoch_for_tests()
        mod.revoke_epoch(failed, rank=0, world=4, added=added, cause=cause)
    assert el.epoch_history() == jel.epoch_history()


def test_set_epoch_adopts_forward_only_as_jax():
    for mod in (el, jel):
        mod._reset_epoch_for_tests()
        mod._set_epoch(3)
        mod._set_epoch(3)
        with pytest.raises(ValueError, match="backwards"):
            mod._set_epoch(2)
    assert el.epoch_history() == jel.epoch_history()
    assert el.current_epoch() == 3


# ---------------------------------------------------------------------------
# describe_commit and the cold-join exchange
# ---------------------------------------------------------------------------


class _SizedComm:
    uid = 4242
    mesh = None

    def __init__(self, k):
        self._k = k

    def world_size(self):
        return self._k


def _states():
    rng = np.random.default_rng(11)
    f32 = rng.standard_normal((7, 5)).astype(np.float32)
    f64 = rng.standard_normal(13)
    i32 = rng.integers(-1000, 1000, (3, 4)).astype(np.int32)
    zero_d = np.asarray(rng.standard_normal(), np.float32)
    return {
        "flat": {"w": f32, "b": f64},
        "nested": {"params": {"w": f32, "n": i32}, "opt": [f64, (zero_d, i32)],
                   "scale": zero_d},
        "tuple_top": (f32, [i32, {"z": zero_d}], f64),
    }


def _torch_of(tree):
    if isinstance(tree, dict):
        return {k: _torch_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_of(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("name", sorted(_states()))
def test_describe_commit_matches_jax_after_json(monkeypatch, name, k):
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_GROW", "1")
    state = _states()[name]
    ref = jel.ShardStore(_SizedComm(k), redundancy=1, rank=0)
    ref.commit(7, state)
    port = el.ShardStore(_SizedComm(k), redundancy=1, rank=0)
    port.commit(7, _torch_of(state))
    assert port.can_describe_commit() and ref.can_describe_commit()
    want = json.loads(json.dumps(ref.describe_commit()))
    got = json.loads(json.dumps(port.describe_commit()))
    assert set(got) - set(want) == {"torch_dtypes"}
    for key in want:
        assert got[key] == want[key], key
    assert all(n in ("float32", "float64", "int32") for n in got["torch_dtypes"])


def _bf16_state():
    rng = np.random.default_rng(3)
    return {"w": torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32)),
            "h": torch.from_numpy(rng.standard_normal(21).astype(np.float32)).to(
                torch.bfloat16),
            "n": torch.tensor(7, dtype=torch.int64),
            "host": [rng.standard_normal(3), (np.int32(4),)]}


@pytest.mark.parametrize("k,redundancy", [(1, 0), (3, 1), (4, 1), (4, 2)])
def test_cold_join_exchange_reassembles_bit_for_bit(monkeypatch, k, redundancy):
    """Every old rank contributes the shards the plan makes it provider
    of, the joiner zeros; the sum rebuilds the committed state on the
    joiner (after a JSON round trip of the description) bit for bit, with
    its dtypes (bf16 through its integer view)."""
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_GROW", "1")
    state = _bf16_state()
    stores = {r: el.ShardStore(_SizedComm(k), redundancy=redundancy, rank=r)
              for r in range(k)}
    for s in stores.values():
        s.commit(5, state)
    desc = json.loads(json.dumps(stores[0].describe_commit()))
    cold = el.ShardStore(_SizedComm(k + 1), redundancy=redundancy, rank=k)
    cold.adopt_commit(desc)
    assert cold.committed_step == 5 and cold._committed["cold"]
    plan = el.plan_from_placement((), stores[0]._rec_placement(
        stores[0]._committed))
    contribs = [s.exchange_contribution(s._committed, plan)
                for s in stores.values()]
    joiner = cold.exchange_contribution(cold._committed, plan)
    assert not joiner.any()
    total = sum(c.astype(np.int64) for c in contribs) + joiner
    assert total.max() <= 255
    back = el._rebuild(cold._committed, total.astype(np.uint8), None)
    assert RE.state_bytes({"w": back["w"], "h": back["h"], "n": back["n"]}) == \
        RE.state_bytes({"w": state["w"], "h": state["h"], "n": state["n"]})
    assert back["h"].dtype == torch.bfloat16
    assert back["host"][0].tobytes() == state["host"][0].tobytes()
    assert isinstance(back["host"], list) and isinstance(back["host"][1], tuple)


Pair = collections.namedtuple("Pair", "a b")


@pytest.mark.parametrize("state", [
    Pair(torch.zeros(2), torch.ones(3)),
    collections.OrderedDict(w=torch.zeros(2)),
    {1: torch.zeros(2)},
], ids=["namedtuple", "ordereddict", "int_keys"])
def test_describe_commit_refuses_what_the_spec_cannot_rebuild(monkeypatch, state):
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_GROW", "1")
    store = el.ShardStore(_SizedComm(2), redundancy=1, rank=0)
    store.commit(1, state)
    assert not store.can_describe_commit()
    with pytest.raises(RuntimeError, match="not JSON-able"):
        store.describe_commit()


def test_describe_commit_refuses_with_the_grow_flag_off():
    store = el.ShardStore(_SizedComm(2), redundancy=1, rank=0)
    store.commit(1, {"w": torch.zeros(2)})
    assert store._committed["pure_spec"] is None
    assert not store.can_describe_commit()
    with pytest.raises(RuntimeError, match="MPI4JAX_TPU_ELASTIC_GROW"):
        store.describe_commit()


@pytest.mark.parametrize("describable", [True, False])
def test_a_world_that_cannot_describe_its_state_refuses_joins(monkeypatch,
                                                              describable):
    """Rank 0 reports no pending join when the commit cannot be described,
    so the SUM every rank reads is 0 and nobody moves an epoch."""
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_GROW", "1")
    tpx.set_telemetry_mode("counters")
    store = el.ShardStore(RE.world_comm(), bootstrap=RE.bootstrap(
        0, "file:///nonexistent", 1, size=1))
    state = {"w": torch.zeros(3)} if describable else Pair(torch.zeros(3), 1)
    store.commit(2, state)
    el.post_simulated_join(1)
    assert el._poll_joins(store) == (1 if describable else 0)
    meters = tpx.telemetry.snapshot()["meters"]
    assert meters.get("elastic.joins_refused", 0) == (0 if describable else 1)
    assert el.current_epoch() == 0


def test_a_cold_commit_restores_only_through_the_exchange(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_GROW", "1")
    src = el.ShardStore(RE.world_comm())
    src.commit(4, {"w": torch.arange(5.0)})
    step, back = src.restore(force_exchange=True)
    assert step == 4 and torch.equal(back["w"], torch.arange(5.0))
    cold = el.ShardStore(RE.world_comm())
    cold.adopt_commit(json.loads(json.dumps(src.describe_commit())))
    for force in (False, True):
        with pytest.raises(RuntimeError, match="holds no shards"):
            cold.restore(force_exchange=force)


# ---------------------------------------------------------------------------
# the control and join planes on localhost
# ---------------------------------------------------------------------------


def _free_port_base():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_notify_drain_returns_the_unacked_ranks(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_PORT_SPAN", "8")
    base = _free_port_base()
    servers = [el._ControlServer("localhost", el.control_port(base, r, 0))
               for r in (1, 2)]
    try:
        assert el.notify_drain("localhost", base, 0, 4, boundary=7, epoch=0,
                               grace=1.0) == [3]
        assert el.peek_peer_drain() == {"rank": 0, "boundary": 7}
        assert el._peer_drain_at and el._peer_drain_at[0] <= time.time()
    finally:
        for srv in servers:
            srv.stop()
    el.take_peer_drain()
    assert el.notify_drain("localhost", base, 0, 2, boundary=3, epoch=1,
                           grace=0.5) == [1]


def test_join_server_parks_and_the_admit_round_trips(monkeypatch, tmp_path):
    """The join handshake on localhost: the joiner finds the listener rank
    0 named beside the rendezvous, parks on the connection, and receives
    the admit message the coordinator sends at the boundary."""
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_PORT_SPAN", "8")
    base = _free_port_base()
    rdv = "file://" + str(tmp_path / "rdv")
    srv = el._JoinServer("localhost", el.join_port(base, 3))
    el._publish_join_port(rdv, "localhost", el.join_port(base, 3), 3)
    got = {}
    t = threading.Thread(target=lambda: got.update(admit=el.request_join(
        rdv, timeout=20.0, poll_interval=0.05)), daemon=True)
    try:
        t.start()
        deadline = time.monotonic() + 15.0
        while el.pending_join_count() == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        (parked,) = el._take_pending_joins()
        assert parked["info"]["kind"] == "join"
        el._send_json(parked["conn"], {"kind": "admit", "epoch": 4,
                                       "process_id": 3, "num_processes": 4,
                                       "origin": 5, "comm_uid": 17})
        parked["conn"].close()
        t.join(timeout=20.0)
        assert got["admit"]["process_id"] == 3 and got["admit"]["origin"] == 5
    finally:
        srv.stop()


class _Mute:
    """A listener that never speaks and records what it is sent (another
    service on a port an elastic client tries)."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.bind(("localhost", 0))
        self.srv.listen(8)
        self.srv.settimeout(0.1)
        self.port = self.srv.getsockname()[1]
        self.received = b""
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conns = []
        while not self.stop.is_set():
            try:
                conns.append(self.srv.accept()[0])
            except socket.timeout:
                pass
            for c in conns:
                c.setblocking(False)
                try:
                    self.received += c.recv(1 << 16)
                except (BlockingIOError, OSError):
                    pass
        for c in conns:
            c.close()
        self.srv.close()

    def close(self):
        self.stop.set()
        self.thread.join(5)


def test_elastic_clients_send_nothing_to_a_listener_that_does_not_greet(
        monkeypatch, tmp_path):
    mute = _Mute()
    rdv = "file://" + str(tmp_path / "rdv")
    el._publish_join_port(rdv, "localhost", mute.port, 0)
    try:
        with pytest.raises(RuntimeError, match="no coordinator admitted us"):
            el.request_join(rdv, timeout=2.5, poll_interval=0.05)
        base = mute.port - el.control_port(0, 1, 0)
        assert el.notify_drain("localhost", base, 0, 2, boundary=3, epoch=0,
                               grace=1.0) == [1]
    finally:
        mute.close()
    assert mute.received == b""


def test_a_control_message_larger_than_the_limit_is_refused():
    a, b = socket.socketpair()
    try:
        a.sendall((el._JSON_LIMIT + 1).to_bytes(8, "big"))
        with pytest.raises(OSError, match="not an elastic listener"):
            el._recv_json(b)
    finally:
        a.close()
        b.close()


def test_request_join_fails_loudly_without_a_world(tmp_path):
    with pytest.raises(RuntimeError, match="no coordinator admitted us"):
        el.request_join("file://" + str(tmp_path / "rdv"), timeout=0.3,
                        poll_interval=0.05)
    with pytest.raises(ValueError, match="file:// rendezvous"):
        el.request_join("tcp://localhost:1234", timeout=0.3)


def test_preempt_probe_posts_the_current_rank_and_grace():
    (c,) = fi.parse_fault_spec("preempt:rank=1:after=1:grace=3")
    indexed = ((0, c),)
    assert fi.probe_host(indexed, "MPI_Allreduce", 0) == 0
    assert el.take_pending_drain() is None
    fi.probe_host(indexed, "MPI_Allreduce", 1)
    assert el.take_pending_drain() is None
    assert fi.probe_host(indexed, "MPI_Allreduce", 1) == 0
    assert el.take_pending_drain() == {"rank": 1, "grace": 3.0}
    # the JAX package's probe posts the same notice
    (jc,) = jfi.parse_fault_spec("preempt:rank=1:after=0:grace=3")
    jfi.reset_fault_state()
    jfi.probe_host(((0, jc),), "MPI_Allreduce", 1)
    assert jel.take_pending_drain() == {"rank": 1, "grace": 3.0}


def test_preempt_after_a_shrink_names_the_current_rank():
    """After old rank 3 became rank 2, a clause on launch rank 3 fires on
    rank 2 and the notice names rank 2: the process the loop compares it
    with."""
    el._renumber_origin({0: 0, 1: 1, 3: 2}, 4)
    (c,) = fi.parse_fault_spec("preempt:rank=3:grace=2")
    for r in (0, 1):
        assert fi.probe_host(((0, c),), "MPI_Allreduce", r) == 0
    assert el.take_pending_drain() is None
    fi.probe_host(((0, c),), "MPI_Allreduce", 2)
    assert el.take_pending_drain() == {"rank": 2, "grace": 2.0}


# ---------------------------------------------------------------------------
# the drained-comm registry and MPX127
# ---------------------------------------------------------------------------


def test_drained_comm_registry_moves_as_jax():
    comm = RE.world_comm()
    for mod in (el, jel):
        assert mod.comm_draining(comm) is None and not mod.comm_drained(comm)
        mod.mark_comm_draining(comm, 7)
        assert mod.comm_draining(comm) == 7 and not mod.comm_drained(comm)
        mod.seal_drained_comm(comm)
        assert mod.comm_drained(comm) and mod.comm_draining(comm) is None
    assert comm.drained
    el._reset_epoch_for_tests()
    assert not comm.drained and not el.comm_drained(comm.uid)


def test_mpx127_on_a_sealed_comm_not_on_a_draining_one():
    comm = RE.world_comm()
    x = torch.arange(3.0)
    el.mark_comm_draining(comm, 4)
    assert torch.equal(tpx.allreduce(x, comm=comm)[0], x)   # still legal
    el.seal_drained_comm(comm)
    with pytest.raises(RuntimeError, match="leave boundary") as e:
        tpx.allreduce(x, comm=comm)
    assert e.value.mpx_code == "MPX127"
    # a survivor's drained comm is of a revoked epoch too: MPX127 first
    el.advance_epoch(cause="drain")
    for op in (lambda: tpx.allreduce(x, comm=comm), lambda: tpx.barrier(comm=comm)):
        with pytest.raises(RuntimeError, match="MPX127") as e:
            op()
        assert e.value.mpx_code == "MPX127"
    # another comm of the revoked epoch is MPX126, and a fresh one works
    with pytest.raises(RuntimeError, match="MPX126"):
        tpx.allreduce(x, comm=comm.Clone())
    assert torch.equal(tpx.allreduce(x, comm=RE.world_comm())[0], x)


# ---------------------------------------------------------------------------
# the SIGTERM handler and the handlers run restores
# ---------------------------------------------------------------------------


def _signal_delivered(deadline=5.0):
    end = time.monotonic() + deadline
    while not el._pending_drain and time.monotonic() < end:
        time.sleep(0.001)


def test_sigterm_posts_a_drain_in_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    prev = el.install_preemption_handler(grace=2.5)
    try:
        assert prev is before
        os.kill(os.getpid(), signal.SIGTERM)
        _signal_delivered()
        assert el.take_pending_drain() == {"rank": None, "grace": 2.5}
    finally:
        signal.signal(signal.SIGTERM, prev)
    # off the main thread nothing is installed
    got = []
    t = threading.Thread(target=lambda: got.append(el.install_preemption_handler()))
    t.start()
    t.join()
    assert got == [None] and signal.getsignal(signal.SIGTERM) is before


def _one_process_store(**kw):
    return el.ShardStore(RE.world_comm(), bootstrap=RE.bootstrap(
        0, "file:///nonexistent", _free_port_base(), size=1), **kw)


def test_run_drains_on_sigterm_and_restores_both_handlers():
    term, intr = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    store = _one_process_store()
    seen = []

    def step_fn(state, step, comm):
        seen.append((step, signal.getsignal(signal.SIGTERM) is not term,
                     signal.getsignal(signal.SIGINT) is not intr))
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
            _signal_delivered()
        return {"w": state["w"] + 1}

    out = el.run(step_fn, {"w": torch.zeros(2)}, store, steps=10,
                 commit_every=5)
    # the notice after step 2 is announced at boundary 3 and executed at
    # 4, with a forced commit: this process is the leaver
    assert [s for s, _, _ in seen] == [0, 1, 2, 3]
    assert all(t and i for _, t, i in seen)
    assert store.drained and torch.equal(out["w"], torch.full((2,), 4.0))
    assert store.committed_step == 4
    (notice, drain) = store.drains
    assert notice["boundary"] == 4 and notice["unacked"] == []
    assert drain["left"] and drain["forced"]
    assert signal.getsignal(signal.SIGTERM) is term
    assert signal.getsignal(signal.SIGINT) is intr


def test_run_restores_both_handlers_when_setup_fails():
    term, intr = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    store = _one_process_store()

    def fail(step, state):
        assert signal.getsignal(signal.SIGTERM) is not term
        raise RuntimeError("commit failed in setup")

    store.commit = fail
    with pytest.raises(RuntimeError, match="commit failed in setup"):
        el.run(lambda s, i, c: s, {"w": torch.zeros(1)}, store, steps=2)
    assert signal.getsignal(signal.SIGTERM) is term
    assert signal.getsignal(signal.SIGINT) is intr


def test_run_off_the_main_thread_installs_no_handler():
    term, intr = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    store = _one_process_store()
    seen, errors = [], []

    def step_fn(state, step, comm):
        seen.append((signal.getsignal(signal.SIGTERM) is term,
                     signal.getsignal(signal.SIGINT) is intr))
        return state

    def body():
        try:
            el.run(step_fn, {"w": torch.zeros(1)}, store, steps=2)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=body)
    t.start()
    t.join(30)
    assert errors == [] and seen == [(True, True), (True, True)]


# ---------------------------------------------------------------------------
# launch ranks, and what a world of one process refuses
# ---------------------------------------------------------------------------


def test_joiners_get_launch_ranks_no_clause_names():
    """After 4 -> 3 (launch rank 3 lost) the joiner is launch rank 4: a
    clause on rank 3 does not hit it, one on rank 4 does; every rank
    issues the same numbers."""
    el._renumber_origin({0: 0, 1: 1, 2: 2}, 4)
    assert el._issue_origins(3, 1) == (4,)
    el._append_origins(3, (4,))
    assert [el.origin_rank(r) for r in range(4)] == [0, 1, 2, 4]
    c3 = fi.parse_fault_spec("corrupt:rank=3")
    c4 = fi.parse_fault_spec("corrupt:rank=4")
    assert fi.probe_host(tuple(enumerate(c3)), "MPI_Allreduce", 3) == 0
    assert fi.probe_host(tuple(enumerate(c4)), "MPI_Allreduce", 3) == 1
    # a second grow continues the count; a world never shrunk starts at
    # its own size
    assert el._issue_origins(4, 2) == (5, 6)
    el._reset_epoch_for_tests()
    assert el._issue_origins(3, 1) == (3,)
    el._adopt_origins([0, 2, 9], 10)
    assert el.origin_rank(2) == 9 and el._issue_origins(3, 1) == (10,)


def test_apply_grow_in_a_world_of_one_process_raises():
    from mpi4jax_tpu_torch.parallel.mesh import grow_world_mesh

    store = el.ShardStore(RE.world_comm())
    store.commit(0, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="not initialised"):
        store.apply_grow(1)
    with pytest.raises(ValueError, match="added must be >= 1"):
        store.apply_grow(0)
    with pytest.raises(ValueError, match="only 1-D grids can grow"):
        grow_world_mesh(tpx.make_world_mesh((1, 1), ("y", "x"), device="cpu"), 1)


def test_join_and_run_refuses_an_armed_health_plane(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_HEALTH", "on")
    store = el.ShardStore(None, bootstrap={"rendezvous": "file:///x",
                                           "host": "localhost", "port_base": 1})
    with pytest.raises(RuntimeError, match="health plane is armed"):
        el.join_and_run(lambda s, i, c: s, store, steps=1, join_timeout=0.1)
    with pytest.raises(RuntimeError, match="missing 'rendezvous'"):
        el.join_and_run(lambda s, i, c: s, el.ShardStore(None, bootstrap={
            "host": "localhost", "port_base": 1}), steps=1)


def test_comm_uids_resume_where_the_world_numbers_them():
    from mpi4jax_tpu_torch.parallel import comm as comm_mod

    n = comm_mod.next_uid()
    assert comm_mod.next_uid() == n            # a peek, not a draw
    assert RE.world_comm().uid == n
    comm_mod.resume_uids_at(n + 40)
    assert RE.world_comm().uid == n + 40


def test_port_exports_the_drain_entry_points():
    import mpi4jax_tpu as mpx

    for name in ("request_drain", "install_preemption_handler"):
        assert name in tpx.__all__ and name in mpx.__all__
        assert getattr(tpx, name) is getattr(el, name)
        assert name in tpx.resilience.__all__
    for name in jel.__all__:
        assert name in el.__all__, name
