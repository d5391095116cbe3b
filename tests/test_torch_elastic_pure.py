"""The elastic layer's pure half against the JAX package's, exactly.

``mpi4jax_tpu_torch/resilience/elastic.py`` keeps its own copy of the
JAX package's pure functions (placement, reconstruction, renumbering,
the port arithmetic, the agreement models and their TCP runtime,
failure classification, byte packing); these tests call both on the same
arguments and compare the results for equality: no tolerance.  The TCP
agreement runs on localhost threads, one per simulated rank.  Two
checks start processes of their own (``tests/torch_ranks_elastic.py``):
gloo's peer-death error classifies as a ``RankFailure``, and
``destroy_process_group`` returns with a dead or a hung peer.
"""

import itertools
import json
import os
import socket
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi4jax_tpu.resilience.elastic as jel
from mpi4jax_tpu.utils import config as jconfig
from mpi4jax_tpu_torch.resilience import elastic as el
from mpi4jax_tpu_torch.resilience import runtime as trt
from mpi4jax_tpu_torch.utils import config as tconfig
from torch_port_isolation import isolated_reference_state  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
KS = [1, 2, 3, 4, 5, 7, 8, 12, 16]
REDUNDANCY = [0, 1, 2, 3]


def topologies(k):
    """Host splits of ``k`` ranks: none, one host, the squarest uniform
    split, an uneven split and a spec string."""
    out = [None, (k,)]
    hosts = max(1, int(k ** 0.5))
    while k % hosts:
        hosts -= 1
    out.append((k // hosts,) * hosts)
    if k >= 3:
        out.append((1, k - 1))
        out.append(f"{hosts}x{k // hosts}")
    return out


def both(name, *args, **kwargs):
    """``(port result, JAX result)``, or the exception type each raised."""
    res = []
    for mod in (el, jel):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                res.append(getattr(mod, name)(*args, **kwargs))
        except (ValueError, RuntimeError) as e:
            res.append((type(e).__name__, str(e)))
    return res


def failed_sets(k):
    """Every failed set of up to two ranks, and one of three."""
    out = [()]
    out += [(r,) for r in range(k)]
    out += list(itertools.combinations(range(k), 2))
    if k >= 3:
        out.append((0, k // 2, k - 1))
    return out


# ---------------------------------------------------------------------------
# placement and reconstruction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("r", REDUNDANCY)
def test_placement_tables_and_plans_match_jax(k, r):
    for nbytes in (0, 1, 1000 + k):
        got, want = both("shard_bounds", nbytes, k)
        assert got == want
    for s in range(k):
        got, want = both("replica_ranks", s, k, r)
        assert got == want
        got, want = both("shards_held_by", s, k, r)
        assert got == want
    tables = []
    for topo in topologies(k):
        got, want = both("stripe_placement", k, r, topo)
        assert got == want, topo
        tables.append(got)
    got, want = both("neighbor_placement", k, r)
    assert got == want
    tables.append(got)
    for table in tables:
        for rank in range(k):
            assert el.placement_shards_held_by(rank, table) == \
                jel.placement_shards_held_by(rank, table)
        for failed in failed_sets(k):
            assert el.placement_recoverable(failed, table) == \
                jel.placement_recoverable(failed, table)
            assert el.recoverable(failed, k, r, table) == \
                jel.recoverable(failed, k, r, table)
            got, want = both("plan_from_placement", failed, table)
            if isinstance(got, dict):
                assert got == want
            else:  # both raise RankFailure (a RuntimeError)
                assert got[0] == want[0] == "RankFailure"
            got, want = both("reconstruction_plan", failed, k, r, table)
            assert got == want or got[0] == want[0] == "RankFailure"
    got, want = both("reconstruction_plan", (), k, r)
    assert got == want


# ---------------------------------------------------------------------------
# renumbering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8, 16])
def test_compact_rank_map_and_shrink_groups_match_jax(world):
    groups_list = [
        (tuple(range(world)),),
        tuple((i,) for i in range(world)),
        (tuple(range(0, world, 2)), tuple(range(1, world, 2))),
        (tuple(reversed(range(world))),),
    ]
    for failed in failed_sets(world) + [tuple(range(world)), (world,)]:
        got, want = both("compact_rank_map", world, failed)
        assert got == want or (isinstance(got, tuple) and got[0] == want[0])
        for groups in groups_list:
            groups = tuple(g for g in groups if g)
            got, want = both("shrink_groups", groups, failed, world)
            assert got == want or (isinstance(got, tuple) and got[0] == want[0])


@pytest.mark.parametrize("shape", [(4,), (8,), (2, 2), (2, 4), (4, 2), (3, 3),
                                   (2, 2, 2)])
@pytest.mark.parametrize("unit", ["rank", "row", "col", "bogus"])
def test_expand_fail_unit_and_shrunken_shape_match_jax(shape, unit):
    world = int(np.prod(shape))
    for failed in failed_sets(world)[:12] + [(world - 1,), (world + 3,)]:
        got, want = both("expand_fail_unit", failed, shape, unit)
        assert got == want
        if isinstance(got, frozenset) and len(shape) <= 2 and unit != "bogus":
            new, jnew = both("shrunken_shape", shape, got, unit)
            assert new == jnew


# ---------------------------------------------------------------------------
# the port arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("span", [None, 1, 3, 64])
def test_port_arithmetic_matches_jax(span):
    for base, epoch in itertools.product((20000, 31337), range(0, 140, 7)):
        for name in ("coordinator_port", "join_port", "agree_port"):
            got, want = both(name, base, epoch, span)
            assert got == want, (name, base, epoch)
        for rank in (0, 2, 63, 64):
            got, want = both("control_port", base, rank, epoch, span)
            assert got == want
        got, want = both("wrapped_epoch", epoch, span)
        assert got == want
    assert both("wrapped_epoch", 3, 0)[0][0] == "ValueError"


# ---------------------------------------------------------------------------
# the agreement models
# ---------------------------------------------------------------------------


def link_matrices(world, seed):
    """Healthy, dead-rank, partitioned and random link matrices."""
    rng = np.random.default_rng(seed)
    full = [[i != j for j in range(world)] for i in range(world)]
    yield full
    for dead in ([world - 1], [0], [world // 2]):
        yield [[i != j and i not in dead and j not in dead
                for j in range(world)] for i in range(world)]
    half = world // 2
    yield [[i != j and (i < half) == (j < half) for j in range(world)]
           for i in range(world)]
    for _ in range(3):
        m = rng.random((world, world)) > 0.25
        yield [[bool(m[i, j] and m[j, i]) and i != j for j in range(world)]
               for i in range(world)]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gossip_and_coordinator_agreement_match_jax(world, seed):
    rng = np.random.default_rng(100 + seed)
    for links in link_matrices(world, seed):
        suspects = {r: sorted(set(int(v) for v in rng.integers(0, world, 2)
                                  if rng.random() < 0.3) - {r})
                    for r in range(world)}
        got, want = both("gossip_agreement", suspects, links)
        assert got == want
        for coord in {0, world - 1}:
            got, want = both("coordinator_agreement", suspects, links, coord)
            assert got == want
        for failed in failed_sets(world)[:8]:
            assert el.majority_survives(failed, world) == \
                jel.majority_survives(failed, world)
    bad = {0: [world + 1]}
    got, want = both("gossip_agreement", bad, [[False] * world] * world)
    assert got[0] == want[0] == "ValueError"


# ---------------------------------------------------------------------------
# the TCP agreement on localhost threads
# ---------------------------------------------------------------------------


def _ephemeral_low(default=32768):
    """The first port of the kernel's ephemeral range, from which outgoing
    connections (gloo's among them) take their local ports."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return default


def _free_base(width):
    """A window of ``width`` ports free now, drawn below the ephemeral
    range (an outgoing connection of another worker cannot take one of
    them between this check and the threads' binds), from this xdist
    worker's own slice of it."""
    top = min(32000, _ephemeral_low()) - width
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    slot = int(worker[2:]) if worker[2:].isdigit() else 0
    span = (top - 10000) // 8
    lo = 10000 + (slot % 8) * span
    for _ in range(40):
        base = int(np.random.default_rng().integers(lo, lo + span))
        try:
            for p in range(base, base + width):
                with socket.socket() as s:
                    s.bind(("localhost", p))
            return base
        except OSError:
            continue
    raise RuntimeError("no free port window")


def _threads(fn, ranks):
    out, errors = {}, {}

    def run(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 - the error is the result
            errors[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in ranks]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return out, errors


@pytest.mark.parametrize("dead", [(), (3,), (1, 3)])
def test_exchange_suspects_reaches_the_gossip_fixpoint(dead):
    world = 5
    base = _free_base(world)
    live = [r for r in range(world) if r not in dead]
    # only the lowest survivor names the dead: propagation, not echo
    local = {r: (list(dead) if r == live[0] else []) for r in live}
    got, errors = _threads(lambda r: el.exchange_suspects(
        r, world, local[r], "localhost", base, timeout=3.0), live)
    assert not errors
    links = [[i != j and i not in dead and j not in dead for j in range(world)]
             for i in range(world)]
    want = jel.gossip_agreement(local, links)
    for r in live:
        assert got[r] == want[r] == frozenset(dead)


@pytest.mark.parametrize("dead", [(3,), (2, 4)])
def test_coordinator_exchange_reaches_the_model_verdict(dead):
    world = 5
    port = _free_base(1)
    live = [r for r in range(world) if r not in dead]
    local = {r: [] for r in live}
    got, errors = _threads(lambda r: el.coordinator_exchange_suspects(
        r, world, local[r], "localhost", port, timeout=2.0), live)
    assert not errors
    links = [[i != j and i not in dead and j not in dead for j in range(world)]
             for i in range(world)]
    want = jel.coordinator_agreement(local, links)
    for r in live:
        assert got[r] == want[r] == frozenset(dead)


def test_negotiate_failed_degrades_to_gossip_with_the_coordinator_dead():
    world, dead = 4, (0,)
    agree = _free_base(1)
    gossip = _free_base(world)
    live = [1, 2, 3]
    got, errors = _threads(lambda r: el.negotiate_failed(
        r, world, [], "localhost", agree_port_no=agree,
        gossip_port_base=gossip, timeout=3.0), live)
    assert not errors
    links = [[i != j and i not in dead and j not in dead for j in range(world)]
             for i in range(world)]
    want = jel.gossip_agreement({r: [] for r in live}, links)
    for r in live:
        assert got[r] == want[r] == frozenset(dead)


def test_negotiate_failed_takes_the_coordinator_star():
    world = 4
    agree = _free_base(1)
    gossip = _free_base(world)
    live = [0, 1, 2]
    got, errors = _threads(lambda r: el.negotiate_failed(
        r, world, [3] if r == 2 else [], "localhost", agree_port_no=agree,
        gossip_port_base=gossip, timeout=4.0, mode="coordinator"), live)
    assert not errors
    assert all(got[r] == frozenset({3}) for r in live)


# ---------------------------------------------------------------------------
# failure classification
# ---------------------------------------------------------------------------


GLOO_PEER_DEATH = ("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                   "Connection closed by peer [127.0.0.1]:4242")
GLOO_TIMEOUT = ("[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:81] "
                "Timed out waiting 2000ms for recv operation to complete")
EXCEPTIONS = [
    RuntimeError(GLOO_PEER_DEATH),
    RuntimeError(GLOO_TIMEOUT),
    RuntimeError("DEADLINE_EXCEEDED: barrier timed out"),
    OSError("Connection reset by peer"),
    RuntimeError("the coordination service has shut down"),
    ValueError("connection refused but a ValueError"),
    KeyboardInterrupt(),
    RuntimeError("shapes do not match"),
]


@pytest.mark.parametrize("i", range(len(EXCEPTIONS)))
@pytest.mark.parametrize("pending", [False, True])
def test_classify_failure_matches_jax(i, pending):
    exc = EXCEPTIONS[i]
    for mod in (el, jel):
        mod.take_pending_failure()
    out = []
    for mod in (el, jel):
        if pending:
            mod._post_failure(mod.RankFailure((), "watchdog expiry: x"))
        rf = mod.classify_failure(exc)
        out.append(None if rf is None else (sorted(rf.suspects), rf.detail))
        mod.take_pending_failure()
    assert out[0] == out[1]
    for mod in (el, jel):
        explicit = mod.RankFailure({2}, "named")
        mod._post_failure(mod.RankFailure({1}, "claim"))
        rf = mod.classify_failure(explicit)
        out.append((sorted(rf.suspects), rf.detail))
    assert out[2] == out[3] == ([1, 2], "named")


def test_gloo_timeout_without_a_claim_is_an_ordinary_error():
    assert el.classify_failure(RuntimeError(GLOO_TIMEOUT)) is None
    rf = el.classify_failure(RuntimeError(GLOO_PEER_DEATH))
    assert isinstance(rf, el.RankFailure) and rf.suspects == frozenset()


def _peer_run(tmp_path, world, mode):
    out = tmp_path / "record.json"
    rdv = "file://" + str(tmp_path / "rdv")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPI4JAX_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(REPO / "tests"),
                                         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" /
                                                   "torch_ranks_elastic.py"),
                               str(r), str(world), rdv, mode, str(out)],
                              env=env, cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for p in procs[:-1]:
            p.wait(40)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return json.loads(out.read_text())


def test_gloo_peer_death_classifies_and_teardown_returns(tmp_path):
    rec = _peer_run(tmp_path, 2, "die")
    assert rec["error"] is not None and rec["classified"], rec
    assert rec["suspects"] == []
    assert rec["destroy_s"] < 5.0 and not rec["initialized_after"]


def test_teardown_with_a_hung_peer_does_not_block(tmp_path):
    rec = _peer_run(tmp_path, 3, "hang")
    # the collective breaks on the process group's 2 s timeout, which
    # classifies as no failure without a claimed watchdog
    assert rec["error"] is not None and not rec["classified"], rec
    assert rec["collective_s"] < 10.0
    assert rec["destroy_s"] < 5.0 and not rec["initialized_after"]


# ---------------------------------------------------------------------------
# packing, the cache token, the knobs
# ---------------------------------------------------------------------------


def _leaf_sets():
    rng = np.random.default_rng(3)
    return [
        [],
        [np.float32(1.5)],
        [rng.standard_normal((3, 5)).astype(np.float32),
         np.arange(7, dtype=np.int64), np.float64(2.25),
         rng.standard_normal((2, 2, 3)).astype(np.float16)],
        [np.asfortranarray(rng.standard_normal((4, 3))), np.zeros((0, 2), np.int8),
         np.array([True, False])],
    ]


@pytest.mark.parametrize("i", range(4))
def test_pack_leaves_bytes_match_jax_and_round_trip(i):
    leaves = _leaf_sets()[i]
    buf, meta = el.pack_leaves(leaves)
    jbuf, jmeta = jel.pack_leaves(leaves)
    assert buf.tobytes() == jbuf.tobytes() and meta == jmeta
    back = el.unpack_leaves(buf, meta)
    for a, b in zip(back, leaves):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b)
        assert a.tobytes() == np.ascontiguousarray(b).tobytes()


def test_commit_restore_round_trip_of_tensors_in_one_rank():
    """A world of one rank: every shard local, the restore bit for bit,
    tensors back as tensors (bfloat16 through an integer view)."""
    from mpi4jax_tpu_torch import Comm, make_world_mesh

    mesh = make_world_mesh(device="cpu")
    store = el.ShardStore(Comm(mesh.axes[0], mesh=mesh))
    rng = np.random.default_rng(9)
    state = {"a": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)),
             "b": [torch.arange(4, dtype=torch.bfloat16), np.float32(3.0)],
             "c": (torch.tensor(7),)}
    store.commit(3, state)
    step, back = store.restore()
    assert step == 3 and store.held_shards() == (0,)
    assert torch.equal(back["a"], state["a"]) and back["a"].dtype == torch.float32
    assert back["b"][0].dtype == torch.bfloat16 and torch.equal(back["b"][0], state["b"][0])
    assert back["b"][1] == np.float32(3.0) and isinstance(back["c"], tuple)
    assert int(back["c"][0]) == 7


@pytest.mark.parametrize("env", [
    {},
    {"MPI4JAX_TPU_ELASTIC_GROW": "1"},
    {"MPI4JAX_TPU_ELASTIC_FAIL_UNIT": "row"},
    {"MPI4JAX_TPU_ELASTIC_PORT_SPAN": "8"},
    {"MPI4JAX_TPU_DRAIN_GRACE_S": "2.5"},
    {"MPI4JAX_TPU_ELASTIC_REDUNDANCY": "2", "MPI4JAX_TPU_ELASTIC_PLACEMENT":
     "neighbor", "MPI4JAX_TPU_ELASTIC_AGREEMENT": "gossip"},
])
def test_elastic_knobs_and_cache_token_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for name in ("elastic_redundancy", "elastic_grow", "elastic_fail_unit",
                 "elastic_placement", "elastic_agreement", "elastic_port_span"):
        assert getattr(tconfig, name)() == getattr(jconfig, name)(), name
    assert el.elastic_cache_token() == jel.elastic_cache_token()
    assert trt.cache_token()[4] == el.elastic_cache_token()
    for name in env:
        assert name in tconfig.FLAG_NAMES


@pytest.mark.parametrize("name,raw", [
    ("MPI4JAX_TPU_ELASTIC_FAIL_UNIT", "diagonal"),
    ("MPI4JAX_TPU_ELASTIC_PLACEMENT", "random"),
    ("MPI4JAX_TPU_ELASTIC_AGREEMENT", "vote"),
    ("MPI4JAX_TPU_ELASTIC_PORT_SPAN", "0"),
    ("MPI4JAX_TPU_ELASTIC_REDUNDANCY", "-1"),
    ("MPI4JAX_TPU_ELASTIC_GROW", "maybe"),
])
def test_bad_elastic_knobs_raise_as_in_jax(monkeypatch, name, raw):
    monkeypatch.setenv(name, raw)
    fn = {"MPI4JAX_TPU_ELASTIC_FAIL_UNIT": "elastic_fail_unit",
          "MPI4JAX_TPU_ELASTIC_PLACEMENT": "elastic_placement",
          "MPI4JAX_TPU_ELASTIC_AGREEMENT": "elastic_agreement",
          "MPI4JAX_TPU_ELASTIC_PORT_SPAN": "elastic_port_span",
          "MPI4JAX_TPU_ELASTIC_REDUNDANCY": "elastic_redundancy",
          "MPI4JAX_TPU_ELASTIC_GROW": "elastic_grow"}[name]
    for cfg in (tconfig, jconfig):
        with pytest.raises(ValueError):
            getattr(cfg, fn)()


def test_epoch_history_matches_jax():
    try:
        for mod in (el, jel):
            mod._reset_epoch_for_tests()
            assert mod.current_epoch() == 0 and mod.epoch_history() == []
            mod.advance_epoch(world=3, cause="failure", detail="shrank out rank(s) [3] of 4")
            mod.advance_epoch()
        assert el.epoch_history() == jel.epoch_history()
        assert el.current_epoch() == jel.current_epoch() == 2
    finally:
        for mod in (el, jel):
            mod._reset_epoch_for_tests()


def test_align_and_auto_commit_interval_match_jax():
    from mpi4jax_tpu.autotune.fit import auto_commit_interval

    for every, unroll in itertools.product(range(1, 9), range(1, 6)):
        assert el.align_commit_every(every, unroll) == \
            jel.align_commit_every(every, unroll)
    for step_s, commit_s in itertools.product((0.0, 1e-4, 0.01, 0.5),
                                              (0.0, 1e-5, 0.002, 0.3, 50.0)):
        assert el.resolve_auto_commit_interval(step_s, commit_s) == \
            auto_commit_interval(step_s, commit_s)


def test_fault_clauses_address_launch_ranks():
    """After a shrink renumbered old rank 3 as rank 2, a clause that names
    rank 2 does not fire on it, and one that names rank 3 does."""
    from mpi4jax_tpu_torch.resilience import faultinject as fi

    try:
        el._renumber_origin({0: 0, 1: 1, 3: 2})
        assert [el.origin_rank(r) for r in range(3)] == [0, 1, 3]
        fi.reset_fault_state()
        c2 = fi.parse_fault_spec("corrupt:rank=2")
        c3 = fi.parse_fault_spec("corrupt:rank=3")
        assert fi.probe_host(tuple(enumerate(c2)), "MPI_Allreduce", 2) == 0
        assert fi.probe_host(tuple(enumerate(c3)), "MPI_Allreduce", 2) == 1
    finally:
        el._reset_epoch_for_tests()
        fi.reset_fault_state()


def _window(base, ranks, epochs=4):
    """Every port ``free_port_base`` checked for a window at ``base``."""
    span = tconfig.elastic_port_span()
    ports = {el.agree_port(base, e, span) for e in range(epochs)}
    ports |= {el.join_port(base, e, span) for e in range(epochs)}
    ports |= {base + 100 + 17 * el.wrapped_epoch(e, span) + r
              for e in range(epochs) for r in range(ranks)}
    ports |= {el.control_port(base, r, e, span)
              for e in range(2) for r in range(min(ranks, span))}
    return ports


@pytest.mark.parametrize("low", [None, 20000])
@pytest.mark.parametrize("worker", ["gw0", "gw5", "master"])
def test_free_port_base_draws_below_the_ephemeral_range(monkeypatch, low, worker):
    """The launcher's window lies below the host's ephemeral range (read
    from /proc), in this worker's slice, whatever the range's low end;
    the serving drill (``models/serving.py:launch``, 3 ranks) gets one
    whose every port binds."""
    from mpi4jax_tpu_torch.models import elastic_training as ET

    if low is not None:
        monkeypatch.setattr(ET, "ephemeral_low", lambda default=32768: low)
    monkeypatch.setenv("PYTEST_XDIST_WORKER", worker)
    top = min(32000, ET.ephemeral_low())
    for ranks in (3, 4):
        base = ET.free_port_base(ranks)
        ports = _window(base, ranks)
        assert ET.PORT_FLOOR <= min(ports) and max(ports) < top
        for p in ports:
            with socket.socket() as s:
                s.bind(("localhost", p))


@pytest.mark.parametrize("worker", ["gw3", None])
def test_free_port_base_windows_of_one_process_are_disjoint(monkeypatch, worker):
    """The windows one process draws in a row share no port, as phase 13
    of the smoke script needs for the four drills it launches side by
    side (a and h at 4 and 8 ranks); without pytest-xdist the range is
    every port below the ephemeral range, with it the worker's slice."""
    from mpi4jax_tpu_torch.models import elastic_training as ET

    if worker is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER", worker)
    lo, hi = ET.port_range()
    top = min(32000, ET.ephemeral_low())
    if worker is None:
        assert (lo, hi) == (ET.PORT_FLOOR, top)
    else:
        width = (top - ET.PORT_FLOOR) // ET.PORT_SLICES
        assert (lo, hi) == (ET.PORT_FLOOR + 3 * width, ET.PORT_FLOOR + 4 * width)
    windows = [_window(ET.free_port_base(n), n) for n in (4, 4, 4, 8, 3, 4)]
    for i, w in enumerate(windows):
        assert lo <= min(w) and max(w) < hi
        for other in windows[i + 1:]:
            assert not w & other


def test_warm_step_touches_no_state_and_needs_a_device(monkeypatch):
    """The replacement's warm-up before it knocks: one forward and backward
    on zeros of the drill's shapes, which leaves torch's generator and grad
    mode as they were, and raises without a card unless the caller asks for
    the CPU, as the port's entry points do."""
    from mpi4jax_tpu_torch.models import elastic_training as ET

    rng = torch.get_rng_state()
    with torch.no_grad():
        ET.warm_step(16, 32, "cpu")
        assert not torch.is_grad_enabled()
    assert torch.equal(torch.get_rng_state(), rng)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ET.warm_step(16, 32, None)


def test_the_replacement_warms_its_step_before_it_knocks(monkeypatch, tmp_path):
    """``run_joiner`` runs ``warm_step`` at the drill's width before
    ``join_and_run`` knocks, so the survivors never wait, under the
    watchdog, in the allreduce of a replacement's cold first step."""
    from mpi4jax_tpu_torch.models import elastic_training as ET

    calls = []
    monkeypatch.setattr(ET, "warm_step",
                        lambda dim, hidden, device: calls.append(
                            ("warm", dim, hidden, device)))

    def join_and_run(step_fn, store, **kw):
        calls.append(("join",))
        raise RuntimeError("stop after the knock")

    monkeypatch.setattr(el, "join_and_run", join_and_run)
    args = ET._parse_args(
        ["--join", "--device", "cpu", "--dim", "24", "--hidden", "40",
         "--port-base", "20000", "--watchdog", "0",
         "--rendezvous", "file://" + str(tmp_path / "rv")])
    ET._timeouts(args)
    with pytest.raises(RuntimeError, match="stop after the knock"):
        ET.run_joiner(args)
    assert calls == [("warm", 24, 40, "cpu"), ("join",)]
