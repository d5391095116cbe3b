"""Elastic shrink-and-resume on gloo ranks on the CPU.

- The example twin (``models/elastic_training.py``) on four ranks with a
  simulated ``RankFailure({3})`` after step 5 of 12: the survivors end at
  world 3, epoch 1, rank 3 declared failed; each step's loss matches the
  JAX example's (``examples/elastic_training.py`` run in a subprocess on
  four virtual CPU devices: 13 losses) in the f32 SUM band the port's
  data-parallel tests use for losses, rtol 1e-5; and the losses after the
  restore are bit for bit those of a clean 3-rank run from the restored
  state.
- The ``die`` and ``hang`` drills (``die:rank=3`` / ``hang:rank=2``,
  ``op=allreduce:after=5``, watchdog 1 s, process-group timeout 3 s):
  the survivors finish at world 3 within ``DRILL_LIMIT_S``; no watchdog
  abort; the hung rank is killed by the launcher.
- ``ShardStore`` on tensors on four ranks, redundancy 1, stripe and
  neighbor placement: a commit and restore round trip, a loss the
  placement cannot recover, and a restore on the three survivors after a
  revoke and re-bootstrap, bit for bit.
- ``aot.compile_step(unroll=2)`` under ``elastic.run`` over a 4 -> 3
  shrink (the twin of the JAX package's megastep shrink drill), with the
  health plane on: only megastep boundaries dispatched, a re-pin and a
  stale refusal, one ``epoch_change`` and one ``rank_failed`` incident in
  each survivor's journal, a bundle with ``epochs``.
- MPX126, ``apply_shrink`` and the suspect hand-off in one process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpi4jax_tpu_torch as tpx
import torch_ranks as R0
import torch_ranks_elastic as RE
from mpi4jax_tpu_torch import aot
from mpi4jax_tpu_torch.models import elastic_training as ET
from mpi4jax_tpu_torch.parallel import launch
from mpi4jax_tpu_torch.resilience import elastic
from torch_port_isolation import isolated_reference_state  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STEPS, FAIL_STEP = 12, 5
DRILL_LIMIT_S = 60.0
LOSS_RTOL = 1e-5  # the port's f32 SUM band for losses (test_torch_data_parallel)


def _rdv(tmp):
    return "file://" + str(Path(tmp) / "rdv")


# ---------------------------------------------------------------------------
# the example twin
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """The 4 -> 3 example run, the JAX example's losses, and the clean
    3-rank run from the restored state; once per test run."""
    def compute():
        d = tmp_path_factory.mktemp("elastic-example")
        res = ET.launch(4, steps=STEPS, device="cpu", fault_spec="",
                        fail_step=FAIL_STEP, watchdog=0, pg_timeout=30.0,
                        agree_timeout=20.0, out=str(d / "port.json"),
                        limit=120.0, workdir=str(d / "run"))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("MPI4JAX_TPU_")}
        env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
        jout = d / "jax.json"
        jax_run = subprocess.run(
            [sys.executable, str(REPO / "examples" / "elastic_training.py"),
             "--steps", str(STEPS), "--fail-step", str(FAIL_STEP),
             "--out", str(jout)],
            env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
        want = json.loads(jout.read_text()) if jout.exists() else None
        clean = None
        if res["results"][0] is not None and "restored_step" in res["results"][0]:
            with np.load(Path(res["dir"]) / "state-p0.npz") as z:
                params = {k.split("/", 1)[1]: z[k] for k in z.files
                          if k.startswith("restored/")}
            start = res["results"][0]["restored_step"]
            clean = launch.run(RE.clean_run_program, 3, device="cpu",
                               timeout=R0.RANK_TIMEOUT_S,
                               args=(params, start, STEPS,
                                     _rdv(d / "clean"), ET.free_port_base(3)))
        finals = {}
        for r in range(4):
            path = Path(res["dir"]) / f"state-p{r}.npz"
            if path.exists():
                with np.load(path) as z:
                    finals[r] = {k: z[k] for k in z.files}
        ports = {}
        for r in range(4):
            p = d / f"port.json.p{r}"
            if p.exists():
                ports[r] = json.loads(p.read_text())
        return {"res": res, "want": want, "jax_rc": jax_run.returncode,
                "jax_err": jax_run.stderr[-2000:], "clean": clean,
                "finals": finals, "ports": ports}

    return R0.shared_result(tmp_path_factory, "elastic-example", compute)


def test_example_survives_a_simulated_loss_at_world_3_epoch_1(simulated):
    res = simulated["res"]
    assert res["ok"], res["stderr"]
    assert res["completed"] == [0, 1, 2]
    assert res["exit"][3] == 3
    assert ET.DECLARED_TAG in res["stdout"][3]
    assert res["results"][3]["declared_failed"]
    for r in (0, 1, 2):
        out = res["results"][r]
        assert out["final_world"] == 3 and out["epoch"] == 1
        assert out["epoch_history"] == [{"epoch": 1, "world": 3,
                                         "cause": "failure",
                                         "detail": "shrank out rank(s) [3] of 4"}]
        (rec,) = out["recoveries"]
        assert rec["failed"] == [3] and rec["step"] == FAIL_STEP
    # the JAX example's --out keys, rank by rank
    for r in (0, 1, 2):
        assert sorted(simulated["ports"][r]) == ["drained", "final_world", "losses"]


def test_example_losses_match_the_jax_example(simulated):
    want = simulated["want"]
    assert want is not None, simulated["jax_err"]
    got = simulated["res"]["results"][0]["losses"]
    assert len(got) == len(want["losses"]) == 13
    assert [(g["step"], g["world"], g["epoch"]) for g in got] == \
        [(w["step"], w["world"], w["epoch"]) for w in want["losses"]]
    np.testing.assert_allclose([g["loss"] for g in got],
                               [w["loss"] for w in want["losses"]],
                               rtol=LOSS_RTOL)
    assert want["final_world"] == 3
    # every survivor saw the same losses, bit for bit
    for r in (1, 2):
        assert [g["loss"] for g in simulated["res"]["results"][r]["losses"]] == \
            [g["loss"] for g in got]


def test_losses_after_the_restore_are_a_clean_three_rank_run(simulated):
    clean = simulated["clean"]
    assert clean is not None
    got = simulated["res"]["results"][0]["losses"]
    after = [(g["step"], g["world"], g["loss"]) for g in got if g["epoch"] == 1]
    for r in range(3):
        assert clean[r]["losses"] == after
    for r in range(3):
        for k, v in clean[r]["params"].items():
            assert v.tobytes() == simulated["finals"][r][f"final/{k}"].tobytes()
    # the survivors end with identical parameters
    for r in (1, 2):
        for k in clean[0]["params"]:
            assert simulated["finals"][r][f"final/{k}"].tobytes() == \
                simulated["finals"][0][f"final/{k}"].tobytes()


# ---------------------------------------------------------------------------
# the die and hang drills
# ---------------------------------------------------------------------------


def _drill(tmp_path, spec):
    return ET.launch(4, steps=STEPS, device="cpu", fault_spec=spec,
                     watchdog=1.0, limit=DRILL_LIMIT_S,
                     workdir=str(tmp_path / "run"))


def test_die_drill_finishes_the_budget_at_world_3(tmp_path):
    res = _drill(tmp_path, "die:rank=3:op=allreduce:after=5")
    assert res["ok"], res["stderr"]
    assert res["exit"][3] == 13
    assert "r3 | FAULT | die injected in MPI_Allreduce" in res["stderr"][3]
    assert res["completed"] == [0, 1, 2]
    for r in (0, 1, 2):
        out = res["results"][r]
        assert out["final_world"] == 3 and out["epoch"] == 1
        assert out["losses"][-1]["step"] == STEPS - 1
        assert out["recoveries"][0]["failed"] == [3]
    assert res["seconds"] < DRILL_LIMIT_S


def test_hang_drill_recovers_without_a_watchdog_abort(tmp_path):
    res = _drill(tmp_path, "hang:rank=2:op=allreduce:after=5")
    assert res["ok"], res["stderr"]
    assert res["exit"][2] == -9  # killed by the launcher once the others ended
    assert "r2 | FAULT | hang injected in MPI_Allreduce" in res["stderr"][2]
    assert res["completed"] == [0, 1, 3]
    for r in (0, 1, 3):
        assert "FATAL" not in res["stderr"][r]
        out = res["results"][r]
        assert out["final_world"] == 3 and out["epoch"] == 1
        assert out["recoveries"][0]["failed"] == [2]
    # old rank 3 is rank 2 of the new world, and the hang clause (launch
    # rank 2) does not fire on it
    assert res["results"][3]["losses"][-1]["step"] == STEPS - 1
    assert res["seconds"] < DRILL_LIMIT_S


# ---------------------------------------------------------------------------
# ShardStore on tensors
# ---------------------------------------------------------------------------


def _unrecoverable(table):
    """A two-rank loss that takes every copy of some shard under ``table``."""
    for a in range(4):
        for b in range(a + 1, 4):
            if not elastic.placement_recoverable({a, b}, table):
                return (a, b)
    raise AssertionError(table)


# (placement, topology, shards held per rank): the 2x2 stripe and the ring
# give every rank 2 of the 4 shards; the 1x3 stripe gives rank 0 all four,
# so the ranks would differ on restoring locally if each chose alone
STORE_CASES = {"stripe": ("stripe", (2, 2), (2, 2, 2, 2)),
               "neighbor": ("neighbor", None, (2, 2, 2, 2)),
               "stripe-1x3": ("stripe", (1, 3), (4, 2, 1, 1))}


@pytest.fixture(scope="module", params=sorted(STORE_CASES))
def store_world(request, tmp_path_factory):
    placement, topology, held = STORE_CASES[request.param]
    table = (elastic.stripe_placement(4, 1, topology) if topology
             else elastic.neighbor_placement(4, 1))
    bad = _unrecoverable(table)

    def compute():
        d = tmp_path_factory.mktemp(f"elastic-store-{request.param}")
        return launch.run(RE.store_program, 4, device="cpu",
                          timeout=R0.RANK_TIMEOUT_S,
                          args=(placement, topology, bad, _rdv(d),
                                ET.free_port_base(4)))
    return table, held, R0.shared_result(
        tmp_path_factory, f"elastic-store-{request.param}", compute)


def test_shard_store_round_trip_and_shrink_restore(store_world):
    table, held, per_rank = store_world
    for r, out in enumerate(per_rank):
        assert out["table"] == table
        assert out["held"] == elastic.placement_shards_held_by(r, table)
        assert len(out["held"]) == held[r]
        assert out["step0"] == 7 and out["same0"]
        assert out["unrecoverable_raised"]
        assert "shrinks through ShardStore.rebootstrap" in out["apply_shrink"]
    assert per_rank[3]["left"]
    for r in range(3):
        out = per_rank[r]
        assert out["rank_map"] == {0: 0, 1: 1, 2: 2}
        assert out["last_rank_map"] == {0: 0, 1: 1, 2: 2}
        assert out["step1"] == 7 and out["same1"]
        assert (out["world"], out["rank"]) == (3, r)
        assert out["epoch"] == out["current_epoch"] == 1
        assert out["old_comm"] == "MPX126"
        assert out["new_sum"] == 3.0


# ---------------------------------------------------------------------------
# compile_step under run, and the health plane's elastic half
# ---------------------------------------------------------------------------


UNROLL = 2


@pytest.fixture(scope="module")
def megastep_world(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-megastep")
        tdir = d / "telemetry"
        return launch.run(RE.compile_step_program, 4, device="cpu",
                          timeout=R0.RANK_TIMEOUT_S,
                          args=(UNROLL, STEPS, _rdv(d), ET.free_port_base(4),
                                str(tdir)))
    return R0.shared_result(tmp_path_factory, "elastic-megastep", compute)


def test_compile_step_unroll_2_repins_across_the_shrink(megastep_world):
    assert "declared failed" in megastep_world[3]["declared"]
    for r in range(3):
        out = megastep_world[r]
        steps = [s for s, _ in out["calls"]]
        assert all(s % UNROLL == 0 for s in steps), steps
        # the failure inside the megastep [4, 6) restores the commit of
        # step 4, and the new world's first call is refused, re-pinned and
        # retried from there
        assert out["calls"][:4] == [(0, 0), (2, 0), (4, 0), (4, 1)]
        assert out["calls"][4:] == [(s, 1) for s in range(4, STEPS, UNROLL)]
        assert out["stats"]["pins"] >= 2 and out["stats"]["stale_raises"] >= 1
        assert out["world"] == 3 and out["epoch"] == 1
        assert out["committed"] == STEPS
    # the survivors end with the same state
    for r in (1, 2):
        assert megastep_world[r]["w"].tobytes() == megastep_world[0]["w"].tobytes()


def test_the_survivors_journal_the_shrink_and_bundle_the_epochs(megastep_world):
    for r in range(3):
        out = megastep_world[r]
        assert out["epoch_changes"] == ["epoch 0 -> 1: shrank out rank(s) [3] of 4"]
        (failed,) = out["rank_failed"]
        assert failed.startswith("rank 3 agreed failed: simulated loss")
        assert out["bundle_epochs"] == [{"epoch": 1, "world": 3,
                                         "cause": "failure",
                                         "detail": "shrank out rank(s) [3] of 4"}]
        # a process keeps its launch rank's bundle file
        assert out["bundle_file"] == f"postmortem-p{r}.json"


def test_run_refuses_a_budget_not_divisible_by_unroll():
    store = elastic.ShardStore(RE.world_comm())
    step = aot.compile_step(RE.megastep_body, unroll=UNROLL)
    with pytest.raises(ValueError, match="multiple of the step function's"):
        elastic.run(step, {"w": torch.zeros(3)}, store, steps=5)


def test_compile_step_is_stale_on_a_new_comm_in_one_process():
    comm = RE.world_comm()
    calls = []

    def body(state, step, c):
        calls.append(int(step))
        return {"w": state["w"] + step.float()}

    es = aot.compile_step(body)
    aot.reset_stats()
    out = es({"w": torch.zeros(2)}, 3, comm)
    assert torch.equal(out["w"], torch.full((2,), 3.0))
    assert not es.pinned.graph  # the CPU: an eager pin
    with pytest.raises(aot.StaleProgramError, match="MPX129"):
        es(out, 4, RE.world_comm())
    es.repin()
    es(out, 4, comm)
    assert aot.stats()["aot"]["pins"] == 2
    assert aot.stats()["aot"]["stale_raises"] == 1
    assert calls == [3, 4]


# ---------------------------------------------------------------------------
# in one process
# ---------------------------------------------------------------------------


def test_mpx126_on_a_revoked_comm_and_a_fresh_comm_passes():
    old = RE.world_comm()
    clone = old.Clone()
    x = torch.arange(3.0)
    assert torch.equal(tpx.allreduce(x, comm=old)[0], x)
    elastic.advance_epoch(cause="revoke")
    for c in (old, clone, old.sub(old.axes[0])):
        assert c.epoch == 0
        with pytest.raises(RuntimeError, match="MPX126") as e:
            tpx.allreduce(x, comm=c)
        assert e.value.mpx_code == "MPX126"
    with pytest.raises(RuntimeError, match="MPX126"):
        tpx.barrier(comm=old)
    fresh = RE.world_comm()
    assert fresh.epoch == fresh.Clone().epoch == 1
    assert torch.equal(tpx.allreduce(x, comm=fresh)[0], x)


def test_apply_shrink_in_a_world_of_one_process():
    store = elastic.ShardStore(RE.world_comm())
    store.commit(0, {"w": torch.ones(2)})
    assert store.apply_shrink(()) == {0: 0}
    assert store.last_rank_map == {0: 0}
    with pytest.raises(elastic.RankFailure, match="no survivors"):
        store.apply_shrink({0})


def test_run_lets_an_unshrinkable_failure_propagate_in_a_world_of_one():
    """The loop's control flow in one process: a step raises a
    classifiable error, the claim is adopted, and a world of one rank
    cannot shrink (no survivors): the failure propagates."""
    store = elastic.ShardStore(RE.world_comm())

    def step(state, i, comm):
        if i == 1:
            raise RuntimeError("Connection closed by peer")
        return {"w": state["w"] + 1}

    with pytest.raises(elastic.RankFailure, match="empty failed set"):
        elastic.run(step, {"w": torch.zeros(1)}, store, steps=3)
    assert store.committed_step == 1


def test_suspect_handoff_posts_a_rank_failure(monkeypatch):
    from mpi4jax_tpu_torch.telemetry import health

    monkeypatch.setenv("MPI4JAX_TPU_HEALTH", "on")
    monkeypatch.setenv("MPI4JAX_TPU_HEALTH_SUSPECTS", "1")
    elastic.take_pending_failure()
    rf = health._post_suspects([3, 1])
    assert isinstance(rf, elastic.RankFailure)
    assert rf.suspects == frozenset({1, 3})
    assert "persistent straggler(s) 1, 3" in rf.detail
    assert elastic.take_pending_failure() is rf


def _grid(shape, axes, rank=0):
    from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid

    return ProcessGrid(tuple(shape), tuple(axes), torch.device("cpu"), rank)


def test_comm_shrink_validates_the_grid_and_stamps_the_epoch():
    import mpi4jax_tpu.resilience.elastic as jel

    old = tpx.Comm("x", mesh=_grid((4,), ("x",), rank=1))
    assert old.world_size() == 4 and old.epoch == 0
    elastic.advance_epoch(cause="failure")
    new = old.shrink({3}, mesh=_grid((3,), ("x",), rank=1))
    assert new.epoch == 1 and new.uid != old.uid and new.Get_size() == 3
    with pytest.raises(ValueError, match="3 of 4 ranks survive"):
        old.shrink({3}, mesh=_grid((4,), ("x",)))
    with pytest.raises(elastic.RankFailure, match="no survivors"):
        old.shrink(range(4), mesh=_grid((1,), ("x",)))
    # a color split keeps its partition, renumbered as shrink_groups does
    split = old.Split([0, 1, 0, 1])
    assert split.epoch == old.epoch == 0 and split.world_size() == 4
    shrunk = split.shrink({3}, mesh=_grid((3,), ("x",), rank=1))
    assert shrunk.groups == jel.shrink_groups(((0, 2), (1, 3)), {3}, 4) \
        == ((0, 2), (1,))
    assert shrunk.epoch == 1 and split.Clone().epoch == 0


def test_shrink_world_mesh_refuses_rank_removal_on_a_2d_grid():
    from mpi4jax_tpu_torch.parallel.mesh import shrink_world_mesh

    with pytest.raises(ValueError, match="only 1-D grids can shrink by rank"):
        shrink_world_mesh(_grid((2, 2), ("y", "x")), {3}, "rank")
    with pytest.raises(ValueError, match="no surviving ranks"):
        shrink_world_mesh(_grid((2, 2), ("y", "x")), {0, 3}, "row")
    # a world of one process builds the grid of its own size only: the
    # survivors' world must exist first (a re-bootstrap)
    with pytest.raises(RuntimeError, match="not initialised"):
        shrink_world_mesh(_grid((2, 2), ("y", "x")), {3}, "row")


def test_auto_commit_interval_is_agreed_across_ranks(tmp_path):
    """Each rank times its own step and commit; the loop locks in the
    largest interval on every rank, so every rank commits the same
    steps (a restore reads shards of one step)."""
    per_rank = launch.run(RE.auto_commit_program, 3, device="cpu",
                          timeout=R0.RANK_TIMEOUT_S, args=(40,))
    agreed = {out["agreed"] for out in per_rank}
    assert len(agreed) == 1 and agreed.pop() >= 1
    assert per_rank[0]["committed"] == per_rank[1]["committed"] == \
        per_rank[2]["committed"]
    assert per_rank[0]["committed"][-1] == 40
