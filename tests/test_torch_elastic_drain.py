"""Graceful drains, row shrinks and grows on gloo ranks on the CPU.

The CPU twins of ``chip_smoke.py`` phase 13 (e)-(h), at the example's own
width (``models/elastic_training.py``, 12 steps, the launcher's files),
each against a clean run of the world it ends in, bit for bit:

- (e) a real SIGTERM to rank 3 after its step 5 (``launch(sigterm=)``):
  ranks 0-2 finish at world 3, epoch 1, cause ``drain``; rank 3 exits 0
  drained; one ``drain`` incident a process, no watchdog expiry, no
  restore; the survivors from the forced commit on are a clean 3-rank
  run from it;
- (f) ``preempt:rank=3`` on a (2,2) grid under
  ``MPI4JAX_TPU_ELASTIC_FAIL_UNIT=row``: ranks 2 and 3 drain, ranks 0 and
  1 finish on (1,2), a clean (1,2) run from the forced commit;
- (g) ``die:rank=3`` on the same grid and fail unit, stripe placement
  over ``MPI4JAX_TPU_TOPOLOGY=2,2``: rank 2 is shrunk out with rank 3,
  ranks 0 and 1 finish on (1,2), a clean (1,2) run from the restore;
- (h) ``die:rank=3`` with ``--grow`` and ``commit_every="auto"``: 4 -> 3
  -> 4, the joiner (launch rank 4) completes the budget, all four final
  parameter sets are equal, the losses from the admission on are a clean
  4-rank run from the admitted state, and each is within ``LOSS_RTOL`` of
  the JAX example's step on four virtual CPU devices from those
  parameters.

And ``BoundaryControl`` polled by a loop other than ``elastic.run`` (three
ranks, rank 2 drains: MPX127 on the old comm, a ring on the new one), and
a joiner admitted while the world still measures ``commit_every="auto"``
(every rank locks in the same interval at the same boundary).  Each world
runs once per test run (``R0.shared_result``), each launch with its own
limit.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import torch_ranks as R0
import torch_ranks_elastic as RE
from mpi4jax_tpu_torch.models import elastic_training as ET
from mpi4jax_tpu_torch.parallel import launch
from torch_port_isolation import isolated_reference_state  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STEPS = 12
GROW_STEPS = 16
DRILL_LIMIT_S = 60.0
LOSS_RTOL = 1e-5  # the port's f32 SUM band for losses (test_torch_elastic)
COUNTERS = {"MPI4JAX_TPU_TELEMETRY": "counters"}
ROW = {"MPI4JAX_TPU_ELASTIC_FAIL_UNIT": "row"}


def _rdv(tmp):
    return "file://" + str(Path(tmp) / "rdv")


def _state(res, name, prefix):
    with np.load(Path(res["dir"]) / f"state-{name}.npz") as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(prefix + "/")}


def _clean_from(d, res, name, epoch, size, steps, grid=None):
    """A clean run of ``size`` ranks from the state the first step of
    ``epoch`` was handed on process ``name``."""
    out = (res["results"][int(name[1:])] if name.startswith("p")
           else res["joiners"][0]["result"])
    start = out["restored_steps"][str(epoch)]
    return start, launch.run(
        RE.clean_run_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(_state(res, name, f"epoch{epoch}"), start, steps,
              _rdv(d / "clean"), ET.free_port_base(size), grid))


def _after(out, epoch):
    return [(x["step"], x["world"], x["loss"]) for x in out["losses"]
            if x["epoch"] >= epoch]


def _assert_clean(res, clean, ranks, epoch, names=None):
    names = names or [f"p{r}" for r in ranks]
    outs = [res["results"][r] if isinstance(r, int) else r for r in ranks]
    for i, (out, name) in enumerate(zip(outs, names)):
        assert [tuple(x) for x in clean[i]["losses"]] == _after(out, epoch), name
        final = _state(res, name, "final")
        for k, v in clean[i]["params"].items():
            assert final[k].tobytes() == v.tobytes(), (name, k)


# ---------------------------------------------------------------------------
# (e) a real SIGTERM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sigterm_drill(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-sigterm")
        res = ET.launch(4, steps=STEPS, device="cpu", fault_spec="",
                        sigterm=(3, 5), watchdog=1.0, commit_every="4",
                        out=str(d / "port.json"), env=COUNTERS,
                        expect_world=3, limit=DRILL_LIMIT_S,
                        workdir=str(d / "run"))
        start, clean = _clean_from(d, res, "p0", 1, 3, STEPS)
        ports = {r: json.loads((d / f"port.json.p{r}").read_text())
                 for r in range(4)}
        return {"res": res, "clean": clean, "start": start, "ports": ports}

    return R0.shared_result(tmp_path_factory, "elastic-sigterm", compute)


def test_sigterm_drains_rank_3_and_the_others_finish_at_world_3(sigterm_drill):
    res = sigterm_drill["res"]
    assert res["ok"], res["stderr"]
    assert res["exit"] == [0, 0, 0, 0]
    assert res["completed"] == [0, 1, 2] and res["drained"] == [3]
    assert ET.DRAINED_TAG in res["stdout"][3]
    for r in range(4):
        out = res["results"][r]
        meters = out["meters"]
        assert meters["elastic.drain_incidents"] == 1, r
        assert "watchdog.expiries" not in meters and "elastic.restores" not in meters
        assert out["recoveries"] == []
        execute = out["drains"][-1]
        # the hold after step 5: announced at boundary 6, executed at 7,
        # off the commit_every=4 cadence, so the commit there is forced
        assert execute["step"] == 7 and execute["forced"] and execute["leaver"] == 3
    for r in range(3):
        out = res["results"][r]
        assert out["final_world"] == 3 and out["epoch"] == 1
        assert out["epoch_history"] == [{"epoch": 1, "world": 3, "cause": "drain",
                                         "detail": "drained rank(s) [3] of 4"}]
        assert out["losses"][-1]["step"] == STEPS - 1
        assert out["drains"][0]["notice_at"] is not None
    leaver = res["results"][3]
    assert leaver["drained"] and leaver["meters"]["elastic.preempt_notices"] == 1
    notice = leaver["drains"][0]
    assert notice["boundary"] == 7 and notice["unacked"] == []
    assert [r["drained"] for r in sigterm_drill["ports"].values()] == \
        [False, False, False, True]


def test_sigterm_drain_is_a_clean_3_rank_run_from_the_forced_commit(sigterm_drill):
    res = sigterm_drill["res"]
    assert sigterm_drill["start"] == 7
    _assert_clean(res, sigterm_drill["clean"], [0, 1, 2], 1)


# ---------------------------------------------------------------------------
# (f) a row drain, (g) a row shrink by a failure
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def row_drain(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-row-drain")
        res = ET.launch(4, steps=STEPS, device="cpu",
                        fault_spec="preempt:rank=3:op=allreduce:after=5",
                        grid="2x2", watchdog=1.0, commit_every="4",
                        env=dict(COUNTERS, **ROW), expect_world=2,
                        limit=DRILL_LIMIT_S, workdir=str(d / "run"))
        start, clean = _clean_from(d, res, "p0", 1, 2, STEPS, grid=(1, 2))
        return {"res": res, "clean": clean, "start": start}

    return R0.shared_result(tmp_path_factory, "elastic-row-drain", compute)


def test_row_drain_takes_ranks_2_and_3_and_leaves_a_1x2_grid(row_drain):
    res = row_drain["res"]
    assert res["ok"], res["stderr"]
    assert res["exit"] == [0, 0, 0, 0]
    assert res["completed"] == [0, 1] and res["drained"] == [2, 3]
    for r in range(4):
        out = res["results"][r]
        assert out["meters"]["elastic.drain_incidents"] == 1
        assert "watchdog.expiries" not in out["meters"]
        assert out["drains"][-1]["removed"] == [2, 3]
    for r in (2, 3):
        assert res["results"][r]["drained"]
    for r in (0, 1):
        out = res["results"][r]
        assert out["final_world"] == 2 and out["epoch"] == 1
        assert out["epoch_history"][0]["detail"] == "drained rank(s) [2, 3] of 4"
        assert out["meters"]["elastic.row_shrinks"] == 1
        assert out["losses"][-1]["world"] == 2


def test_row_drain_is_a_clean_1x2_run_from_the_forced_commit(row_drain):
    res = row_drain["res"]
    assert res["results"][0]["drains"][-1]["forced"]
    _assert_clean(res, row_drain["clean"], [0, 1], 1)


@pytest.fixture(scope="module")
def row_failure(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-row-failure")
        env = dict(COUNTERS, **ROW, MPI4JAX_TPU_ELASTIC_PLACEMENT="stripe",
                   MPI4JAX_TPU_TOPOLOGY="2,2")
        res = ET.launch(4, steps=STEPS, device="cpu",
                        fault_spec="die:rank=3:op=allreduce:after=5",
                        grid="2x2", watchdog=1.0, env=env, expect_world=2,
                        limit=DRILL_LIMIT_S, workdir=str(d / "run"))
        start, clean = _clean_from(d, res, "p0", 1, 2, STEPS, grid=(1, 2))
        return {"res": res, "clean": clean, "start": start}

    return R0.shared_result(tmp_path_factory, "elastic-row-failure", compute)


def test_row_failure_shrinks_rank_2_out_with_rank_3(row_failure):
    res = row_failure["res"]
    assert res["ok"], res["stderr"]
    assert res["exit"][2] == 3 and res["exit"][3] == 13
    assert res["completed"] == [0, 1]
    assert "shrunk out with them" in res["results"][2]["declared"]
    for r in (0, 1):
        out = res["results"][r]
        assert out["final_world"] == 2 and out["epoch"] == 1
        assert out["recoveries"][0]["failed"] == [3]
        assert out["epoch_history"][0]["detail"] == "shrank out rank(s) [2, 3] of 4"
        assert out["meters"]["elastic.row_shrinks"] == 1
        assert out["meters"]["elastic.restores"] == 1


def test_row_failure_is_a_clean_1x2_run_from_the_restore(row_failure):
    _assert_clean(row_failure["res"], row_failure["clean"], [0, 1], 1)


# ---------------------------------------------------------------------------
# (h) shrink, then grow
# ---------------------------------------------------------------------------


def _jax_losses(params, start, steps):
    """The JAX example's step on four virtual CPU devices from ``params``
    at ``start``."""
    import jax

    import mpi4jax_tpu as mpx

    spec = importlib.util.spec_from_file_location(
        "_elastic_example", REPO / "examples" / "elastic_training.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    mesh = mpx.make_world_mesh((4,), ("i",), devices=jax.devices()[:4])
    comm = mpx.Comm("i", mesh=mesh)
    step_fn, losses = ex._make_elastic_step(mpx)
    state = {"params": {k: np.asarray(v) for k, v in params.items()}}
    for step in range(start, steps):
        state = step_fn(state, step, comm)
    return [(x["step"], x["loss"]) for x in losses]


@pytest.fixture(scope="module")
def grow_drill(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-grow")
        res = ET.launch(4, steps=GROW_STEPS, device="cpu",
                        fault_spec="die:rank=3:op=allreduce:after=25",
                        grow=True, commit_every="auto", watchdog=1.0,
                        wait_for_join=30.0, ef_state=False, expect_world=4,
                        limit=DRILL_LIMIT_S, workdir=str(d / "run"))
        joiner = res["joiners"][0]["result"] if res["joiners"] else None
        clean = start = jax = None
        if joiner is not None:
            start, clean = _clean_from(d, res, "p0", 2, 4, GROW_STEPS)
            jax = _jax_losses(_state(res, "p0", "epoch2"), start, GROW_STEPS)
        return {"res": res, "clean": clean, "start": start, "jax": jax}

    return R0.shared_result(tmp_path_factory, "elastic-grow", compute)


def _joiner(grow_drill):
    res = grow_drill["res"]
    assert len(res["joiners"]) == 1, res["stderr"]
    j = res["joiners"][0]
    assert j["exit"] == 0, j["stderr"]
    return j["result"]


def test_grow_brings_the_world_back_to_4_with_launch_rank_4(grow_drill):
    res = grow_drill["res"]
    assert res["ok"], res["stderr"]
    assert res["exit"][:3] == [0, 0, 0] and res["exit"][3] == 13
    assert res["completed"] == [0, 1, 2, "join0"]
    joiner = _joiner(grow_drill)
    assert joiner["final_world"] == 4 and joiner["origin"] == 4
    assert joiner["joined"]["process_id"] == 3 and joiner["joined"]["epoch"] == 2
    assert joiner["losses"][0]["step"] == grow_drill["start"]
    assert joiner["losses"][-1]["step"] == GROW_STEPS - 1
    for r in range(3):
        out = res["results"][r]
        assert out["final_world"] == 4 and out["epoch"] == 2
        assert [h["cause"] for h in out["epoch_history"]] == ["failure", "join"]
        (grow,) = out["grows"]
        assert grow["step"] == grow_drill["start"] and grow["world"] == 4
    # every rank locked the same commit_every='auto' interval in, and the
    # joiner was handed it
    (agreed,) = {res["results"][r]["auto_commit_every"] for r in range(3)}
    assert agreed >= 1 and joiner["joined"]["commit_every"] == agreed
    assert not joiner["joined"]["auto_commit"]
    # all four end with the same parameters
    finals = [_state(res, f"p{r}", "final") for r in range(3)]
    finals.append(_state(res, "j3", "final"))
    for f in finals[1:]:
        for k, v in finals[0].items():
            assert f[k].tobytes() == v.tobytes(), k


def test_grow_losses_are_a_clean_4_rank_run_from_the_admission(grow_drill):
    res = grow_drill["res"]
    joiner = _joiner(grow_drill)
    outs = [res["results"][r] for r in range(3)] + [joiner]
    for i, out in enumerate(outs):
        assert [tuple(x) for x in grow_drill["clean"][i]["losses"]] == \
            _after(out, 2)
    for i, name in enumerate(["p0", "p1", "p2", "j3"]):
        final = _state(res, name, "final")
        for k, v in grow_drill["clean"][i]["params"].items():
            assert final[k].tobytes() == v.tobytes(), (name, k)


def test_grow_losses_match_the_jax_example_after_the_admission(grow_drill):
    got = [(x["step"], x["loss"]) for x in grow_drill["res"]["results"][0]["losses"]
           if x["epoch"] == 2]
    want = grow_drill["jax"]
    assert [s for s, _ in got] == [s for s, _ in want]
    assert len(got) == GROW_STEPS - grow_drill["start"] >= 1
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# BoundaryControl, and a joiner admitted while the world measures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def boundary_world(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-boundary")
        return launch.run(RE.boundary_control_program, 3, device="cpu",
                          timeout=R0.RANK_TIMEOUT_S,
                          args=(_rdv(d), ET.free_port_base(3)))

    return R0.shared_result(tmp_path_factory, "elastic-boundary", compute)


def test_boundary_control_drains_rank_2_from_an_external_loop(boundary_world):
    leaver = boundary_world[2]
    assert leaver["drained"] and leaver["steps"] == [(s, 3, 0) for s in range(4)]
    for r in range(3):
        out = boundary_world[r]
        assert out["meters"]["elastic.drain_incidents"] == 1
        assert out["drains"][-1]["step"] == 4 and out["drains"][-1]["forced"]
        assert out["committed"] == 4
        assert out["old_drained"] and out["old_comm"] == "MPX127"
        assert out["sigterm_restored"]
    for r in (0, 1):
        out = boundary_world[r]
        assert out["steps"] == [(s, 3, 0) for s in range(4)] + \
            [(s, 2, 1) for s in range(4, 8)]
        assert out["history"] == [{"epoch": 1, "world": 2, "cause": "drain",
                                   "detail": "drained rank(s) [2] of 3"}]
        assert (out["world"], out["rank"], out["epoch"]) == (2, r, 1)
        assert out["new_sum"] == 2.0
        assert out["ring"].tolist() == [float(1 - r)] * 3
    assert boundary_world[0]["w"].tobytes() == boundary_world[1]["w"].tobytes()


@pytest.fixture(scope="module")
def auto_join(tmp_path_factory):
    def compute():
        d = tmp_path_factory.mktemp("elastic-auto-join")
        out = str(d / "joiner.json")
        world = launch.run(RE.auto_join_program, 2, device="cpu",
                           timeout=R0.RANK_TIMEOUT_S,
                           args=(_rdv(d), ET.free_port_base(3), out))
        path = Path(out)
        joiner = json.loads(path.read_text()) if path.exists() else \
            Path(out + ".err").read_text()
        return {"world": world, "joiner": joiner}

    return R0.shared_result(tmp_path_factory, "elastic-auto-join", compute)


def test_a_joiner_admitted_while_measuring_locks_in_with_the_world(auto_join):
    joiner = auto_join["joiner"]
    assert isinstance(joiner, dict), joiner
    assert joiner["joined"]["auto_commit"] and joiner["joined"]["step"] == 1
    assert (joiner["world"], joiner["rank"], joiner["origin"]) == (3, 2, 2)
    agreed = {joiner["auto"]} | {w["auto"] for w in auto_join["world"]}
    assert len(agreed) == 1 and agreed.pop() >= 1
    for w in auto_join["world"]:
        (grow,) = w["grows"]
        assert grow["step"] == 1 and w["world"] == 3
        assert [h["cause"] for h in w["history"]] == ["join"]
        # the world committed every boundary while measuring; from the
        # admission on every rank commits the same steps
        assert w["committed"][:3] == [0, 1, 2]
        assert w["committed"][2:] == joiner["committed"]
        assert w["w"].tolist() == joiner["w"]
