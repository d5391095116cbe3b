"""The port's pipeline schedule compiler (``mpi4jax_tpu_torch/parallel/
pipeline.py``), the pure half, against the JAX package's.

``rank_program`` (every rank), ``stash_depth`` and ``compile_phases``
equal the JAX package's over schedule x S in 1..5 x M in 1..9 x v in
1..3, each validation error included (the same type and message);
``split_microbatches`` and the two pipeline knobs; the program's
construction errors; ``schedule="auto"``'s fixed rule, set beside the
JAX package's cost-model pick.  The JAX pure half imports no JAX at
import time and is called as it is.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.utils import config  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pp = importlib.import_module("mpi4jax_tpu_torch.parallel.pipeline")
jpp = importlib.import_module("mpi4jax_tpu.parallel.pipeline")
jconfig = importlib.import_module("mpi4jax_tpu.utils.config")

KNOBS = ("MPI4JAX_TPU_PIPELINE_MICROBATCHES", "MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the comparison
        return (type(e).__name__, str(e))


def _plan_tuple(plan):
    return tuple(getattr(plan, f) for f in (
        "schedule", "stages", "microbatches", "virtual", "warmup", "steady",
        "cooldown", "ticks", "max_stash", "stash_by_rank"))


@pytest.mark.parametrize("virtual", [1, 2, 3])
@pytest.mark.parametrize("microbatches", range(1, 10))
@pytest.mark.parametrize("stages", range(1, 6))
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_programs_stashes_and_phases_equal_jax(schedule, stages, microbatches,
                                               virtual):
    got = _outcome(lambda: pp.compile_phases(schedule, stages, microbatches,
                                             virtual))
    want = _outcome(lambda: jpp.compile_phases(schedule, stages, microbatches,
                                               virtual))
    if got[0] == "ok":
        assert want[0] == "ok"
        assert _plan_tuple(got[1]) == _plan_tuple(want[1])
    else:
        assert got == want
        return
    for rank in range(stages):
        prog = pp.rank_program(schedule, stages, microbatches, rank, virtual)
        assert prog == jpp.rank_program(schedule, stages, microbatches, rank,
                                        virtual)
        assert pp.stash_depth(prog) == jpp.stash_depth(prog)
    for rank in (-1, stages):
        assert _outcome(lambda: pp.rank_program(schedule, stages, microbatches,
                                                rank, virtual)) == \
            _outcome(lambda: jpp.rank_program(schedule, stages, microbatches,
                                              rank, virtual))


@pytest.mark.parametrize("args", [
    ("zigzag", 4, 8, 1), ("gpipe", 0, 8, 1), ("1f1b", 4, 0, 1),
    ("interleaved", 4, 8, 0), ("interleaved", 4, 8, 1), ("gpipe", 4, 8, 2),
    ("1f1b", 4, 8, 3), ("auto", 4, 8, 1)])
def test_validation_errors_equal_jax(args):
    got = _outcome(lambda: pp.compile_phases(*args))
    assert got[0] == "ValueError"
    assert got == _outcome(lambda: jpp.compile_phases(*args))


@pytest.mark.parametrize("program", [(("B", 0, 0),), (("F", 0, 0), ("B", 0, 0), ("B", 1, 0)),
                                     (("F", 0, 0), ("F", 1, 0), ("X", 2, 0))])
def test_stash_depth_of_hand_programs(program):
    assert _outcome(lambda: pp.stash_depth(program)) == \
        _outcome(lambda: jpp.stash_depth(program))


@pytest.mark.parametrize("b,n", [(32, 16), (32, 4), (12, 3), (10, 4), (8, 0),
                                 (8, -2), (5, 1)])
def test_split_microbatches_equals_jax(b, n):
    x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
    got = _outcome(lambda: pp.split_microbatches(x, n))
    want = _outcome(lambda: jpp.split_microbatches(x, n))
    if got[0] == "ok":
        assert want[0] == "ok" and got[1].shape == want[1].shape
        assert got[1].tobytes() == want[1].tobytes()
        t = pp.split_microbatches(torch.from_numpy(x), n)
        assert t.numpy().tobytes() == want[1].tobytes()
    else:
        assert got == want


def test_pipeline_knobs(monkeypatch):
    x = np.zeros((12, 2), np.float32)
    assert config.pipeline_microbatches() == jconfig.pipeline_microbatches() == 0
    assert config.pipeline_virtual_stages() == jconfig.pipeline_virtual_stages() == 0
    assert pp.split_microbatches(x).shape == (1, 12, 2)
    monkeypatch.setenv("MPI4JAX_TPU_PIPELINE_MICROBATCHES", "4")
    assert pp.split_microbatches(x).shape == jpp.split_microbatches(x).shape == (4, 3, 2)
    monkeypatch.setenv("MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES", "3")
    assert config.pipeline_virtual_stages() == jconfig.pipeline_virtual_stages() == 3
    prog = pp.pipeline(lambda h, p: h, 4, schedule="interleaved")
    assert prog.plan(4, 4, 64).virtual == 3
    for name in KNOBS:
        monkeypatch.setenv(name, "-1")
        fns = {KNOBS[0]: (config.pipeline_microbatches,
                          jconfig.pipeline_microbatches),
               KNOBS[1]: (config.pipeline_virtual_stages,
                          jconfig.pipeline_virtual_stages)}[name]
        assert _outcome(fns[0]) == _outcome(fns[1])
        assert _outcome(fns[0])[0] == "ValueError"
        monkeypatch.delenv(name)
        assert name in config.FLAG_NAMES


def _sub(h, w):
    return h


FNS = [lambda h, p: h, lambda h, p: h]


@pytest.mark.parametrize("kwargs", [
    dict(stage_fns=_sub, schedule="zigzag"),
    dict(stage_fns=FNS, schedule="gpipe"),
    dict(stage_fns=FNS, schedule="1f1b"),
    dict(stage_fns=_sub, schedule="gpipe", virtual=2),
    dict(stage_fns=_sub, schedule="1f1b", virtual=2),
    dict(stage_fns=FNS, schedule="interleaved", virtual=3),
    dict(stage_fns=[], schedule="auto"),
    dict(stage_fns=[_sub, 3], schedule="auto"),
])
def test_program_construction_errors_equal_jax(kwargs):
    kw = dict(kwargs)
    fns = kw.pop("stage_fns")
    got = _outcome(lambda: pp.pipeline(fns, 8, **kw))
    want = _outcome(lambda: jpp.pipeline(fns, 8, **kw))
    assert got[0] in ("ValueError", "TypeError")
    assert got == want


@pytest.mark.parametrize("schedule,fns,virtual", [
    ("gpipe", _sub, None), ("1f1b", _sub, None),
    ("interleaved", _sub, 2), ("interleaved", FNS, None), ("interleaved", _sub, None)])
def test_explicit_plans_equal_jax(schedule, fns, virtual):
    for stages, m in ((4, 16), (8, 16), (2, 3)):
        got = pp.pipeline(fns, m, schedule=schedule, virtual=virtual).plan(
            stages, m, 64)
        want = jpp.pipeline(fns, m, schedule=schedule, virtual=virtual).plan(
            stages, m, 64)
        assert _plan_tuple(got) == _plan_tuple(want)


# (stages, microbatches, boundary bytes): the JAX tests' (4 and 8 ranks,
# 16 B), the example's (64 B), the port tests' twin's (4 ranks, 64 B) and
# chip_smoke.py phase 14's (128 KiB), and the MPX144 fixture's
AUTO_SHAPES = [(4, 16, 16), (8, 16, 16), (8, 16, 64), (4, 16, 64),
               (4, 16, 128 * 1024), (8, 8, 64 * 1024)]


@pytest.mark.parametrize("stages,microbatches,nbytes", AUTO_SHAPES)
def test_auto_fixed_rule_equals_the_default_cost_model(stages, microbatches,
                                                       nbytes, tmp_path,
                                                       monkeypatch):
    """``auto`` prices its candidates with ``best_schedule`` under the
    active cost model, as the JAX package does: under one model file both
    packages read (the JAX package's analytic defaults), the same plan; a
    chunked program runs interleaved (its only candidate), a flat one
    1f1b."""
    from mpi4jax_tpu.analysis import costmodel as jcm

    model = tmp_path / "m.json"
    model.write_text(json.dumps(dict(jcm.DEFAULT_PARAMS,
                                     schema="mpx-cost-model/1")))
    monkeypatch.setenv("MPI4JAX_TPU_COST_MODEL", str(model))
    for fns, virtual in ((FNS, None), (_sub, 2), (_sub, 3), (_sub, None)):
        got = pp.pipeline(fns, microbatches, virtual=virtual).plan(
            stages, microbatches, nbytes)
        want = jpp.pipeline(fns, microbatches, virtual=virtual).plan(
            stages, microbatches, nbytes)
        assert got.schedule == ("1f1b" if fns is _sub and virtual is None
                                else "interleaved")
        assert _plan_tuple(got) == _plan_tuple(want)


def test_microbatch_count_mismatch_raises():
    prog = pp.pipeline(_sub, 8, schedule="gpipe")
    with pytest.raises(ValueError, match="n_microbatches=8"):
        prog(torch.zeros(4, 1, 2), torch.zeros(2, 2))


def test_trace_outside_a_region_raises():
    prog = pp.pipeline(_sub, 4, schedule="gpipe")
    with pytest.raises(RuntimeError, match="inside a region"):
        prog.trace(torch.zeros(4, 1, 2), torch.zeros(2, 2))


def test_all_names_exported():
    assert sorted(pp.__all__) == sorted(jpp.__all__)
    assert pp.SCHEDULES == jpp.SCHEDULES


def test_stage_params_from_jax_splits_the_rank_stack():
    """``convert.stage_params_from_jax`` on the pipeline example's stacks:
    the flat schedules' ``(S, 2, D, D)`` and the interleaved ``(S, v, D, D)``
    (chunk ``c`` of rank ``r`` is substage ``c * S + r``), and a dict."""
    from mpi4jax_tpu_torch import convert
    from mpi4jax_tpu_torch.models import pipeline_parallel as PP

    stages = 4
    _x0, ws = PP.build_inputs(stages)
    w2s = ws.reshape(stages, 2, PP.DIM, PP.DIM)
    wi = ws.reshape(2, stages, PP.DIM, PP.DIM).transpose(1, 0, 2, 3)
    for stacked in (w2s, wi):
        ranks = convert.stage_params_from_jax(stacked, device="cpu")
        for r, got in enumerate(ranks):
            assert got.numpy().tobytes() == np.ascontiguousarray(stacked[r]).tobytes()
    for r, got in enumerate(ranks):
        pair, chunks = PP.stage_weights(ws, stages, r)
        assert got.numpy().tobytes() == np.ascontiguousarray(chunks).tobytes()
    both = convert.stage_params_from_jax({"a": w2s, "b": wi[:, 0]}, device="cpu")
    assert set(both[3]) == {"a", "b"} and both[3]["b"].shape == (PP.DIM, PP.DIM)
    with pytest.raises(ValueError, match="leading rank axis"):
        convert.stage_params_from_jax([w2s, wi[:3]], device="cpu")
