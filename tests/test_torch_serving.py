"""The port's serving engine on gloo ranks against the JAX package's.

On 2 and 4 ranks (``tests/torch_ranks_serving.py:serving_program``, one
world each per test run through ``R0.shared_result``) the port's engine
serves ``tests/test_serving.py``'s tiny config and trace under the
continuous and static schedulers at unroll 1 and 2; the JAX engine
serves the same on a k-device CPU mesh.  Held against it: the ``run()``
dict field for field (the virtual clock makes every latency a count of
boundaries), every request's token stream, and the final K/V and token
table of every rank (rows of the slot pool; the scratch row takes the
padding lanes' writes in an unspecified order): K/V within rtol 1e-5,
atol 1e-6, the f32 SUM band (the two allreduces a layer sum in another
order than XLA's ``psum``), the tokens equal.  The manual prefill and
four single decode steps are held the same way at every step; the
pinned decode megastep equals ``unroll`` single steps bit for bit and
no call changes its arguments; live batches 4 and 3 share one decode
program; admission lands on boundaries; and the telemetry rows, journal
records and the report's serving section are computed here from what
the engine must have done.  The drain drill runs on 3 ranks (the tiny
preset, rank 2 drained, as ``serve.py --launch 3 --drain-rank 2``).

JAX is imported where the JAX side is computed, so that the ``gpu`` test
runs on the card, which has no JAX (``--noconftest``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as R0  # noqa: E402
import torch_ranks_serving as RS  # noqa: E402
from mpi4jax_tpu_torch.models import serving as MS  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = (2, 4)
RTOL, ATOL = 1e-5, 1e-6
VARIANTS = [f"{s}/u{u}" for s, u in RS.VARIANTS]
_JAX = {}


@pytest.fixture(scope="module", params=SIZES, ids=lambda k: f"k{k}")
def world(request, tmp_path_factory):
    k = request.param
    return k, R0.shared_result(
        tmp_path_factory, f"serving-{k}",
        lambda: launch.run(RS.serving_program, k, device="cpu",
                           timeout=R0.RANK_TIMEOUT_S, args=("cpu",)))


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    return R0.shared_result(
        tmp_path_factory, "serving-drill",
        lambda: MS.launch(3, drain_rank=2, device="cpu",
                          limit=R0.RANK_TIMEOUT_S))


# ---------------------------------------------------------------------------
# the JAX side: the JAX engine on a k-device CPU mesh, once per k
# ---------------------------------------------------------------------------


def _jcfg(js, **overrides):
    return js.ServingConfig(**dict(RS.TINY, **overrides))


def _jax_side(k):
    if k in _JAX:
        return _JAX[k]
    import jax

    import mpi4jax_tpu as mpx
    from mpi4jax_tpu import serving as js
    from mpi4jax_tpu.serving import model as jmodel

    mesh = mpx.make_world_mesh((k,), ("i",), devices=jax.devices()[:k])
    comm = mpx.Comm("i", mesh=mesh)
    trace = js.poisson_trace(6, 300.0, seed=5, prompt_len=(2, 4),
                             max_new=(2, 6), long_frac=0.0, vocab=32)
    out = {}
    for sched, unroll in RS.VARIANTS:
        eng = js.ServingEngine(_jcfg(js, unroll=unroll), comm)
        res = eng.run(trace, scheduler=sched)
        out[f"{sched}/u{unroll}"] = {
            "result": res,
            "streams": {s.rid: list(s.generated)
                        for s in eng._sched.finished},
            "state": {n: np.asarray(eng._state[i])
                      for n, i in (("kk", 5), ("vv", 6), ("tok", 7))}}

    # the manual prefill and single steps, as the ranks run them
    cfg = _jcfg(js)
    eng = js.ServingEngine(cfg, comm)
    _bucket, prompts, plens, slots = RS.manual_lanes(cfg)
    lanes = tuple(eng._prep(np.tile(a[None], (k,) + (1,) * a.ndim))
                  for a in (prompts, plens, slots))
    kk, vv, tok, first = mpx.spmd(jmodel.prefill_step, comm=comm)(
        *(eng._state + lanes))
    steps = {"prefill": {"kk": kk, "vv": vv, "tok": tok, "first": first}}
    cur = eng._state[:5] + (kk, vv, tok, first, lanes[1], lanes[2])
    step = mpx.spmd(jmodel.decode_step, comm=comm, unroll=1)
    for i in range(RS.STEPS):
        cur = step(*cur)
        steps[f"step{i}"] = {"kk": cur[5], "vv": cur[6], "tok": cur[7],
                             "nxt": cur[8], "lens": cur[9]}
    out["steps"] = {p: {n: np.asarray(a) for n, a in d.items()}
                    for p, d in steps.items()}

    eng = js.ServingEngine(_jcfg(js, unroll=1), comm)
    bucket_trace = [js.Request(rid=r.rid, arrival_s=r.arrival_s,
                               prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens)
                    for r in RS.bucket_trace()]
    out["buckets"] = eng.run(bucket_trace, scheduler="continuous")
    eng = js.ServingEngine(_jcfg(js, unroll=2, tick_s=0.01), comm)
    late = [js.Request(rid=r.rid, arrival_s=r.arrival_s, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
            for r in RS.late_trace()]
    res = eng.run(late, scheduler="continuous")
    out["admission"] = {"result": res, "admitted_s": {
        s.rid: s.admitted_s for s in eng._sched.finished}}
    _JAX[k] = out
    return out


def _pool(a, slots):
    """The slot pool's rows (the scratch row, index ``slots``, left out)."""
    return np.asarray(a)[:slots]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_run_dict_equals_jax(world, variant):
    k, ranks = world
    want = _jax_side(k)[variant]["result"]
    for r in ranks:
        assert r["world"] == k and r[variant]["pin"] is False
        assert r[variant]["result"] == want
    assert want["failed"] == 0 and want["completed"] == 6


@pytest.mark.parametrize("variant", VARIANTS)
def test_token_streams_equal_jax(world, variant):
    k, ranks = world
    want = _jax_side(k)[variant]["streams"]
    assert sorted(want) == list(range(6))
    for r in ranks:
        assert r[variant]["streams"] == want


def test_token_streams_invariant_under_scheduling(world):
    """Lanes are independent, so a request's greedy stream depends on the
    request alone (tests/test_serving.py:test_tokens_invariant_under_scheduling)."""
    _k, ranks = world
    base = ranks[0]["continuous/u1"]["streams"]
    for r in ranks:
        for v in VARIANTS:
            assert r[v]["streams"] == base


@pytest.mark.parametrize("variant", VARIANTS)
def test_final_kv_and_tokens_match_jax(world, variant):
    k, ranks = world
    slots = RS.tiny_cfg().slots()
    want = _jax_side(k)[variant]["state"]
    for r, rank in enumerate(ranks):
        got = rank[variant]["state"]
        for name in ("kk", "vv"):
            np.testing.assert_allclose(_pool(got[name], slots),
                                       _pool(want[name][r], slots),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(_pool(got["tok"], slots),
                                      _pool(want["tok"][r], slots))


def test_each_step_matches_jax(world):
    """The manual prefill and each of four single decode steps: K/V of
    every rank in the band, the token table, sampled tokens and lengths
    equal."""
    k, ranks = world
    slots = RS.tiny_cfg().slots()
    want = _jax_side(k)["steps"]
    for phase, fields in want.items():
        for r, rank in enumerate(ranks):
            got = rank["steps"][phase]
            for name, arr in fields.items():
                if name in ("kk", "vv"):
                    np.testing.assert_allclose(
                        _pool(got[name], slots), _pool(arr[r], slots),
                        rtol=RTOL, atol=ATOL, err_msg=f"{phase} {name}")
                elif name == "tok":
                    np.testing.assert_array_equal(_pool(got[name], slots),
                                                  _pool(arr[r], slots))
                else:
                    np.testing.assert_array_equal(got[name], arr[r])


def test_megastep_equals_single_steps_and_calls_leave_arguments(world):
    _k, ranks = world
    for r in ranks:
        assert r["steps"]["megastep_bitwise"]
        assert r["steps"]["untouched"]


def test_one_program_per_bucket(world):
    """Live batches 4 and 3 share decode bucket 4: one decode program
    (tests/test_serving.py:test_one_program_per_bucket); on several
    processes the programs are regions, so nothing is pinned."""
    k, ranks = world
    want = _jax_side(k)["buckets"]
    for r in ranks:
        res = r["buckets"]["result"]
        assert res == want and res["failed"] == 0
        assert [p for p in res["programs"] if p.startswith("decode.")] == \
            ["decode.b4"]
        assert r["buckets"]["pins"] == 0


def test_admission_lands_on_megastep_boundaries(world):
    k, ranks = world
    want = _jax_side(k)["admission"]
    tick = RS.tiny_cfg(tick_s=0.01).tick_s
    for r in ranks:
        got = r["admission"]
        assert got["result"] == want["result"]
        assert got["result"]["failed"] == 0
        assert got["result"]["completed"] == 2
        assert got["admitted_s"] == want["admitted_s"]
        for admitted in got["admitted_s"].values():
            ratio = admitted / tick
            assert abs(ratio - round(ratio)) < 1e-9
        assert got["admitted_s"][99] >= 0.02   # the boundary AFTER arrival


@pytest.mark.parametrize("mode", ["counters", "events"])
def test_telemetry_rows_and_report_section(world, mode):
    """One op row per (phase, bucket) whose calls are the engine's
    dispatches, the serving meters, under ``events`` a journal begin and
    end per dispatch (decode records carry the unroll), and the report's
    serving section: each meter summed over the k processes."""
    from mpi4jax_tpu_torch.telemetry.report import render

    k, ranks = world
    snaps = []
    for r in ranks:
        res, snap = r[mode]["result"], r[mode]["snapshot"]
        snaps.append(snap)
        assert res == _jax_side(k)["continuous/u2"]["result"]
        meters = snap["meters"]
        rows = {(row["op"], row["algo"]): row for row in snap["ops"].values()
                if row["op"].startswith("serving.")}
        assert {op for op, _ in rows} == {"serving.prefill", "serving.decode"}
        assert {a for _, a in rows} <= {f"b{b}" for b in (1, 2, 4)}
        decode_calls = sum(row["calls"] for (op, _), row in rows.items()
                           if op == "serving.decode")
        prefill_calls = sum(row["calls"] for (op, _), row in rows.items()
                            if op == "serving.prefill")
        assert decode_calls == meters["serving.megasteps"] >= 1
        assert prefill_calls == meters["serving.prefills"] >= 1
        assert meters["serving.requests_admitted"] == 6
        assert meters["serving.requests_completed"] == 6
        assert meters["serving.tokens_generated"] == res["tokens"]
        assert "serving.requests_failed" not in meters
        assert meters["serving.programs.decode"] + \
            meters["serving.programs.prefill"] == len(res["programs"])
        recs = r[mode]["serving_records"]
        if mode == "events":
            dec = [x for x in recs if x["op"] == "serving.decode"]
            assert len(dec) == decode_calls
            assert len(recs) == decode_calls + prefill_calls
            assert all(x["unroll"] == 2 and "latency" in x for x in dec)
            assert all(x["algo"] == f"b{x['bucket']}" for x in recs)
        else:
            assert recs == []
            assert all(row.get("latency", {}).get("count") == row["calls"]
                       for row in rows.values())
    text = render(snaps)
    after = text[text.index("\nserving:\n") + len("\nserving:\n"):]
    section = after.split("\n\n")[0].splitlines()
    lines = {ln[:24].strip(): int(ln[24:]) for ln in section}
    total = {name: sum(s["meters"].get(name, 0) for s in snaps)
             for name in snaps[0]["meters"]}
    assert lines == {
        "requests admitted": total["serving.requests_admitted"],
        "requests completed": total["serving.requests_completed"],
        "tokens generated": total["serving.tokens_generated"],
        "prefill dispatches": total["serving.prefills"],
        "decode megasteps": total["serving.megasteps"],
    }
    assert lines["requests completed"] == 6 * k


# ---------------------------------------------------------------------------
# the drain drill
# ---------------------------------------------------------------------------


def test_drain_drill_three_ranks(drill):
    """3 ranks, rank 2 drained at the first boundary from 4 with sequences
    in flight: every worker exits 0, one drained, the survivors finish the
    trace at world 2 with zero failures, having re-admitted sequences."""
    res = drill
    assert res["ok"], res["stderr"]
    assert res["drained"] == [2] and res["completed"] == [0, 1]
    for r in (0, 1):
        rec = res["results"][r]
        out = rec["result"]
        assert out["world"] == 2 and out["failed"] == 0
        assert out["completed"] == 24
        assert out["preempt_readmissions"] > 0
        [change] = rec["world_changes"]
        assert change["world"] == 2 and change["readmitted"] > 0
        assert rec["posted"] == []
    left = res["results"][2]
    assert left["drained"] and left["result"]["failed"] == 0
    assert len(left["posted"]) == 1 and left["posted"][0]["boundary"] >= 4
    # the survivors agree on every stream
    assert res["results"][0]["streams"] == res["results"][1]["streams"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_serving_on_the_card_tiny():
    """Phase 15 (a) and (b) of ``chip_smoke.py`` at the tiny preset: both
    schedulers on one GPU with every decode program a CUDA graph and zero
    failures, and each request's stream the same under continuous unroll
    4, static unroll 4, continuous unroll 1 and the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from mpi4jax_tpu_torch import Comm, make_world_mesh

    cfg = MS.make_config("tiny")
    trace, meta = MS.make_trace(cfg)
    mesh = make_world_mesh(device="cuda")
    comm = Comm(mesh.axes[0], mesh=mesh)
    payload, engine, runs = MS.benchmark(cfg, trace, meta, comm)
    for run in runs.values():
        assert run["result"]["failed"] == 0
        assert run["result"]["completed"] == len(trace)
    assert all(payload["graphs"].values())
    streams = {}
    for label, sched, unroll, dev in (("cont4", "continuous", 4, "cuda"),
                                      ("static4", "static", 4, "cuda"),
                                      ("cont1", "continuous", 1, "cuda"),
                                      ("cpu4", "continuous", 4, "cpu")):
        c = MS.make_config("tiny", unroll=unroll, virtual_clock=True)
        m = make_world_mesh(device=dev)
        _res, streams[label] = MS.serve_streams(c, trace,
                                                Comm(m.axes[0], mesh=m),
                                                sched)
    assert streams["static4"] == streams["cont4"]
    assert streams["cont1"] == streams["cont4"]
    assert streams["cpu4"] == streams["cont4"]
