"""The port's cost pass end to end (``analyze(cost=True)``, the ambient
``MPI4JAX_TPU_ANALYZE_COST``, the tuning route), against the JAX package's.

The programs of ``tests/test_cost.py`` and the verifier's clean programs,
written for the port and run under one explicit parameter dict in both
packages on a 4-rank comm: the per-op costs and the per-link-class wire
part of the prediction are equal (bytes, rounds and microseconds), the
advisory codes are equal (MPX107 aside: the port's tokens order nothing,
``tests/test_torch_analysis.py``).  The compute part holds within a
stated band: the port counts the bytes each aten op, op and kernel
``meta`` route writes, the JAX package each XLA equation's outputs, and
those are not the same grain (a fused kernel is one write in the port,
its slices and pads are several equations in JAX).  Each program holds
the port-over-JAX ratio of its compute part that was observed on the CPU
(``COMPUTE_RATIO``; both sides count bytes, so the ratio is exact and
moves only when the capture or the JAX package's equations change) within
``COMPUTE_ROOM``, 0.8x to 1.25x of it.  The rest holds the JAX
package's rules: ``cost`` implies every rank, the memo key grows only with
the pass on, a malformed file is loud, the ambient pass sinks clean
reports with a cost, the cache token moves only when the pass is armed,
and the naive ladder reports MPX135 in both packages.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.analysis import costmodel as jcm  # noqa: E402

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import analysis  # noqa: E402
from mpi4jax_tpu_torch.analysis import costmodel as pcm  # noqa: E402
from mpi4jax_tpu_torch.analysis import hook  # noqa: E402
from mpi4jax_tpu_torch.parallel.comm import Comm  # noqa: E402
from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

N = 4
PARAMS = {"links": {"ici": {"alpha_us": 2.0, "gb_per_s": 50.0},
                    "dcn": {"alpha_us": 30.0, "gb_per_s": 10.0}},
          "gamma_gb_per_s": 300.0, "compute_gb_per_s": 200.0,
          "dispatch_us": 100.0}
# port over JAX of the compute part, per program, as observed on the CPU
# (max over ranks of ``cost.compute_us``: port µs / JAX µs)
COMPUTE_RATIO = {
    "two_allreduce_step": 0.2711864406779661,   # 0.00384 / 0.01416
    "ring_attention": 0.4159997553865911,       # 4.08154 / 9.8114
    "moe_layer": 1.351577961737354,             # 2.54048 / 1.87964
    "pipeline:gpipe": 0.19215890062936655,      # 0.01664 / 0.086595
    "pipeline:1f1b": 0.2512773624482332,        # 0.02336 / 0.092965
    "pipeline:interleaved": 0.26721725166322546,  # 0.08736 / 0.326925
}
COMPUTE_ROOM = (0.8, 1.25)


@pytest.fixture(autouse=True)
def fresh_jax_traces(monkeypatch):
    """Every ``jax.make_jaxpr`` traces afresh (see
    ``tests/test_torch_analysis.py``), and no cost variable leaks in."""
    make_jaxpr = jax.make_jaxpr

    def fresh(*args, **kwargs):
        jax.clear_caches()
        return make_jaxpr(*args, **kwargs)

    monkeypatch.setattr(jax, "make_jaxpr", fresh)
    for var in ("MPI4JAX_TPU_ANALYZE", "MPI4JAX_TPU_ANALYZE_RANKS",
                "MPI4JAX_TPU_ANALYZE_COST", "MPI4JAX_TPU_COST_MODEL",
                "MPI4JAX_TPU_TUNING"):
        monkeypatch.delenv(var, raising=False)
    yield
    mpx.set_analyze_mode(None)
    mpx.clear_caches()
    tpx.clear_caches()


def jax_comm(n=N):
    mesh = mpx.make_world_mesh((n,), ("i",), devices=jax.devices()[:n])
    return mpx.Comm("i", mesh=mesh)


def port_comm(n=N):
    return Comm(("i",), mesh=ProcessGrid((n,), ("i",), torch.device("cpu"),
                                         rank=0))


def jrows(shape, n=N):
    return jnp.stack([jnp.full(shape, 1.0 + r) for r in range(n)])


def codes(report, skip=("MPX107",)):
    return sorted({f.code for f in report.findings} - set(skip))


def jax_step(comm):
    def step(x):
        out, tok = mpx.allreduce(x, comm=comm)
        out2, _ = mpx.allreduce(mpx.varying(out * 0.5), comm=comm, token=tok)
        return mpx.varying(out2)

    return step


def port_step(comm):
    def step(x):
        out, tok = tpx.allreduce(x, comm=comm)
        out2, _ = tpx.allreduce(out * 0.5, comm=comm, token=tok)
        return out2

    return step


def both(jfn, jargs, pfn, pargs):
    jc, pc = jfn[1], pfn[1]
    jrep = mpx.analyze(jfn[0], *jargs, comm=jc, ranks="all", cost=True,
                       cost_model=jcm.CostModel(PARAMS))
    prep = analysis.analyze(pfn[0], *pargs, comm=pc, ranks="all", cost=True,
                            cost_model=pcm.CostModel(PARAMS))
    return jrep, prep


def check_equal_wire(jrep, prep, program):
    j, p = jrep.cost, prep.cost
    assert p is not None and j is not None
    assert p.per_op == j.per_op
    assert p.per_link == j.per_link
    assert p.params == j.params and p.ranks == j.ranks
    assert p.dispatch_us == j.dispatch_us
    assert codes(prep) == codes(jrep)
    ratio = max(p.compute_us.values()) / max(j.compute_us.values())
    want = COMPUTE_RATIO[program]
    assert COMPUTE_ROOM[0] * want <= ratio <= COMPUTE_ROOM[1] * want, \
        (program, ratio, want)
    return ratio


# ---------------------------------------------------------------------------
# the programs, against the JAX package
# ---------------------------------------------------------------------------


def test_the_two_allreduce_step_equals_jax():
    jc, pc = jax_comm(), port_comm()
    jrep, prep = both((jax_step(jc), jc), (jrows((64,)),),
                      (port_step(pc), pc), (torch.ones(64),))
    check_equal_wire(jrep, prep, "two_allreduce_step")
    assert prep.cost.per_op["allreduce"]["count"] == 2
    assert prep.cost.per_link["dcn"]["bytes"] == 0
    assert {"MPX111", "MPX132"} <= set(codes(prep))
    assert [n["op"] for n in prep.cost.critical_path] == \
        [n["op"] for n in jrep.cost.critical_path]


def test_ring_attention_equals_jax():
    from mpi4jax_tpu.attention import ring_attention as jring
    from mpi4jax_tpu_torch.attention import ring_attention as pring

    jc, pc = jax_comm(), port_comm()
    q, t = jnp.zeros((N, 1, 64, 2, 64)), torch.zeros((1, 64, 2, 64))
    jrep, prep = both((lambda a, b, c: jring(a, b, c, comm=jc), jc), (q, q, q),
                      (lambda a, b, c: pring(a, b, c, comm=pc), pc), (t, t, t))
    check_equal_wire(jrep, prep, "ring_attention")


def test_moe_layer_equals_jax():
    from mpi4jax_tpu.parallel import moe as jmoe
    from mpi4jax_tpu_torch.parallel import moe as pmoe

    tokens, d, d_ff = 64, 32, 48
    params = [jmoe.init_moe_params(d, d_ff, N, rank=r, seed=3) for r in range(N)]
    stacked = tuple(jnp.asarray(np.stack([getattr(p, f) for p in params]))
                    for f in pmoe.MoEParams._fields)
    mine = pmoe.init_moe_params(d, d_ff, N, rank=0, seed=3)
    jc, pc = jax_comm(), port_comm()
    jrep, prep = both(
        (lambda x, a, b, c: jmoe.moe_layer(x, jmoe.MoEParams(a, b, c),
                                           comm=jc)[0], jc),
        (jnp.zeros((N, tokens, d)), *stacked),
        (lambda x, a, b, c: pmoe.moe_layer(x, pmoe.MoEParams(a, b, c),
                                           comm=pc)[0], pc),
        (torch.zeros((tokens, d)), *(torch.from_numpy(np.asarray(p))
                                      for p in mine)))
    check_equal_wire(jrep, prep, "moe_layer")


@pytest.mark.parametrize("schedule,virtual", [("gpipe", 1), ("1f1b", 1),
                                              ("interleaved", 2)])
def test_pipeline_rounds_equal_jax(schedule, virtual):
    from mpi4jax_tpu_torch.parallel.pipeline import pipeline as ppipeline

    m, dim = 16, 8
    jc, pc = jax_comm(), port_comm()
    jprog = mpx.pipeline(lambda h, w: jnp.tanh(h @ w), m, schedule=schedule,
                         virtual=virtual, comm=jc)
    pprog = ppipeline(lambda h, w: torch.tanh(h @ w), m, schedule=schedule,
                      virtual=virtual, comm=pc)
    wshape = (virtual, dim, dim) if virtual > 1 else (dim, dim)
    jrep, prep = both(
        (lambda mb, w: jprog.trace(mb, w)[0], jc),
        (jnp.zeros((N, m, 2, dim)), jnp.zeros((N,) + wshape)),
        (lambda mb, w: pprog.trace(mb, w)[0], pc),
        (torch.zeros((m, 2, dim)), torch.zeros(wshape)))
    check_equal_wire(jrep, prep, f"pipeline:{schedule}")
    # the round stamps its schedule on the first boundary (MPX144's input)
    stamps = [e.extra["pipeline"] for e in prep.events if "pipeline" in e.extra]
    assert stamps == [(schedule, N, m, virtual, 2 * dim * 4)]
    assert stamps == [e.extra["pipeline"] for e in jrep.events
                      if "pipeline" in e.extra]


def test_a_gpipe_round_is_a_schedule_mispick_as_in_jax():
    """gpipe at a boundary whose transfer costs more than a stage: the
    model prices 1f1b measurably cheaper, MPX144 in both packages."""
    from mpi4jax_tpu_torch.parallel.pipeline import pipeline as ppipeline

    m, dim = 8, 256
    jc, pc = jax_comm(), port_comm()
    jprog = mpx.pipeline(lambda h, w: jnp.tanh(h @ w), m, schedule="gpipe",
                         comm=jc)
    pprog = ppipeline(lambda h, w: torch.tanh(h @ w), m, schedule="gpipe",
                      comm=pc)
    jrep, prep = both(
        (lambda mb, w: jprog.trace(mb, w)[0], jc),
        (jnp.zeros((N, m, 16, dim)), jnp.zeros((N, dim, dim))),
        (lambda mb, w: pprog.trace(mb, w)[0], pc),
        (torch.zeros((m, 16, dim)), torch.zeros((dim, dim))))
    assert "MPX144" in codes(prep)
    key = [(f.code, f.message) for f in prep.findings if f.code == "MPX144"]
    assert key == [(f.code, f.message) for f in jrep.findings
                   if f.code == "MPX144"]


def _ladders(jc, pc):
    from mpi4jax_tpu_torch.models import pipeline_parallel as PP

    def jladder(x, w):
        rank = jc.Get_rank()
        h = jnp.tanh(x @ w)
        tok = None
        for s in range(1, N):
            tok = mpx.send(h, dest={s - 1: s}, tag=s, comm=jc, token=tok)
            got, tok = mpx.recv(h, source={s: s - 1}, tag=s, comm=jc,
                                token=tok)
            h = jnp.where(rank == s, jnp.tanh(got @ w), h)
        return h

    return jladder, PP.make_ladder(pc)


def test_the_ladder_reports_mpx135_as_in_jax():
    jc, pc = jax_comm(), port_comm()
    jladder, pladder = _ladders(jc, pc)
    x, w = jnp.zeros((N, 64, 64)), jnp.zeros((N, 64, 64))
    jrep = mpx.analyze(jladder, x, w, comm=jc, ranks="all", cost=True,
                       cost_model=jcm.CostModel(PARAMS))
    prep = analysis.analyze(pladder, torch.zeros(64, 64),
                            torch.zeros(2, 64, 64), comm=pc, ranks="all",
                            cost=True, cost_model=pcm.CostModel(PARAMS))
    assert not prep.errors, prep.render()
    assert "MPX135" in codes(prep) and "MPX135" in codes(jrep)
    assert prep.cost.per_op == jrep.cost.per_op
    # without the cost pass the ladder verifies clean: correct, not fast
    assert analysis.analyze(pladder, torch.zeros(64, 64),
                            torch.zeros(2, 64, 64), comm=pc, ranks="all").ok


# ---------------------------------------------------------------------------
# the rules of the pass
# ---------------------------------------------------------------------------


def test_cost_implies_ranks_all_and_off_keeps_the_report_shape():
    pc = port_comm()
    rep = analysis.analyze(port_step(pc), torch.ones(8), comm=pc, cost=True)
    assert rep.cost is not None
    assert list(rep.meta["ranks"]) == list(range(N))
    assert rep.cost.ranks == tuple(range(N))
    payload = rep.to_json()
    assert payload["cost"]["total_us"] == pytest.approx(rep.cost.total_us)
    json.dumps(payload)
    assert "predicted step time" in rep.render()
    plain = analysis.analyze(port_step(pc), torch.ones(8), comm=pc,
                             ranks="all")
    assert plain.cost is None and "cost" not in plain.to_json()
    assert "predicted step time" not in plain.render()


def test_the_cost_memo_is_distinct_from_the_plain_one():
    pc = port_comm()
    step, x = port_step(pc), torch.ones(8)
    plain = analysis.analyze(step, x, comm=pc, ranks="all")
    costed = analysis.analyze(step, x, comm=pc, ranks="all", cost=True)
    assert plain.cost is None and costed.cost is not None
    assert analysis.analyze(step, x, comm=pc, ranks="all") is plain
    assert analysis.analyze(step, x, comm=pc, ranks="all", cost=True) is costed
    other = analysis.analyze(step, x, comm=pc, ranks="all", cost=True,
                             cost_model=pcm.CostModel(PARAMS))
    assert other is not costed


def test_a_file_through_analyze(tmp_path):
    pc = port_comm()
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"schema": pcm.SCHEMA, "links": {
        "ici": {"alpha_us": 5000.0, "gb_per_s": 10.0}}}))
    slow = analysis.analyze(port_step(pc), torch.ones(8), comm=pc, cost=True,
                            cost_model=str(path))
    fast = analysis.analyze(port_step(pc), torch.ones(8), comm=pc, cost=True)
    assert slow.cost.source == str(path)
    assert slow.cost.total_us > fast.cost.total_us
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    with pytest.raises(ValueError, match="JSON object"):
        analysis.analyze(port_step(pc), torch.ones(8), comm=pc, cost=True,
                         cost_model=str(bad))


def test_the_tuning_layer_feeds_the_model_with_its_stamp(tmp_path):
    from mpi4jax_tpu_torch.autotune import SCHEMA

    pc = port_comm()
    tpx.load_tuning({"schema": SCHEMA, "links": {
        "ici": {"alpha_us": 7.0, "gb_per_s": 3.0}}, "dispatch_us": 11.0,
        "measured": {"fusion_bucket_bytes": 1024}})
    try:
        model = pcm.load_model()
        assert model.tuned_stamp == tpx.active_tuning().stamp
        rep = analysis.analyze(port_step(pc), torch.ones(8), comm=pc,
                               cost=True)
        assert rep.cost.dispatch_us == 11.0
        adv = [f for f in rep.findings if f.code == "MPX132"]
        assert adv and f"tuned@{model.tuned_stamp}" in adv[0].message
        assert hook.config_snapshot()["measured_fusion_bucket_bytes"] == 1024
    finally:
        tpx.load_tuning(None)
    assert "measured_fusion_bucket_bytes" not in hook.config_snapshot()


def _verify(comm, fn, *args):
    """The ambient verification of a region of ``fn`` over ``comm`` (what
    a region's first call runs before its body; the body itself is not
    run here: a virtual grid has no processes)."""
    from mpi4jax_tpu_torch.analysis import crossrank
    from mpi4jax_tpu_torch.parallel.region import region_body

    crossrank.verify_region(fn, comm, (), (), 1, args, {},
                            region_body(fn, comm, (), ()))


def test_the_ambient_pass_attaches_a_cost(monkeypatch):
    pc = port_comm()
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE", "warn")
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_COST", "on")
    tpx.clear_caches()
    sink = []
    hook.set_report_sink(sink)
    try:
        _verify(pc, lambda x: tpx.allreduce(x, comm=pc)[0], torch.ones(8))
    finally:
        hook.set_report_sink(None)
    costed = [r for _, r in sink if r.cost is not None]
    # a clean report is sunk too when the cost pass ran
    assert costed and costed[0].ok and costed[0].cost.total_us > 0
    assert costed[0].cost.ranks == tuple(range(N))


def test_the_ambient_pass_prices_a_one_rank_region(monkeypatch):
    one = port_comm(1)
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE", "error")
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_COST", "on")
    tpx.clear_caches()
    sink = []
    hook.set_report_sink(sink)
    try:
        out = tpx.run(lambda x: x * 2 + 1, torch.ones(4), comm=one)
    finally:
        hook.set_report_sink(None)
    assert out.tolist() == [3.0] * 4
    (where, rep), = [(w, r) for w, r in sink if r.cost is not None]
    assert "cross-rank" in where and rep.cost.ranks == (0,)
    assert max(rep.cost.compute_us.values()) > 0


def test_the_cache_token_moves_only_with_the_pass_armed(monkeypatch):
    base = hook.analysis_cache_token()
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_COST", "off")
    assert hook.analysis_cache_token() == base
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_COST", "on")
    assert hook.analysis_cache_token() != base
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_COST", "bogus")
    with pytest.raises(ValueError, match="MPI4JAX_TPU_ANALYZE_COST"):
        hook.analysis_cache_token()


def test_a_rejected_file_skips_the_ambient_cost_pass_with_a_warning(
        monkeypatch, tmp_path):
    pc = port_comm()
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    monkeypatch.setenv("MPI4JAX_TPU_COST_MODEL", str(bad))
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE", "warn")
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_COST", "on")
    tpx.clear_caches()
    sink = []
    hook.set_report_sink(sink)
    try:
        with pytest.warns(UserWarning, match="cost pass skipped"):
            _verify(pc, lambda x: tpx.allreduce(x, comm=pc)[0],
                    torch.ones(8))
    finally:
        hook.set_report_sink(None)
    assert all(r.cost is None for _, r in sink)
