"""The port's collective verifier against the JAX package's, end to end.

The same programs go through ``mpi4jax_tpu.analysis.analyze`` (on the
8-device CPU mesh, rank-dependent structure written with ``lax.cond``)
and ``mpi4jax_tpu_torch.analysis.analyze`` (on a *virtual* grid,
``ProcessGrid(..., rank=0)`` without ``torch.distributed``, the same
structure written as Python branches on ``comm.Get_rank()``):

- the four broken twins of ``models/broken/`` and a two-rank
  head-to-head: under ``analyze(ranks='all')`` the two reports give equal
  codes, ranks and ``where`` (op and index); messages are compared after
  masking the comm uids and async span ids in them, which count each
  process's objects and differ between the packages;
- clean programs (the shallow-water step on (2, 2) in every
  ``select_steps`` mode a (2, 2) grid runs, ring attention, the MoE
  layer, the interleaved pipeline, the serving decode step): 0 error
  findings in both packages (the JAX package's single-trace pass; see
  below for its cross-rank pass), and the port's event stream equals the
  JAX one's event by event in (op, shape, dtype, root, pairs, tag,
  reduction).  On a row or column sub-communicator the port records its
  routing pairs in world ranks, the rank space of the per-rank
  schedules; the JAX package records the comm's own ranks, so its pairs
  are mapped to world ranks here before the comparison (ROADMAP Queue 3);
- the ambient mode on 4 gloo ranks: ``off``, ``warn`` and ``error`` give
  bit for bit the same states and exchanges on a clean program, a key
  verified once runs no verifier code again, and the rank-divergent twin
  raises ``AnalysisError`` on every rank before any exchange;
- the kernels' ``meta`` routes give their plain versions' shapes and
  dtypes (``tests/test_torch_cuda.py:test_meta_routes_launch_nothing_on_the_card``
  holds, on the card, that an abstract run launches nothing).

The JAX side is computed directly, not through the JAX suite (whose
``test_crossrank.py`` fails in this environment): with the installed JAX,
``jax.make_jaxpr`` serves a second trace of the same function from its
trace cache, so the JAX package's per-rank re-traces after the first
record no event and its matcher reports rank 0's messages as never
received (``test_jax_cross_rank_pass_needs_a_fresh_trace_per_rank``).
The ``fresh_jax_traces`` fixture clears JAX's caches before each of its
traces, which gives every rank its own trace, as the JAX package
intends.  Two differences by design remain (ROADMAP Queue 3): the port's
tokens order nothing and pass through every op, so it has no MPX107
token fork, which the JAX package reports on its own halo exchanges and
pipeline; and on a row or column communicator the JAX package's routing
pairs are the comm's own ranks, which its matcher reads as world ranks
(false MPX101/MPX102 on the (2, 2) shallow-water step), while the port's
are world ranks.  The shallow-water cases therefore compare the port's
findings with no error against the JAX single-trace pass, MPX107 aside.
"""

import importlib.util
import os
import re
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

import mpi4jax_tpu_torch as tpx  # noqa: E402
import torch_ranks as R  # noqa: E402
import torch_ranks_analysis as RA  # noqa: E402
from mpi4jax_tpu_torch import analysis  # noqa: E402
from mpi4jax_tpu_torch.analysis import crossrank  # noqa: E402
from mpi4jax_tpu_torch.models import broken  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.parallel.comm import Comm  # noqa: E402
from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(REPO, "examples"))

import shallow_water as JSW  # noqa: E402

from mpi4jax_tpu_torch.models import shallow_water as PSW  # noqa: E402

N = 4


@pytest.fixture(autouse=True)
def fresh_jax_traces(monkeypatch):
    """Every ``jax.make_jaxpr`` traces afresh (see the module docstring)."""
    make_jaxpr = jax.make_jaxpr

    def fresh(*args, **kwargs):
        jax.clear_caches()
        return make_jaxpr(*args, **kwargs)

    monkeypatch.setattr(jax, "make_jaxpr", fresh)


def jax_comm(n=N, shape=None, axes=("i",)):
    mesh = mpx.make_world_mesh(shape or (n,), axes, devices=jax.devices()[:n])
    return mpx.Comm(axes, mesh=mesh) if len(axes) > 1 else mpx.Comm(axes[0], mesh=mesh)


def port_comm(n=N, shape=None, axes=("i",), device="cpu"):
    grid = ProcessGrid(shape or (n,), axes, torch.device(device), rank=0)
    return Comm(axes, mesh=grid)


def load_jax_broken(name):
    path = os.path.join(REPO, "examples", "broken", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_broken_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_UIDS = re.compile(r"\b(comm|span) \d+")


def masked(text: str) -> str:
    """A message with its comm uids and async span ids masked."""
    return _UIDS.sub(lambda m: m.group(1) + " #", text)


def finding_keys(report, skip=()):
    return sorted((f.code, f.rank, f.op, f.index, f.seq, masked(f.message))
                  for f in report.findings if f.code not in skip)


def errors(report):
    return [f.code for f in report.findings if f.severity == "error"]


# ---------------------------------------------------------------------------
# broken programs: the same findings in both packages
# ---------------------------------------------------------------------------


def _jax_broken(name, comm):
    mod = load_jax_broken(name)
    n = comm.Get_size()
    row = jnp.stack([jnp.full((16,), float(r)) for r in range(n)])
    if name == "rank_divergent_deadlock":
        return mod.build_exchange(comm), (row,)
    if name == "pipeline_interleave_deadlock":
        return mod.build_boundary(comm), (row,)
    if name == "moe_divergent_capacity":
        x = jnp.stack([jnp.full((n, mod.CAPACITY, mod.D), float(r))
                       for r in range(n)])
        return mod.build_combine(comm), (x,)
    if name == "ef_divergent_gate":
        g = jnp.stack([jnp.full((64,), 1.0) for r in range(n)])
        return mod.build_step(comm), (g, jnp.zeros_like(g))
    return mod.build_step(comm), (row,)


# the JAX package records both arms of a lax.cond into the event stream, one
# after the other; the port's stream holds the first arm only (the others
# are recorded apart, parallel/control.py), so an advisory that counts a
# run of adjacent collectives across the branch counts the arms differently
ARM_COUNTED = {"ef_divergent_gate": ("MPX111",)}


@pytest.mark.parametrize("name", broken.TWINS)
def test_broken_twin_reports_equal_jax(name, monkeypatch):
    if name == "ef_divergent_gate":
        # the JAX script sets a lossy codec at import when none is set
        monkeypatch.setenv("MPI4JAX_TPU_COMPRESS", "bf16")
    twin = importlib.import_module(f"mpi4jax_tpu_torch.models.broken.{name}")
    jc = jax_comm()
    jfn, jargs = _jax_broken(name, jc)
    jrep = mpx.analyze(jfn, *jargs, comm=jc, ranks="all")
    pc = port_comm()
    prep = analysis.analyze(twin.build(pc, "meta"), *twin.example(pc, "meta"),
                            comm=pc, ranks="all")
    assert twin.CODES & {f.code for f in prep.findings}
    skip = ARM_COUNTED.get(name, ())
    assert finding_keys(prep, skip) == finding_keys(jrep, skip)
    for code in skip:
        assert code in {f.code for f in prep.findings} & \
            {f.code for f in jrep.findings}


def test_two_rank_head_to_head_equals_jax():
    """Both ranks receive first: a two-rank wait cycle, MPX121."""
    swap = ((0, 1), (1, 0))

    def jfn(x):
        got, t = mpx.recv(x, source=swap, tag=0)
        mpx.send(x, swap, tag=0, token=t)
        return got

    def pfn(x):
        got, t = tpx.recv(x, source=swap, tag=0)
        tpx.send(x, swap, tag=0, token=t)
        return got

    jc, pc = jax_comm(2), port_comm(2)
    jrep = mpx.analyze(jfn, jnp.zeros((2, 8)), comm=jc, ranks="all")
    prep = analysis.analyze(pfn, torch.zeros(8), comm=pc, ranks="all")
    assert "MPX121" in {f.code for f in prep.findings}
    assert finding_keys(prep) == finding_keys(jrep)


def test_rank_as_a_root_is_mpx104_in_both():
    jc, pc = jax_comm(), port_comm()
    jrep = mpx.analyze(lambda x: mpx.bcast(x, root=jc.Get_rank(), comm=jc)[0],
                       jnp.zeros((N, 4)), comm=jc, ranks="all")
    prep = analysis.analyze(lambda x: tpx.bcast(x, root=pc.Get_rank(), comm=pc)[0],
                            torch.zeros(4), comm=pc, ranks="all")
    assert {f.code for f in prep.findings} == {f.code for f in jrep.findings} \
        == {"MPX104"}
    assert sorted(f.rank for f in prep.findings) == list(range(N))


def test_rank_as_a_tag_or_route_is_mpx104():
    pc = port_comm()
    for fn in (lambda x: tpx.send(x, tpx.shift(1), tag=pc.Get_rank(), comm=pc),
               lambda x: tpx.send(x, pc.Get_rank(), comm=pc)):
        rep = analysis.analyze(fn, torch.zeros(4), comm=pc, ranks="all")
        assert {f.code for f in rep.findings} == {"MPX104"}


def test_single_trace_unmatched_p2p_equals_jax():
    """Without ``ranks`` a send with no recv is MPX101 and a recv with no
    send MPX102, from the run's own queues."""
    for jfn, pfn, code in (
            (lambda x: mpx.send(x, mpx.shift(1)) and x,
             lambda x: tpx.send(x, tpx.shift(1)) and x, "MPX101"),
            (lambda x: mpx.recv(x, source=mpx.shift(1))[0],
             lambda x: tpx.recv(x, source=tpx.shift(1))[0], "MPX102")):
        jrep = mpx.analyze(jfn, jnp.zeros((N, 4)), comm=jax_comm())
        prep = analysis.analyze(pfn, torch.zeros(4), comm=port_comm())
        assert [f.code for f in prep.findings] == [f.code for f in jrep.findings] \
            == [code]


# ---------------------------------------------------------------------------
# clean programs: 0 errors, and the JAX event stream
# ---------------------------------------------------------------------------


def event_key(e, tables=None):
    pairs = e.pairs
    if tables is not None and pairs is not None:
        pairs = tuple(sorted((t[s], t[d]) for t in tables for s, d in pairs))
    return (e.op, tuple(e.shape), e.dtype, e.root, pairs, e.tag, e.reduction)


def jax_events_in_world_ranks(jrep, pc):
    """The JAX events, a sub-communicator's pairs mapped to world ranks
    through the port's member tables of the same grid."""
    out = []
    for e in jrep.events:
        tables = None
        if e.pairs is not None and len(e.comm_axes) < len(pc.mesh.axes):
            tables = Comm(e.comm_axes, mesh=pc.mesh)._all_member_tables()
        out.append(event_key(e, tables))
    return out


def check_clean(jfn, jargs, jc, pfn, pargs, pc, same_findings=True):
    """0 error findings in both packages (MPX107 aside on the JAX side),
    the same findings where the JAX pairs are world ranks, and the JAX
    event stream."""
    jrep = mpx.analyze(jfn, *jargs, comm=jc, ranks="all")
    jsingle = mpx.analyze(jfn, *jargs, comm=jc)
    prep = analysis.analyze(pfn, *pargs, comm=pc, ranks="all")
    psingle = analysis.analyze(pfn, *pargs, comm=pc)
    assert errors(prep) == errors(psingle) == []
    assert [c for c in errors(jsingle) if c != "MPX107"] == []
    assert finding_keys(psingle) == finding_keys(jsingle, skip=("MPX107",))
    if same_findings:
        assert finding_keys(prep) == finding_keys(jrep, skip=("MPX107",))
    want = jax_events_in_world_ranks(jrep, pc)
    assert [event_key(e) for e in prep.events] == want
    assert [event_key(e) for e in psingle.events] == \
        jax_events_in_world_ranks(jsingle, pc)
    assert len(want) > 0
    return prep


SW_MODES = ["wide2", "wide", "pallas_halo", True, False]


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("mode", SW_MODES, ids=str)
def test_shallow_water_step_is_clean_with_the_jax_event_stream(mode, periodic):
    jcfg = replace(JSW.Config(nx=64, ny=32, nproc_y=2, nproc_x=2),
                   periodic_x=periodic)
    pcfg = replace(PSW.Config(nx=64, ny=32, nproc_y=2, nproc_x=2),
                   periodic_x=periodic)
    jc = JSW.make_mesh_and_comm(jcfg, devices=jax.devices()[:4])[1]
    pc = port_comm(shape=(2, 2), axes=("py", "px"))
    jstep, pstep = JSW.select_steps(mode, jcfg)[0], PSW.select_steps(mode, pcfg)[0]
    shape = (pcfg.ny_local, pcfg.nx_local)
    check_clean(lambda s: jstep(s, jcfg, jc, False), (JSW.initial_state(jcfg),), jc,
                lambda s: pstep(s, pcfg, pc, False),
                (PSW.State(*[torch.empty(shape, device="meta")] * 6),), pc,
                same_findings=False)


def test_ring_attention_is_clean_with_the_jax_event_stream():
    from mpi4jax_tpu.attention import ring_attention as jring
    from mpi4jax_tpu_torch.attention import ring_attention as pring

    jc, pc = jax_comm(), port_comm()
    q = jnp.zeros((N, 1, 16, 2, 64), jnp.float32)
    t = torch.zeros((1, 16, 2, 64))
    check_clean(lambda a, b, c: jring(a, b, c, comm=jc), (q, q, q), jc,
                lambda a, b, c: pring(a, b, c, comm=pc), (t, t, t), pc)


def test_moe_layer_is_clean_with_the_jax_event_stream():
    from mpi4jax_tpu.parallel import moe as jmoe
    from mpi4jax_tpu_torch.parallel import moe as pmoe

    tokens, d, d_ff = 16, 8, 12
    params = [jmoe.init_moe_params(d, d_ff, N, rank=r, seed=3) for r in range(N)]
    stacked = tuple(jnp.asarray(np.stack([getattr(p, f) for p in params]))
                    for f in pmoe.MoEParams._fields)
    mine = pmoe.init_moe_params(d, d_ff, N, rank=0, seed=3)
    jc, pc = jax_comm(), port_comm()
    check_clean(
        lambda x, a, b, c: jmoe.moe_layer(x, jmoe.MoEParams(a, b, c), comm=jc)[0],
        (jnp.zeros((N, tokens, d)), *stacked), jc,
        lambda x, a, b, c: pmoe.moe_layer(x, pmoe.MoEParams(a, b, c), comm=pc)[0],
        (torch.zeros((tokens, d)), *(torch.from_numpy(np.asarray(p)) for p in mine)),
        pc)


@pytest.mark.parametrize("schedule,virtual", [("interleaved", 2), ("1f1b", 1),
                                              ("gpipe", 1)])
def test_pipeline_is_clean_with_the_jax_event_stream(schedule, virtual):
    from mpi4jax_tpu_torch.parallel.pipeline import pipeline as ppipeline

    m, dim = 16, 4
    jc, pc = jax_comm(), port_comm()
    jprog = mpx.pipeline(lambda h, w: jnp.tanh(h @ w), m, schedule=schedule,
                         virtual=virtual, comm=jc)
    pprog = ppipeline(lambda h, w: torch.tanh(h @ w), m, schedule=schedule,
                      virtual=virtual, comm=pc)
    wshape = (virtual, dim, dim) if virtual > 1 else (dim, dim)
    check_clean(lambda a, b: jprog.trace(a, b)[0],
                (jnp.zeros((N, m, 1, dim)), jnp.zeros((N,) + wshape)), jc,
                lambda a, b: pprog.trace(a, b)[0],
                (torch.zeros((m, 1, dim)), torch.zeros(wshape)), pc)


def test_serving_decode_step_is_clean_with_the_jax_event_stream():
    from mpi4jax_tpu.serving import engine as jengine
    from mpi4jax_tpu.serving import model as jmodel
    from mpi4jax_tpu_torch.serving import engine as pengine
    from mpi4jax_tpu_torch.serving import model as pmodel

    jc, pc = jax_comm(), port_comm()
    jargs = [jnp.zeros(s, jnp.dtype(d))
             for s, d in jengine.ServingConfig().program_args("decode", 4, N)]
    pargs = [torch.zeros(s, dtype=getattr(torch, d))
             for s, d in pengine.ServingConfig().program_args("decode", 4, N)]
    check_clean(jmodel.decode_step, jargs, jc, pmodel.decode_step, pargs, pc)


def test_jax_cross_rank_pass_needs_a_fresh_trace_per_rank(monkeypatch):
    """With the installed JAX a second ``jax.make_jaxpr`` of the same
    function is served from the trace cache: without the fixture the JAX
    package's per-rank re-traces after the first record no event on ring
    attention, and its matcher reports rank 0's sends as never received.
    The port re-runs every rank."""
    from mpi4jax_tpu.analysis import crossrank as jcrossrank
    from mpi4jax_tpu.attention import ring_attention as jring
    from mpi4jax_tpu.parallel.region import spmd as jspmd
    from mpi4jax_tpu_torch.attention import ring_attention as pring

    monkeypatch.undo()
    jc, pc = jax_comm(), port_comm()
    q = jnp.zeros((N, 1, 16, 2, 64), jnp.float32)
    target = jspmd(lambda a, b, c: jring(a, b, c, comm=jc), comm=jc, jit=False)
    jper, _, _ = jcrossrank.trace_rank_schedules(target, (q, q, q), {}, (),
                                                 jc.axes, [N], range(N))
    assert len(jper[0]) > 0 and all(len(jper[r]) == 0 for r in range(1, N))
    t = torch.zeros((1, 16, 2, 64))
    target = tpx.spmd(lambda a, b, c: pring(a, b, c, comm=pc), comm=pc)
    pper, fatal = crossrank.trace_rank_schedules(target, (t, t, t), {}, pc.axes,
                                                 [N], range(N))
    assert not fatal
    assert all(len(pper[r]) == len(jper[0]) for r in range(N))


@pytest.mark.parametrize("axes", [("py", "px"), ("px", "py"), ("px",)])
def test_per_rank_pairs_and_groups_are_in_the_scope_rank_space(axes):
    """During a per-rank run a region comm's routing pairs and member
    groups are ranks of the run's scope, ordered over the region comm's
    axes, whatever the grid's axis order (on a row comm, the copies in
    this rank's row)."""
    grid = ProcessGrid((2, 3), ("py", "px"), torch.device("cpu"), rank=0)
    c = Comm(axes, mesh=grid)
    n = c.Get_size()

    def fn(x):
        y, _ = tpx.sendrecv(x, x, dest=tpx.shift(1), comm=c)
        return tpx.allreduce(y, comm=c)[0]

    target = tpx.spmd(fn, comm=c)
    per, fatal = crossrank.trace_rank_schedules(target, (torch.zeros(2),), {},
                                                c.axes, [grid.axis_size(a) for a in axes],
                                                range(n))
    assert not fatal
    for r in range(n):
        sr, ar = per[r]
        assert sr.pairs == tuple((i, (i + 1) % n) for i in range(n))
        assert ar.groups == (tuple(range(n)),)
    assert not analysis.analyze(fn, torch.zeros(2), comm=c, ranks="all").errors


def test_the_virtual_comm_may_name_the_card():
    """The abstract run never touches the comm's device: a virtual grid on
    the card analyzes without one, with the stream of the CPU grid."""
    cfg = PSW.Config(nx=64, ny=32, nproc_y=2, nproc_x=2)
    step = PSW.select_steps("auto", cfg)[0]
    state = PSW.State(*[torch.empty((cfg.ny_local, cfg.nx_local), device="meta")] * 6)
    reps = []
    for device in ("cuda:0", "cpu"):
        pc = port_comm(shape=(2, 2), axes=("py", "px"), device=device)
        assert pc.device.type == device[:4].rstrip(":")
        reps.append(analysis.analyze(lambda s: step(s, cfg, pc, False), state,
                                     comm=pc, ranks="all"))
    assert [event_key(e) for e in reps[0].events] == \
        [event_key(e) for e in reps[1].events]
    assert errors(reps[0]) == []


# ---------------------------------------------------------------------------
# the front-ends' contracts
# ---------------------------------------------------------------------------


def test_a_data_dependent_branch_names_its_cause():
    pc = port_comm()

    def fn(x):
        if x.sum() > 0:  # a branch on a value the abstract run does not have
            return tpx.allreduce(x, comm=pc)[0]
        return x

    with pytest.raises(crossrank.DataDependentBranch) as e:
        analysis.analyze(fn, torch.ones(4), comm=pc)
    assert "abstract run" in str(e.value) and "meta" in str(e.value)


def test_analyze_runs_nothing_and_is_memoized():
    pc = port_comm()
    calls = []

    def fn(x):
        calls.append(x.device.type)
        return tpx.allreduce(x, comm=pc)[0]

    x = torch.ones(4)
    a = analysis.analyze(fn, x, comm=pc)
    b = analysis.analyze(fn, x, comm=pc)
    assert a is b and calls == ["meta"]
    assert [e.op for e in a.events] == ["allreduce"] and a.ok
    tpx.clear_caches()
    assert analysis.analyze(fn, x, comm=pc) is not a


def test_cost_attaches_a_prediction_and_implies_every_rank():
    """``cost=True`` runs the cross-rank pass (``ranks='all'`` implied) and
    attaches ``Report.cost``; ``cost_model`` alone, as in the JAX package,
    changes nothing without it."""
    from mpi4jax_tpu_torch.analysis import costmodel

    pc = port_comm()

    def fn(x):
        return tpx.allreduce(x, comm=pc)[0]

    rep = analysis.analyze(fn, torch.ones(8), comm=pc, cost=True)
    assert rep.cost is not None and rep.cost.total_us > 0
    assert list(rep.meta["ranks"]) == list(range(N))
    assert rep.cost.per_op["allreduce"]["count"] == 1
    model = costmodel.CostModel({"dispatch_us": 7.0})
    plain = analysis.analyze(fn, torch.ones(8), comm=pc, cost_model=model)
    assert plain.cost is None and "ranks" not in plain.meta
    with pytest.raises(ValueError, match="implies ranks='all'"):
        analysis.analyze(fn, torch.ones(8), comm=pc, wrap=False, cost=True)


def test_set_analyze_mode_validates_and_bumps_the_pin_stamp():
    with pytest.raises(ValueError, match="analyze mode"):
        tpx.set_analyze_mode("loud")
    pc = port_comm(1)
    pp = tpx.compile(lambda x: x + 1, torch.ones(2), comm=pc)
    key = pp.key
    tpx.set_analyze_mode("warn")
    assert pp.is_stale()
    with pytest.raises(tpx.StaleProgramError) as e:
        pp(torch.ones(2))
    assert e.value.mpx_code == "MPX129"
    assert pp.repin().key != key
    tpx.set_analyze_mode(None)


def test_an_eager_op_is_verified_once_per_static_key(monkeypatch):
    """Outside a region an op is verified at its first call for each
    key, before it runs; a root out of range raises its own MPX105."""
    pc = port_comm(1)
    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE", "error")
    before = crossrank.stats["verifications"]
    for _ in range(3):
        y, _ = tpx.allreduce(torch.ones(3), comm=pc)
    assert y.tolist() == [1.0, 1.0, 1.0]
    assert crossrank.stats["verifications"] - before == 1
    tpx.bcast(torch.ones(3), 0, comm=pc)
    assert crossrank.stats["verifications"] - before == 2


def test_region_verification_happens_before_it_runs(monkeypatch):
    """Under ``error`` a region with findings raises before its body
    runs; under ``warn`` it warns once and runs."""
    pc = port_comm(1)
    ran = []

    def fn(x):
        ran.append(x.device.type)
        # two adjacent allreduces with fusion off: the MPX111 advisory
        a, _ = tpx.allreduce(x, comm=pc)
        b, _ = tpx.allreduce(x, comm=pc)
        return a + b

    prog = tpx.spmd(fn, comm=pc)
    tpx.set_analyze_mode("error")
    with pytest.raises(tpx.AnalysisError) as e:
        prog(torch.ones(2))
    assert [f.code for f in e.value.findings] == ["MPX111"]
    assert ran == ["meta"]
    tpx.set_analyze_mode("warn")
    with pytest.warns(UserWarning, match="MPX111"):
        assert prog(torch.ones(2)).tolist() == [2.0, 2.0]
    assert ran == ["meta", "meta", "cpu"]
    tpx.set_analyze_mode(None)


# ---------------------------------------------------------------------------
# the ambient mode on gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.RunResults(tmp_path_factory, "analysis")


def test_ambient_modes_are_bit_for_bit_with_off_on_four_ranks(results):
    world = results.get("ambient", lambda: launch.run(
        RA.ambient_program, 4, device="cpu", timeout=R.RANK_TIMEOUT_S))
    for out in world:
        for mode in RA.MODES:
            for call in (1, 2):
                assert out[f"{mode}/{call}/state"].tobytes() == \
                    out[f"off/{call}/state"].tobytes()
                assert out[f"{mode}/{call}/exchanges"] == out["off/1/exchanges"] > 0
            # a verified key runs no verifier code
            assert out[f"{mode}/2/runs"] == out[f"{mode}/2/verifications"] == 0
        assert out["off/1/runs"] == 0
        # this rank's own run and one per rank of the cross-rank pass
        assert out["warn/1/runs"] == out["error/1/runs"] == 5
        assert out["warn/1/verifications"] == 1


def test_rank_divergent_twin_raises_on_every_gloo_rank_before_any_exchange():
    out = broken.drill("rank_divergent_deadlock",
                       ["--launch", "4", "--device", "cpu", "--timeout", "50"])
    assert out["launch"] == [["MPX121"]] * 4
    assert out["analyze"] == out["ambient"] == ["MPX121"]


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------


def _like(outs):
    return [(tuple(t.shape), t.dtype) for t in outs]


def _fields(shape, device):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.rand(shape, generator=g).to(device) for _ in range(6))


def test_stencil_meta_routes_give_the_plain_shapes():
    from mpi4jax_tpu_torch.kernels import sw_phase, sw_steps, sw_wide

    cfg = PSW.Config(nx=64, ny=32, nproc_y=1, nproc_x=1)
    shape = (cfg.ny_local, cfg.nx_local)
    cpu, meta = _fields(shape, "cpu"), _fields(shape, "meta")
    assert _like(sw_steps.sw_steps(meta, cfg, False, 2)) == \
        _like(sw_steps.sw_steps(cpu, cfg, False, 2))
    assert _like(sw_phase.sw_phase1(meta, cfg, True, (0, 0))) == \
        _like(sw_phase.sw_phase1(cpu, cfg, True, (0, 0)))
    assert _like(sw_phase.sw_phase2(meta[1], meta[2], cfg, (0, 0))) == \
        _like(sw_phase.sw_phase2(cpu[1], cpu[2], cfg, (0, 0)))
    wide = (shape[0] + 8, shape[1] + 8)
    assert _like(sw_wide.sw_wide(_fields(wide, "meta"), cfg, False, 2, (-4, -4))) \
        == _like(sw_wide.sw_wide(_fields(wide, "cpu"), cfg, False, 2, (-4, -4)))
    with pytest.raises(ValueError, match="sw_steps"):
        sw_steps.sw_steps(_fields((5, 5), "meta"), cfg, False, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_meta_routes_give_the_plain_shapes(dtype, causal):
    from mpi4jax_tpu_torch.kernels import flash_attention as fa

    b, t, h, d = 1, 32, 2, 64
    q = torch.rand((b, t, h, d)).to(dtype)
    mq = q.to("meta")
    mask = None
    cpu = fa.flash_block_partials(q, q, q, mask, scale=0.1, causal=causal)
    meta = fa.flash_block_partials(mq, mq, mq, mask, scale=0.1, causal=causal)
    assert _like(meta) == _like(cpu) and all(x.is_meta for x in meta)
    m, g_o, g_l = cpu[1], torch.rand_like(cpu[0]), torch.rand_like(cpu[2])
    grads = fa.block_partials_bwd(q, q, q, mask, m, g_o, g_l, scale=0.1,
                                  causal=causal)
    mgrads = fa.block_partials_bwd(mq, mq, mq, mask, m.to("meta"),
                                   g_o.to("meta"), g_l.to("meta"), scale=0.1,
                                   causal=causal)
    assert _like(mgrads) == _like(grads)


# ---------------------------------------------------------------------------
# programs under vmap: the JAX events of the jax.vmap program
# ---------------------------------------------------------------------------

VMAP_LANES = 3
# (name, the JAX op, the port op): the lane's call of each op family
VMAP_OPS = {
    "allreduce": lambda ns, c: lambda v: ns.allreduce(v, comm=c)[0],
    "sendrecv": lambda ns, c: lambda v: ns.sendrecv(v, v, dest=ns.shift(1), comm=c)[0],
    "alltoall": lambda ns, c: lambda v: ns.alltoall(v, comm=c)[0],
    "allgather": lambda ns, c: lambda v: ns.allgather(v, comm=c)[0],
    "bcast": lambda ns, c: lambda v: ns.bcast(v, 1, comm=c)[0],
}


@pytest.mark.parametrize("name", sorted(VMAP_OPS))
def test_vmapped_op_records_the_jax_events(name):
    """An op under ``vmap`` (three lanes of (N, 5)) records the events of
    the JAX package's ``jax.vmap`` of it, lane shape and all, 0 errors."""
    jc, pc = jax_comm(), port_comm()
    jop, pop = VMAP_OPS[name](mpx, jc), VMAP_OPS[name](tpx, pc)
    check_clean(jax.vmap(jop), (jnp.zeros((N, VMAP_LANES, N, 5)),), jc,
                lambda x: torch.func.vmap(pop)(x), (torch.zeros((VMAP_LANES, N, 5)),), pc)


@pytest.mark.parametrize("causal", [False, True])
def test_vmapped_ring_forward_records_the_jax_events(causal):
    """The vmapped ring forward (the rotations and, on ``meta``, the
    partials' batched shape rule) records the JAX ``jax.vmap`` events."""
    from mpi4jax_tpu.attention import ring_attention as jring
    from mpi4jax_tpu_torch.attention import ring_attention as pring

    jc, pc = jax_comm(), port_comm()
    q = jnp.zeros((N, VMAP_LANES, 1, 16, 2, 64), jnp.float32)
    t = torch.zeros((VMAP_LANES, 1, 16, 2, 64))
    rep = check_clean(
        jax.vmap(lambda a, b, c: jring(a, b, c, comm=jc, causal=causal)), (q, q, q), jc,
        lambda a, b, c: torch.func.vmap(
            lambda a, b, c: pring(a, b, c, comm=pc, causal=causal))(a, b, c), (t, t, t), pc)
    assert {e.op for e in rep.events} == {"sendrecv"}


@pytest.mark.parametrize("mode", ["pallas_halo", "wide2"])
def test_vmapped_stepper_pair_records_the_jax_events(mode):
    """A stepper pair of a (2, 2) grid (the first step, then one call of
    the chunk step, ``select_steps``' pair) under ``vmap`` over a
    two-member ensemble: 0 errors and the JAX event stream of ``jax.vmap``
    of the JAX pair; the stencils' batched ``meta`` routes run in the
    port's abstract run."""
    from mpi4jax_tpu_torch.kernels import _build

    jcfg = JSW.Config(nx=64, ny=32, nproc_y=2, nproc_x=2)
    pcfg = PSW.Config(nx=64, ny=32, nproc_y=2, nproc_x=2)
    jc = JSW.make_mesh_and_comm(jcfg, devices=jax.devices()[:4])[1]
    pc = port_comm(shape=(2, 2), axes=("py", "px"))

    def pair(ns, cfg, comm):
        step, chunk, _ = ns.select_steps(mode, cfg)
        return lambda s: (chunk or step)(step(s, cfg, comm, True), cfg, comm, False)

    jpair, ppair = pair(JSW, jcfg, jc), pair(PSW, pcfg, pc)
    # the rank axis first, the members behind it
    jens = JSW.State(*(jnp.stack([f, f], axis=1) for f in JSW.initial_state(jcfg)))
    shape = (2, pcfg.ny_local, pcfg.nx_local)
    seen = []
    hook = _build._meta_hook
    _build.set_meta_hook(lambda outs, ins, name: (
        seen.append((name, tuple(outs[0].shape))), hook and hook(outs, ins, name)))
    try:
        check_clean(jax.vmap(jpair), (jens,), jc,
                    lambda s: PSW.State(*torch.func.vmap(
                        lambda *f: tuple(ppair(PSW.State(*f))))(*s)),
                    (PSW.State(*[torch.empty(shape, device="meta")] * 6),), pc,
                    same_findings=False)
    finally:
        _build.set_meta_hook(hook)
    kernel = "sw_phase1" if mode == "pallas_halo" else "sw_wide"
    assert any(name == kernel and s[0] == 2 for name, s in seen), seen
