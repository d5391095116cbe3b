"""The port's dataflow passes end to end, against the JAX package's.

The same programs go through ``mpi4jax_tpu.analyze`` (the 8-device CPU
mesh, branches written with ``lax.cond``/``lax.switch``) and
``mpi4jax_tpu_torch.analysis.analyze`` (a virtual grid, branches written
with the port's ``cond``/``switch``): MPX108, MPX141 and MPX142 give equal
codes, ops, ranks and messages (the programs of ``tests/test_hazards.py``
and the ``ef_divergent_gate`` twin), and each trail starts at its seed.
The map from each port op to the JAX primitives its JAX op lowers to
(``dataflow.jax_primitives``) is held against real jaxprs.  The lineage
capture itself, ``cond``/``switch`` in concrete and per-rank runs, the
``ef`` mark and the ambient ``error`` mode are held to their own rules,
and the main-path programs carry no lineage finding.
"""

import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.analysis.walker import _sub_jaxprs, is_collective  # noqa: E402

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import analysis  # noqa: E402
from mpi4jax_tpu_torch.analysis import dataflow, hook, lineage  # noqa: E402
from mpi4jax_tpu_torch.parallel.comm import Comm  # noqa: E402
from mpi4jax_tpu_torch.parallel.control import cond, switch  # noqa: E402
from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

N = 4
LINEAGE = ("MPX108", "MPX141", "MPX142")


@pytest.fixture(autouse=True)
def fresh_jax_traces(monkeypatch):
    """Every ``jax.make_jaxpr`` traces afresh (the installed JAX serves a
    re-trace from its cache: ``tests/test_torch_analysis.py``)."""
    make_jaxpr = jax.make_jaxpr

    def fresh(*args, **kwargs):
        jax.clear_caches()
        return make_jaxpr(*args, **kwargs)

    monkeypatch.setattr(jax, "make_jaxpr", fresh)
    monkeypatch.delenv("MPI4JAX_TPU_COMPRESS", raising=False)
    yield
    mpx.set_analyze_mode(None)
    mpx.clear_caches()


def jax_comm(n=N):
    mesh = mpx.make_world_mesh((n,), ("i",), devices=jax.devices()[:n])
    return mpx.Comm("i", mesh=mesh)


def port_comm(n=N):
    return Comm(("i",), mesh=ProcessGrid((n,), ("i",), torch.device("cpu"),
                                         rank=0))


def lineage_keys(report):
    return sorted((f.code, f.op, f.rank, f.message)
                  for f in report.findings if f.code in LINEAGE)


def jrows(shape=(16,), n=N):
    return jnp.stack([jnp.full(shape, 1.0 + r) for r in range(n)])


# ---------------------------------------------------------------------------
# the JAX primitives of each op, against real jaxprs
# ---------------------------------------------------------------------------


def _jax_prims(fn, x):
    closed = jax.make_jaxpr(fn)(x)
    names = []

    def walk(j):
        for e in j.eqns:
            if is_collective(e.primitive.name):
                names.append(e.primitive.name)
            for sub in _sub_jaxprs(e):
                walk(sub)

    walk(closed.jaxpr)
    return Counter(names)


OPS = {
    "allreduce:sum": (lambda c: lambda v: mpx.allreduce(v, mpx.SUM, comm=c)[0],
                      "allreduce", "sum"),
    "allreduce:max": (lambda c: lambda v: mpx.allreduce(v, mpx.MAX, comm=c)[0],
                      "allreduce", "max"),
    "allreduce:min": (lambda c: lambda v: mpx.allreduce(v, mpx.MIN, comm=c)[0],
                      "allreduce", "min"),
    "allreduce:prod": (lambda c: lambda v: mpx.allreduce(v, mpx.PROD, comm=c)[0],
                       "allreduce", "prod"),
    "reduce:max": (lambda c: lambda v: mpx.reduce(v, mpx.MAX, 0, comm=c)[0],
                   "reduce", "max"),
    "scan:sum": (lambda c: lambda v: mpx.scan(v, mpx.SUM, comm=c)[0],
                 "scan", "sum"),
    "bcast": (lambda c: lambda v: mpx.bcast(v, 1, comm=c)[0], "bcast", None),
    "allgather": (lambda c: lambda v: mpx.allgather(v, comm=c)[0],
                  "allgather", None),
    "gather": (lambda c: lambda v: mpx.gather(v, 0, comm=c)[0], "gather", None),
    "sendrecv": (lambda c: lambda v: mpx.sendrecv(
        v, v, source=mpx.shift(-1), dest=mpx.shift(1), comm=c)[0],
        "sendrecv", None),
    "barrier": (lambda c: lambda v: (mpx.barrier(comm=c), v)[1], "barrier",
                None),
}


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(OPS))
def test_jax_primitives_are_the_jax_lowering(name, k):
    build, op, reduction = OPS[name]
    c = jax_comm(k)
    want = _jax_prims(mpx.spmd(build(c), comm=c), jnp.zeros((k, 16)))
    assert Counter(dataflow.jax_primitives(op, reduction, k)) == want


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("name", ["allreduce:sum", "allreduce:max", "bcast"])
def test_jax_primitives_of_a_color_split(name, k):
    _, op, reduction = OPS[name]
    c = jax_comm(k)
    split = c.Split([r % 2 for r in range(k)], list(range(k)))
    fns = {"allreduce:sum": lambda v: mpx.allreduce(v, mpx.SUM, comm=split)[0],
           "allreduce:max": lambda v: mpx.allreduce(v, mpx.MAX, comm=split)[0],
           "bcast": lambda v: mpx.bcast(v, 0, comm=split)[0]}
    want = _jax_prims(mpx.spmd(fns[name], comm=c), jnp.zeros((k, 16)))
    assert Counter(dataflow.jax_primitives(op, reduction, k // 2,
                                           split=True)) == want


# ---------------------------------------------------------------------------
# MPX141 and MPX142: the programs of tests/test_hazards.py
# ---------------------------------------------------------------------------


def _jax_gate(comm, diverge=True):
    def step(x):
        total, _ = mpx.allreduce(x, mpx.SUM, comm=comm)
        drift = jnp.max(jnp.abs(x))

        def resync(v):
            s, _ = mpx.allreduce(v, mpx.SUM, comm=comm)
            m, _ = mpx.allreduce(jnp.mean(s) * jnp.ones_like(s), mpx.SUM,
                                 comm=comm)
            return s - m

        def keep(v):
            s, _ = mpx.allreduce(v, mpx.SUM, comm=comm)
            return s

        return lax.cond(drift > jnp.float32(0.5), resync if diverge else keep,
                        keep, total)

    return step


def _port_gate(comm, diverge=True):
    def step(x):
        total, _ = tpx.allreduce(x, tpx.SUM, comm=comm)
        drift = x.abs().max()

        def resync(v):
            s, _ = tpx.allreduce(v, tpx.SUM, comm=comm)
            m, _ = tpx.allreduce(s.mean() * torch.ones_like(s), tpx.SUM,
                                 comm=comm)
            return s - m

        def keep(v):
            s, _ = tpx.allreduce(v, tpx.SUM, comm=comm)
            return s

        return cond(drift > 0.5, resync if diverge else keep, keep, total)

    return step


@pytest.mark.parametrize("ranks", [None, "all"])
def test_mpx141_divergent_gate_equals_jax(ranks):
    jc, pc = jax_comm(), port_comm()
    jrep = mpx.analyze(_jax_gate(jc), jrows(), comm=jc, ranks=ranks)
    prep = analysis.analyze(_port_gate(pc), torch.ones(16), comm=pc,
                            ranks=ranks)
    assert "MPX141" in {f.code for f in prep.findings}
    assert lineage_keys(prep) == lineage_keys(jrep)
    f = next(f for f in prep.findings if f.code == "MPX141")
    assert f.severity == "error"
    assert f.frontier[0].startswith("rank-varying region argument 0")
    assert f.frontier[-1] == "cond predicate (schedule gate)"
    assert "aten.max" in f.frontier and "aten.gt" in f.frontier
    assert "taint:" in prep.render()
    assert "MPX108" not in {f.code for f in prep.findings}


def _slice_gate(x, comm):
    flags = torch.zeros(1, device=x.device)
    flags[0] = x.abs().max()  # aten.select + aten.copy_ into the base
    return flags[0]


def _view_before_write_gate(x, comm):
    buf = torch.zeros(4, device=x.device)
    head = buf[:1]  # taken before the write into its base
    buf.add_(x[:4].abs())
    return head.max()


def _write_through_a_view_gate(x, comm):
    z = torch.zeros(4, device=x.device)
    z.view(2, 2).copy_(x[:4].abs().view(2, 2))
    return z.max()


def _rank_into_a_slice_gate(x, comm):
    flags = torch.zeros(1, device=x.device)
    flags[0] = comm.Get_rank()  # a RankConcrete in a per-rank run
    return flags[0]


ALIASED_GATES = {
    "slice": (_slice_gate, "rank-varying region argument 0"),
    "view_before_write": (_view_before_write_gate,
                          "rank-varying region argument 0"),
    "write_through_a_view": (_write_through_a_view_gate,
                             "rank-varying region argument 0"),
    "rank_into_a_slice": (_rank_into_a_slice_gate,
                          "rank-varying RankConcrete scalar into"),
}


@pytest.mark.parametrize("name", sorted(ALIASED_GATES))
def test_mpx141_follows_writes_through_views_and_bases(name):
    """A rank-local value written into a buffer through a view (or into a
    base a view was taken of) reaches a predicate read from the buffer, as
    ``x.at[i].set(t)`` makes all of ``x`` depend on ``t`` in JAX."""
    gate, seed = ALIASED_GATES[name]
    pc = port_comm()

    def step(x):
        total, _ = tpx.allreduce(x, tpx.SUM, comm=pc)

        def resync(v):
            s, _ = tpx.allreduce(v, tpx.SUM, comm=pc)
            return tpx.allreduce(s, tpx.MAX, comm=pc)[0]

        def keep(v):
            return tpx.allreduce(v, tpx.SUM, comm=pc)[0]

        return cond(gate(x, pc) > 0.5, resync, keep, total)

    rep = analysis.analyze(step, torch.ones(16), comm=pc, ranks="all")
    f = next((f for f in rep.findings if f.code == "MPX141"), None)
    assert f is not None, rep.render()
    assert f.frontier[0].startswith(seed)
    assert f.frontier[-1] == "cond predicate (schedule gate)"


def test_mpx141_through_a_slice_equals_jax():
    jc, pc = jax_comm(), port_comm()

    def jstep(x):
        total, _ = mpx.allreduce(x, mpx.SUM, comm=jc)
        flags = jnp.zeros(1).at[0].set(jnp.max(jnp.abs(x)))

        def resync(v):
            s, _ = mpx.allreduce(v, mpx.SUM, comm=jc)
            m, _ = mpx.allreduce(jnp.mean(s) * jnp.ones_like(s), mpx.SUM,
                                 comm=jc)
            return s - m

        def keep(v):
            return mpx.allreduce(v, mpx.SUM, comm=jc)[0]

        return lax.cond(flags[0] > jnp.float32(0.5), resync, keep, total)

    def pstep(x):
        total, _ = tpx.allreduce(x, tpx.SUM, comm=pc)

        def resync(v):
            s, _ = tpx.allreduce(v, tpx.SUM, comm=pc)
            m, _ = tpx.allreduce(s.mean() * torch.ones_like(s), tpx.SUM,
                                 comm=pc)
            return s - m

        def keep(v):
            return tpx.allreduce(v, tpx.SUM, comm=pc)[0]

        return cond(_slice_gate(x, pc) > 0.5, resync, keep, total)

    jrep = mpx.analyze(jstep, jrows(), comm=jc, ranks="all")
    prep = analysis.analyze(pstep, torch.ones(16), comm=pc, ranks="all")
    assert "MPX141" in {f.code for f in prep.findings}
    assert lineage_keys(prep) == lineage_keys(jrep)


def test_mpx141_silent_when_the_arms_agree():
    jc, pc = jax_comm(), port_comm()
    jrep = mpx.analyze(_jax_gate(jc, False), jrows(), comm=jc, ranks="all")
    prep = analysis.analyze(_port_gate(pc, False), torch.ones(16), comm=pc,
                            ranks="all")
    assert lineage_keys(prep) == lineage_keys(jrep) == []


def test_a_replicated_gate_is_silent():
    """MAX-allreduce the gating value first (the fix the finding names)."""
    pc = port_comm()

    def step(x):
        total, _ = tpx.allreduce(x, comm=pc)
        drift, _ = tpx.allreduce(x.abs().max(), tpx.MAX, comm=pc)
        return cond(drift > 0.5, lambda v: tpx.allreduce(v, comm=pc)[0] * 2,
                    lambda v: v, total)

    rep = analysis.analyze(step, torch.ones(16), comm=pc, ranks="all")
    assert not {"MPX141", "MPX142"} & {f.code for f in rep.findings}
    assert "MPX108" in {f.code for f in rep.findings}


def _jax_codec_gate(comm):
    def step(x):
        total, _ = mpx.allreduce(x, mpx.SUM, comm=comm)
        q = total.astype(jnp.bfloat16).astype(jnp.float32)

        def a(v):
            return mpx.allreduce(v, mpx.SUM, comm=comm)[0]

        return lax.cond(jnp.max(q) > jnp.float32(0.5), a, a, total)

    return step


def _port_codec_gate(comm):
    def step(x):
        total, _ = tpx.allreduce(x, tpx.SUM, comm=comm)
        q = total.to(torch.bfloat16).to(torch.float32)

        def a(v):
            return tpx.allreduce(v, tpx.SUM, comm=comm)[0]

        return cond(q.max() > 0.5, a, a, total)

    return step


@pytest.mark.parametrize("codec", ["bf16", "off"])
def test_mpx142_codec_gate_equals_jax(codec, monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_COMPRESS", codec)
    jc, pc = jax_comm(), port_comm()
    jrep = mpx.analyze(_jax_codec_gate(jc), jrows(), comm=jc, ranks="all")
    prep = analysis.analyze(_port_codec_gate(pc), torch.ones(16), comm=pc,
                            ranks="all")
    assert lineage_keys(prep) == lineage_keys(jrep)
    got = [f for f in prep.findings if f.code == "MPX142"]
    assert bool(got) == (codec == "bf16")
    if got:
        assert got[0].severity == "advisory"
        assert got[0].frontier[0].startswith("aten._to_copy -> torch.bfloat16")


def test_mpx108_equals_jax():
    jc, pc = jax_comm(), port_comm()

    def jstep(x):
        return lax.cond(x[0] > 0,
                        lambda v: mpx.varying(mpx.allreduce(v, comm=jc)[0]),
                        lambda v: v * 2, x)

    def pstep(x):
        return cond(x[0] > 0, lambda v: tpx.allreduce(v, comm=pc)[0],
                    lambda v: v * 2, x)

    jrep = mpx.analyze(jstep, jrows(), comm=jc, ranks="all")
    prep = analysis.analyze(pstep, torch.ones(16), comm=pc, ranks="all")
    assert lineage_keys(prep) == lineage_keys(jrep)
    assert {"MPX108", "MPX141"} <= {f.code for f in prep.findings}


def test_switch_equals_jax():
    jc, pc = jax_comm(), port_comm()
    jarms = [lambda v: mpx.varying(mpx.allreduce(v, comm=jc)[0]),
             lambda v: mpx.varying(mpx.allgather(v, comm=jc)[0][0]),
             lambda v: mpx.varying(mpx.allreduce(v, comm=jc)[0])]
    parms = [lambda v: tpx.allreduce(v, comm=pc)[0],
             lambda v: tpx.allgather(v, comm=pc)[0][0],
             lambda v: tpx.allreduce(v, comm=pc)[0]]

    def jstep(x):
        return lax.switch(jnp.argmax(x), jarms, x)

    def pstep(x):
        return switch(x.argmax(), parms, x)

    jrep = mpx.analyze(jstep, jrows(), comm=jc, ranks="all")
    prep = analysis.analyze(pstep, torch.ones(16), comm=pc, ranks="all")
    assert lineage_keys(prep) == lineage_keys(jrep)
    assert "branch 1: {all_gatherx1}" in next(
        f.message for f in prep.findings if f.code == "MPX141")


@pytest.mark.parametrize("codec", ["bf16", "off"])
def test_ef_divergent_gate_equals_jax(codec, monkeypatch):
    import importlib.util

    monkeypatch.setenv("MPI4JAX_TPU_COMPRESS", codec)
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "broken",
                        "ef_divergent_gate.py")
    spec = importlib.util.spec_from_file_location("jax_ef_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from mpi4jax_tpu_torch.models.broken import ef_divergent_gate as twin

    jc, pc = jax_comm(), port_comm()
    g = jnp.stack([jnp.full((64,), 1.0 + r) for r in range(N)])
    jrep = mpx.analyze(mod.build_step(jc), g, jnp.zeros_like(g), comm=jc,
                       ranks="all")
    prep = analysis.analyze(twin.build(pc, "meta"), *twin.example(pc, "meta"),
                            comm=pc, ranks="all")
    assert lineage_keys(prep) == lineage_keys(jrep)
    codes = {f.code for f in prep.findings}
    assert "MPX141" in codes
    assert ("MPX142" in codes) == (codec == "bf16")
    f = next(f for f in prep.findings if f.code == "MPX141")
    assert f.frontier[0].startswith("rank-varying region argument")


# ---------------------------------------------------------------------------
# the ef mark and the approximate seeds' arming
# ---------------------------------------------------------------------------


def test_the_ef_mark_arms_approx_and_plain_mixed_precision_does_not():
    pc = port_comm()

    def ef_step(g, r):
        total, new_res, _ = tpx.compress.ef_allreduce(g, r, comm=pc)
        return total, new_res

    def mixed(g):
        return tpx.allreduce(g.to(torch.bfloat16).to(torch.float32),
                             comm=pc)[0]

    ef = analysis.analyze(ef_step, torch.ones(8), torch.zeros(8), comm=pc)
    plain = analysis.analyze(mixed, torch.ones(8), comm=pc)
    assert [e.extra.get("ef") for e in ef.events] == [True]
    assert dataflow.graph_arms_approx(hook.CollectiveGraph(events=ef.events))
    assert not dataflow.graph_arms_approx(
        hook.CollectiveGraph(events=plain.events))


# ---------------------------------------------------------------------------
# the ambient mode
# ---------------------------------------------------------------------------


def test_the_ambient_error_mode_raises_mpx141_before_running():
    pc = port_comm()
    tpx.set_analyze_mode("error")
    try:
        with pytest.raises(analysis.AnalysisError) as ei:
            tpx.run(_port_gate(pc), torch.empty(16, device="meta"), comm=pc)
    finally:
        tpx.set_analyze_mode(None)
    assert "MPX141" in {f.code for f in ei.value.findings}


# ---------------------------------------------------------------------------
# cond and switch outside an abstract run, and in a per-rank run
# ---------------------------------------------------------------------------


def test_cond_and_switch_run_one_arm_on_concrete_predicates():
    seen = []

    def arm(i):
        return lambda v: (seen.append(i), v + i)[1]

    x = torch.zeros(2)
    assert cond(torch.tensor(True), arm(1), arm(0), x).tolist() == [1, 1]
    assert cond(False, arm(1), arm(0), x).tolist() == [0, 0]
    assert switch(torch.tensor(7), [arm(0), arm(1), arm(2)], x)[0] == 2
    assert switch(-3, [arm(0), arm(1)], x)[0] == 0
    assert seen == [1, 0, 2, 0]
    with pytest.raises(TypeError, match="scalar"):
        cond(torch.ones(2), arm(1), arm(0), x)
    with pytest.raises(ValueError, match="at least one branch"):
        switch(0, [], x)


def test_an_abstract_branch_checks_its_arms_and_records_one_stream():
    pc = port_comm()

    def bad(x):
        return cond(x.sum() > 0, lambda v: v, lambda v: v[:1], x)

    with pytest.raises(TypeError, match="different structures, shapes or dtypes"):
        analysis.analyze(bad, torch.ones(4), comm=pc)

    def two_arms(x):
        return cond(x.sum() > 0, lambda v: tpx.allreduce(v, comm=pc)[0],
                    lambda v: tpx.allgather(v, comm=pc)[0][0], x)

    rep = analysis.analyze(two_arms, torch.ones(4), comm=pc, ranks="all")
    # the first arm (true_fn) into the stream, the other kept apart
    assert [e.op for e in rep.events] == ["allreduce"]


def test_a_rank_concrete_predicate_takes_its_own_arm():
    """Per-rank runs concretize the rank: each rank records only the arm
    it takes, and the matcher sees the rank-divergent schedule."""
    pc = port_comm(2)

    def step(x):
        return cond(pc.Get_rank() == 0,
                    lambda v: tpx.allreduce(v, comm=pc)[0], lambda v: v, x)

    rep = analysis.analyze(step, torch.ones(4), comm=pc, ranks="all")
    assert {f.code for f in rep.errors} & {"MPX120", "MPX121", "MPX122",
                                           "MPX123"}
    assert "MPX108" not in {f.code for f in rep.findings}


# ---------------------------------------------------------------------------
# the capture
# ---------------------------------------------------------------------------


def _capture(fn, *args):
    cap = lineage.Capture(("i",))
    margs = tuple(torch.empty(a.shape, dtype=a.dtype, device="meta")
                  for a in args)
    cap.seed_args(margs)
    with lineage.capturing(cap):
        fn(*margs)
    return cap.record


def test_the_capture_records_aten_ops_bytes_and_in_place_merges():
    def fn(x, y):
        z = x * 2            # 4 floats written
        v = z.view(2, 2)     # a view: no bytes
        v.add_(y.view(2, 2))  # in place: z's storage, merged into v
        return v.sum(), z.sum()  # one float each; z reads v's write

    rec = _capture(fn, torch.ones(4), torch.ones(4))
    names = [e.primitive.name for e in rec.eqns]
    assert names[0] == "aten.mul" and "aten.add_" in names
    assert "aten.sum" in names
    by_name = {e.primitive.name: e for e in rec.eqns}
    assert by_name["aten.mul"].params["bytes"] == 16
    assert by_name["aten.view"].params["bytes"] == 0
    assert by_name["aten.sum"].params["bytes"] == 4
    add = by_name["aten.add_"]
    assert len(add.invars) == 2 and len(add.outvars) == 1
    assert sum(e.params["bytes"] for e in rec.eqns) == 16 + 16 + 4 + 4
    # the base's read merges the write made through its view
    (alias,) = [e for e in rec.eqns if e.primitive.name == "aliased write"]
    assert alias.params["bytes"] == 0
    assert alias.invars[1] is add.outvars[0]
    z_sum = [e for e in rec.eqns if e.primitive.name == "aten.sum"][1]
    assert z_sum.invars == alias.outvars
    assert [v.aval.origin for v in rec.invars] == ["region argument 0",
                                                   "region argument 1"]


def test_a_meta_route_derives_its_outputs():
    from mpi4jax_tpu_torch.models import shallow_water as P

    cfg = P.Config(nx=64, ny=32)
    shape = (cfg.ny_local, cfg.nx_local)
    fields = tuple(torch.ones(shape) for _ in range(6))
    from mpi4jax_tpu_torch.kernels import sw_steps

    rec = _capture(lambda *f: sw_steps.sw_steps(f, cfg, False, 2), *fields)
    (eqn,) = [e for e in rec.eqns if e.primitive.name == "sw_steps"]
    assert len(eqn.invars) == 6 and len(eqn.outvars) == 6
    assert eqn.params["bytes"] == 6 * 4 * shape[0] * shape[1]


def test_the_capture_is_off_outside_an_abstract_run():
    assert lineage.current() is None
    lineage.derive(torch.ones(2), torch.ones(2), "nothing")
    assert lineage.current() is None


# ---------------------------------------------------------------------------
# the main-path programs carry no lineage finding
# ---------------------------------------------------------------------------


def _main_path_programs():
    from mpi4jax_tpu_torch import attention as TA
    from mpi4jax_tpu_torch.models import shallow_water as P
    from mpi4jax_tpu_torch.parallel import moe

    cfg = P.Config(nx=64, ny=32, nproc_y=2, nproc_x=2)
    grid = Comm(("py", "px"), mesh=ProcessGrid((2, 2), ("py", "px"),
                                               torch.device("cpu"), rank=0))
    state = P.State(*[torch.zeros(cfg.ny_local, cfg.nx_local)] * 6)
    progs = {}
    for mode in ("wide2", "pallas_halo"):
        first, multi = P.make_stepper(cfg, grid, fast=mode)
        progs[mode] = (lambda s, first=first, multi=multi: multi(first(s), 2),
                       (state,), grid)
    ring = port_comm()
    q = torch.zeros(1, 16, 2, 64)
    progs["ring"] = (lambda a, b, c: TA.ring_attention(a, b, c, comm=ring),
                     (q, q, q), ring)
    w = moe.init_moe_params(8, 12, N, rank=0, seed=3)
    progs["moe"] = (lambda x, a, b, d: moe.moe_layer(
        x, moe.MoEParams(a, b, d), comm=ring)[0],
        (torch.zeros(16, 8), *(torch.from_numpy(np.asarray(p)) for p in w)),
        ring)
    return progs


@pytest.mark.parametrize("name", ["wide2", "pallas_halo", "ring", "moe"])
def test_main_path_programs_carry_no_lineage_finding(name):
    fn, args, comm = _main_path_programs()[name]
    rep = analysis.analyze(fn, *args, comm=comm, ranks="all")
    assert not rep.errors
    assert not set(LINEAGE) & {f.code for f in rep.findings}
