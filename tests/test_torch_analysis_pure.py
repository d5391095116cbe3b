"""The port's verifier modules against the JAX package's, on hand-built input.

``mpi4jax_tpu_torch.analysis`` keeps its own copies of the JAX package's
pure modules (the catalog, the graph checkers, the schedule matcher and
the progress checker).  Here the same hand-built graphs and per-rank
schedules go through both packages' functions, and the findings must be
equal: ``Finding.to_json()`` lists compared whole, texts bit for bit.
Every registered code gets a graph that fires it and one that stays
silent; the cross-rank codes (MPX101, MPX102, MPX106, MPX110,
MPX120-MPX125) get schedules that fire them and a matched one.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from mpi4jax_tpu.analysis import checkers as jcheckers  # noqa: E402
from mpi4jax_tpu.analysis import crossrank as jcrossrank  # noqa: E402
from mpi4jax_tpu.analysis import graph as jgraph  # noqa: E402
from mpi4jax_tpu.analysis import matcher as jmatcher  # noqa: E402
from mpi4jax_tpu.analysis import progress as jprogress  # noqa: E402
from mpi4jax_tpu.analysis import report as jreport  # noqa: E402
from mpi4jax_tpu.analysis import schedule as jschedule  # noqa: E402

from mpi4jax_tpu_torch.analysis import checkers as pcheckers  # noqa: E402
from mpi4jax_tpu_torch.analysis import crossrank as pcrossrank  # noqa: E402
from mpi4jax_tpu_torch.analysis import graph as pgraph  # noqa: E402
from mpi4jax_tpu_torch.analysis import matcher as pmatcher  # noqa: E402
from mpi4jax_tpu_torch.analysis import progress as pprogress  # noqa: E402
from mpi4jax_tpu_torch.analysis import report as preport  # noqa: E402
from mpi4jax_tpu_torch.analysis import schedule as pschedule  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

JAX = (jgraph, jcheckers)
PORT = (pgraph, pcheckers)


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("code", sorted(jreport.CODES))
def test_catalog_entry_equals_jax(code):
    got, want = preport.CODES[code], jreport.CODES[code]
    assert (got.code, got.title, got.severity, got.doc) == \
        (want.code, want.title, want.severity, want.doc)


def test_catalog_holds_the_same_codes_and_families():
    assert set(preport.CODES) == set(jreport.CODES)
    assert preport.HAZARD_GRAPH_CODES == jreport.HAZARD_GRAPH_CODES
    assert preport.HAZARD_CODES == jreport.HAZARD_CODES


def test_registry_covers_the_jax_graph_codes():
    assert pcheckers.registered_codes() == jcheckers.registered_codes()
    assert len(pcheckers.CHECKERS) == len(jcheckers.CHECKERS)
    assert pcheckers.RING_MIN_GROUP == 4
    assert pcheckers.FUSABLE_OPS == jcheckers.FUSABLE_OPS
    assert pcheckers.ENUM_REDUCTIONS == jcheckers.ENUM_REDUCTIONS


def test_finding_render_and_json_equal_jax():
    kw = dict(code="MPX121", message="m", suggestion="s", op="recv", index=3,
              rank=1, seq=2)
    a, b = preport.Finding(**kw), jreport.Finding(**kw)
    assert a.render() == b.render() and a.to_json() == b.to_json()
    ra = preport.Report(findings=(a,), meta={"x": (1, object)})
    rb = jreport.Report(findings=(b,), meta={"x": (1, object)})
    assert ra.render() == rb.render()
    assert ra.to_json()["findings"] == rb.to_json()["findings"]
    with pytest.raises(preport.AnalysisError) as e:
        ra.raise_if_findings()
    assert e.value.findings == (a,)


def test_mpx_error_and_finding_from_exception_equal_jax():
    pe = preport.mpx_error(ValueError, "MPX105", "root 9 out of range")
    je = jreport.mpx_error(ValueError, "MPX105", "root 9 out of range")
    assert str(pe) == str(je) and pe.mpx_code == je.mpx_code == "MPX105"
    assert preport.finding_from_exception(pe).to_json() == \
        jreport.finding_from_exception(je).to_json()
    assert preport.finding_from_exception(ValueError("x")) is None


# ---------------------------------------------------------------------------
# hand-built graphs: one that fires and one that stays silent, per code
# ---------------------------------------------------------------------------


def ev(op, **kw):
    return dict(op=op, comm_uid=kw.pop("comm_uid", 1), **kw)


SEND = ev("send", tag=0, shape=(4,), dtype="float32")
RECV = ev("recv", tag=0, shape=(4,), dtype="float32")
AR = ev("allreduce", reduction="sum", comm_size=4, shape=(25,), dtype="float32",
        payload_bytes=100)
DON = ("pinned call 'scale'",)

# code -> (firing (events, meta), silent (events, meta))
GRAPHS = {
    "MPX101": (([SEND], {}), ([SEND, RECV], {})),
    "MPX102": (([RECV], {}), ([SEND, RECV], {})),
    "MPX106": (([SEND, dict(RECV, shape=(5,))], {}),
               ([SEND, dict(RECV, shape=(2, 2))], {})),
    "MPX110": (([SEND, SEND, RECV, RECV], {}), ([SEND, RECV, SEND, RECV], {})),
    "MPX103": (([ev("send", extra={"bare_int_routing": True})], {}),
               ([ev("send")], {})),
    "MPX104": (([ev("bcast", extra={"traced_structure": "root"})], {}),
               ([ev("bcast")], {})),
    "MPX105": (([ev("bcast", root=5, min_size=4)], {}),
               ([ev("bcast", root=1, min_size=4)], {})),
    "MPX107": (([ev("allreduce", token_in=10, token_out=11),
                 ev("allreduce", token_in=10, token_out=12)], {}),
               ([ev("allreduce", token_in=10, token_out=11),
                 ev("allreduce", token_in=11, token_out=12)], {})),
    "MPX109": (([dict(AR, algo="ring", payload_bytes=1200)],
                {"collective_algo": "auto", "ring_crossover_bytes": 1000}),
               ([dict(AR, algo="ring", payload_bytes=10)],
                {"collective_algo": "auto", "ring_crossover_bytes": 1000})),
    "MPX111": (([AR, AR], {"fusion": "off", "fusion_bucket_bytes": 4096}),
               ([AR, AR], {"fusion": "auto", "fusion_bucket_bytes": 4096})),
    "MPX112": (([ev("allreduce_start", span=1)], {}),
               ([ev("allreduce_start", span=1), ev("allreduce_wait", span=1)],
                {})),
    "MPX113": (([dict(AR, algo="ring", hosts=2, comm_size=8, payload_bytes=2000)],
                {"ring_crossover_bytes": 1000}),
               ([dict(AR, algo="ring", hosts=1, comm_size=8, payload_bytes=2000)],
                {"ring_crossover_bytes": 1000})),
    "MPX126": (([dict(AR, epoch=1)], {"epoch": 2}),
               ([dict(AR, epoch=2)], {"epoch": 2})),
    "MPX127": (([dict(AR, drained=True)], {}), ([AR], {})),
    "MPX128": (([AR] * 8, {"pinned": False}), ([AR] * 7, {"pinned": False})),
    "MPX130": (([ev("allreduce_start", span=1, loop=1),
                 ev("allreduce_wait", span=1)], {}),
               ([ev("allreduce_start", span=1, loop=1),
                 ev("allreduce_wait", span=1, loop=1)], {})),
    "MPX136": (([dict(AR, shape=(3, 8))], {"serving_buckets": (1, 2, 4)}),
               ([dict(AR, shape=(4, 8))], {"serving_buckets": (1, 2, 4)})),
    "MPX137": (([ev("alltoall", algo="native", hosts=2, comm_size=8,
                    payload_bytes=2000)], {"alltoall_crossover_bytes": 1000}),
               ([ev("alltoall", algo="native", comm_size=8,
                    payload_bytes=2000)], {"alltoall_crossover_bytes": 1000})),
    "MPX138": (([dict(AR, algo="hier", hosts=2, comm_size=8, payload_bytes=1000)],
                {"compress": "off", "dcn_crossover_bytes": 100}),
               ([dict(AR, algo="hier", hosts=2, comm_size=8, payload_bytes=1000)],
                {"compress": "bf16", "dcn_crossover_bytes": 100})),
    "MPX139": (([ev("allreduce_start", span=1, buffers=(77,)), AR,
                 ev("allreduce_wait", span=1)],
                {"donations": ((1, frozenset({77}), DON[0]),)}),
               ([ev("allreduce_start", span=1, buffers=(77,)),
                 ev("allreduce_wait", span=1), AR],
                {"donations": ((2, frozenset({77}), DON[0]),)})),
    "MPX140": (([AR, dict(AR, buffers=(77,))],
                {"donations": ((0, frozenset({77}), DON[0]),)}),
               ([AR, dict(AR, buffers=(77,))],
                {"donations": ((2, frozenset({77}), DON[0]),)})),
    "MPX143": (([dict(AR, loop=1)] * 3, {"flight_ring": 4}),
               ([dict(AR, loop=1)] * 2, {"flight_ring": 4})),
}


def graph(pkg, spec):
    mod, _ = pkg
    events, meta = spec
    return mod.CollectiveGraph(
        events=[mod.CollectiveEvent(index=i, **{k: (dict(v) if k == "extra" else v)
                                                for k, v in e.items()})
                for i, e in enumerate(events)],
        meta=dict(meta))


def findings_json(pkg, spec):
    return [f.to_json() for f in pkg[1].run_checkers(graph(pkg, spec))]


def test_every_registered_code_has_a_graph():
    assert set(GRAPHS) == pcheckers.registered_codes()


@pytest.mark.parametrize("which", ["fires", "silent"])
@pytest.mark.parametrize("code", sorted(GRAPHS))
def test_graph_checkers_equal_jax(code, which):
    spec = GRAPHS[code][0 if which == "fires" else 1]
    got, want = findings_json(PORT, spec), findings_json(JAX, spec)
    assert got == want
    codes = {f["code"] for f in got}
    assert (code in codes) == (which == "fires")


def test_per_rank_skip_is_the_jax_packages():
    assert pcrossrank._PER_RANK_SKIP == jcrossrank._PER_RANK_SKIP
    spec = ([SEND], {})
    got = [f.to_json() for f in pcheckers.run_checkers(
        graph(PORT, spec), skip=pcrossrank._PER_RANK_SKIP)]
    want = [f.to_json() for f in jcheckers.run_checkers(
        graph(JAX, spec), skip=jcrossrank._PER_RANK_SKIP)]
    assert got == want == []


# ---------------------------------------------------------------------------
# hand-built per-rank schedules: the matcher and the progress checker
# ---------------------------------------------------------------------------


def coll(op="allreduce", seq=0, ck=("u", 1), parts=(0, 1), **kw):
    return dict(kind="coll", op=op, seq=seq, comm_key=ck, comm_uid=ck[1],
                participants=parts, **kw)


def snd(dst, tag=0, ck=("u", 1), nelems=4):
    return dict(kind="send", op="send", dst=dst, tag=tag, comm_key=ck,
                comm_uid=ck[1], dtype="float32", nelems=nelems)


def rcv(src, tag=0, ck=("u", 1), nelems=4):
    return dict(kind="recv", op="recv", src=src, tag=tag, comm_key=ck,
                comm_uid=ck[1], dtype="float32", nelems=nelems)


# name -> ({rank: [op spec, ...]}, the code that must fire or None)
SCHEDULES = {
    "matched": ({0: [snd(1), rcv(1), coll()], 1: [snd(0), rcv(0), coll()]}, None),
    "MPX101": ({0: [snd(1)], 1: []}, "MPX101"),
    "MPX102": ({0: [rcv(1)], 1: []}, "MPX102"),
    "MPX106": ({0: [snd(1)], 1: [rcv(0, nelems=5)]}, "MPX106"),
    "MPX110": ({0: [snd(1), snd(1)], 1: [rcv(0), rcv(0)]}, "MPX110"),
    "MPX120-signature": ({0: [coll("allreduce", reduction="sum")],
                          1: [coll("bcast", root=0)]}, "MPX120"),
    "MPX120-order": ({0: [coll(seq=0, ck=("u", 1)), coll(seq=0, ck=("u", 2))],
                      1: [coll(seq=0, ck=("u", 2)), coll(seq=0, ck=("u", 1))]},
                     "MPX120"),
    "MPX121": ({0: [rcv(1), snd(1)], 1: [rcv(0), snd(0)]}, "MPX121"),
    "MPX122": ({0: [rcv(1), coll()], 1: [coll(), snd(0)]}, "MPX122"),
    "MPX123": ({0: [coll(seq=0), coll(seq=1)], 1: [coll(seq=0)]}, "MPX123"),
    "MPX124": ({0: [coll(fused=(2, 64, (("float32", 16),)))],
                1: [coll(fused=(3, 96, (("float32", 24),)))]}, "MPX124"),
    "MPX125": ({0: [coll(hier=(2, 2))], 1: [coll(hier=(4, 1))]}, "MPX125"),
}


def schedules(mod, spec):
    """``spec``'s ops as ``mod``'s SchedOps: a send's source and a recv's
    destination are the rank itself."""
    own = {"send": "src", "recv": "dst"}
    return {r: [mod.SchedOp(rank=r, pos=i, **o,
                            **({own[o["kind"]]: r} if o["kind"] in own else {}))
                for i, o in enumerate(ops)]
            for r, ops in spec.items()}


def cross_json(matcher, progress, mod, spec):
    matched = matcher.match_schedules(schedules(mod, spec))
    return [f.to_json() for f in list(matched.findings) + progress.check_progress(matched)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_match_and_progress_equal_jax(name):
    spec, code = SCHEDULES[name]
    got = cross_json(pmatcher, pprogress, pschedule, spec)
    want = cross_json(jmatcher, jprogress, jschedule, spec)
    assert got == want
    codes = {f["code"] for f in got}
    if code is None:
        assert not codes
    else:
        assert code in codes


def test_build_schedule_equals_jax_on_hand_built_streams():
    """The same per-rank event stream projects onto the same schedule."""
    stream = [
        dict(op="sendrecv", tag=0, pairs=((0, 1), (1, 0)), shape=(4,),
             dtype="float32"),
        dict(op="allreduce", reduction="sum", comm_size=2, shape=(4,),
             dtype="float32", groups=((0, 1),)),
        dict(op="recv", tag=3, pairs=None, shape=(4,), dtype="float32"),
        dict(op="allreduce_start", span=5, comm_size=2, shape=(4,),
             dtype="float32", groups=((0, 1),)),
        dict(op="allreduce_wait", span=5),
    ]
    for rank in (0, 1):
        outs = []
        for gmod, smod in ((pgraph, pschedule), (jgraph, jschedule)):
            events = [gmod.CollectiveEvent(index=i, comm_uid=7, **e)
                      for i, e in enumerate(stream)]
            outs.append([vars(o) for o in smod.build_schedule(
                events, rank=rank, world=2, uid_watermark=5)])
        assert outs[0] == outs[1]


@pytest.mark.parametrize("ranks,world", [("all", 4), (2, 4), ([3, 1, 1], 4)])
def test_resolve_rank_list_equals_jax(ranks, world):
    assert pcrossrank.resolve_rank_list(ranks, world) == \
        jcrossrank.resolve_rank_list(ranks, world)


@pytest.mark.parametrize("ranks", [0, 5, [4], [], True])
def test_resolve_rank_list_refuses_as_jax_does(ranks):
    with pytest.raises(ValueError) as pe:
        pcrossrank.resolve_rank_list(ranks, 4)
    with pytest.raises(ValueError) as je:
        jcrossrank.resolve_rank_list(ranks, 4)
    assert str(pe.value) == str(je.value)


def test_rank_concrete_and_scope_equal_jax():
    for mod in (pschedule, jschedule):
        r = mod.RankConcrete(3)
        assert r == 3 and mod.is_rank_concrete(r)
        assert not mod.is_rank_concrete(r % 2) and not mod.is_rank_concrete(int(r))
    with pschedule.scope(("py", "px"), (2, 2), 3):
        with jschedule.scope(("py", "px"), (2, 2), 3):
            assert pschedule.concrete_comm_rank(("px",)) == \
                jschedule.concrete_comm_rank(("px",)) == 1
            assert pschedule.groups_for_axes(("px",)) == \
                jschedule.groups_for_axes(("px",))
            assert pschedule.scope_coords(("py", "px")) == (1, 1)
    assert not pschedule.concretizing() and pschedule.ACTIVE[0] == 0


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "off", "warn", "ERROR", "loud"])
def test_analyze_mode_parses_as_jax(monkeypatch, raw):
    from mpi4jax_tpu.utils import config as jconfig
    from mpi4jax_tpu_torch.utils import config as pconfig

    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE", raw)
    outs = []
    for fn in (pconfig.analyze_mode, jconfig.analyze_mode):
        try:
            outs.append(fn())
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("raw", ["", "auto", "off", "4", "0", "many"])
def test_analyze_ranks_parses_as_jax(monkeypatch, raw):
    from mpi4jax_tpu.utils import config as jconfig
    from mpi4jax_tpu_torch.utils import config as pconfig

    monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_RANKS", raw)
    outs = []
    for fn in (pconfig.analyze_ranks, jconfig.analyze_ranks):
        try:
            outs.append(fn())
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]
