"""The port's cost model (``analysis/costmodel.py``, ``analysis/cost.py``)
and host topology (``parallel/topology.py``) against the JAX package's.

Every formula is held equal to the JAX package's under one explicit
parameter dict (the two packages' analytic defaults differ by design: the
port's are the card's): ``collective_cost`` over every op x algorithm x
payload x group size x host span x two-level shape x order preservation x
codec, the copied byte models (``flat_link_bytes``, ``hier_link_bytes``,
``dcn_leg_bytes``) against ``mpi4jax_tpu/ops/_hierarchy.py``, ``p2p_cost``,
``chunked_async_cost``, ``best_algo``, the pipeline formulas and
``best_schedule``, exactly (an exception by its type and message).  The
file loaders agree on payloads and rejections.  The timed simulation and
the critic run the JAX package's scripted schedules
(``tests/test_cost_pure.py``), built with each package's ``SchedOp``:
the reports and findings are equal.  The compute estimate reads a record
of the port's (``params["bytes"]``) where the JAX package reads avals; the
fakes here carry both.
"""

import itertools
import json

import pytest

pytest.importorskip("torch")

from mpi4jax_tpu.analysis import cost as jcost  # noqa: E402
from mpi4jax_tpu.analysis import costmodel as jcm  # noqa: E402
from mpi4jax_tpu.analysis import matcher as jmatcher  # noqa: E402
from mpi4jax_tpu.analysis import schedule as jsched  # noqa: E402
from mpi4jax_tpu.ops import _hierarchy as jhier  # noqa: E402
from mpi4jax_tpu.parallel import topology as jtopo  # noqa: E402

from mpi4jax_tpu_torch.analysis import cost as pcost  # noqa: E402
from mpi4jax_tpu_torch.analysis import costmodel as pcm  # noqa: E402
from mpi4jax_tpu_torch.analysis import matcher as pmatcher  # noqa: E402
from mpi4jax_tpu_torch.analysis import schedule as psched  # noqa: E402
from mpi4jax_tpu_torch.parallel import topology as ptopo  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

PARAMS = {
    "links": {"ici": {"alpha_us": 2.5, "gb_per_s": 40.0},
              "dcn": {"alpha_us": 40.0, "gb_per_s": 6.0}},
    "gamma_gb_per_s": 250.0,
    "compute_gb_per_s": 120.0,
    "dispatch_us": 75.0,
}
JM, PM = jcm.CostModel(PARAMS), pcm.CostModel(PARAMS)

SIZES = (0, 1, 1000, 4096, 65536, 1 << 20, (3 << 20) + 5)
KS = (1, 2, 3, 4, 8, 16)
HOSTS = (None, 1, 2, 4)
HIERS = (None, (2, 4), (4, 2), (4, 4))
CODECS = (None, "off", "bf16", "fp8")
ALGOS = (None, "native", "butterfly", "ring", "hier", "pairwise")


def _same(f, g, *args, **kw):
    """``f`` and ``g`` on the same arguments: equal results, or equal
    exceptions (type and message)."""
    try:
        want = g(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the exception is the result
        with pytest.raises(type(e)) as ei:
            f(*args, **kw)
        assert str(ei.value) == str(e)
        return None
    got = f(*args, **kw)
    assert _tup(got) == _tup(want), (args, kw)
    return got


def _tup(c):
    if hasattr(c, "ici"):
        return (c.ici.rounds, c.ici.nbytes, c.dcn.rounds, c.dcn.nbytes,
                c.gamma_bytes)
    return c


# ---------------------------------------------------------------------------
# the formula matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", sorted(set(jcm.MODELED_OPS)))
def test_collective_cost_equals_jax_over_the_grid(op):
    assert pcm.MODELED_OPS == jcm.MODELED_OPS
    for algo, nbytes, k, hosts, hier, preserve, codec in itertools.product(
            ALGOS, SIZES, KS, HOSTS, HIERS, (False, True), CODECS):
        got = _same(pcm.collective_cost, jcm.collective_cost, op, algo,
                    nbytes, k, hosts=hosts, hier=hier, preserve=preserve,
                    codec=codec)
        if got is not None:
            assert PM.time_us(got) == JM.time_us(got)


@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter", "bcast",
                                  "alltoall"])
def test_byte_models_equal_the_jax_hierarchy(kind):
    for nbytes, h, r, preserve in itertools.product(
            SIZES, (1, 2, 3, 4, 8), (1, 2, 4, 8), (False, True)):
        _same(pcm.hier_link_bytes, jhier.hier_link_bytes, kind, nbytes, h,
              r, preserve)
        _same(pcm.dcn_leg_bytes, jhier.dcn_leg_bytes, kind, nbytes, r)
    for algo, nbytes, k, h, preserve in itertools.product(
            ("native", "butterfly", "ring"), SIZES, KS, (None, 1, 2, 4),
            (False, True)):
        _same(pcm.flat_link_bytes, jhier.flat_link_bytes, kind, algo, nbytes,
              k, h, preserve)


def test_the_dcn_crossover_reaches_the_byte_model(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_DCN_CROSSOVER_BYTES", "1024")
    for nbytes, h in itertools.product(SIZES, (2, 4, 8)):
        _same(pcm.hier_link_bytes, jhier.hier_link_bytes, "allreduce",
              nbytes, h, 4)
        _same(pcm.collective_cost, jcm.collective_cost, "allreduce", "hier",
              nbytes, 4 * h, hosts=h, hier=(h, 4))


def test_p2p_and_chunked_async_cost_equal_jax():
    for nbytes, same in itertools.product(SIZES, (True, False)):
        _same(pcm.p2p_cost, jcm.p2p_cost, nbytes, same_host=same)
    for op, chunks, k, hosts in itertools.product(
            ("allreduce", "reduce_scatter", "alltoall"), (0, 1, 2, 4, 8),
            (2, 4, 8), (None, 2)):
        base_p = pcm.collective_cost(op, "ring", 1 << 20, k, hosts=hosts)
        base_j = jcm.collective_cost(op, "ring", 1 << 20, k, hosts=hosts)
        assert _tup(pcm.chunked_async_cost(base_p, chunks)) == \
            _tup(jcm.chunked_async_cost(base_j, chunks))
    with pytest.raises(ValueError, match="point-to-point"):
        pcm.collective_cost("send", None, 64, 4)


def test_best_algo_equals_jax():
    for op, nbytes, k, hosts, hier, preserve in itertools.product(
            ("allreduce", "reduce_scatter", "bcast", "alltoall"), SIZES,
            (2, 4, 8, 16), (None, 2), (None, (2, 4)), (False, True)):
        got = pcm.best_algo(op, nbytes, k, PM, hosts=hosts, hier=hier,
                            preserve=preserve)
        want = jcm.best_algo(op, nbytes, k, JM, hosts=hosts, hier=hier,
                             preserve=preserve)
        assert got == want


@pytest.mark.parametrize("schedule", list(jcm.PIPELINE_SCHEDULES) + ["bogus"])
def test_pipeline_formulas_equal_jax(schedule):
    for s, m, nbytes, c, same, v in itertools.product(
            (1, 2, 4, 8), (1, 2, 16), (0, 64, 1 << 17), (0.0, 3.5, 900.0),
            (True, False), (1, 2, 3)):
        for fn in ("pipeline_wall_us", "pipeline_bubble_fraction"):
            _same(lambda *a, **k: getattr(pcm, fn)(*a, PM, **k),
                  lambda *a, **k: getattr(jcm, fn)(*a, JM, **k),
                  schedule, s, m, nbytes, c, same_host=same, virtual=v)
    with pytest.raises(ValueError, match="stages and microbatches"):
        pcm.pipeline_wall_us("gpipe", 0, 1, 64, 1.0, PM)


def test_best_schedule_equals_jax():
    for s, m, nbytes, c, v in itertools.product(
            (2, 4, 8), (1, 4, 16), (64, 1 << 17, 1 << 22), (0.1, 50.0, 5e3),
            (1, 2, 3)):
        got = pcm.best_schedule(s, m, nbytes, c, PM, virtual=v)
        want = jcm.best_schedule(s, m, nbytes, c, JM, virtual=v)
        assert got == want
        cands = ["ladder", "gpipe", "1f1b", "interleaved"]
        assert pcm.best_schedule(s, m, nbytes, c, PM, virtual=v,
                                 candidates=cands) == \
            jcm.best_schedule(s, m, nbytes, c, JM, virtual=v,
                              candidates=cands)


def test_cost_model_arithmetic_and_identity_equal_jax():
    for link, rounds, nbytes in itertools.product(("ici", "dcn"), (0, 3),
                                                  SIZES):
        assert PM.link_time_us(link, rounds, nbytes) == \
            JM.link_time_us(link, rounds, nbytes)
    for nbytes in SIZES:
        assert PM.compute_us(nbytes) == JM.compute_us(nbytes)
    assert PM.stamp() == JM.stamp()
    assert PM.dispatch_us == JM.dispatch_us
    src = pcm.CostModel(PARAMS, source="f.json", measured={"x": 1})
    assert src.to_json() == jcm.CostModel(PARAMS, source="f.json",
                                          measured={"x": 1}).to_json()
    assert pcm.LINK_CLASSES == jcm.LINK_CLASSES
    assert pcm.REDUCTION_OPS == jcm.REDUCTION_OPS
    assert pcm.PIPELINE_SCHEDULES == jcm.PIPELINE_SCHEDULES


def test_the_defaults_are_the_cards_own():
    """No TPU figure stands in the port's defaults: each is the card's
    (``DEFAULT_SOURCE`` names it), and none equals the JAX package's."""
    assert "H100" in pcm.DEFAULT_SOURCE and "700.00 W" in pcm.DEFAULT_SOURCE
    assert "gloo" in pcm.DEFAULT_SOURCE
    p, j = pcm.DEFAULT_PARAMS, jcm.DEFAULT_PARAMS
    for k in ("gamma_gb_per_s", "compute_gb_per_s", "dispatch_us"):
        assert p[k] > 0 and p[k] != j[k]
    for lc in pcm.LINK_CLASSES:
        for key in ("alpha_us", "gb_per_s"):
            assert p["links"][lc][key] > 0
            assert p["links"][lc][key] != j["links"][lc][key]
    ici, dcn = p["links"]["ici"], p["links"]["dcn"]
    assert dcn["alpha_us"] == pytest.approx(ici["alpha_us"]
                                            * pcm.DCN_ALPHA_RATIO, rel=1e-6)
    assert dcn["gb_per_s"] == pytest.approx(ici["gb_per_s"]
                                            * pcm.DCN_BANDWIDTH_RATIO,
                                            rel=1e-3)
    pcm.validate_model_dict(dict(p, schema=pcm.SCHEMA))


# ---------------------------------------------------------------------------
# the file loaders
# ---------------------------------------------------------------------------

GOOD = [
    {},
    {"schema": "mpx-cost-model/1", "links": {"ici": {"alpha_us": 1}}},
    {"schema": "mpx-tuning/1", "links": {"dcn": {"gb_per_s": 2.5}},
     "dispatch_us": 0, "measured": {"ring_crossover_bytes": 100}},
    {"cost_model": {"links": {"ici": {"gb_per_s": 3}}}},
    dict(PARAMS, schema="mpx-cost-model/1"),
]
BAD = [
    [], "x", {"schema": "nope"}, {"links": []}, {"links": {"nvlink": {}}},
    {"links": {"ici": []}}, {"links": {"ici": {"beta": 1}}},
    {"links": {"ici": {"alpha_us": "1"}}}, {"links": {"ici": {"alpha_us": True}}},
    {"links": {"ici": {"gb_per_s": 0}}}, {"links": {"ici": {"alpha_us": -1}}},
    {"gamma_gb_per_s": 0}, {"compute_gb_per_s": -2}, {"dispatch_us": -1},
    {"dispatch_us": "3"}, {"measured": []}, {"measured": {"x": -1}},
    {"measured": {"x": "y"}},
]


@pytest.mark.parametrize("payload", GOOD + BAD, ids=str)
def test_validate_model_dict_equals_jax(payload):
    _same(pcm.validate_model_dict, jcm.validate_model_dict, payload)


def test_files_load_as_in_jax(tmp_path, monkeypatch):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(dict(PARAMS, schema="mpx-cost-model/1",
                                    measured={"fusion_bucket_bytes": 1024})))
    p, j = pcm.load_model(str(path)), jcm.load_model(str(path))
    assert p.stamp() == j.stamp() and p.to_json() == j.to_json()
    assert pcm.load_model(p) is p
    assert pcm.load_model(dict(PARAMS)).stamp() == \
        jcm.load_model(dict(PARAMS)).stamp()
    monkeypatch.setenv("MPI4JAX_TPU_COST_MODEL", str(path))
    assert pcm.load_model().stamp() == jcm.load_model().stamp()
    assert pcm.measured_meta() == jcm.measured_meta()
    assert pcm.measured_meta()["measured_fusion_bucket_bytes"] == 1024
    for bad, match in (("[]", "JSON object"), ("{", "not valid JSON")):
        other = tmp_path / f"bad{len(bad)}.json"
        other.write_text(bad)
        _same(pcm.model_from_file, jcm.model_from_file, str(other))
        with pytest.raises(ValueError, match=match):
            pcm.load_model(str(other))
    with pytest.raises(ValueError, match="could not be read"):
        pcm.load_model(str(tmp_path / "missing.json"))


def test_no_file_is_the_defaults_and_no_measured_meta(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_COST_MODEL", raising=False)
    monkeypatch.delenv("MPI4JAX_TPU_TUNING", raising=False)
    m = pcm.load_model()
    assert m.source is None and m.params["dispatch_us"] == \
        pcm.DEFAULT_PARAMS["dispatch_us"]
    assert pcm.measured_meta() == {}


# ---------------------------------------------------------------------------
# the topology helpers
# ---------------------------------------------------------------------------


def test_topology_helpers_equal_jax():
    for raw in ((7, 7, 3), (0, 1, 0, 1), (), ("a", "b", "b")):
        assert ptopo.canonical_labels(raw) == jtopo.canonical_labels(raw)
    for counts in ((4, 4), (3, 5), (1,), (2, 2, 2)):
        p, j = ptopo.from_counts(counts), jtopo.from_counts(counts)
        assert p.host_of_rank == j.host_of_rank
        assert (p.num_hosts, p.ranks_per_host, p.fingerprint()) == \
            (j.num_hosts, j.ranks_per_host, j.fingerprint())
        assert repr(p) == repr(j)
        hor = p.host_of_rank
        for members in ((), (0,), tuple(range(len(hor)))):
            assert ptopo.span_hosts(hor, members) == \
                jtopo.span_hosts(hor, members)
        for a, b in itertools.product(range(len(hor)), repeat=2):
            assert ptopo.link_class(hor, a, b) == jtopo.link_class(hor, a, b)
    assert ptopo.link_class(None, 0, 7) == "ici"
    assert ptopo.Topology((5, 5, 2)) == ptopo.Topology((0, 0, 1))


def test_a_world_topology_comes_from_the_spec_alone(monkeypatch):
    import torch

    from mpi4jax_tpu_torch.parallel.comm import Comm
    from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid

    comm = Comm(("i",), mesh=ProcessGrid((8,), ("i",), torch.device("cpu"),
                                         rank=0))
    monkeypatch.delenv("MPI4JAX_TPU_TOPOLOGY", raising=False)
    # without the spec, the grid's host layout: one host, flat (the JAX
    # package's topology of a one-process mesh)
    assert ptopo.derive_world_topology(comm).num_hosts == 1
    monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", "2x4")
    assert ptopo.derive_world_topology(comm).host_of_rank == \
        (0, 0, 0, 0, 1, 1, 1, 1)
    monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", "3,3")  # 6 != 8 ranks
    assert ptopo.derive_world_topology(comm) is None
    monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", "3,5")
    assert ptopo.derive_world_topology(comm).host_of_rank == \
        (0, 0, 0, 1, 1, 1, 1, 1)
    unbound = Comm(("i",))  # no grid: no world to match the spec against
    assert ptopo.derive_world_topology(unbound) is None


# ---------------------------------------------------------------------------
# the timed simulation and the critic over scripted schedules
# ---------------------------------------------------------------------------


class _Aval:
    def __init__(self, shape, dtype="float32"):
        self.shape = shape
        self.dtype = dtype


class _OutVar:
    def __init__(self, shape):
        self.aval = _Aval(shape)


class _Eqn:
    """Writes ``nbytes`` float32 bytes: an outvar aval for the JAX
    estimate, ``params["bytes"]`` for the port's."""

    def __init__(self, nbytes):
        self.outvars = [_OutVar((nbytes // 4,))]
        self.params = {"bytes": nbytes}


class _Prog:
    def __init__(self, *nbytes):
        self.eqns = [_Eqn(n) for n in nbytes]


def _coll(S, rank, pos, op="allreduce", seq=0, parts=(0, 1, 2, 3),
          nbytes=1 << 20, algo="ring", **kw):
    return S(rank=rank, pos=pos, kind="coll", op=op, comm_key=0, seq=seq,
             participants=tuple(parts), payload_bytes=nbytes, algo=algo, **kw)


def _p2p(S, rank, pos, kind, src, dst, tag, nbytes=1 << 16):
    return S(rank=rank, pos=pos, kind=kind, op=kind, comm_key=0, src=src,
             dst=dst, tag=tag, payload_bytes=nbytes)


def _ladder(S, ranks=4, nbytes=1 << 16):
    out = {r: [] for r in range(ranks)}
    for s in range(1, ranks):
        out[s - 1].append(_p2p(S, s - 1, len(out[s - 1]), "send", s - 1, s, s,
                               nbytes))
        out[s].append(_p2p(S, s, len(out[s]), "recv", s - 1, s, s, nbytes))
    return out


def _sw(S, r, parts=(0, 1)):
    return [S(rank=r, pos=0, kind="start", op="allreduce_start", comm_key=0,
              seq=0, participants=parts, payload_bytes=1 << 20,
              algo="butterfly", span=7),
            S(rank=r, pos=1, kind="wait", op="allreduce_wait", comm_key=0,
              seq=0, participants=parts, payload_bytes=1 << 20,
              algo="butterfly", span=7)]


def _pipe(S, stamp, ranks=4):
    out = _ladder(S, ranks, stamp[4])
    for ops in out.values():
        for op in ops:
            if op.kind == "recv":
                op.meta["pipeline"] = stamp
    return out


SCENARIOS = {
    "sequence": (lambda S: {r: [_coll(S, r, 0, seq=0), _coll(S, r, 1, seq=1)]
                            for r in range(4)}, {}),
    "straggler": (lambda S: {r: [_coll(S, r, 0)] for r in range(4)},
                  {"closed": {3: _Prog(1 << 24)}}),
    "deadlock": (lambda S: {
        0: [_p2p(S, 0, 0, "recv", 1, 0, 0), _p2p(S, 0, 1, "send", 0, 1, 1)],
        1: [_p2p(S, 1, 0, "recv", 0, 1, 1), _p2p(S, 1, 1, "send", 1, 0, 0)]},
        {}),
    "start_wait": (lambda S: {0: _sw(S, 0), 1: _sw(S, 1)}, {}),
    "mpx131": (lambda S: {r: [_coll(S, r, 0)] for r in range(4)},
               {"closed": {r: _Prog(1 << 24, 1 << 10) for r in range(4)}}),
    "mpx132": (lambda S: {r: [_coll(S, r, 0, seq=0, nbytes=1 << 16,
                                    algo="butterfly", reduction="sum"),
                              _coll(S, r, 1, seq=1, nbytes=1 << 16,
                                    algo="butterfly", reduction="sum")]
                          for r in range(4)},
               {"meta": {"fusion": "off", "fusion_bucket_bytes": 4 << 20}}),
    "mpx132_eager": (lambda S: {r: [
        _coll(S, r, 0, seq=0, nbytes=1 << 16, algo="butterfly",
              reduction="sum", eager=True),
        _coll(S, r, 1, seq=1, nbytes=1 << 16, algo="butterfly",
              reduction="sum", eager=True)] for r in range(4)},
        {"meta": {"fusion": "off", "fusion_bucket_bytes": 4 << 20}}),
    "mpx133": (lambda S: {r: [_coll(S, r, 0, nbytes=1 << 24, algo="butterfly")]
                          for r in range(4)}, {}),
    "mpx134": (lambda S: {r: [_coll(S, r, 0, nbytes=(1 << 20) * (
        2 if r == 3 else 1))] for r in range(4)}, {}),
    "mpx135": (lambda S: _ladder(S), {}),
    "mpx135_dcn": (lambda S: _ladder(S), {"host_of_rank": (0, 0, 1, 1)}),
    "moe_fixture": (lambda S: {r: [
        _coll(S, r, 0, op="alltoall", seq=0, parts=tuple(range(8)),
              nbytes=1 << 20, algo="native", hosts=2),
        _coll(S, r, 1, op="alltoall", seq=1, parts=tuple(range(8)),
              nbytes=1 << 20, algo="native", hosts=2)] for r in range(8)},
        {"closed": {r: _Prog(1 << 25) for r in range(8)}}),
    "wildcard": (lambda S: {
        0: [_p2p(S, 0, 0, "send", 0, 2, 0)],
        1: [_p2p(S, 1, 0, "send", 1, 2, 0)],
        2: [_p2p(S, 2, 0, "recv", 0, 2, 0), _p2p(S, 2, 1, "recv", None, 2, 0)]},
        {"host_of_rank": (0, 1, 0)}),
    "mpx144_gpipe": (lambda S: _pipe(S, ("gpipe", 4, 16, 1, 1 << 17)), {}),
    "mpx144_interleaved": (lambda S: _pipe(S, ("interleaved", 4, 16, 2, 64)),
                           {}),
}


def _run(pkg, build, kw):
    S, matcher, cost = pkg
    matched = matcher.match_schedules(build(S))
    return cost.run_cost_pass(matched, model=PM if cost is pcost else JM,
                              **kw)


def _finding_key(f):
    return (f.code, f.op, f.index, f.rank, f.seq, f.message, f.suggestion)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_timed_simulation_and_critic_equal_jax(name):
    build, kw = SCENARIOS[name]
    prep, pfind = _run((psched.SchedOp, pmatcher, pcost), build, kw)
    jrep, jfind = _run((jsched.SchedOp, jmatcher, jcost), build, kw)
    assert [_finding_key(f) for f in pfind] == [_finding_key(f) for f in jfind]
    if jrep is None:
        assert prep is None and name == "deadlock"
        return
    assert prep.to_json() == jrep.to_json()
    assert prep.render() == jrep.render().replace("analytic defaults",
                                                  pcm.DEFAULTS_NAME)
    expect = {"mpx131": "MPX131", "mpx132": "MPX132", "mpx133": "MPX133",
              "mpx134": "MPX134", "mpx135": "MPX135", "moe_fixture": "MPX133",
              "mpx144_gpipe": "MPX144"}.get(name)
    if expect:
        assert expect in {f.code for f in pfind}
    if name in ("mpx132_eager", "mpx144_interleaved"):
        assert not {"MPX132", "MPX144"} & {f.code for f in pfind}


def test_traffic_of_a_record_counts_its_writes_and_the_widest_arm():
    class E:
        def __init__(self, params):
            self.params = params
            self.outvars = ()

    class R:
        def __init__(self, eqns):
            self.eqns = eqns

    arm_a, arm_b = R([E({"bytes": 10}), E({"bytes": 5})]), R([E({"bytes": 40})])
    rec = R([E({"bytes": 7}), E({"bytes": 0, "branches": (arm_a, arm_b)}),
             E({"primitives": ("psum",), "bytes": 8})])
    assert pcost.jaxpr_traffic_bytes(rec) == 7 + 40 + 8
    assert pcost.jaxpr_traffic_bytes(None) == 0


def test_cost_codes_are_the_jax_advisories():
    from mpi4jax_tpu_torch.analysis import report

    assert pcost.COST_CODES == jcost.COST_CODES
    for code in pcost.COST_CODES:
        assert report.CODES[code].severity == report.ADVISORY
    for name in ("OVERLAP_HIDE_FRACTION", "ASYNC_CAPABLE_OPS",
                 "MISPICK_MIN_FRACTION", "CHAIN_MIN_HOPS", "CHAIN_MIN_RANKS",
                 "CHAIN_MIN_FRACTION"):
        assert getattr(pcost, name) == getattr(jcost, name)
