"""The dataflow passes of the port (``analysis/walker.py``,
``analysis/dataflow.py``) against the JAX package's, on hand-built records.

The JAX package drives its passes with duck-typed fake jaxprs
(``tests/test_hazards_pure.py``); the port's passes read the same duck
type (``lineage.Record``: ``eqns`` with ``primitive.name``, ``invars``,
``outvars``, ``params``), so one fake drives both.  A ``cond``'s arms use
the operand vars themselves (the port's arms are closures; the JAX pass
maps the same vars through its binders), and seeds ride on ``aval.vma``.
Every case compares the findings of both passes: code, op, rank,
message and trail, exactly.  The port-only pieces are held to their own
rules: the map from the port's ops to the JAX primitives they lower to
(``jax_primitives``, against real jaxprs in
``tests/test_torch_dataflow.py``), the arms seeing their closures, an
eqn standing for several collectives (``params["primitives"]``) and the
index operands of the aten gathers (``params["index_invars"]``).
"""

import pytest

pytest.importorskip("torch")

from mpi4jax_tpu.analysis import dataflow as jdf  # noqa: E402
from mpi4jax_tpu.analysis import hazards as jhz  # noqa: E402
from mpi4jax_tpu.analysis import walker as jwk  # noqa: E402
from mpi4jax_tpu.analysis.graph import CollectiveEvent as JE  # noqa: E402
from mpi4jax_tpu.analysis.graph import CollectiveGraph as JG  # noqa: E402

from mpi4jax_tpu_torch.analysis import dataflow as pdf  # noqa: E402
from mpi4jax_tpu_torch.analysis import hazards as phz  # noqa: E402
from mpi4jax_tpu_torch.analysis import walker as pwk  # noqa: E402
from mpi4jax_tpu_torch.analysis.graph import CollectiveEvent as PE  # noqa: E402
from mpi4jax_tpu_torch.analysis.graph import CollectiveGraph as PG  # noqa: E402


class _Prim:
    def __init__(self, name):
        self.name = name


class _Aval:
    def __init__(self, dtype=None, vma=None):
        self.dtype = dtype
        self.vma = vma


class _Var:
    def __init__(self, aval=None):
        self.aval = aval


class _Lit:
    def __init__(self, val=0):
        self.val = val


class _Eqn:
    def __init__(self, name, invars=(), outvars=(), params=None):
        self.primitive = _Prim(name)
        self.invars = list(invars)
        self.outvars = list(outvars)
        self.params = params or {}


class _Jaxpr:
    def __init__(self, eqns, invars=(), outvars=()):
        self.eqns = eqns
        self.invars = list(invars)
        self.outvars = list(outvars)


def _rank_var():
    return _Var(_Aval(dtype="float32", vma=("i",)))


def _branch(operand, *coll_names):
    """One arm on ``operand`` issuing the named collectives in a chain;
    its binder is the operand itself (a closure, for the port)."""
    eqns, cur = [], operand
    for name in coll_names:
        nxt = _Var()
        eqns.append(_Eqn(name, [cur], [nxt]))
        cur = nxt
    return _Jaxpr(eqns, invars=[operand], outvars=[cur])


def _gate(pred, operand, left=("psum", "ppermute"), right=("psum",)):
    return _Eqn("cond", [pred, operand], [_Var()],
                {"branches": (_branch(operand, *left),
                              _branch(operand, *right))})


def _keys(findings):
    return [(f.code, f.op, f.rank, f.message, tuple(f.frontier))
            for f in findings]


def both(eqns, **kw):
    """The findings of both passes over one fake program (equal, or the
    test fails); returns the port's."""
    j = jdf.hazard_jaxpr_findings(_Jaxpr(eqns), **kw)
    p = pdf.hazard_jaxpr_findings(_Jaxpr(eqns), **kw)
    assert _keys(p) == _keys(j)
    return p


def _pred_from(var):
    p = _Var()
    return _Eqn("gt", [var, _Lit()], [p]), p


# ---------------------------------------------------------------------------
# MPX141: rank-local lineage gating the collective schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [None, 2])
def test_mpx141_vma_seed_fires_as_in_jax(rank):
    r, x = _rank_var(), _Var()
    gt, p = _pred_from(r)
    (f,) = both([gt, _gate(p, x)], rank=rank)
    assert f.code == "MPX141" and f.rank == rank
    assert f.frontier[0].startswith("rank-varying")
    assert f.frontier[-1] == "cond predicate (schedule gate)"


def test_mpx141_silent_when_schedules_agree():
    r, x = _rank_var(), _Var()
    gt, p = _pred_from(r)
    assert both([gt, _gate(p, x, left=("psum",), right=("psum",))]) == []


def test_mpx141_silent_on_an_untainted_predicate():
    x = _Var()
    gt, p = _pred_from(_Var())
    assert both([gt, _gate(p, x)]) == []


@pytest.mark.parametrize("name,launders", [
    ("psum", True), ("psum_invariant", True), ("pmax", True),
    ("pmin", True), ("all_gather", True), ("psum_scatter", False),
    ("ppermute", False), ("all_to_all", False), ("reduce_scatter", False)])
def test_a_collective_launders_rank_lineage_as_in_jax(name, launders):
    r, s, x = _rank_var(), _Var(), _Var()
    gt, p = _pred_from(s)
    fs = both([_Eqn(name, [r], [s]), gt, _gate(p, x)])
    assert [f.code for f in fs] == ([] if launders else ["MPX141"])
    assert pdf.replicates(name) == jdf.replicates(name) == launders


@pytest.mark.parametrize("prims,launders", [
    (("psum_invariant",), True), (("pmax",), True),
    (("ppermute",) * 4, False), (("all_to_all",), False), ((), False)])
def test_an_op_eqn_launders_when_every_primitive_does(prims, launders):
    """A port op's eqn stands for the primitives its JAX op lowers to."""
    r, s, x = _rank_var(), _Var(), _Var()
    gt, p = _pred_from(s)
    eqns = [_Eqn("allreduce", [r], [s], {"primitives": prims}), gt,
            _gate(p, x)]
    fs = pdf.hazard_jaxpr_findings(_Jaxpr(eqns))
    assert [f.code for f in fs] == ([] if launders else ["MPX141"])
    if not launders:
        assert "allreduce" in fs[0].frontier


def test_collective_signature_counts_nested_and_op_primitives():
    inner = _Jaxpr([_Eqn("psum"), _Eqn("psum")])
    outer = _Jaxpr([_Eqn("pjit", params={"jaxpr": inner}),
                    _Eqn("ppermute")])
    assert pdf.collective_signature(outer) == \
        jdf.collective_signature(outer) == (("ppermute", 1), ("psum", 2))
    ops = _Jaxpr([_Eqn("allreduce", params={"primitives": ("ppermute",) * 4}),
                  _Eqn("aten.mul"), _Eqn("barrier", params={
                      "primitives": ("psum_invariant",)})])
    assert pdf.collective_signature(ops) == (("ppermute", 4),
                                             ("psum_invariant", 1))


def test_a_switch_of_three_arms_names_each():
    r, x = _rank_var(), _Var()
    gt, p = _pred_from(r)
    eqn = _Eqn("cond", [p, x], [_Var()], {"branches": (
        _branch(x, "psum"), _branch(x, "psum"), _branch(x, "all_gather"))})
    (f,) = both([gt, eqn])
    assert "branch 2: {all_gatherx1}" in f.message


def test_an_arm_sees_its_closures():
    """A port arm reads the values around it directly; the JAX pass reads
    the same values through the branch's binders."""
    r, x, y = _rank_var(), _Var(), _Var()
    inner_p = _Var()
    arm = _Jaxpr([_Eqn("gt", [r, _Lit()], [inner_p]),
                  _gate(inner_p, y)], outvars=[inner_p])
    outer = [_Eqn("cond", [_Var(), x], [_Var()],
                  {"branches": (arm, _Jaxpr([], outvars=[]))})]
    fs = pdf.hazard_jaxpr_findings(_Jaxpr(outer))
    assert [f.code for f in fs] == ["MPX141"]


def test_cond_outputs_carry_the_arms_taint():
    r, x = _rank_var(), _Var()
    out = _Var()
    arm = _Jaxpr([_Eqn("aten.add", [r], [out])], outvars=[out])
    cond_out = _Var()
    y = _Var()
    gt, p = _pred_from(cond_out)
    eqns = [_Eqn("cond", [_Var(), x], [cond_out],
                 {"branches": (arm, _Jaxpr([], outvars=[]))}),
            gt, _gate(p, y)]
    fs = pdf.hazard_jaxpr_findings(_Jaxpr(eqns))
    assert [f.code for f in fs] == ["MPX141"]
    assert "aten.add" in fs[0].frontier


# ---------------------------------------------------------------------------
# MPX142: approximate lineage at exactness-required sinks
# ---------------------------------------------------------------------------


def _downcast(old="float32", new="bfloat16"):
    x = _Var(_Aval(dtype=old))
    y = _Var()
    return _Eqn("convert_element_type", [x], [y], {"new_dtype": new}), y


@pytest.mark.parametrize("armed", [False, True])
def test_mpx142_predicate_sink_is_armed_as_in_jax(armed):
    down, y = _downcast()
    gt, p = _pred_from(y)
    fs = both([down, gt, _gate(p, _Var(), left=("psum",), right=("psum",))],
              approx_armed=armed)
    assert [f.code for f in fs] == (["MPX142"] if armed else [])
    if armed:
        assert "lossy codec downcast" in fs[0].frontier[0]


def test_mpx142_silent_on_a_gate_that_issues_no_collectives():
    down, y = _downcast()
    gt, p = _pred_from(y)
    assert both([down, gt, _gate(p, _Var(), left=(), right=())],
                approx_armed=True) == []


@pytest.mark.parametrize("old,new,seeds", [
    ("float32", "bfloat16", True), ("float32", "float16", True),
    ("float32", "float8_e4m3fn", True), ("bfloat16", "float32", False),
    ("float32", "int32", False), ("float32", "float32", False),
    ("float64", "float32", True)])
def test_downcast_seeds_by_width_as_in_jax(old, new, seeds):
    down, y = _downcast(old, new)
    gt, p = _pred_from(y)
    fs = both([down, gt, _gate(p, _Var(), left=("psum",), right=("psum",))],
              approx_armed=True)
    assert bool(fs) == seeds


@pytest.mark.parametrize("old,new", [
    ("torch.float32", "torch.bfloat16"), ("torch.float32", "torch.float16"),
    ("torch.float32", "torch.float8_e4m3fn")])
def test_torch_dtypes_seed(old, new):
    down, y = _downcast(old, new)
    down.primitive = _Prim("aten._to_copy")
    gt, p = _pred_from(y)
    fs = pdf.hazard_jaxpr_findings(
        _Jaxpr([down, gt, _gate(p, _Var(), left=("psum",), right=("psum",))]),
        approx_armed=True)
    assert [f.code for f in fs] == ["MPX142"]
    assert fs[0].frontier[0].startswith("aten._to_copy -> torch.")


def test_mpx142_survives_a_reduction():
    down, y = _downcast()
    s = _Var()
    gt, p = _pred_from(s)
    (f,) = both([down, _Eqn("psum", [y], [s]), gt,
                 _gate(p, _Var(), left=("psum",), right=("psum",))],
                approx_armed=True)
    assert f.code == "MPX142"


@pytest.mark.parametrize("name", ["aten.gather", "aten.index_select",
                                  "aten.index", "aten.scatter_add",
                                  "aten.narrow"])
def test_mpx142_at_an_index_operand(name):
    down, y = _downcast()
    arr, out = _Var(), _Var()
    eqn = _Eqn(name, [arr, y], [out], {"index_invars": (y,)})
    (f,) = pdf.hazard_jaxpr_findings(_Jaxpr([down, eqn]), approx_armed=True)
    assert f.code == "MPX142" and f.op == name
    assert f.frontier[-1] == f"{name} index operand"
    # the same value as data, not as an index: no finding
    data = _Eqn(name, [y, arr], [out], {"index_invars": (arr,)})
    assert pdf.hazard_jaxpr_findings(_Jaxpr([down, data]),
                                     approx_armed=True) == []


def test_graph_arms_approx_as_in_jax():
    cases = [
        (None, None),
        ({"events": []}, None),
        ({"events": []}, {"compress": "off"}),
        ({"events": []}, {"compress": "bf16"}),
        ({"events": [dict(index=0, op="allreduce", codec="fp8")]}, None),
        ({"events": [dict(index=0, op="allreduce", extra={"ef": True})]},
         None),
        ({"events": [dict(index=0, op="allreduce", extra={"ef": False})]},
         None),
    ]
    for spec, meta in cases:
        if spec is None:
            assert pdf.graph_arms_approx(None) == jdf.graph_arms_approx(None)
            continue
        pg = PG(events=[PE(**e) for e in spec["events"]], meta=meta or {})
        jg = JG(events=[JE(**e) for e in spec["events"]], meta=meta or {})
        assert pdf.graph_arms_approx(pg) == jdf.graph_arms_approx(jg)


# ---------------------------------------------------------------------------
# the trail and the walker
# ---------------------------------------------------------------------------


def test_trail_caps_with_the_jax_elision():
    r, x = _rank_var(), _Var()
    eqns, cur = [], r
    for _ in range(3 * pdf._TRAIL_CAP):
        nxt = _Var()
        eqns.append(_Eqn("sin", [cur], [nxt]))
        cur = nxt
    gt, p = _pred_from(cur)
    (f,) = both(eqns + [gt, _gate(p, x)])
    assert pdf._TRAIL_CAP == jdf._TRAIL_CAP and pdf._ELLIPSIS == jdf._ELLIPSIS
    assert len(f.frontier) <= pdf._TRAIL_CAP + 2
    assert pdf._ELLIPSIS in f.frontier
    assert f.frontier[0].startswith("rank-varying")


@pytest.mark.parametrize("left,right,fires", [
    (("psum",), (), True), ((), ("ppermute", "psum"), True),
    (("psum",), ("psum",), False), ((), (), False)])
def test_mpx108_as_in_jax(left, right, fires):
    x = _Var()
    prog = _Jaxpr([_gate(_Var(), x, left=left, right=right)])
    got = [(f.code, f.message) for f in pwk.check_cond_divergence(prog)]
    want = [(f.code, f.message) for f in jwk.check_cond_divergence(prog)]
    assert got == want and bool(got) == fires


def test_mpx108_counts_an_op_eqns_primitives():
    x = _Var()
    arm = _Jaxpr([_Eqn("allreduce", [x], [_Var()],
                       {"primitives": ("ppermute",) * 4})])
    prog = _Jaxpr([_Eqn("cond", [_Var(), x], [_Var()],
                        {"branches": (arm, _Jaxpr([]))})])
    (f,) = pwk.check_cond_divergence(prog)
    assert "contain 4 collective(s)" in f.message
    assert pwk.count_collectives(arm) == 4


def test_nested_conds_are_walked():
    x = _Var()
    inner = _Jaxpr([_gate(_Var(), x, left=("psum",), right=())])
    outer = _Jaxpr([_Eqn("cond", [_Var(), x], [_Var()],
                         {"branches": (inner, inner)})])
    assert len(pwk.find_cond_divergences(outer)) == \
        len(jwk.find_cond_divergences(outer)) == 2


# ---------------------------------------------------------------------------
# the map from the port's ops to the JAX primitives (pure half)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,reduction,k,split,want", [
    ("allreduce", "sum", 4, False, ("psum_invariant",)),
    ("allreduce", "max", 8, False, ("pmax",)),
    ("allreduce", "min", 2, False, ("pmin",)),
    ("allreduce", "prod", 4, False, ("ppermute",) * 4),
    ("allreduce", "sum", 4, True, ("ppermute",) * 4),
    ("allreduce", "sum", 1, True, ()),
    ("reduce", "max", 4, False, ("pmax",)),
    ("reduce_scatter", "sum", 4, False, ("reduce_scatter",)),
    ("reduce_scatter", "max", 8, False, ("ppermute",) * 6),
    ("bcast", None, 8, False, ("psum_invariant",)),
    ("bcast", None, 8, True, ("ppermute",) * 3),
    ("scan", "sum", 8, False, ("ppermute",) * 3),
    ("allgather", None, 4, False, ("all_gather",)),
    ("gather", None, 4, False, ("all_gather",)),
    ("alltoall", None, 4, False, ("all_to_all",)),
    ("scatter", None, 4, False, ("all_to_all",)),
    ("sendrecv", None, 4, False, ("ppermute",)),
    ("recv", None, 4, False, ("ppermute",)),
    ("send", None, 4, False, ()),
    ("barrier", None, 4, False, ("psum_invariant",)),
    ("allreduce_start", "sum", 4, False, ("psum_invariant",)),
    ("allreduce_wait", "sum", 4, False, ()),
])
def test_jax_primitives_table(op, reduction, k, split, want):
    assert pdf.jax_primitives(op, reduction, k, split) == want


@pytest.mark.parametrize("op,reduction,split,seeds", [
    ("allreduce", "sum", False, False), ("allreduce", "prod", False, True),
    ("allreduce", "max", True, True), ("bcast", None, False, False),
    ("allgather", None, False, False), ("alltoall", None, False, True),
    ("sendrecv", None, False, True), ("recv", None, False, True),
    ("scan", "sum", False, True), ("reduce_scatter", "sum", False, True),
    ("send", None, False, False), ("alltoall_wait", None, False, True),
    ("allreduce_wait", "sum", False, False), ("p2p_wait", None, False, True)])
def test_seeds_rank(op, reduction, split, seeds):
    assert pdf.seeds_rank(op, reduction, split) == seeds


def test_hazard_findings_arms_from_the_graph_as_in_jax():
    down, y = _downcast()
    gt, p = _pred_from(y)
    prog = _Jaxpr([down, gt, _gate(p, _Var(), left=("psum",), right=("psum",))])
    for events, meta in (([], {}), ([dict(index=0, op="allreduce",
                                          extra={"ef": True})], {}),
                         ([], {"compress": "fp8"})):
        pg = PG(events=[PE(**e) for e in events], meta=meta)
        jg = JG(events=[JE(**e) for e in events], meta=meta)
        got = phz.hazard_findings(prog, pg, rank=1)
        assert _keys(got) == _keys(jhz.hazard_findings(prog, jg, rank=1))
        assert bool(got) == bool(events or meta)
