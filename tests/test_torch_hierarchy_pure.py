"""The pure half of the port's ``ops/_hierarchy.py`` and topology, and the
verifier's multi-host codes, against the JAX package.

No ranks: the plan geometry, the per-link-class byte models, the codec
pick and the plan of a virtual grid (``ProcessGrid(..., rank=0)``) are
held value for value against the JAX functions on the 8-device CPU mesh
under the same ``MPI4JAX_TPU_TOPOLOGY``; ``mesh_topology`` against the JAX
one on fake devices whose ``process_index`` is the host label the port
reads (``host_labels`` monkeypatched); and ``analyze`` of the same
programs in both packages gives the same MPX109, MPX113, MPX137 and
MPX138 findings (comm uids masked).  Exact equality throughout.
"""

import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu.ops import _codec as JCODEC  # noqa: E402
from mpi4jax_tpu.ops import _hierarchy as JH  # noqa: E402
from mpi4jax_tpu.parallel import topology as JT  # noqa: E402
from mpi4jax_tpu_torch import analysis  # noqa: E402
from mpi4jax_tpu_torch.ops import _hierarchy as PH  # noqa: E402
from mpi4jax_tpu_torch.parallel import comm as PCOMM  # noqa: E402
from mpi4jax_tpu_torch.parallel import topology as PT  # noqa: E402
from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

KNOBS = ("MPI4JAX_TPU_COLLECTIVE_ALGO", "MPI4JAX_TPU_RING_CROSSOVER_BYTES",
         "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
         "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", "MPI4JAX_TPU_TOPOLOGY",
         "MPI4JAX_TPU_COMPRESS", "MPI4JAX_TPU_TUNING",
         "MPI4JAX_TPU_COST_MODEL")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def fresh_jax_traces(monkeypatch):
    """Every ``jax.make_jaxpr`` traces afresh (tests/test_torch_analysis.py)."""
    make_jaxpr = jax.make_jaxpr

    def fresh(*args, **kwargs):
        jax.clear_caches()
        return make_jaxpr(*args, **kwargs)

    monkeypatch.setattr(jax, "make_jaxpr", fresh)


HOST_MAPS = [(0, 0, 1, 1), (0, 1, 0, 1), (0, 0, 0, 0), (0, 0, 0, 1),
             (0, 0, 0, 0, 1, 1, 1, 1), (0, 0, 1, 1, 2, 2, 3, 3),
             (0, 0, 0, 1, 1, 1, 1, 1), (0, 1, 2, 3, 0, 1, 2, 3)]


def _groupings(k):
    return [(tuple(range(k)),),
            (tuple(range(0, k, 2)), tuple(range(1, k, 2))),
            (tuple(range(k // 2)), tuple(range(k // 2, k))),
            (tuple(reversed(range(k))),)]


@pytest.mark.parametrize("hor", HOST_MAPS)
def test_plan_geometry(hor):
    k = len(hor)
    for groups in _groupings(k):
        for members in groups:
            assert PH.host_blocks(members, hor) == JH.host_blocks(members, hor)
        assert PH.hier_split(groups, hor) == JH.hier_split(groups, hor)


def test_byte_models():
    for kind, nbytes, h, r, pres in itertools.product(
            ("allreduce", "reduce_scatter", "bcast", "alltoall"),
            (0, 1, 60, 4096, 1 << 20, 1 << 23), (1, 2, 3, 4, 8), (1, 2, 4),
            (False, True)):
        assert PH.hier_link_bytes(kind, nbytes, h, r, pres) == \
            JH.hier_link_bytes(kind, nbytes, h, r, pres)
        assert PH.dcn_leg_bytes(kind, nbytes, r) == \
            JH.dcn_leg_bytes(kind, nbytes, r)
    for kind, algo, nbytes, k, h, pres in itertools.product(
            ("allreduce", "reduce_scatter", "bcast", "alltoall"),
            ("native", "butterfly", "ring", "pairwise"), (0, 60, 1 << 20),
            (1, 2, 4, 8), (None, 1, 2), (False, True)):
        assert PH.flat_link_bytes(kind, algo, nbytes, k, h, pres) == \
            JH.flat_link_bytes(kind, algo, nbytes, k, h, pres)
    for h, r in itertools.product(range(1, 6), range(1, 6)):
        assert PH.alltoall_dcn_messages(h, r) == JH.alltoall_dcn_messages(h, r)


class _Plan:
    def __init__(self, h, r):
        self.h, self.r = h, r


@pytest.mark.parametrize("mode", ["off", "bf16", "fp8", "auto"])
def test_selected_codec(monkeypatch, mode):
    monkeypatch.setenv("MPI4JAX_TPU_COMPRESS", mode)
    for kind, nbytes, plan, pres, op, dtype in itertools.product(
            ("allreduce", "reduce_scatter", "bcast", "alltoall"),
            (8, 1 << 20), (None, _Plan(2, 4)), (False, True),
            (None, "SUM", "MAX"), ("float32", "int32", "bfloat16")):
        pop = None if op is None else getattr(tpx, op)
        jop = None if op is None else getattr(mpx, op)
        assert PH.selected_codec(kind, nbytes, plan, pres, pop, dtype) == \
            JH.selected_codec(kind, nbytes, plan, pres, jop, dtype)


def port_comm(k, shape=None, axes=("x",)):
    grid = ProcessGrid(shape or (k,), axes, torch.device("cpu"), rank=0)
    return PCOMM.Comm(axes, mesh=grid)


def jax_comm(k, shape=None, axes=("x",)):
    mesh = mpx.make_world_mesh(shape or (k,), axes, devices=jax.devices()[:k])
    return mpx.Comm(axes, mesh=mesh)


SPECS = ["2x2", "2x4", "4x2", "8x1", "3,5", "1x8", "1,1,2"]


@pytest.mark.parametrize("spec", SPECS)
def test_plans_of_virtual_grids(monkeypatch, spec):
    """The plan of a whole comm, of a parity split and of a halves split,
    on the port's virtual grid and the JAX package's CPU mesh: the same
    ``(h, r)`` and the same intra and inter groups (``None`` alike), and
    the same host span."""
    monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", spec)
    counts = mpx.utils.config.parse_topology_spec(spec)
    k = sum(counts)
    pc, jc = port_comm(k), jax_comm(k)
    pcs = [pc, pc.Split([r % 2 for r in range(k)]),
           pc.Split([r < k // 2 for r in range(k)])]
    jcs = [jc, jc.Split([r % 2 for r in range(k)]),
           jc.Split([r < k // 2 for r in range(k)])]
    for p, j in zip(pcs, jcs):
        pp, jp = PH.hier_plan(p), JH.hier_plan(j)
        assert (pp is None) == (jp is None)
        assert PH.comm_hosts(p) == JH.comm_hosts(j)
        if pp is None:
            continue
        assert (pp.h, pp.r) == (jp.h, jp.r)
        assert pp.intra.groups == jp.intra.groups
        assert pp.inter.groups == jp.inter.groups


def test_plan_memo_and_derived_uids(monkeypatch):
    """A plan is memoized per comm, its two comms take no uid from the
    process's count, and an abstract run builds it without a process
    group."""
    monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", "2x4")
    pc = port_comm(8)
    before = PCOMM.next_uid()
    plan = PH.hier_plan(pc)
    assert PCOMM.next_uid() == before
    assert PH.hier_plan(pc) is plan
    assert plan.intra.uid == (pc.uid, "intra")
    assert plan.inter.uid == (pc.uid, "inter")
    PH._plan_memo.clear()
    again = PH.hier_plan(pc)
    assert again is not plan and PCOMM.next_uid() == before
    assert (again.h, again.r, again.intra.groups) == \
        (plan.h, plan.r, plan.intra.groups)


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


class _FakeMesh:
    def __init__(self, shape, axes, labels):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.devices = np.array([_Dev(p) for p in labels],
                                dtype=object).reshape(shape)


LABELS = [
    ((8,), ("x",), ["a"] * 4 + ["b"] * 4),
    ((8,), ("x",), ["a", "b"] * 4),
    ((8,), ("x",), ["a"] * 8),
    ((2, 4), ("y", "x"), ["a"] * 4 + ["b"] * 4),
    ((2, 4), ("y", "x"), ["a", "a", "b", "b"] * 2),
    ((4, 2), ("y", "x"), ["a", "a", "b", "b", "c", "c", "d", "d"]),
    ((2, 4), ("y", "x"), ["a", "a", "b", "b", "a", "b", "a", "b"]),
]


@pytest.mark.parametrize("shape,axes,labels", LABELS)
def test_hostname_topology(monkeypatch, shape, axes, labels):
    """``mesh_topology`` from host labels equals the JAX one from each
    device's ``process_index``, for the whole grid and each sub-axis; and
    ``derive_world_topology`` without a spec reads it, with the spec
    winning when one is set."""
    monkeypatch.setattr(PT, "host_labels", lambda: tuple(labels))
    grid = ProcessGrid(shape, axes, torch.device("cpu"), rank=0)
    jmesh = _FakeMesh(shape, axes, [ord(c) for c in labels])
    subsets = [axes] + [(a,) for a in axes] if len(axes) > 1 else [axes]
    for sub in subsets:
        p, j = PT.mesh_topology(grid, sub), JT.mesh_topology(jmesh, sub)
        assert (p is None) == (j is None), sub
        if p is not None:
            assert p.host_of_rank == j.host_of_rank
    whole = PCOMM.Comm(axes, mesh=grid)
    PT._topo_memo.clear()
    topo = PT.derive_world_topology(whole)
    want = JT.mesh_topology(jmesh, axes)
    assert (topo is None) == (want is None)
    if topo is not None:
        assert topo.host_of_rank == want.host_of_rank
    monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", "8x1")
    assert PT.derive_world_topology(whole).num_hosts == 8


_UIDS = re.compile(r"\b(comm|span) \d+")


def _findings(report):
    return sorted((f.code, f.rank, f.op, f.index, f.seq,
                   _UIDS.sub(lambda m: m.group(1) + " #", f.message))
                  for f in report.findings)


PROGRAMS = {
    # PROD near the ring crossover under auto: MPX109
    "mpx109": ({"MPI4JAX_TPU_RING_CROSSOVER_BYTES": "4096"}, "prod", 1024),
    # a forced flat ring on two hosts above the crossover: MPX113
    "mpx113": ({"MPI4JAX_TPU_TOPOLOGY": "2x4",
                "MPI4JAX_TPU_RING_CROSSOVER_BYTES": "1024",
                "MPI4JAX_TPU_COLLECTIVE_ALGO": "ring"}, "prod", 1024),
    # auto picks hier; nothing to advise
    "hier_clean": ({"MPI4JAX_TPU_TOPOLOGY": "2x4",
                    "MPI4JAX_TPU_RING_CROSSOVER_BYTES": "1024"}, "prod", 1024),
    # hier with an uncompressed float32 leg above the DCN crossover: MPX138
    "mpx138": ({"MPI4JAX_TPU_TOPOLOGY": "2x4",
                "MPI4JAX_TPU_RING_CROSSOVER_BYTES": "1024",
                "MPI4JAX_TPU_DCN_CROSSOVER_BYTES": "512"}, "prod", 1024),
    # the same with the codec on: silent
    "mpx138_bf16": ({"MPI4JAX_TPU_TOPOLOGY": "2x4",
                     "MPI4JAX_TPU_RING_CROSSOVER_BYTES": "1024",
                     "MPI4JAX_TPU_DCN_CROSSOVER_BYTES": "512",
                     "MPI4JAX_TPU_COMPRESS": "bf16"}, "prod", 1024),
    # a flat alltoall on two hosts above the alltoall crossover: MPX137
    "mpx137": ({"MPI4JAX_TPU_TOPOLOGY": "2x4",
                "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES": "1024",
                "MPI4JAX_TPU_COLLECTIVE_ALGO": "butterfly"}, "alltoall", 256),
    # auto takes the hier alltoall: MPX138 on its leg at DCN 512
    "alltoall_hier": ({"MPI4JAX_TPU_TOPOLOGY": "2x4",
                       "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES": "1024",
                       "MPI4JAX_TPU_DCN_CROSSOVER_BYTES": "512"},
                      "alltoall", 256),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_verifier_codes_equal_jax(monkeypatch, fresh_jax_traces, name):
    """The same program under the same knobs: the same findings and the
    same recorded ``algo``, ``hosts``, ``hier`` and ``codec`` on every
    event, in the port's abstract (``meta``) run and the JAX trace."""
    env, kind, n = PROGRAMS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    k = 8
    jc, pc = jax_comm(k), port_comm(k)
    if kind == "prod":
        jrep = mpx.analyze(lambda x: mpx.allreduce(x, mpx.PROD, comm=jc)[0],
                           jnp.zeros((k, n)), comm=jc)
        prep = analysis.analyze(
            lambda x: tpx.allreduce(x, tpx.PROD, comm=pc)[0],
            torch.zeros(n), comm=pc)
    else:
        jrep = mpx.analyze(lambda x: mpx.alltoall(x, comm=jc)[0],
                           jnp.zeros((k, k, n)), comm=jc)
        prep = analysis.analyze(lambda x: tpx.alltoall(x, comm=pc)[0],
                                torch.zeros(k, n), comm=pc)
    assert _findings(prep) == _findings(jrep)
    fields = lambda rep: [(e.op, e.algo, e.hosts, e.hier, e.codec)  # noqa: E731
                          for e in rep.events]
    assert fields(prep) == fields(jrep)
    expect = {"mpx109": {"MPX109"}, "mpx113": {"MPX113"},
              "mpx138": {"MPX138"}, "mpx137": {"MPX137"},
              "alltoall_hier": {"MPX138"}}.get(name, set())
    assert {f.code for f in prep.findings} == expect


def test_cost_model_prices_with_the_lowerings_byte_models():
    """The cost model's byte models are the lowerings' own objects."""
    from mpi4jax_tpu_torch.analysis import costmodel
    from mpi4jax_tpu_torch.ops import _algos

    assert costmodel.hier_link_bytes is PH.hier_link_bytes
    assert costmodel.flat_link_bytes is PH.flat_link_bytes
    assert costmodel.dcn_leg_bytes is PH.dcn_leg_bytes
    assert costmodel.resolve_dcn_algo is _algos.resolve_dcn_algo
    assert costmodel.algorithm_bytes_per_rank is _algos.algorithm_bytes_per_rank


def test_link_bytes_model_checks_jax_codec_wire_bytes():
    for nbytes, codec in itertools.product((0, 1, 255, 256, 1 << 20),
                                           ("bf16", "fp8", None)):
        from mpi4jax_tpu_torch.ops import _codec

        assert _codec.wire_bytes(nbytes, codec) == \
            JCODEC.wire_bytes(nbytes, codec)
