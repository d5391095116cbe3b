"""The pure half of the port's ``ops/_algos.py`` against the JAX package's.

Every index formula, pair table, byte model and selection rule is plain
Python over ints in both packages; each is held against the JAX function
value for value over a grid of ints, the selection tables over (algo,
bytes, k, ring_ok, hier_ok) under several crossovers, and
``algo_cache_token`` under each knob it folds in.  The order-preserving
reduce-scatter update runs on symbolic string folds (the JAX suite's
lockstep idea, tests/test_algos.py): the result must be the exact
ascending fold.  Exact equality throughout.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpi4jax_tpu.ops import _algos as J  # noqa: E402
from mpi4jax_tpu.utils import config as JC  # noqa: E402
from mpi4jax_tpu_torch.ops import _algos as P  # noqa: E402
from mpi4jax_tpu_torch.utils import config as PC  # noqa: E402

pytest_plugins = ["leaked_env_guard"]

KS = (1, 2, 3, 4, 5, 7, 8, 16)
KNOBS = ("MPI4JAX_TPU_COLLECTIVE_ALGO", "MPI4JAX_TPU_RING_CROSSOVER_BYTES",
         "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
         "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", "MPI4JAX_TPU_TOPOLOGY",
         "MPI4JAX_TPU_COMPRESS", "MPI4JAX_TPU_TUNING")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def test_ring_min_group():
    assert P.RING_MIN_GROUP == J.RING_MIN_GROUP == 4


@pytest.mark.parametrize("name", ["rs_send_chunk", "rs_recv_chunk",
                                  "ag_recv_chunk", "a2a_send_block",
                                  "a2a_recv_slot"])
def test_index_formulas(name):
    pf, jf = getattr(P, name), getattr(J, name)
    for k in KS:
        for pos, r in itertools.product(range(k), range(2 * k)):
            assert pf(pos, r, k) == jf(pos, r, k), (name, pos, r, k)


def test_chunk_layout_and_powers():
    for n, k in itertools.product(range(0, 40), KS):
        assert P.chunk_layout(n, k) == J.chunk_layout(n, k)
    for k in range(1, 70):
        assert P.next_pow2(k) == J.next_pow2(k)
        assert P.vdg_widths(P.next_pow2(k)) == J.vdg_widths(J.next_pow2(k))


GROUPS = [((0, 1, 2, 3),), ((0, 2), (1, 3)), ((3, 1, 0, 2),),
          ((0,), (1, 2, 3)), ((0, 1, 2, 3, 4, 5, 6, 7),),
          ((4, 5, 6), (0, 1, 2))]


@pytest.mark.parametrize("groups", GROUPS)
def test_pair_tables(groups):
    assert P.ring_pairs(groups) == J.ring_pairs(groups)
    kmax = max(len(g) for g in groups)
    for t in range(kmax + 1):
        assert P.rotation_pairs(groups, t) == J.rotation_pairs(groups, t)
    kmin = min(len(g) for g in groups)
    K = P.next_pow2(kmax)
    for root in range(kmin):
        for w in P.vdg_widths(K):
            assert P.vdg_scatter_pairs(groups, root, w, K) == \
                J.vdg_scatter_pairs(groups, root, w, K)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 8])
def test_order_preserving_pair_is_the_ascending_fold(k):
    """The lo/hi pair update and finish, driven in lockstep over symbolic
    operands with a non-commutative fold (string concatenation): every
    position ends with the ascending fold of its chunk, in both packages,
    and the intermediate pairs agree."""
    def where(c, a, b):
        return a if c else b

    def fn(a, b):
        return a + b

    blocks = [[f"<{p}.{c}>" for c in range(k)] for p in range(k)]
    state = {}
    for pkg in (P, J):
        acc = {p: (blocks[p][(p - 1) % k],) * 2 for p in range(k)}
        trace = []
        for r in range(k - 1):
            new = {}
            for p in range(k):
                c = pkg.rs_recv_chunk(p, r, k)
                lo_in, hi_in = acc[(p - 1) % k]
                new[p] = pkg.rs_update_pair(where, fn, p, c, k, lo_in, hi_in,
                                            blocks[p][c])
            acc = new
            trace.append(dict(acc))
        final = {p: pkg.rs_finish_pair(where, fn, p, k, *acc[p])
                 for p in range(k)}
        state[pkg.__name__] = (trace, final)
        for p in range(k):
            assert final[p] == "".join(blocks[q][p] for q in range(k))
    assert state[P.__name__] == state[J.__name__]


def test_algorithm_bytes_per_rank():
    for algo, nbytes, k, pres in itertools.product(
            ("butterfly", "ring"), (0, 1, 60, 1000, 1 << 20), KS,
            (False, True)):
        assert P.algorithm_bytes_per_rank(algo, nbytes, k, pres) == \
            J.algorithm_bytes_per_rank(algo, nbytes, k, pres)


CROSSOVERS = (None, "0", "4096")
BYTES = (0, 100, 4095, 4096, 1 << 20, (1 << 20) + 1, 1 << 23)


@pytest.mark.parametrize("crossover", CROSSOVERS)
def test_resolve_algo_table(monkeypatch, crossover):
    if crossover is not None:
        monkeypatch.setenv("MPI4JAX_TPU_RING_CROSSOVER_BYTES", crossover)
    for algo, nbytes, k, ring_ok, hier_ok in itertools.product(
            JC.COLLECTIVE_ALGOS, BYTES, KS, (False, True), (False, True)):
        assert P.resolve_algo(algo, nbytes, k, ring_ok, hier_ok) == \
            J.resolve_algo(algo, nbytes, k, ring_ok, hier_ok), \
            (algo, nbytes, k, ring_ok, hier_ok)


@pytest.mark.parametrize("crossover", CROSSOVERS)
def test_resolve_dcn_and_alltoall_tables(monkeypatch, crossover):
    if crossover is not None:
        monkeypatch.setenv("MPI4JAX_TPU_DCN_CROSSOVER_BYTES", crossover)
        monkeypatch.setenv("MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", crossover)
    for nbytes, h, ring_ok in itertools.product(BYTES, KS, (False, True)):
        assert P.resolve_dcn_algo(nbytes, h, ring_ok) == \
            J.resolve_dcn_algo(nbytes, h, ring_ok)
    for algo, nbytes, hier_ok, flat in itertools.product(
            JC.COLLECTIVE_ALGOS, BYTES, (False, True), ("native", "pairwise")):
        assert P.resolve_alltoall_algo(algo, nbytes, hier_ok, flat) == \
            J.resolve_alltoall_algo(algo, nbytes, hier_ok, flat)


@pytest.mark.parametrize("name,value", [
    (None, None),
    ("MPI4JAX_TPU_COLLECTIVE_ALGO", "ring"),
    ("MPI4JAX_TPU_COLLECTIVE_ALGO", "hier"),
    ("MPI4JAX_TPU_RING_CROSSOVER_BYTES", "123"),
    ("MPI4JAX_TPU_DCN_CROSSOVER_BYTES", "456"),
    ("MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", "789"),
    ("MPI4JAX_TPU_TOPOLOGY", "2x4"),
    ("MPI4JAX_TPU_COMPRESS", "bf16"),
    ("MPI4JAX_TPU_COMPRESS", "fp8"),
])
def test_algo_cache_token_reacts_to_each_knob(monkeypatch, name, value):
    base = P.algo_cache_token()
    if name is not None:
        monkeypatch.setenv(name, value)
        assert P.algo_cache_token() != base
    assert P.algo_cache_token() == J.algo_cache_token()


def test_collective_algo_knob(monkeypatch):
    assert PC.COLLECTIVE_ALGOS == JC.COLLECTIVE_ALGOS
    assert "MPI4JAX_TPU_COLLECTIVE_ALGO" in PC.FLAG_NAMES
    assert PC.collective_algo() == JC.collective_algo() == "auto"
    for v in ("butterfly", " RING ", "hier", ""):
        monkeypatch.setenv("MPI4JAX_TPU_COLLECTIVE_ALGO", v)
        assert PC.collective_algo() == JC.collective_algo()
    monkeypatch.setenv("MPI4JAX_TPU_COLLECTIVE_ALGO", "tree")
    with pytest.raises(ValueError) as pe:
        PC.collective_algo()
    with pytest.raises(ValueError) as je:
        JC.collective_algo()
    assert str(pe.value) == str(je.value)


DTYPES = (("bool", torch.bool, jnp.bool_), ("int32", torch.int32, jnp.int32),
          ("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16))


@pytest.mark.parametrize("a,b", itertools.product(range(4), repeat=2))
def test_where_promotes_as_jnp_where(a, b):
    """The port's static ``where`` returns the dtype ``jnp.where`` gives."""
    _, ta, ja = DTYPES[a]
    _, tb, jb = DTYPES[b]
    for cond in (True, False):
        got = P._where(cond, torch.zeros(3, dtype=ta), torch.ones(3, dtype=tb))
        want = jnp.where(cond, jnp.zeros(3, ja), jnp.ones(3, jb))
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
