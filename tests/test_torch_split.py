"""Color-split and cloned communicators on 8 gloo ranks against the JAX
package (tests/test_split.py:37-420, 510).

The port's side runs ``tests/torch_ranks_ops.py:split_program`` as eight
gloo ranks on the CPU; the JAX side splits the 8-device CPU mesh with the
same colors.  Groups, ranks and data moves are held exactly; sums of the
rank-valued inputs are exact too.  ``test_split_bcast_and_reduce_nonuniform``
of the JAX suite is red in the suite's full runs (ROADMAP Queue 3), so
the bcast/reduce case is computed here directly.  The gradient through a
group allreduce (rank r's backward seeded by rank r's loss) is the JAX
package's: the sum of the group's cotangents.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_ops as R  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZE = 8


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "split")


def port_run(results):
    return results.get("port", lambda: launch.run(
        R.split_program, SIZE, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(SIZE,)))


def jax_results(results):
    def compute():
        comm = mpx.Comm("x", mesh=mpx.make_world_mesh((SIZE,), ("x",),
                                                      devices=jax.devices()[:SIZE]))
        split, uniform = comm.Split(R.COLORS_2), comm.Split(R.COLORS_EO)
        out = {"groups": {
            "COLORS_2": split.groups, "EO": uniform.groups,
            "keyed": comm.Split([0] * SIZE, key=list(range(SIZE))[::-1]).groups,
            "nested": split.Split([r % 2 for r in range(SIZE)]).groups,
            "int": comm.Split(R.INT_COLORS).groups,
            "int_nested": comm.Split(R.INT_COLORS).Split(
                [10 if r % 2 else 2 for r in range(SIZE)]).groups,
            "str": comm.Split(R.STR_COLORS).groups}}
        nested = split.Split([r % 2 for r in range(SIZE)])
        gs = SIZE // 2
        mats = np.random.default_rng(1).normal(size=(SIZE, 2, 2)).astype(np.float32)

        @partial(mpx.spmd, comm=comm)
        def f(x, rows, m):
            o = {}
            o["unequal/sum"] = mpx.allreduce(x, mpx.SUM, comm=split)[0]
            o["unequal/max"] = mpx.allreduce(x, mpx.MAX, comm=split)[0]
            o["unequal/scan"] = mpx.scan(x, mpx.SUM, comm=split)[0]
            y, t = mpx.sendrecv(x, x, dest=mpx.shift(1), comm=split)
            t = mpx.send(x, dest=mpx.shift(-1), tag=3, comm=split, token=t)
            z, _ = mpx.recv(x, source=mpx.shift(1), tag=3, comm=split, token=t)
            o["unequal/ring"] = (y, z)
            o["uniform/sendrecv"] = mpx.sendrecv(x, x, dest=mpx.shift(1),
                                                 comm=uniform)[0]
            s = mpx.Status()
            t = mpx.send(x, dest=mpx.shift(1), comm=uniform, tag=2)
            o["uniform/recv"] = mpx.recv(x, comm=uniform, tag=2, status=s, token=t)[0]
            o["uniform/source"] = s.Get_source()
            o["uniform/allgather"] = mpx.allgather(x, comm=uniform)[0]
            o["uniform/gather"] = mpx.gather(x, 1, comm=uniform)[0]
            o["uniform/scan"] = mpx.scan(x, mpx.SUM, comm=uniform)[0]
            o["uniform/alltoall"] = mpx.alltoall(rows, comm=uniform)[0]
            o["uniform/scatter"] = mpx.scatter(rows, 2, comm=uniform)[0]
            o["uniform/reduce_scatter"] = mpx.reduce_scatter(rows.reshape(gs, 1),
                                                             comm=uniform)[0]
            o["uniform/matmul"] = mpx.allreduce(m, jnp.matmul, comm=uniform)[0]
            o["nested/sum"] = mpx.allreduce(x, mpx.SUM, comm=nested)[0]
            return o

        x = jnp.arange(float(SIZE))[:, None]
        rows = jnp.stack([10.0 * r + jnp.arange(gs, dtype=jnp.float32)
                          for r in range(SIZE)])
        out.update(jax.tree.map(np.asarray, f(x, rows, jnp.asarray(mats))))

        def loss(xg, op):
            @partial(mpx.spmd, comm=comm)
            def parts(xl):
                return jnp.sum(mpx.allreduce(xl, op, comm=split)[0] ** 2)

            return jnp.sum(parts(xg))

        xg = jnp.arange(1.0, SIZE + 1)[:, None]
        out["unequal/grad"] = np.asarray(jax.grad(loss)(xg, mpx.SUM))
        out["unequal/prod_grad"] = np.asarray(jax.grad(loss)(xg, mpx.PROD))
        return out

    return results.get("jax", compute)


def stacked(results, key, i=None):
    return np.stack([r[key] if i is None else r[key][i] for r in port_run(results)])


def expected_groupwise(vals, groups, fn):
    out = np.empty_like(vals)
    for g in groups:
        out[list(g)] = fn([vals[r] for r in g])
    return out


GROUPS_2 = ((0, 3, 5), (1, 2, 4, 6, 7))
GROUPS_EO = ((0, 2, 4, 6), (1, 3, 5, 7))


def test_groups_follow_mpi_ordering(results):
    """Colors, keys (ties by rank), nesting within groups, integer colors
    in numeric order and string colors in lexical order, as the JAX
    package's ``Split``."""
    want = jax_results(results)["groups"]
    for res in port_run(results):
        assert res["groups"] == want
    assert want["COLORS_2"] == GROUPS_2
    assert want["int"] == ((0, 5), (2, 4, 7), (1, 3, 6))
    assert port_run(results)[0]["kinds"] == "GroupComm"


def test_rank_and_size(results):
    """Group ranks; a uniform split's size; Get_size refuses unequal groups."""
    for r, res in enumerate(port_run(results)):
        rank, uniform_size, err = res["rank_size"]
        assert rank == next(g.index(r) for g in GROUPS_2 if r in g)
        assert uniform_size == SIZE // 2
        assert err.startswith("RuntimeError") and "unequal group sizes" in err


@pytest.mark.parametrize("key", ["unequal/sum", "unequal/max", "unequal/scan",
                                 "uniform/sendrecv", "uniform/recv",
                                 "uniform/allgather", "uniform/gather",
                                 "uniform/scan", "uniform/alltoall", "uniform/scatter",
                                 "uniform/reduce_scatter", "nested/sum"])
def test_split_ops_match_jax(results, key):
    """Reductions, scan and p2p on the unequal split; every op on the
    uniform one; allreduce on the nested split."""
    np.testing.assert_array_equal(stacked(results, key), jax_results(results)[key])


def test_unequal_ring_and_send_recv(results):
    """A ring per group by sendrecv, and send/recv with an explicit
    source, on unequal groups (tests/test_split.py:243)."""
    want = jax_results(results)["unequal/ring"]
    for i in range(2):
        np.testing.assert_array_equal(stacked(results, "unequal/ring", i), want[i])


def test_status_source_is_the_group_rank(results):
    want = jax_results(results)["uniform/source"]
    assert [r["uniform/source"] for r in port_run(results)] == list(want)


def test_unequal_bcast_and_reduce(results):
    """bcast from group rank 1, reduce to group rank 0 on the unequal
    split (computed here: the JAX suite's case is red in its full runs)."""
    vals = np.arange(SIZE, dtype=np.float32)
    exp_b, exp_r = np.empty(SIZE, np.float32), vals.copy()
    for g in GROUPS_2:
        exp_b[list(g)] = g[1]
        exp_r[g[0]] = sum(g)
    np.testing.assert_array_equal(stacked(results, "unequal/bcast")[:, 0], exp_b)
    np.testing.assert_array_equal(stacked(results, "unequal/reduce")[:, 0], exp_r)


def test_noncommutative_callable_is_group_consistent(results):
    """Every member of a group gets the fold of its group in group order."""
    got = stacked(results, "uniform/matmul")
    np.testing.assert_allclose(got, jax_results(results)["uniform/matmul"],
                               rtol=1e-5, atol=1e-5)
    mats = np.random.default_rng(1).normal(size=(SIZE, 2, 2)).astype(np.float32)
    for g in GROUPS_EO:
        want = np.eye(2, dtype=np.float32)
        for r in g:
            want = want @ mats[r]
        for r in g:
            np.testing.assert_array_equal(got[r], got[g[0]])
            np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)


def test_grad_through_group_allreduce(results):
    """SUM: the group's cotangents summed, ``2 * |group| * group_sum``, as
    the JAX package's butterfly transposes (tests/test_split.py:163); PROD
    (the fold) as the JAX package's."""
    want = jax_results(results)
    got = stacked(results, "unequal/grad")
    np.testing.assert_allclose(got, want["unequal/grad"], rtol=1e-6)
    vals = np.arange(1.0, SIZE + 1, dtype=np.float32)
    exp = np.empty(SIZE, np.float32)
    for g in GROUPS_2:
        exp[list(g)] = 2 * len(g) * sum(vals[r] for r in g)
    np.testing.assert_allclose(got[:, 0], exp, rtol=1e-6)
    np.testing.assert_allclose(stacked(results, "unequal/prod_grad"),
                               want["unequal/prod_grad"], rtol=1e-5)


def test_split_errors(results):
    """Unequal groups refuse the gather family; a routing that names a rank
    some group lacks, tables of the wrong length, grid splits and sub() of
    a split raise."""
    for res in port_run(results):
        for err in res["unequal/gather_error"]:
            assert "unequal group sizes" in err
        assert "out of range" in res["unequal/dict_error"]
        grid, short, sub = res["nested/errors"]
        assert "grid splits" in grid and "GLOBAL rank" in short
        assert "sub() on a color-split" in sub
        colors, key, nested = res["validation"]
        assert "every rank's color" in colors
        assert "one entry per rank" in key
        assert "GLOBAL rank" in nested


def test_clone_and_bind(results):
    """Clone keeps the groups in a fresh namespace (a recv on the original
    never takes the clone's message); bind keeps groups and namespace."""
    x = np.arange(SIZE, dtype=np.float32)
    exp = np.empty(SIZE, np.float32)
    for g in GROUPS_EO:
        for i, r in enumerate(g):
            exp[g[(i + 1) % len(g)]] = r
    for res in port_run(results):
        assert res["clone"] == ("GroupComm", True, True, True, True)
        assert res["clone/isolated"].endswith("[MPX102]")
    np.testing.assert_array_equal(stacked(results, "clone/recv")[:, 0], exp)
    np.testing.assert_array_equal(stacked(results, "bound/sum")[:, 0],
                                  expected_groupwise(x, GROUPS_2, sum))


def test_grid_form_of_split(results):
    """``Split("sy")`` on a (2, 4) grid comm is the row comm over sx, a
    plain Comm."""
    for r, res in enumerate(port_run(results)):
        axes, kind, total = res["grid_split"]
        assert tuple(axes) == ("sx",) and kind == "Comm"
        row = r // (SIZE // 2)
        assert total[0] == sum(range(row * 4, row * 4 + 4))
