"""The async start/wait pairs and ``overlap()`` against the JAX package.

The port's side runs ``tests/torch_ranks_throughput.py:
throughput_program`` on 2, 4 and 8 gloo ranks on the CPU (one world per
size, shared with ``test_torch_codec.py`` and ``test_torch_fusion.py``),
with ``MPI4JAX_TPU_OVERLAP_CHUNKS=3``: every pair started, then waited in
the reverse order of the starts; the same calls synchronously; and inside
``overlap()``.  The JAX side runs the pairs in one ``mpx.spmd`` region on
the 8-device CPU mesh, and again inside ``mpx.overlap()``.

The contract, stated in ``mpi4jax_tpu_torch/ops/_async.py``: against the
synchronous op bit for bit, except an f32 allreduce SUM in pieces, rtol
1e-5 (tests/test_allreduce.py:62); against the JAX package the same, and
its f32 reduce_scatter SUM, which adds in ring order, in the same band.
A handle waited twice, or a start its region never waited, raises
MPX112.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.ops import _async as JA  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_throughput as R  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.ops import _async as TA  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]
KEYS = ([f"allreduce/{k}" for k, _, _ in R.ASYNC_ALLREDUCE]
        + [f"reduce_scatter/{k}" for k, _, _ in R.ASYNC_RS] + ["alltoall/rows"])
# f32 SUMs: the pieces' all_reduce adds in the backend's order; against
# the JAX package also the reduce_scatter (its ring adds in ring order)
BANDED = {"allreduce/g/SUM"}
BANDED_JAX = BANDED | {"reduce_scatter/blocks/SUM"}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "throughput")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.throughput_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


def per_rank(results, size, key, sub):
    return np.stack([r[key][sub] for r in port_run(results, size)])


def assert_contract(got, want, key, banded=BANDED):
    if key in banded:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
    else:
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def jax_async(results, size):
    def compute():
        mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
        comm = mpx.Comm("x", mesh=mesh)
        x = {k: jnp.asarray(v) for k, v in R.async_inputs(size).items()}

        @partial(mpx.spmd, comm=comm)
        def pairs(x):
            started = []
            for key, k, op in R.ASYNC_ALLREDUCE:
                started.append((f"allreduce/{key}", mpx.allreduce_wait,
                                mpx.allreduce_start(x[k], getattr(mpx, op))[0]))
            for key, k, op in R.ASYNC_RS:
                started.append((f"reduce_scatter/{key}", mpx.reduce_scatter_wait,
                                mpx.reduce_scatter_start(x[k], getattr(mpx, op))[0]))
            started.append(("alltoall/rows", mpx.alltoall_wait,
                            mpx.alltoall_start(x["rows"])[0]))
            hs = mpx.send_start(x["g"], mpx.shift(1))[0]
            hr = mpx.recv_start(jnp.zeros_like(x["g"]))[0]
            out = {"p2p/recv": mpx.p2p_wait(hr)[0], "p2p/send": mpx.p2p_wait(hs)[0]}
            for key, wait, h in started:
                out[key] = wait(h)[0]
            return out

        @partial(mpx.spmd, comm=comm)
        def overlapped(x):
            with mpx.overlap():
                out = {f"allreduce/{key}": mpx.allreduce(x[k], getattr(mpx, op))[0]
                       for key, k, op in R.ASYNC_ALLREDUCE}
                out.update({f"reduce_scatter/{key}": mpx.reduce_scatter(
                    x[k], getattr(mpx, op))[0] for key, k, op in R.ASYNC_RS})
                out["alltoall/rows"] = mpx.alltoall(x["rows"])[0]
                out = {k: jnp.asarray(v) for k, v in out.items()}
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MPI4JAX_TPU_OVERLAP_CHUNKS", str(R.OVERLAP_CHUNKS))
            return {"pairs": {k: np.asarray(v) for k, v in pairs(x).items()},
                    "overlap": {k: np.asarray(v) for k, v in overlapped(x).items()}}

    return results.get(f"jax-async-{size}", compute)


@pytest.mark.parametrize("n,chunks", [(0, 2), (1, 2), (5, 2), (1000, 3), (7, 7),
                                      (7, 10), (4096, 1), (10, 4)])
def test_overlap_chunk_split_matches_jax(n, chunks):
    assert TA.overlap_chunk_split(n, chunks) == JA.overlap_chunk_split(n, chunks)


@pytest.mark.parametrize("size", SIZES)
def test_pairs_match_the_synchronous_ops(results, size):
    """Started all, waited in the reverse order: each result is the
    synchronous op's."""
    for key in KEYS:
        assert_contract(per_rank(results, size, "async", key),
                        per_rank(results, size, "async/sync", key), key)


@pytest.mark.parametrize("size", SIZES)
def test_pairs_match_jax(results, size):
    want = jax_async(results, size)["pairs"]
    for key in KEYS + ["p2p/recv", "p2p/send"]:
        assert_contract(per_rank(results, size, "async", key), want[key], key,
                        BANDED_JAX)


@pytest.mark.parametrize("size", SIZES)
def test_p2p_pair_follows_the_ring(results, size):
    """``send_start(x, shift(1))`` and ``recv_start``: rank r receives rank
    r - 1's payload, and the send's handle gives its own back."""
    g = R.async_inputs(size)["g"]
    np.testing.assert_array_equal(per_rank(results, size, "async", "p2p/recv"),
                                  np.roll(g, 1, axis=0))
    np.testing.assert_array_equal(per_rank(results, size, "async", "p2p/send"), g)


@pytest.mark.parametrize("size", SIZES)
def test_overlap_matches_jax_overlap(results, size):
    want = jax_async(results, size)["overlap"]
    for key in KEYS:
        got = per_rank(results, size, "async/overlap", key)
        assert_contract(got, want[key], key, BANDED_JAX)
        assert_contract(got, per_rank(results, size, "async/sync", key), key)
    np.testing.assert_array_equal(per_rank(results, size, "async/overlap", "first_use"),
                                  per_rank(results, size, "async/overlap",
                                           "allreduce/g/SUM"))


@pytest.mark.parametrize("size", SIZES)
def test_chunks_double_waits_and_unwaited_starts(results, size):
    """An f32 allreduce of 1000 elements goes out in 3 pieces (3
    exchanges); a second wait on one handle, and a start never waited in
    its region, raise MPX112 on every rank; a callable reduction and a
    tensor autograd follows run whole at the start, the latter with the
    SUM's gradient ``2 * sum_r x_r``."""
    x = R.async_inputs(size)
    for r in port_run(results, size):
        assert r["async/chunk_calls"] == R.OVERLAP_CHUNKS
        assert r["async/double_wait"] == "MPX112"
        assert r["async/never_waited"] == "MPX112"
        np.testing.assert_array_equal(r["async/callable"], x["f"].max(0))
        np.testing.assert_array_equal(r["async/grad"], 2 * x["f"].sum(0))


def test_starts_need_a_region_and_their_own_handles():
    mesh = tpx.make_world_mesh(device="cpu")
    comm = tpx.Comm(mesh.axes[0], mesh=mesh)
    a = torch.arange(4.0)
    with pytest.raises(RuntimeError, match="inside a region"):
        tpx.allreduce_start(a, comm=comm)
    with pytest.raises(RuntimeError, match="requires a region"):
        with tpx.overlap():
            pass

    @tpx.spmd(comm=comm)
    def wrong_kind():
        h = tpx.allreduce_start(a)[0]
        try:
            tpx.alltoall_wait(h)
        finally:
            tpx.allreduce_wait(h)

    with pytest.raises(TypeError, match="alltoall_start"):
        wrong_kind()
    with pytest.raises(TypeError, match="P2PHandle"):
        tpx.run(lambda: tpx.p2p_wait(tpx.allreduce_wait(
            tpx.allreduce_start(a)[0])[0]), comm=comm)


def test_one_rank_pairs_are_copies():
    mesh = tpx.make_world_mesh(device="cpu")
    comm = tpx.Comm(mesh.axes[0], mesh=mesh)
    a = torch.arange(6.0).reshape(1, 6)

    @tpx.spmd(comm=comm)
    def f():
        ha = tpx.allreduce_start(a)[0]
        hb = tpx.alltoall_start(a)[0]
        hc = tpx.reduce_scatter_start(a)[0]
        hs = tpx.send_start(a, tpx.shift(1))[0]
        hr = tpx.recv_start(torch.zeros_like(a))[0]
        return (tpx.allreduce_wait(ha)[0], tpx.alltoall_wait(hb)[0],
                tpx.reduce_scatter_wait(hc)[0], tpx.p2p_wait(hr)[0],
                tpx.p2p_wait(hs)[0])

    got = f()
    for t, want in zip(got, (a, a, a[0], a, a)):
        assert torch.equal(t, want)
