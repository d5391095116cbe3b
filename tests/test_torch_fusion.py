"""Tensor fusion against the JAX package.

``bucket_plan`` and ``pack_offsets`` are held against the JAX package's
on drawn inputs.  The port's fused collectives run in
``tests/torch_ranks_throughput.py:throughput_program`` on 2, 4 and 8 gloo
ranks on the CPU (one world per size, shared with ``test_torch_codec.py``
and ``test_torch_async.py``): every reduction over its leaves of f32,
int32 and bool, and ``bcast`` from the first and the last rank, in one
region under fusion ``off``, ``auto`` and ``force``; the JAX side runs
the same region on the 8-device CPU mesh under ``auto`` and ``force``.
When the queue flushes is held in-process, on a world of one rank.

The contract, stated in ``mpi4jax_tpu_torch/ops/_fusion.py``: fused and
unfused results bit for bit for integer and bool payloads, MIN and MAX,
the logical and bitwise reductions and ``bcast``; the f32 SUM and PROD
rtol 1e-5, the band the port's SUM is held to against the JAX package
(tests/test_allreduce.py:62).  The inputs of every SUM and PROD but one
leaf (``g``, gaussian) are small integers, where every order is exact.
"""

from functools import partial

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.ops import _fusion as JF  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_throughput as R  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.ops import _fusion as TF  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.parallel.region import current_context  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]
BAND = {"g"}  # the one gaussian f32 leaf, under SUM


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "throughput")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.throughput_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


def per_rank(results, size, key):
    ranks = port_run(results, size)
    return {k: np.stack([r[key][k] for r in ranks]) for k in ranks[0][key]}


def assert_contract(got, want, key, msg=""):
    """Bit for bit, except an f32 SUM or PROD of the gaussian leaf."""
    if key.split("/")[-1] in BAND and key.split("/")[1] in ("SUM", "PROD"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=msg + key)
    else:
        assert got.dtype == want.dtype, msg + key
        np.testing.assert_array_equal(got, want, err_msg=msg + key)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

entries = st.lists(st.tuples(st.sampled_from(["float32", "int32", "bool", "bfloat16"]),
                             st.integers(0, 5000)), max_size=24)


@settings(max_examples=200, deadline=None)
@given(entries=entries, cap=st.integers(1, 8192), force=st.booleans())
def test_bucket_plan_matches_jax(entries, cap, force):
    assert TF.bucket_plan(entries, cap, force) == JF.bucket_plan(entries, cap, force)


@settings(max_examples=100, deadline=None)
@given(sizes=st.lists(st.integers(0, 10**6), max_size=30))
def test_pack_offsets_match_jax(sizes):
    assert TF.pack_offsets(sizes) == JF.pack_offsets(sizes)


MIB = 1 << 20


@pytest.mark.parametrize("name,entries,force,want", [
    # the data-parallel step: b, w of each layer in sorted key order, then
    # the loss: one bucket
    ("dp_step", [("float32", 256), ("float32", 4096), ("float32", 4),
                 ("float32", 256), ("float32", 4)], False, [[0, 1, 2, 3, 4]]),
    # the long-context step at d_model 1024, d_ff 2048: the loss, w1, w2,
    # wo, wout, wqkv; under the 4 MiB cap no two share a bucket
    ("lct_full_width", [("float32", 4), ("float32", 8 * MIB), ("float32", 8 * MIB),
                        ("float32", 4 * MIB), ("float32", 4096),
                        ("float32", 12 * MIB)], False, [[0], [1], [2], [3], [4], [5]]),
    ("lct_full_width_force", [("float32", 4), ("float32", 8 * MIB),
                              ("float32", 8 * MIB), ("float32", 4 * MIB),
                              ("float32", 4096), ("float32", 12 * MIB)], True,
     [[0, 1, 2, 3, 4, 5]]),
])
def test_bucket_plan_of_the_slice_paths(name, entries, force, want):
    cap = tpx.utils.config.DEFAULT_FUSION_BUCKET_BYTES
    assert TF.bucket_plan(entries, cap, force) == want == JF.bucket_plan(entries, cap,
                                                                         force)


# ---------------------------------------------------------------------------
# fused against unfused and against the JAX package, over the ranks
# ---------------------------------------------------------------------------


def jax_fused(results, size):
    def compute():
        mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
        comm = mpx.Comm("x", mesh=mesh)
        x = {k: jnp.asarray(v) for k, v in R.fusion_inputs(size).items()}
        out = {}
        for mode in ("auto", "force"):
            @partial(mpx.spmd, comm=comm)
            def f(x):
                o = {}
                for op, kinds in R.FUSED.items():
                    for k in kinds:
                        o[f"allreduce/{op}/{k}"] = mpx.allreduce(x[k], getattr(mpx, op),
                                                                 comm=comm)[0]
                for root in (0, size - 1):
                    for k in R.BCAST_KINDS:
                        o[f"bcast/{root}/{k}"] = mpx.bcast(x[k], root, comm=comm)[0]
                return o

            mpx.set_fusion_mode(mode)
            try:
                out[mode] = {k: np.asarray(v) for k, v in f(x).items()}
            finally:
                mpx.set_fusion_mode(None)
        return out

    return results.get(f"jax-fused-{size}", compute)


@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("size", SIZES)
def test_fused_equals_unfused(results, size, mode):
    fused = per_rank(results, size, f"fusion/{mode}")
    plain = per_rank(results, size, "fusion/off")
    assert set(fused) == set(plain)
    for key in plain:
        assert_contract(fused[key], plain[key], key, f"{mode}: ")


@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("size", SIZES)
def test_fused_matches_jax_fused(results, size, mode):
    got = per_rank(results, size, f"fusion/{mode}")
    want = jax_fused(results, size)[mode]
    assert set(got) == set(want)
    for key in want:
        assert_contract(got[key], want[key], key, f"{mode}: ")


def expected_collectives(size, mode):
    """The packed collectives of ``fusion_body``: each reduction's leaves
    (and each root's bcast leaves) planned into buckets."""
    if mode == "off":
        return sum(len(k) for k in R.FUSED.values()) + 2 * len(R.BCAST_KINDS)
    x = R.fusion_inputs(size)

    def plan(kinds):
        entries = [(str(torch.from_numpy(x[k][0]).dtype).replace("torch.", ""),
                    x[k][0].nbytes) for k in kinds]
        return len(TF.bucket_plan(entries, 4 << 20, mode == "force"))

    return (sum(plan(kinds) for kinds in R.FUSED.values())
            + 2 * plan(R.BCAST_KINDS))


@pytest.mark.parametrize("mode", R.FUSION_MODES)
@pytest.mark.parametrize("size", SIZES)
def test_exchanges_and_callables(results, size, mode):
    """Each bucket is one exchange; callables never fuse (one exchange a
    call in every mode) and give the SUM."""
    for r in port_run(results, size):
        assert r[f"fusion/{mode}/calls"] == expected_collectives(size, mode)
        assert r[f"fusion/{mode}/callables/calls"] == 2
    for i, k in enumerate(("f", "f2")):
        got = np.stack([r[f"fusion/{mode}/callables"][i]
                        for r in port_run(results, size)])
        np.testing.assert_array_equal(got, per_rank(results, size, "fusion/off")[
            f"allreduce/SUM/{k}"])


@pytest.mark.parametrize("size", SIZES)
def test_gradient_through_a_fused_pair(results, size):
    """``sum(allreduce(a)**2) + sum(allreduce(b)**3)`` with ``a`` and
    ``b`` packed together: the gradient is the unfused one, bit for bit,
    and ``2 * sum_r a_r``, ``3 * (sum_r b_r)**2`` (the SUM backward is the
    per-rank identity)."""
    x = R.fusion_inputs(size)
    want = (2 * x["f"].sum(0), 3 * x["f2"].sum(0) ** 2)
    for r in port_run(results, size):
        for mode in R.FUSION_MODES:
            for g, w, p in zip(r[f"fusion/{mode}/grad"], want,
                               r["fusion/off/grad"]):
                np.testing.assert_array_equal(g, p)
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# when the queue flushes (a world of one rank)
# ---------------------------------------------------------------------------


@pytest.fixture
def solo():
    mesh = tpx.make_world_mesh(device="cpu")
    yield tpx.Comm(mesh.axes[0], mesh=mesh)
    tpx.set_fusion_mode(None)


def pending(lazy):
    return isinstance(lazy, TF.LazyResult) and lazy._value is None


def test_a_use_flushes_the_whole_queue(solo):
    tpx.set_fusion_mode("auto")
    a, b = torch.arange(4.0), torch.ones(2, 3)

    @tpx.spmd(comm=solo)
    def f():
        ra, rb = tpx.allreduce(a)[0], tpx.allreduce(b)[0]
        seen = [pending(ra), pending(rb), len(current_context().fusion_queue.entries)]
        # known without a flush
        seen.append((ra.shape, rb.dtype, rb.device, rb.ndim, rb.size(), rb.numel(),
                     pending(ra)))
        out = 2.0 * ra
        seen.append((pending(ra), pending(rb)))
        return seen, out, rb

    seen, out, rb = f()
    assert seen[:3] == [True, True, 2]
    assert seen[3] == (torch.Size([4]), torch.float32, torch.device("cpu"), 2,
                       torch.Size([2, 3]), 6, True)
    assert seen[4] == (False, False)
    assert torch.equal(out, 2 * a) and type(rb) is torch.Tensor and torch.equal(rb, b)


@pytest.mark.parametrize("use", [
    "sub", "rsub", "rmul", "truediv", "torch_fn", "cat", "method", "index",
    "numpy", "matmul", "neg", "compare", "bitwise"])
def test_every_kind_of_use_flushes(solo, use):
    tpx.set_fusion_mode("auto")
    a = torch.arange(1.0, 7.0).reshape(2, 3)
    p = torch.full((2, 3), 10.0)
    fns = {"sub": lambda r: p - r, "rsub": lambda r: r - p,
           "rmul": lambda r: 0.5 * r, "truediv": lambda r: r / 4,
           "torch_fn": lambda r: torch.exp(r), "cat": lambda r: torch.cat([r, p]),
           "method": lambda r: r.sum(1), "index": lambda r: r[1],
           "numpy": lambda r: torch.from_numpy(np.asarray(r)),
           "matmul": lambda r: r @ p.T, "neg": lambda r: -r,
           "compare": lambda r: r > 2, "bitwise": lambda r: (r > 2) | (r < 2)}
    fn = fns[use]

    @tpx.spmd(comm=solo)
    def f():
        r = tpx.allreduce(a)[0]
        got = fn(r)
        return pending(r), got

    was_pending, got = f()
    assert not was_pending and type(got) is torch.Tensor
    assert torch.equal(got, fn(a))


@pytest.mark.parametrize("op", ["bcast", "barrier", "flush", "sendrecv", "callable",
                                "other_reduction"])
def test_an_op_that_does_not_join_flushes(solo, op):
    """Another op, ``barrier``, ``flush()``, a callable reduction or
    another ``Op`` issue the queue first, so program order holds."""
    tpx.set_fusion_mode("auto")
    a = torch.arange(3.0)
    calls = {"bcast": lambda: tpx.bcast(a, 0),
             "barrier": lambda: tpx.barrier(),
             "flush": tpx.flush,
             "sendrecv": lambda: tpx.sendrecv(a, a, dest=tpx.shift(1)),
             "callable": lambda: tpx.allreduce(a, torch.add),
             "other_reduction": lambda: tpx.allreduce(a, tpx.MAX)}

    @tpx.spmd(comm=solo)
    def f():
        r = tpx.allreduce(a)[0]
        before = pending(r)
        calls[op]()
        return before, pending(r)

    assert f() == (True, False)


def test_region_end_flushes_and_materializes(solo):
    tpx.set_fusion_mode("force")
    a = torch.arange(3.0)

    @tpx.spmd(comm=solo)
    def f():
        return {"x": [tpx.allreduce(a)[0], tpx.bcast(a, 0)[0]]}

    out = f()
    assert all(type(t) is torch.Tensor for t in out["x"])
    assert torch.equal(out["x"][0], a) and torch.equal(out["x"][1], a)


def test_inactive_outside_a_region_off_and_for_callables(solo, monkeypatch):
    a = torch.arange(3.0)
    tpx.set_fusion_mode("auto")
    assert type(tpx.allreduce(a, comm=solo)[0]) is torch.Tensor
    region = tpx.spmd(comm=solo)
    assert type(region(lambda: tpx.allreduce(a, torch.add)[0])()) is torch.Tensor
    assert region(lambda: pending(tpx.allreduce(a)[0]))()
    tpx.set_fusion_mode("off")
    assert not region(lambda: pending(tpx.allreduce(a)[0]))()
    tpx.set_fusion_mode(None)
    monkeypatch.setenv("MPI4JAX_TPU_FUSION", "force")
    assert region(lambda: pending(tpx.allreduce(a)[0]))()
    with pytest.raises(ValueError, match="fusion mode must be one of"):
        tpx.set_fusion_mode("always")


@pytest.mark.parametrize("size", SIZES)
def test_bare_spmd_runs_over_the_world(results, size):
    """``spmd`` without a comm: the region's comm is the world's
    (``get_default_comm``), and ``comm=None`` inside it reduces over
    every rank."""
    want = np.full(3, sum(range(size)), np.float32)
    for r in port_run(results, size):
        red, n = r["default"]
        np.testing.assert_array_equal(red, want)
        assert n == size


def test_comm_none_takes_the_region_comm_and_raises_outside(solo):
    a = torch.arange(3.0)
    assert torch.equal(tpx.run(lambda: tpx.allreduce(a)[0], comm=solo), a)
    with pytest.raises(ValueError, match="pass comm="):
        tpx.allreduce(a)
    with pytest.raises(ValueError, match="pass comm="):
        tpx.barrier()
