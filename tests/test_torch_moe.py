"""The port's expert-parallel MoE layer on four gloo ranks (four experts)
against the JAX package.

The ranks (``tests/torch_ranks_workloads.py:moe_program``) run the layer
on ``tests/test_moe.py``'s inputs; here it is held against the JAX
package's ``reference_moe`` and its ``moe_layer`` on a 4-device CPU mesh
(``rtol 1e-5, atol 1e-6``, the band of ``tests/test_moe.py:72``), the
overlapped layer (chunks 2, 3 and the capacity) against the synchronous
one bit for bit, the ``MPI4JAX_TPU_MOE_CAPACITY_CHUNKS`` default and a
setting, a call outside any region, the gradient of ``w_in`` with chunks
1 against 2 and against the JAX package's (the same band), and the
training twin (``models/moe_training.py``): its pin, its counters rows,
and its four losses against the JAX example's step on four devices
(``rtol 1e-5``, the port's f32 SUM band), decreasing.  The world runs
once per test run (``R0.shared_result``).  JAX is imported where the
JAX side is computed, so that the ``gpu`` test runs on the card, which
has no JAX (``--noconftest``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as R0  # noqa: E402
import torch_ranks_workloads as RW  # noqa: E402
from mpi4jax_tpu_torch.models import moe_training as MT  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch, moe  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZE = 4
RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R0.shared_result(
        tmp_path_factory, "workloads-moe",
        lambda: launch.run(RW.moe_program, SIZE, device="cpu",
                           timeout=R0.RANK_TIMEOUT_S, args=("cpu",)))


def _jax():
    """``(jax, jax.numpy, mpi4jax_tpu, mpi4jax_tpu.parallel.moe)``."""
    import jax
    import jax.numpy as jnp

    import mpi4jax_tpu as mpx
    from mpi4jax_tpu.parallel import moe as jmoe

    return jax, jnp, mpx, jmoe


def _comm():
    jax, _jnp, mpx, _ = _jax()
    mesh = mpx.make_world_mesh((SIZE,), ("i",), devices=jax.devices()[:SIZE])
    return mpx.Comm("i", mesh=mesh)


def _stacked(params):
    jnp = _jax()[1]
    return tuple(jnp.asarray(np.stack([getattr(p, f) for p in params]))
                 for f in ("w_gate", "w_in", "w_out"))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's layer and ``w_in`` gradients on a 4-device mesh."""
    jax, jnp, mpx, jmoe = _jax()
    comm = _comm()
    x, params = RW.moe_inputs(SIZE)
    wg, wi, wo = _stacked(params)

    @mpx.spmd(comm=comm)
    def fwd(xv, a, b, c):
        y, _ = jmoe.moe_layer(xv, jmoe.MoEParams(a, b, c), comm=comm, chunks=1)
        return mpx.varying(y)

    @mpx.spmd(comm=comm)
    def grad(xv, a, b, c):
        def loss(b_):
            y, _ = jmoe.moe_layer(xv, jmoe.MoEParams(a, b_, c), comm=comm,
                                  chunks=1)
            return jnp.sum(y * y)

        return mpx.varying(jax.grad(loss)(b))

    return {"x": x, "y": np.asarray(fwd(jnp.asarray(x), wg, wi, wo)),
            "grad_w_in": np.asarray(grad(jnp.asarray(x), wg, wi, wo))}


def _rows(world, key):
    return np.stack([r[key] for r in world])


def test_layer_matches_the_jax_reference_moe(world, jax_side):
    want = _jax()[3].reference_moe(jax_side["x"], RW.MOE_D_FF, SIZE, seed=RW.MOE_SEED)
    np.testing.assert_allclose(_rows(world, "y/1"), want, rtol=RTOL, atol=ATOL)


def test_layer_matches_the_jax_moe_layer(world, jax_side):
    np.testing.assert_allclose(_rows(world, "y/1"), jax_side["y"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("chunks", [2, 3, "capacity"])
def test_overlapped_combine_is_bit_identical_to_sync(world, chunks):
    cap = world[0]["capacity"]
    assert cap == _jax()[3].capacity_for(RW.MOE_TOKENS, SIZE) == 5
    key = f"y/{cap if chunks == 'capacity' else chunks}"
    for r in world:
        assert r[key].tobytes() == r["y/1"].tobytes()


def test_capacity_chunks_knob_default_and_setting(world):
    for r in world:
        assert r["knob/default"] == 2 and r["knob/set"] == 3
        assert r["y/default"].tobytes() == r["y/2"].tobytes()
        assert r["y/knob3"].tobytes() == r["y/3"].tobytes()


def test_layer_outside_a_region_opens_its_own(world):
    for r in world:
        assert r["y/no_region"].tobytes() == r["y/2"].tobytes()


def test_w_in_gradient_sync_against_overlap_and_jax(world, jax_side):
    g1, g2 = _rows(world, "grad_w_in/1"), _rows(world, "grad_w_in/2")
    np.testing.assert_allclose(g1, g2, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g1, jax_side["grad_w_in"], rtol=RTOL, atol=ATOL)


def _jax_example_losses(steps=MT.STEPS, lr=MT.LR):
    """The JAX example's train step (``examples/moe_training.py``) on four
    devices from ``build_inputs(4)``."""
    jax, jnp, mpx, jmoe = _jax()
    comm = _comm()
    x, tgt, params = MT.build_inputs(SIZE)
    wg, wi, wo = _stacked(params)
    n = SIZE

    @mpx.spmd(comm=comm)
    def train_step(xv, tv, a, b, c):
        def loss_fn(a_, b_, c_):
            y, _ = jmoe.moe_layer(xv, jmoe.MoEParams(a_, b_, c_), comm=comm,
                                  chunks=1)
            return jnp.mean((y - tv) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(a, b, c)
        g_gate, tok = mpx.allreduce(grads[0], op=mpx.SUM)
        loss_g, _ = mpx.allreduce(loss, token=tok)
        return (mpx.varying(loss_g * (1.0 / n)),
                mpx.varying(a - lr * g_gate * (1.0 / n)),
                mpx.varying(b - lr * grads[1]), mpx.varying(c - lr * grads[2]))

    losses = []
    xj, tj = jnp.asarray(x), jnp.asarray(tgt)
    for _ in range(steps):
        loss, wg, wi, wo = train_step(xj, tj, wg, wi, wo)
        losses.append(float(np.asarray(loss)[0]))
    return losses


def test_twin_losses_match_the_jax_example_and_decrease(world):
    want = _jax_example_losses()
    for r in world:
        got = r["twin"]["losses"]
        assert len(got) == MT.STEPS and got[-1] < got[0]
        assert all(b < a for a, b in zip(got, got[1:]))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert got == world[0]["twin"]["losses"]


def test_twin_pin_and_counters_rows(world):
    for r in world:
        twin = r["twin"]
        assert twin["capacity"] == _jax()[3].capacity_for(MT.TOKENS, SIZE)
        assert twin["y_sync"].tobytes() == twin["y_ovl"].tobytes()
        ops = {row["op"]: row for row in twin["rows"]}
        # one overlapped forward: the dispatch, two chunk starts and waits
        assert ops["alltoall"]["calls"] == 1
        assert ops["alltoall_start"]["calls"] == ops["alltoall_wait"]["calls"] == 2
        assert ops["alltoall"]["bytes"] == ops["alltoall_start"]["bytes"] > 0
        assert all(row["inter_bytes"] == 0 for row in twin["rows"])


@pytest.mark.gpu
def test_layer_on_cuda_ranks_matches_the_reference():
    """Four gloo ranks on one card: the layer (sync and two chunks) against
    the port's numpy reference; runs on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    ranks = launch.run(RW.moe_program, SIZE, device="cuda:0",
                       timeout=R0.RANK_TIMEOUT_S, args=("cuda:0",))
    x, _ = RW.moe_inputs(SIZE)
    want = moe.reference_moe(x, RW.MOE_D_FF, SIZE, seed=RW.MOE_SEED)
    np.testing.assert_allclose(_rows(ranks, "y/1"), want, rtol=RTOL, atol=ATOL)
    for r in ranks:
        assert r["y/2"].tobytes() == r["y/1"].tobytes()
