"""The data-parallel training example against the JAX package's.

The port's side runs ``tests/torch_ranks_throughput.py:dp_program`` on
four gloo ranks on the CPU (once per test run): five steps of
``models/data_parallel_training.py``'s ``make_train_step`` from the JAX
example's ``init_mlp(PRNGKey(0), (16, 64, 1))`` carried over by
``convert.mlp_params_from_jax``, under the codecs off, bf16 and fp8 with
fusion ``auto`` (as the example's ``main`` runs) and off without fusion,
on data from a numpy seed; then the port's ``main`` for 30 steps.  The
JAX side runs ``examples/data_parallel_training.py``'s
``make_train_step`` (with its residual) on four devices of the 8-device
CPU mesh on the same parameters and data, under each codec and fusion
``auto``.

Bands: parameters rtol 5e-5, atol 1e-6 against the JAX package's and
against single-device SGD on the concatenated batch
(tests/test_data_parallel.py:82-84); losses rtol 1e-5; with the codec off
the residual exactly zero; fused and unfused steps in the f32 SUM band,
rtol 1e-5.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_throughput as R  # noqa: E402
from mpi4jax_tpu_torch import convert  # noqa: E402
from mpi4jax_tpu_torch.models import data_parallel_training as DP  # noqa: E402
from mpi4jax_tpu_torch.models import fusion_overlap_demo as FD  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.utils.tree import tree_leaves  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZE = 4


def _load_example():
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "data_parallel_training.py")
    spec = importlib.util.spec_from_file_location("_dp_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EX = _load_example()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "data-parallel")


def jax_params():
    """The JAX example's ``init_mlp`` at its widths, as numpy."""
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in EX.init_mlp(jax.random.PRNGKey(0), DP.SIZES)]


def port_run(results):
    return results.get("port", lambda: launch.run(
        R.dp_program, SIZE, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(SIZE, jax_params())))


def jax_run(results):
    def compute():
        mesh = mpx.make_world_mesh((SIZE,), ("x",), devices=jax.devices()[:SIZE])
        comm = mpx.Comm("x", mesh=mesh)
        x, y = (jnp.asarray(a) for a in DP.train_data(R.DP_SEED, SIZE))
        out = {}
        for codec in R.CODECS:
            params = EX.replicate(jax.tree.map(jnp.asarray, jax_params()), SIZE)
            residual = mpx.compress.ef_zeros_like(params)
            step = EX.make_train_step(comm, lr=DP.LR)
            losses = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("MPI4JAX_TPU_COMPRESS", codec)
                mpx.set_fusion_mode("auto")
                try:
                    for _ in range(R.DP_STEPS):
                        params, residual, loss = step(params, residual, x, y)
                        losses.append(np.asarray(loss))
                finally:
                    mpx.set_fusion_mode(None)
            out[codec] = {"params": jax.tree.map(np.asarray, params),
                          "residual": jax.tree.map(np.asarray, residual),
                          "losses": np.stack(losses, axis=1)}
        return out

    return results.get("jax", compute)


def stacked(ranks, run, part):
    """A tree of one run, each leaf stacked over the ranks."""
    trees = [r[run][part] for r in ranks]
    return [{k: np.stack([t[i][k] for t in trees]) for k in ("b", "w")}
            for i in range(len(trees[0]))]


def assert_params(got, want, msg):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("b", "w"):
            np.testing.assert_allclose(g[k], w[k], rtol=5e-5, atol=1e-6,
                                       err_msg=f"{msg}: layer {i} {k}")


@pytest.mark.parametrize("codec", R.CODECS)
def test_steps_match_the_jax_example(results, codec):
    """Five steps from the same weights and data: every rank's parameters
    and losses against the JAX example's, under each codec."""
    ranks = port_run(results)
    want = jax_run(results)[codec]
    assert_params(stacked(ranks, f"{codec}/auto", "params"), want["params"], codec)
    losses = np.stack([r[f"{codec}/auto"]["losses"] for r in ranks])
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)


def test_residual_is_exactly_zero_with_the_codec_off(results):
    for r in port_run(results):
        for run in ("off/auto", "off/off"):
            for leaf in tree_leaves(r[run]["residual"]):
                assert torch.equal(torch.from_numpy(leaf), torch.zeros(leaf.shape))
    for leaf in tree_leaves(jax_run(results)["off"]["residual"]):
        assert not leaf.any()


@pytest.mark.parametrize("codec", ["bf16", "fp8"])
def test_residual_carries_the_rounding_under_a_codec(results, codec):
    """Non-zero, and like the JAX example's in size: within one rounding
    of the codec (2**-8, 2**-3) of the largest gradient."""
    got = stacked(port_run(results), f"{codec}/auto", "residual")
    want = jax_run(results)[codec]["residual"]
    assert max(np.abs(leaf).max() for leaf in tree_leaves(got)) > 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert np.abs(w).max() > 0 or np.abs(g).max() == 0
        assert np.abs(g).max() <= 2 * np.abs(w).max() + 1e-7


def test_dp_matches_single_device_sgd(results):
    """Four ranks of 64 rows against one device on the 256 rows (the mean
    of equal shards' mean losses is the full batch's)."""
    x, y = DP.train_data(R.DP_SEED, SIZE)
    params = convert.mlp_params_from_jax(jax_params(), device="cpu")
    want = DP.sgd_steps(params, torch.from_numpy(x.reshape(-1, 16)),
                        torch.from_numpy(y.reshape(-1, 1)), R.DP_STEPS, DP.LR)
    want = [{k: np.broadcast_to(v.numpy(), (SIZE, *v.shape)) for k, v in layer.items()}
            for layer in want]
    for run in ("off/auto", "off/off"):
        assert_params(stacked(port_run(results), run, "params"), want, run)


def test_fused_step_is_one_exchange(results):
    """The four gradients and the loss go out as one packed collective a
    step under fusion, five without; fused and unfused agree in the f32
    SUM band."""
    for r in port_run(results):
        for codec in R.CODECS:
            assert r[f"{codec}/auto"]["calls"] == [1] * R.DP_STEPS
        assert r["off/off"]["calls"] == [5] * R.DP_STEPS
        for g, w in zip(tree_leaves(r["off/auto"]["params"]),
                        tree_leaves(r["off/off"]["params"])):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_main_trains_in_lockstep(results):
    """The example's ``main`` on four ranks: the loss falls, every rank
    holds the same weights and losses, one exchange a step."""
    mains = [r["main"] for r in port_run(results)]
    losses = mains[0]["losses"]
    assert len(losses) == 30 and losses[-1] < 0.5 * losses[0]
    for m in mains:
        assert m["losses"] == losses
        assert (m["compress"], m["fusion"], m["world"]) == ("off", "auto", SIZE)
        assert [e["calls"] for e in m["exchange"]] == [1] * 30
        for a, b in zip(tree_leaves(m["params"]), tree_leaves(mains[0]["params"])):
            np.testing.assert_array_equal(a, b)
    init = DP.init_mlp(DP.SIZES, generator=torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(mains[0]["params0"]), tree_leaves(init)):
        np.testing.assert_array_equal(a, b.numpy())


def test_mlp_params_from_jax_give_the_same_output():
    params = jax_params()
    x = np.random.default_rng(5).standard_normal((7, 16), dtype=np.float32)
    want = EX.mlp_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    got = DP.mlp_apply(convert.mlp_params_from_jax(params, device="cpu"),
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad,err", [
    ([{"w": np.zeros((16, 4))}], KeyError),
    ([{"w": np.zeros((16, 4)), "b": np.zeros(3)}], ValueError),
    ([{"w": np.zeros((16, 4)), "b": np.zeros(4)},
      {"w": np.zeros((5, 1)), "b": np.zeros(1)}], ValueError)])
def test_mlp_params_from_jax_checks_keys_and_shapes(bad, err):
    with pytest.raises(err, match="mlp_params_from_jax"):
        convert.mlp_params_from_jax(bad, device="cpu")


@pytest.mark.parametrize("entry", ["dp", "demo"])
def test_entry_points_need_cuda_unless_asked_for_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    fn = {"dp": lambda: DP.main(steps=1), "demo": FD.main}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_fusion_demo_on_four_ranks():
    """The demo's three forms on four ranks: sixteen allreduces in one
    packed collective, the start/wait and ``overlap()`` means equal the
    plain allreduce's (``main`` raises otherwise)."""
    ranks = launch.run(FD.rank_main, 4, device="cpu", timeout=R0.RANK_TIMEOUT_S,
                       args=("cpu",))
    for r in ranks:
        assert (r["fused/auto/calls"], r["fused/off/calls"]) == (1, 16)
        for i, leaf in enumerate(r["fused/auto"]):
            np.testing.assert_array_equal(leaf, np.full(64 * (i % 3 + 1), i + 1.0))
        np.testing.assert_array_equal(r["overlap"], np.ones(4096))
