"""Gradients over the ranks, allreduce and the dp x sp training step
against the JAX package.

The port's side runs ``tests/torch_ranks.py:training_program`` as gloo
ranks on the CPU (once per test run for each world size): on 2 and 4
ranks the gradients of ring attention (its memory-efficient backward,
causal and not, f32 and bf16) and of Ulysses attention, and ``allreduce``
with SUM, PROD, MIN and MAX; on 2, 4 and 8 ranks, a (2, size/2) grid,
one step of the training example from the JAX package's
``init_params`` carried over by ``convert.params_from_jax``, and its
gradients under each fusion mode.  The JAX side
runs the same on the first ``size`` devices of the 8-device CPU mesh:
``jax.grad`` of ``ring_attention`` and ``ulysses_attention``,
``mpx.allreduce``, and ``examples/long_context_training.py``'s
``make_train_step`` and its single-device reference.  Bands, those of the
JAX suite: ring gradients rtol 1e-4, atol 1e-5
(tests/test_long_context.py:156); bf16 ring gradients rtol 0.1, atol
0.05 against the f32 gradient (:185); Ulysses gradients rtol 2e-3, atol
2e-4 (:127); allreduce of integer-valued data bit for bit; the training
loss rtol 1e-5 and the update rtol 2e-3, atol 2e-5
(tests/test_examples.py:563-569); fused against unfused gradients rtol
1e-5 (the f32 SUM band of tests/test_allreduce.py:62).
"""

import importlib.util
import pathlib
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu import attention as JA  # noqa: E402

import torch_ranks as R  # noqa: E402
from mpi4jax_tpu_torch import attention as TA  # noqa: E402
from mpi4jax_tpu_torch import convert  # noqa: E402
from mpi4jax_tpu_torch.models import long_context_training as LCT  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

GRAD_SIZES = [2, 4]
TRAIN_SIZES = [2, 4, 8]
T = R.TRAIN
F32_RING = [R.grad_key("ring", c, "float32") for c in (True, False)]
COMMS = {2: ["world"], 4: ["world", "px", "py", "px,py"]}


def _load_example():
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "long_context_training.py")
    spec = importlib.util.spec_from_file_location("_lct_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EX = _load_example()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.RunResults(tmp_path_factory, "training")


def grid_shape(size):
    n_dp = 2 if size % 2 == 0 and size > 1 else 1
    return n_dp, size // n_dp


def train_inputs(size):
    """The JAX example's parameters (``init_params(PRNGKey(0), ...)``) as
    numpy, and every rank's tiles ``x`` (size, B, T, D), ``y`` (size, B, T)
    from a numpy seed."""
    params = {k: np.asarray(v) for k, v in
              EX.init_params(jax.random.PRNGKey(0), T["d_model"], T["d_ff"]).items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((size, T["b_loc"], T["t_loc"], T["d_model"]),
                            dtype=np.float32)
    y = rng.standard_normal((size, T["b_loc"], T["t_loc"]), dtype=np.float32)
    return params, x, y


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.training_program, size, device="cpu", timeout=R.RANK_TIMEOUT_S,
        args=(size, *train_inputs(size), size in GRAD_SIZES)))


def gathered(x, n_dp, n_sp):
    """Rank tiles ``(n_dp * n_sp, B, T, ...)`` -> the global
    ``(n_dp * B, n_sp * T, ...)``: rank r = dp * n_sp + sp holds batch rows
    dp and sequence chunk sp (tests/test_examples.py:545)."""
    rows = [np.concatenate([x[dp * n_sp + s] for s in range(n_sp)], axis=1)
            for dp in range(n_dp)]
    return np.concatenate(rows, axis=0)


def jax_train(size):
    params, x, y = train_inputs(size)
    n_dp, n_sp = grid_shape(size)
    mesh = mpx.make_world_mesh((n_dp, n_sp), ("dp", "sp"),
                               devices=jax.devices()[:size])
    world = mpx.Comm(("dp", "sp"), mesh=mesh)
    step = EX.make_train_step(world, world.sub("sp"), T["heads"], lr=T["lr"])
    params_g = {k: jnp.broadcast_to(v, (size, *v.shape)) for k, v in params.items()}
    new, loss = step(params_g, jnp.asarray(x), jnp.asarray(y))
    xg, yg = (jnp.asarray(gathered(a, n_dp, n_sp)) for a in (x, y))

    def loss_full(p):
        pred = EX.block_forward(p, xg, heads=T["heads"], attend=lambda q, k, v:
                                JA.reference_attention(q, k, v, causal=True))
        return jnp.mean((pred - yg) ** 2)

    l_full, g_full = jax.value_and_grad(loss_full)(
        {k: jnp.asarray(v) for k, v in params.items()})
    out = {"train/loss": np.asarray(loss), "train/reference_loss": float(l_full)}
    for name in params:
        out[f"train/params/{name}"] = np.asarray(new[name])
        out[f"train/reference_grad/{name}"] = np.asarray(g_full[name])
    return out


def jax_grads(size):
    """``jax.grad`` of the sum over ranks of ``sum(out**2)``, each run of
    ``R.GRAD_RUNS`` (the bf16 ring's f32 counterpart is its true
    gradient)."""
    comm = mpx.Comm("sp", mesh=mpx.make_world_mesh(
        (size,), ("sp",), devices=jax.devices()[:size]))
    q, k, v = (jnp.asarray(a) for a in R.grad_inputs(size))
    schemes = {"ring": JA.ring_attention, "ulysses": JA.ulysses_attention}
    out = {}
    for scheme, causal, dtype in R.GRAD_RUNS:
        if dtype != "float32":
            continue

        def loss(q, k, v, fn=schemes[scheme], causal=causal):
            @partial(mpx.spmd, comm=comm)
            def f(q, k, v):
                return jnp.sum(fn(q, k, v, comm=comm, causal=causal) ** 2)

            # each rank's scalar is its own partial sum: their sum is the loss
            return jnp.sum(f(q, k, v))

        grads = jax.grad(loss, (0, 1, 2))(q, k, v)
        out[R.grad_key(scheme, causal, dtype)] = tuple(np.asarray(g) for g in grads)
    return out


def jax_allreduce(size):
    x = jnp.asarray(R.allreduce_inputs(size))
    devices = jax.devices()[:size]
    world = mpx.Comm("x", mesh=mpx.make_world_mesh((size,), ("x",), devices=devices))
    comms = {"world": (world, world)}
    if size == 4:
        gmesh = mpx.make_world_mesh((2, 2), ("py", "px"), devices=devices)
        grid = mpx.Comm(("py", "px"), mesh=gmesh)
        comms["px"] = (grid, grid.sub("px"))
        comms["py"] = (grid, grid.sub("py"))
        colmajor = mpx.Comm(("px", "py"), mesh=gmesh)
        comms["px,py"] = (colmajor, colmajor)
    out = {}
    for name, (region, comm) in comms.items():
        for op in R.REDUCTIONS:
            @partial(mpx.spmd, comm=region)
            def f(x, comm=comm, op=getattr(mpx, op)):
                return mpx.allreduce(x, op=op, comm=comm)[0]

            out[f"allreduce/{name}/{op}"] = np.asarray(f(x))
    out["allreduce/world/LAND"] = np.asarray(mpx.allreduce(x, mpx.LAND, comm=world)[0])
    out["allreduce/world/add"] = np.asarray(mpx.allreduce(x, jnp.add, comm=world)[0])
    return out


def jax_results(results, size):
    def compute():
        out = jax_train(size)
        if size in GRAD_SIZES:
            out["grads"] = jax_grads(size)
            out.update(jax_allreduce(size))
        return out

    return results.get(f"jax-{size}", compute)


def per_rank(results, size, key):
    return np.stack([r[key] for r in port_run(results, size)])


# ---------------------------------------------------------------------------
# attention gradients over the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", F32_RING)
@pytest.mark.parametrize("size", GRAD_SIZES)
def test_ring_gradients_match_jax(results, size, key):
    """The memory-efficient ring backward against the JAX package's, for
    dq, dk and dv of every rank."""
    want = jax_results(results, size)["grads"][key]
    for i, name in enumerate("qkv"):
        got = np.stack([r[f"{key}/grads"][i] for r in port_run(results, size)])
        np.testing.assert_allclose(got, want[i], rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("size", GRAD_SIZES)
def test_ring_bf16_gradients(results, size):
    """bf16 shards: gradients in bf16, finite, within bf16 tolerance of the
    true f32 gradient (tests/test_long_context.py:161-187)."""
    key = R.grad_key("ring", True, "bfloat16")
    want = jax_results(results, size)["grads"][R.grad_key("ring", True, "float32")]
    for r in port_run(results, size):
        assert r[f"{key}/dtype"] == "torch.bfloat16"
    for i, name in enumerate("qkv"):
        got = np.stack([r[f"{key}/grads"][i] for r in port_run(results, size)])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want[i], rtol=0.1, atol=0.05,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("size", GRAD_SIZES)
def test_ulysses_gradients_match_jax(results, size):
    key = R.grad_key("ulysses", True, "float32")
    want = jax_results(results, size)["grads"][key]
    for i, name in enumerate("qkv"):
        got = np.stack([r[f"{key}/grads"][i] for r in port_run(results, size)])
        np.testing.assert_allclose(got, want[i], rtol=2e-3, atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("size", GRAD_SIZES)
def test_backward_exchanges_per_rank(results, size):
    """Every rank makes the same exchanges: the ring rotates K/V
    2 (size - 1) times forward and again backward, plus 2 size dK/dV
    rotations; Ulysses makes 4 alltoalls each way (q, k, v, out and their
    transposes)."""
    ring = [2 * (size - 1), 2 * (size - 1) + 2 * size]
    want = {"ring": ring, "ulysses": [4, 4]}
    for r in port_run(results, size):
        for scheme, causal, dtype in R.GRAD_RUNS:
            got = r[f"{R.grad_key(scheme, causal, dtype)}/exchanges"].tolist()
            assert got == want[scheme], (scheme, causal, dtype)


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------


# the members of each comm's group, by global rank, on a (2,2) grid ("py", "px")
GROUPS = {"world": None, "px": [[0, 1], [2, 3]], "py": [[0, 2], [1, 3]],
          "px,py": None}
# the JAX package's PROD on the column-major comm differs from the product
# of the inputs on three of its four ranks (its butterfly over a comm whose
# order is not the mesh's); the port is held to the exact product there
JAX_OFF = {("px,py", "PROD")}
ALLREDUCE_CASES = [(s, c, op) for s in GRAD_SIZES for c in COMMS[s]
                   for op in R.REDUCTIONS]


def exact_allreduce(size, comm, op):
    """Every rank's exact result from the integer-valued inputs."""
    x = R.allreduce_inputs(size)
    reduce = {"SUM": np.sum, "PROD": np.prod, "MIN": np.min, "MAX": np.max}[op]
    groups = GROUPS[comm] or [list(range(size))]
    out = np.empty_like(x)
    for members in groups:
        out[members] = reduce(x[members], axis=0)
    return out


@pytest.mark.parametrize("size,comm,op", ALLREDUCE_CASES)
def test_allreduce_matches_exact_reduction(results, size, comm, op):
    """Bit for bit with the reduction of the inputs over each comm's
    members: the world and, on 4 ranks, the row (px), column (py) and
    column-major (px, py) comms of a (2,2) grid."""
    np.testing.assert_array_equal(
        per_rank(results, size, f"allreduce/{comm}/{op}"),
        exact_allreduce(size, comm, op))


@pytest.mark.parametrize("size,comm,op", [c for c in ALLREDUCE_CASES
                                          if c[1:] not in JAX_OFF])
def test_allreduce_matches_jax(results, size, comm, op):
    """Bit for bit with ``mpx.allreduce`` on the same comms."""
    key = f"allreduce/{comm}/{op}"
    np.testing.assert_array_equal(per_rank(results, size, key),
                                  jax_results(results, size)[key])


def test_jax_prod_on_the_column_major_comm_is_not_the_product(results):
    """The one case left out above, pinned so that a fix of the JAX
    package shows: its result differs from the exact product, which the
    port's equals."""
    want = exact_allreduce(4, "px,py", "PROD")
    got = jax_results(results, 4)["allreduce/px,py/PROD"]
    assert not np.array_equal(got, want)
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("size", GRAD_SIZES)
def test_allreduce_counts_and_keeps_its_input(results, size):
    """One exchange a call in ``stats`` (nothing staged on the CPU), and
    the input is not reduced in place."""
    for r in port_run(results, size):
        for comm in COMMS[size]:
            for op in R.REDUCTIONS:
                assert r[f"allreduce/{comm}/{op}/stats"].tolist() == [1, 0]
        assert r["allreduce/input_kept"]


@pytest.mark.parametrize("size", GRAD_SIZES)
def test_allreduce_refuses_what_is_not_ported(results, size):
    """What an older slice refused now works, as in the JAX package: LAND
    of f32 data (the JAX package's dtype, f32 0/1), a callable reduction
    (``torch.add`` against ``jnp.add``), bit for bit; and the gradient of
    ``sum(allreduce(x)**2)``, whose SUM backward is the per-rank identity
    (tests/test_allreduce.py:131): ``2 * sum_r x_r`` on every rank."""
    want = jax_results(results, size)
    land, added, grad = (per_rank(results, size, "allreduce/once_refused")[:, i]
                         for i in range(3))
    np.testing.assert_array_equal(land, want["allreduce/world/LAND"])
    assert land.dtype == want["allreduce/world/LAND"].dtype == np.float32
    np.testing.assert_array_equal(added, want["allreduce/world/add"])
    np.testing.assert_array_equal(grad, 2 * exact_allreduce(size, "world", "SUM"))


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", TRAIN_SIZES)
def test_train_step_matches_jax_step(results, size):
    """Loss and updated parameters of every rank against the JAX package's
    ``make_train_step`` on the same parameters and tiles."""
    want = jax_results(results, size)
    np.testing.assert_allclose(per_rank(results, size, "train/loss"),
                               want["train/loss"], rtol=1e-5)
    params, _, _ = train_inputs(size)
    for name, p0 in params.items():
        new = np.stack([r["train/params"][name] for r in port_run(results, size)])
        got = (p0 - new) / T["lr"]
        ref = (p0 - want[f"train/params/{name}"]) / T["lr"]
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-5,
                                   err_msg=f"update of {name}")


@pytest.mark.parametrize("size", TRAIN_SIZES)
def test_train_step_matches_single_device(results, size):
    """The distributed step against one device on the gathered batch and
    sequence with full attention (tests/test_examples.py:515): the loss,
    and every parameter's update as a gradient."""
    want = jax_results(results, size)
    params, _, _ = train_inputs(size)
    for r in port_run(results, size):
        np.testing.assert_allclose(r["train/loss"], want["train/reference_loss"],
                                   rtol=1e-5)
        for name, p0 in params.items():
            np.testing.assert_allclose(
                (p0 - r["train/params"][name]) / T["lr"],
                want[f"train/reference_grad/{name}"], rtol=2e-3, atol=2e-5,
                err_msg=f"grad {name}")


@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("size", TRAIN_SIZES)
def test_train_step_under_fusion_matches_unfused(results, size, mode):
    """The loss and gradients of ``make_grad_fn`` under fusion ``auto`` and
    ``force`` against ``off`` in the f32 SUM band (rtol 1e-5,
    tests/test_allreduce.py:62); at these widths the loss and the five
    gradients (under 4 MiB) go out as one packed allreduce, where ``off``
    makes six."""
    n_dp, n_sp = grid_shape(size)
    ring = 4 * (n_sp - 1) + 2 * n_sp if n_sp > 1 else 0
    for r in port_run(results, size):
        got, want = r[f"train/fusion/{mode}"], r["train/fusion/off"]
        assert want["exchanges"] == ring + 6
        assert got["exchanges"] == ring + 1
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, rtol=1e-5,
                                       atol=1e-6 * np.abs(g).max(), err_msg=name)


@pytest.mark.parametrize("size", TRAIN_SIZES)
def test_train_step_grid_and_exchanges(results, size):
    """Rank r sits at (dp, sp) = divmod(r, n_sp) and every rank makes the
    same exchanges: the ring's forward and backward rotations over its sp
    comm (none when n_sp = 1), then 6 allreduces (the loss and five
    gradients)."""
    n_dp, n_sp = grid_shape(size)
    ring = 4 * (n_sp - 1) + 2 * n_sp if n_sp > 1 else 0
    for rank, r in enumerate(port_run(results, size)):
        assert tuple(r["train/grid"]) == divmod(rank, n_sp)
        assert r["train/exchanges"] == ring + 6


def test_main_reduces_the_loss_on_four_ranks():
    """The CLI's run (the JAX example's widths, five steps at lr 0.1, a
    (2,2) grid, fusion ``auto`` as the JAX example's ``main``): the loss
    falls, every rank ends every step with the same parameters and the
    same losses, the CPU launches no kernel, and a step's exchanges are
    the ring's and one packed allreduce of the loss and the gradients."""
    ranks = launch.run(LCT.rank_main, 4, device="cpu", timeout=R.RANK_TIMEOUT_S,
                       args=("cpu", {}))
    losses = ranks[0]["losses"]
    assert len(losses) == 5 and losses[-1] < losses[0]
    for r in ranks:
        assert r["losses"] == losses
        assert r["digests"] == ranks[0]["digests"]
        assert all(n == 0 for step in r["launches"] for n in step.values())
        assert r["exchange"][0]["calls"] == 4 * 1 + 2 * 2 + 1


def test_main_on_one_rank_matches_one_step_by_hand():
    """``main`` as a world of one: its first gradients are those of the
    single-device loss with ring attention on one rank, which equal
    ``reference_attention``'s."""
    kw = {"b_loc": 2, "t_loc": 16, "d_model": 32, "d_ff": 64, "heads": 4}
    res = LCT.main("cpu", steps=2, lr=0.1, seed=3, **kw)
    params = LCT.init_params(32, 64, generator=torch.Generator().manual_seed(3),
                             device="cpu")
    x, y = LCT.train_data(4, 2, 16, 32)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    pred = LCT.block_forward(leaves, x, heads=4, attend=lambda q, k, v:
                             TA.reference_attention(q, k, v, causal=True))
    loss = torch.mean((pred - y) ** 2)
    loss.backward()
    assert res["losses"][0] == pytest.approx(loss.item(), rel=1e-5)
    for name, p in leaves.items():
        torch.testing.assert_close(res["grads0"][name], p.grad, rtol=2e-3,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# parameters from the JAX package
# ---------------------------------------------------------------------------


def test_params_from_jax_give_the_same_block_output():
    """``init_params(PRNGKey(0), 32, 64)`` carried over: the port's
    ``block_forward`` and ``Block`` give the JAX example's output on the
    same ``x``."""
    jparams = EX.init_params(jax.random.PRNGKey(0), 32, 64)
    params = convert.params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                                     device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 16, 32), dtype=np.float32)
    want = EX.block_forward(jparams, jnp.asarray(x), heads=4, attend=lambda q, k, v:
                            JA.reference_attention(q, k, v, causal=True))

    def attend(q, k, v):
        return TA.reference_attention(q, k, v, causal=True)

    got = LCT.block_forward(params, torch.from_numpy(x), heads=4, attend=attend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    block = LCT.Block(params, heads=4)
    assert sorted(n for n, _ in block.named_parameters()) == list(LCT.PARAM_NAMES)
    with torch.no_grad():
        torch.testing.assert_close(block(torch.from_numpy(x), attend), got,
                                   rtol=0, atol=0)


def test_params_from_jax_checks_keys_and_shapes():
    params = {k: np.asarray(v) for k, v in
              EX.init_params(jax.random.PRNGKey(0), 32, 64).items()}
    with pytest.raises(KeyError, match="missing"):
        convert.params_from_jax({k: v for k, v in params.items() if k != "wo"},
                                device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        convert.params_from_jax({**params, "bias": np.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="wo has shape"):
        convert.params_from_jax({**params, "wo": params["wo"][:, :16]},
                                device="cpu")
