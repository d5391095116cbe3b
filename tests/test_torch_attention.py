"""The port's long-context attention and alltoall against the JAX package.

One rank: ``reference_attention`` and ``flash_attention`` (causal and
not) against the JAX package's on the same numpy inputs.  Two and four
gloo ranks on the CPU: ``tests/torch_ranks.py:attention_program`` runs
``alltoall`` and the demo's entry point
(``mpi4jax_tpu_torch.models.long_context_attention.main``: ring and
Ulysses, causal and not) at the JAX demo's widths (b=2, t_loc=128, h=8,
d=64); the JAX side runs ``mpx.alltoall``, ``ring_attention`` and
``ulysses_attention`` on the first 2 or 4 devices of the 8-device CPU
mesh.  ``alltoall`` only moves data, so it is compared bit for bit;
attention in the band of tests/test_long_context.py:61 (rtol 2e-4,
atol 2e-5), against the JAX package's scheme and against its
``reference_attention`` on the gathered sequence.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu import attention as JA  # noqa: E402

import torch_ranks as R  # noqa: E402
from mpi4jax_tpu_torch import Comm, alltoall, make_world_mesh  # noqa: E402
from mpi4jax_tpu_torch import attention as TA  # noqa: E402
from mpi4jax_tpu_torch.models import long_context_attention as LCA  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4]
RTOL, ATOL = 2e-4, 2e-5
RUN_KEYS = [f"{s}/{'causal' if c else 'full'}" for s, c in R.ATTENTION_RUNS]
JAX_SCHEMES = {"ring": JA.ring_attention, "ulysses": JA.ulysses_attention}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.RunResults(tmp_path_factory, "attention")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.attention_program, size, device="cpu", timeout=R.RANK_TIMEOUT_S,
        args=(size,)))


def gathered(x):
    """``(size, B, T_loc, H, D)`` shards -> ``(B, T_global, H, D)``."""
    return np.concatenate(list(np.asarray(x)), axis=1)


def jax_error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return ""


def jax_results(results, size):
    """The JAX package's results of everything ``attention_program`` runs."""

    def compute():
        devices = jax.devices()[:size]
        comm = mpx.Comm("sp", mesh=mpx.make_world_mesh((size,), ("sp",),
                                                       devices=devices))
        out = {}
        x = jnp.asarray(R.alltoall_inputs(size, size))
        out["alltoall/world"] = mpx.alltoall(x, comm=comm)[0]
        out["alltoall/error"] = jax_error(
            lambda: mpx.alltoall(x[:, :1], comm=comm))
        if size == 4:
            gmesh = mpx.make_world_mesh((2, 2), ("py", "px"), devices=devices)
            grid = mpx.Comm(("py", "px"), mesh=gmesh)
            sub = jnp.asarray(R.alltoall_inputs(size, 2))
            for axes in ("px", "py"):
                @partial(mpx.spmd, comm=grid)
                def sub_alltoall(x, axes=axes):
                    return mpx.alltoall(x, comm=grid.sub(axes))[0]

                out[f"alltoall/{axes}"] = sub_alltoall(sub)
            colmajor = mpx.Comm(("px", "py"), mesh=gmesh)
            out["alltoall/px,py"] = partial(mpx.spmd, comm=colmajor)(
                lambda x: mpx.alltoall(x, comm=colmajor)[0])(x)

        q, k, v = (jnp.asarray(a) for a in LCA.demo_data(0, size, **R.ATTENTION))
        for (scheme, causal), key in zip(R.ATTENTION_RUNS, RUN_KEYS):
            fn = JAX_SCHEMES[scheme]

            @partial(mpx.spmd, comm=comm)
            def run(q, k, v, fn=fn, causal=causal):
                return fn(q, k, v, comm=comm, causal=causal)

            out[f"{key}/out"] = run(q, k, v)
            out[f"{key}/reference"] = JA.reference_attention(
                *(jnp.asarray(gathered(a)) for a in (q, k, v)), causal=causal)
        bad = jnp.zeros((size, 1, 4, size + 1, 32))
        out["ulysses/error"] = jax_error(lambda: partial(mpx.spmd, comm=comm)(
            lambda q: JA.ulysses_attention(q, q, q, comm=comm))(bad))
        return {k: v if isinstance(v, str) else np.asarray(v)
                for k, v in out.items()}

    return results.get(f"jax-{size}", compute)


def stacked(per_rank, key):
    return np.stack([r[key] for r in per_rank])


@pytest.mark.parametrize("size,key", [(2, "world"), (4, "world"), (4, "px"),
                                      (4, "py"), (4, "px,py")])
def test_alltoall_matches_jax(results, size, key):
    """Bit for bit: on the world, and on 4 ranks on the row (px), column
    (py) and column-major (px, py) comms of a (2,2) grid; the last one's
    comm-rank order differs from its process group's."""
    key = f"alltoall/{key}"
    per_rank = port_run(results, size)
    if key == "alltoall/px,py":  # the JAX package stacks by comm rank
        per_rank = sorted(per_rank, key=lambda r: r[f"{key}/rank"])
        assert [r[f"{key}/rank"] for r in per_rank] == list(range(size))
    np.testing.assert_array_equal(stacked(per_rank, key),
                                  jax_results(results, size)[key])


@pytest.mark.parametrize("size", SIZES)
def test_alltoall_leading_axis_error_matches_jax(results, size):
    want = jax_results(results, size)["alltoall/error"]
    assert want.startswith("ValueError: alltoall input must have leading axis")
    for r in port_run(results, size):
        assert r["alltoall/error"] == want


def test_alltoall_size_one_is_a_copy():
    comm = Comm("x", mesh=make_world_mesh((1,), ("x",), device="cpu"))
    x = torch.arange(6.0).reshape(1, 2, 3)
    out, _ = alltoall(x, comm=comm)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match=r"leading axis == comm size \(1\)"):
        alltoall(x.reshape(2, 3), comm=comm)


@pytest.mark.parametrize("key", RUN_KEYS)
@pytest.mark.parametrize("size", SIZES)
def test_attention_matches_jax_scheme(results, size, key):
    want = jax_results(results, size)[f"{key}/out"]
    np.testing.assert_allclose(stacked(port_run(results, size), f"{key}/out"),
                               want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", RUN_KEYS)
@pytest.mark.parametrize("size", SIZES)
def test_attention_matches_reference_on_gathered_sequence(results, size, key):
    want = jax_results(results, size)[f"{key}/reference"]
    got = gathered(stacked(port_run(results, size), f"{key}/out"))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", SIZES)
def test_attention_exchanges_and_no_kernel_on_cpu(results, size):
    """The ring rotates K and V at every step but the last, on every rank;
    Ulysses makes four alltoalls (q, k, v there, the output back).  CPU
    tensors launch no kernel."""
    want = {"ring": 2 * (size - 1), "ulysses": 4}
    for r in port_run(results, size):
        for key in RUN_KEYS:
            assert r[f"{key}/exchanges"] == want[key.split("/")[0]]
            assert r[f"{key}/launches"] == 0


@pytest.mark.parametrize("size", SIZES)
def test_ulysses_rejects_bad_head_count(results, size):
    want = jax_results(results, size)["ulysses/error"]
    assert "divisible" in want
    for r in port_run(results, size):
        assert r["ulysses/error"] == want


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
@pytest.mark.parametrize("size", SIZES)
def test_multi_rank_attention_refuses_grad(results, size, scheme):
    """Over several ranks every path differentiates: the ring through its
    memory-efficient backward, Ulysses through the alltoall transposes
    (tests/test_torch_training.py holds both against the JAX package): a
    finite gradient of the input's shape on every rank.  The ring's
    plain-AD path (``memory_efficient_grad=False``), which an older slice
    refused, now differentiates through ``sendrecv``'s transpose and gives
    the memory-efficient gradient (rtol 1e-4, atol 1e-5,
    tests/test_long_context.py:156; tests/test_torch_ring_grad.py holds it
    against the JAX package)."""
    for r in port_run(results, size):
        grad = r[f"{scheme}/grad"]
        assert grad.shape == (1, 4, size, 32) and np.isfinite(grad).all()
        assert np.abs(grad).max() > 0
        np.testing.assert_allclose(r["ring/plain_grad"], r["ring/grad"],
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def one_rank_inputs(seed=1, b=2, t=256, h=4, d=64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, b, t, h, d), dtype=np.float32)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("fn", ["reference_attention", "flash_attention"])
def test_single_device_attention_matches_jax(fn, causal):
    q, k, v = one_rank_inputs()
    want = getattr(JA, fn)(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = getattr(TA, fn)(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_keeps_bf16(causal):
    q, k, v = (torch.from_numpy(a).bfloat16() for a in one_rank_inputs(t=32))
    out = TA.flash_attention(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16
    want = JA.flash_attention(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                for a in (q, k, v)), causal)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=4 * 2.0**-8 * float(jnp.abs(want).max()))


def test_demo_entry_point_on_one_rank():
    """``main`` outside any world: a world of one, where the ring is one
    block and Ulysses' alltoalls are copies; both equal flash attention,
    and the CPU path stays differentiable on one rank."""
    res = LCA.main("cpu", b=1, t_loc=64, h=2, d=32)
    q, k, v = (torch.from_numpy(a[0]) for a in LCA.demo_data(0, 1, 1, 64, 2, 32))
    want = TA.flash_attention(q, k, v, causal=True)
    for key in ("ring/causal", "ulysses/causal"):
        torch.testing.assert_close(res[key]["out"], want, rtol=0, atol=0)
        assert res[key]["exchange_calls"] == 0
    comm = Comm("sp", mesh=make_world_mesh((1,), ("sp",), device="cpu"))
    qg = q.clone().requires_grad_(True)
    TA.ring_attention(qg, k, v, comm=comm, causal=True).sum().backward()
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())


def test_schemes_need_a_comm():
    q = torch.zeros((1, 4, 2, 32))
    for fn in (TA.ring_attention, TA.ulysses_attention):
        with pytest.raises(ValueError, match="pass comm="):
            fn(q, q, q)
