"""``ring_attention(memory_efficient_grad=False)`` over 2 and 4 gloo ranks:
the op-by-op backward through ``sendrecv``'s transpose, against the JAX
package.

The port's side runs ``tests/torch_ranks_ops.py:ring_program`` (q, k and
v three distinct draws, so that a swap of dK and dV shows); the JAX side
takes ``jax.grad`` of the sum over ranks of ``sum(out**2)`` through its
``ring_attention(memory_efficient_grad=False)`` on the first 2 or 4
devices of the 8-device CPU mesh.  Bands: outputs rtol 2e-4, atol 2e-5
(tests/test_long_context.py:61); gradients rtol 2e-3, atol 2e-4 against
the JAX package's, and rtol 1e-4, atol 1e-5 against the port's
memory-efficient backward on the same ranks (tests/test_long_context.py:
156); the forward mode against the JAX package's ``jvp`` of
``reference_attention`` on the gathered sequence, rtol 2e-3, atol 2e-4.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu import attention as JA  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_ops as R  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4]
CAUSAL = ["causal", "full"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "ring-grad")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.ring_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


def jax_results(results, size):
    def compute():
        comm = mpx.Comm("sp", mesh=mpx.make_world_mesh(
            (size,), ("sp",), devices=jax.devices()[:size]))
        q, k, v = (jnp.asarray(a) for a in R.ring_inputs(size))
        out = {}
        for causal in (True, False):
            @partial(mpx.spmd, comm=comm)
            def ring(q, k, v, causal=causal):
                return JA.ring_attention(q, k, v, comm=comm, causal=causal,
                                         memory_efficient_grad=False)

            def loss(q, k, v, ring=ring):
                return jnp.sum(ring(q, k, v) ** 2)

            key = "causal" if causal else "full"
            out[key] = (np.asarray(ring(q, k, v)),
                        *(np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(q, k, v)))
        full = [jnp.concatenate(list(a), axis=1) for a in (q, k, v)]
        _, jv = jax.jvp(lambda a: JA.reference_attention(a, full[1], full[2],
                                                         causal=True),
                        (full[0],), (jnp.ones_like(full[0]),))
        out["jvp"] = np.stack(np.split(np.asarray(jv), size, axis=1))
        return out

    return results.get(f"jax-{size}", compute)


def stacked(results, size, key, i):
    return np.stack([r[key][i] for r in port_run(results, size)])


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("size", SIZES)
def test_plain_ad_ring_matches_jax(results, size, causal):
    want = jax_results(results, size)[causal]
    np.testing.assert_allclose(stacked(results, size, f"{causal}/plain", 0), want[0],
                               rtol=2e-4, atol=2e-5, err_msg="out")
    for i, name in enumerate("qkv", start=1):
        np.testing.assert_allclose(stacked(results, size, f"{causal}/plain", i),
                                   want[i], rtol=2e-3, atol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("size", SIZES)
def test_plain_ad_ring_matches_memory_efficient(results, size, causal):
    """The same outputs and gradients as the port's memory-efficient
    backward; dK and dV differ from each other (a swap would show)."""
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(stacked(results, size, f"{causal}/plain", i),
                                   stacked(results, size, f"{causal}/me", i),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    dk, dv = (stacked(results, size, f"{causal}/plain", i) for i in (2, 3))
    assert np.abs(dk - dv).max() > 0.1


@pytest.mark.parametrize("size", SIZES)
def test_exchanges_per_rank(results, size):
    """Op by op: one stacked K/V rotation a step forward and its transpose
    backward, on every rank; the memory-efficient path rotates K and V
    apart, twice over, and the dK/dV accumulators size times."""
    for res in port_run(results, size):
        for causal in CAUSAL:
            assert tuple(res[f"{causal}/plain/exchanges"]) == (size - 1, size - 1)
            assert tuple(res[f"{causal}/me/exchanges"]) == (
                2 * (size - 1), 2 * (size - 1) + 2 * size)


@pytest.mark.parametrize("size", SIZES)
def test_forward_mode_through_the_ring(results, size):
    """``jvp`` along the queries through the causal ring op by op (the
    rotations' ``jvp``) against full attention's."""
    got = np.stack([r["jvp"] for r in port_run(results, size)])
    np.testing.assert_allclose(got, jax_results(results, size)["jvp"],
                               rtol=2e-3, atol=2e-4)
