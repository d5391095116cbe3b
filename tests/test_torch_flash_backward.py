"""The backward of the port's flash partials against the JAX package's.

``mpi4jax_tpu_torch.kernels.flash_attention.flash_block_partials`` with
``custom_backward=True`` routes CPU tensors through ``FlashPartials``,
the autograd ``Function`` the card uses, whose backward here is
``block_partials_bwd_plain``; the JAX package's runs its custom VJP with
the Pallas backward kernels in interpret mode (``interpret=True``, as
tests/test_kernels.py runs them).  Both sides get the same numpy inputs
from a seed and differentiate the same normalised-attention loss.
Bands, those of tests/test_kernels.py: rtol 1e-3, atol 1e-4 for the
blockwise backward (the two sides sum the same f32 products in other
orders and tiles); rtol 5e-3, atol 5e-4 for a merge chain against full
softmax.  The CUDA kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpi4jax_tpu.kernels import flash_attention as JFA  # noqa: E402
from mpi4jax_tpu_torch.kernels import flash_attention as FA  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

# tests/test_kernels.py:219-229: square, rectangular (a ring block),
# masked, causal, ragged causal tiles, streaming non-causal tiles
GRAD_CASES = [
    (1, 16, 16, 2, 32, False, False),
    (2, 16, 24, 2, 32, False, False),
    (2, 16, 24, 2, 32, False, True),
    (1, 64, 64, 2, 32, True, False),
    (1, 550, 550, 1, 32, True, False),
    (1, 257, 1100, 1, 32, False, False),
    (1, 257, 1100, 1, 32, False, True),
]
RTOL, ATOL = 1e-3, 1e-4


def inputs(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    mask = rng.random((tq, tk)) < 0.8  # p = 0.8, as tests/test_kernels.py
    return q, k, v, mask


def jax_normalized(o, l):
    l_safe = jnp.where(l == 0.0, 1.0, l)
    return o / jnp.moveaxis(l_safe, 1, 2)[..., None]


def port_normalized(o, l):
    l_safe = torch.where(l == 0.0, 1.0, l)
    return o / l_safe.transpose(1, 2)[..., None]


def jax_grads(q, k, v, mask, scale, causal, **kwargs):
    def loss(q, k, v):
        o, _, l = JFA.flash_block_partials(
            q, k, v, None if mask is None else jnp.asarray(mask), scale=scale,
            causal=causal, **kwargs)
        return (jax_normalized(o, l).astype(jnp.float32) ** 2).sum()

    return jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


def port_grads(q, k, v, mask, scale, causal, dtype=torch.float32, **kwargs):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True)
              for x in (q, k, v)]
    o, _, l = FA.flash_block_partials(
        *leaves, None if mask is None else torch.from_numpy(mask), scale=scale,
        causal=causal, **kwargs)
    (port_normalized(o, l).float() ** 2).sum().backward()
    return [t.grad for t in leaves]


def assert_grads_close(want, got, rtol, atol):
    for a, b, name in zip(want, got, "qkv"):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=rtol, atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("b,tq,tk,h,d,causal,masked", GRAD_CASES)
def test_custom_backward_matches_jax_custom_vjp(b, tq, tk, h, d, causal, masked):
    """The port's blockwise backward against the JAX package's Pallas
    backward kernels in interpret mode, through normalised attention."""
    q, k, v, mask = inputs(11, b, tq, tk, h, d)
    mask = mask if masked else None
    scale = 1.0 / math.sqrt(d)
    want = jax_grads(q, k, v, mask, scale, causal, interpret=True)
    got = port_grads(q, k, v, mask, scale, causal, custom_backward=True)
    assert_grads_close(want, got, RTOL, ATOL)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,masked", GRAD_CASES[:4])
def test_custom_backward_matches_native_autograd(b, tq, tk, h, d, causal, masked):
    """The same loss through the natively differentiated plain version
    (which also routes the m cotangent): equal within the band, since the
    normalised output does not depend on the stabilizer."""
    q, k, v, mask = inputs(12, b, tq, tk, h, d)
    mask = mask if masked else None
    scale = 1.0 / math.sqrt(d)
    want = port_grads(q, k, v, mask, scale, causal)
    got = port_grads(q, k, v, mask, scale, causal, custom_backward=True)
    assert_grads_close([w.numpy() for w in want], got, RTOL, ATOL)


@pytest.mark.parametrize("causal,masked", [(False, False), (False, True),
                                           (True, False)])
def test_bwd_plain_matches_autograd_of_plain(causal, masked):
    """``block_partials_bwd_plain`` given the cotangents of ``o`` and ``l``
    that autograd of ``block_partials_plain`` reaches through the
    normalised output (``g_m`` = 0): the same ``dq``, ``dk``, ``dv``."""
    q, k, v, mask = inputs(4, 2, 12, 12 if causal else 20, 2, 32)
    mask = torch.from_numpy(mask) if masked else None
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, m, l = FA.block_partials_plain(*leaves, mask, scale=0.3, causal=causal)
    o.retain_grad()
    l.retain_grad()
    (port_normalized(o, l) ** 2).sum().backward()
    got = FA.block_partials_bwd_plain(
        *(t.detach() for t in leaves), mask, m.detach(), o.grad, l.grad,
        scale=0.3, causal=causal)
    for t, g, name in zip(leaves, got, "qkv"):
        torch.testing.assert_close(g, t.grad, rtol=RTOL, atol=ATOL,
                                   msg=lambda s: f"d{name}: {s}")


def test_merge_chain_gradient_matches_full_softmax():
    """tests/test_kernels.py:258: gradients through a ``merge_partials``
    chain of four key blocks (where a nonzero ``m`` cotangent reaches the
    backward and is dropped) equal those of full softmax attention, and
    the JAX package's blockwise gradient."""
    b, t, h, d = 1, 32, 2, 32
    q, k, v, _ = inputs(12, b, t, t, h, d)
    scale = 1.0 / math.sqrt(d)
    blk = t // 4

    def port_loss(q, k, v):
        m = torch.full((b, h, t), -torch.inf)
        l = torch.zeros((b, h, t))
        acc = torch.zeros_like(q)
        for i in range(4):
            sl = slice(i * blk, (i + 1) * blk)
            acc, m, l = FA.merge_partials(acc, m, l, *FA.flash_block_partials(
                q, k[:, sl], v[:, sl], None, scale=scale, custom_backward=True))
        return (port_normalized(acc, l) ** 2).sum()

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    port_loss(*leaves).backward()
    got = [t.grad for t in leaves]

    def full_loss(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
        out = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)
        return (out ** 2).sum()

    def jax_blockwise(q, k, v):
        m = jnp.full((b, h, t), -jnp.inf, jnp.float32)
        l = jnp.zeros((b, h, t), jnp.float32)
        acc = jnp.zeros_like(q)
        for i in range(4):
            sl = slice(i * blk, (i + 1) * blk)
            acc, m, l = JFA.merge_partials(acc, m, l, *JFA.flash_block_partials(
                q, k[:, sl], v[:, sl], None, scale=scale, interpret=True))
        return (jax_normalized(acc, l) ** 2).sum()

    args = [jnp.asarray(x) for x in (q, k, v)]
    assert_grads_close(jax.grad(full_loss, (0, 1, 2))(*args), got, 5e-3, 5e-4)
    assert_grads_close(jax.grad(jax_blockwise, (0, 1, 2))(*args), got, RTOL, ATOL)


@pytest.mark.parametrize("impl", ["interpret", "force_jnp"])
def test_fully_masked_rows_give_zero_gradients(impl):
    """tests/test_kernels.py:297: rows with no attendable key give exactly
    zero gradients, never NaN, on both sides."""
    q, k, v, _ = inputs(13, 1, 16, 16, 2, 32)
    mask = np.zeros((16, 16), bool)
    want = jax_grads(q, k, v, mask, 0.2, False, **{impl: True})
    got = port_grads(q, k, v, mask, 0.2, False, custom_backward=True)
    for a, b in zip(want, got):
        assert not bool(torch.isnan(b).any())
        assert bool((b == 0).all())
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bf16_gradients_keep_the_primal_dtype():
    """tests/test_kernels.py:316: the cotangents of bfloat16 inputs are
    bfloat16 on both sides, and the port's are within bf16 rounding of the
    JAX package's."""
    q, k, v, _ = inputs(14, 1, 16, 16, 2, 32)
    want = jax_grads(*(np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                       for x in (q, k, v)), None, 0.2, True, interpret=True)
    jwant = jax.grad(
        lambda q, k, v: (jax_normalized(*JFA.flash_block_partials(
            q, k, v, None, scale=0.2, causal=True, interpret=True)[::2])
            .astype(jnp.float32) ** 2).sum(), (0, 1, 2))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert all(g.dtype == jnp.bfloat16 for g in jwant)
    got = port_grads(q, k, v, None, 0.2, True, dtype=torch.bfloat16,
                     custom_backward=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for a, b in zip(want, got):
        top = float(np.abs(np.asarray(a)).max())
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a), rtol=0,
                                   atol=4 * 2.0**-8 * top)


def test_custom_backward_drops_the_stabilizer_cotangent():
    """A loss of ``m`` alone has zero gradient through the blockwise
    backward, as through the JAX package's custom VJP."""
    q, k, v, _ = inputs(15, 1, 8, 8, 1, 32)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    _, m, _ = FA.flash_block_partials(*leaves, None, scale=0.2,
                                      custom_backward=True)
    m.sum().backward()
    want = jax.grad(lambda q: JFA.flash_block_partials(
        q, jnp.asarray(k), jnp.asarray(v), None, scale=0.2,
        interpret=True)[1].sum())(jnp.asarray(q))
    assert bool((leaves[0].grad == 0).all())
    np.testing.assert_array_equal(np.asarray(want), leaves[0].grad.numpy())


class OtherDevice(torch.Tensor):
    """A tensor that reports a device the kernels have no route for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_backward_dispatch_refuses_other_devices():
    """``block_partials_bwd`` takes the plain version only for CPU tensors
    and the shape rule only for ``meta`` templates (the verifier's
    abstract run); anything else that is not CUDA is refused."""
    q = torch.empty((1, 8, 1, 32), device="meta")
    m = torch.empty((1, 1, 8), device="meta")
    oq, om = q.as_subclass(OtherDevice), m.as_subclass(OtherDevice)
    with pytest.raises(RuntimeError, match="unsupported device"):
        FA.block_partials_bwd(oq, oq, oq, None, om, oq, om, scale=0.2)
    assert all(t.is_meta for t in FA.block_partials_bwd(q, q, q, None, m, q, m,
                                                        scale=0.2))
