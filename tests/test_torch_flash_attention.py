"""The port's flash-attention partials against the JAX package's, on the CPU.

``mpi4jax_tpu_torch.kernels.flash_attention.flash_block_partials`` on CPU
tensors runs its plain version; the JAX package's runs its Pallas kernels
in interpret mode (``interpret=True``, as tests/test_kernels.py runs
them) and its jnp path (``force_jnp=True``).  Both sides get the same
numpy inputs from a seed.  Bands, those of tests/test_kernels.py, since
the two sides sum the same f32 products in other orders: ``m`` rtol and
atol 1e-6; ``l`` rtol 1e-5, atol 1e-6; ``o`` rtol and atol 1e-5 (1e-4
for the causal kernel, which streams key tiles where the jnp path masks
one block); bfloat16 ``o`` 4 * 2^-8 of max|ref| (two of its rounding
units at the largest value).  The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpi4jax_tpu.kernels import flash_attention as JFA  # noqa: E402
from mpi4jax_tpu_torch.kernels import flash_attention as FA  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

IMPLS = ["interpret", "force_jnp"]
# tests/test_kernels.py:33-41: square, rectangular (a ring step of unequal
# shards), D=64, and ragged q and k tiles of the streaming loop
SHAPES = [(1, 16, 16, 1, 32), (2, 16, 24, 4, 32), (2, 8, 8, 3, 64),
          (1, 257, 1100, 1, 32)]
# tests/test_kernels.py:195: one q tile, two whole tiles, a ragged tile
CAUSAL_SHAPES = [(2, 16, 4, 32), (1, 1024, 1, 32), (1, 1100, 1, 32)]
BANDS = {"m": (1e-6, 1e-6), "l": (1e-5, 1e-6), "o": (1e-5, 1e-5)}


def inputs(seed, b, tq, tk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    mask = rng.random((tq, tk)) < 0.8  # p = 0.8, as tests/test_kernels.py:44
    return q, k, v, mask


def jax_partials(impl, q, k, v, mask, scale, causal=False, dtype=jnp.float32):
    kwargs = {impl: True}
    out = JFA.flash_block_partials(
        *(jnp.asarray(x, dtype) for x in (q, k, v)),
        None if mask is None else jnp.asarray(mask),
        scale=scale, causal=causal, **kwargs)
    return out


def port_partials(q, k, v, mask, scale, causal=False, dtype=torch.float32):
    return FA.flash_block_partials(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
        scale=scale, causal=causal)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_partials_close(want, got, o_band=BANDS["o"]):
    for name, a, b in zip("oml", want, got):
        rtol, atol = o_band if name == "o" else BANDS[name]
        np.testing.assert_allclose(as_np(b), as_np(a), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_partials_match_jax(impl, b, tq, tk, h, d, masked):
    q, k, v, mask = inputs(0, b, tq, tk, h, d)
    mask = mask if masked else None
    scale = 1.0 / math.sqrt(d)
    assert_partials_close(jax_partials(impl, q, k, v, mask, scale),
                          port_partials(q, k, v, mask, scale))


@pytest.mark.parametrize("b,t,h,d", CAUSAL_SHAPES)
@pytest.mark.parametrize("impl", IMPLS)
def test_causal_partials_match_jax(impl, b, t, h, d):
    """``causal=True``: the key-tile-skipping kernel (interpret) and the
    tril-mask jnp path."""
    q, k, v, _ = inputs(3, b, t, t, h, d)
    scale = 1.0 / math.sqrt(d)
    assert_partials_close(jax_partials(impl, q, k, v, None, scale, causal=True),
                          port_partials(q, k, v, None, scale, causal=True),
                          o_band=(1e-4, 1e-4))


@pytest.mark.parametrize("impl", IMPLS)
def test_fully_masked_rows(impl):
    """A ring step against a wholly future block: every row gives
    ``m = -inf``, ``l = 0``, ``o = 0``, never NaN, on both sides."""
    q, k, v, _ = inputs(1, 2, 16, 16, 2, 32)
    mask = np.zeros((16, 16), bool)
    o, m, l = (x.numpy() for x in port_partials(q, k, v, mask, 0.1))
    assert np.all(np.isneginf(m)) and np.all(l == 0.0) and np.all(o == 0.0)
    assert_partials_close(jax_partials(impl, q, k, v, mask, 0.1), (o, m, l))


@pytest.mark.parametrize("impl", IMPLS)
def test_partially_masked_rows(impl):
    """The causal diagonal block as a mask: rows see 1..t keys, and one
    row sees none."""
    q, k, v, _ = inputs(2, 1, 16, 16, 2, 32)
    mask = np.tril(np.ones((16, 16), bool))
    mask[5] = False
    got = port_partials(q, k, v, mask, 0.2)
    assert np.isneginf(got[1][:, :, 5].numpy()).all()
    assert_partials_close(jax_partials(impl, q, k, v, mask, 0.2), got)


def test_mask_none_equals_all_true_mask():
    q, k, v, _ = inputs(5, 2, 16, 16, 2, 32)
    none = port_partials(q, k, v, None, 0.2)
    ones = port_partials(q, k, v, np.ones((16, 16), bool), 0.2)
    for a, b in zip(none, ones):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_dtype_contract(impl, causal):
    """``o`` keeps q's dtype and ``m``/``l`` are f32, on both sides."""
    q, k, v, _ = inputs(6, 1, 16, 16, 2, 32)
    o, m, l = port_partials(q, k, v, None, 0.2, causal, dtype=torch.bfloat16)
    assert o.dtype == torch.bfloat16
    assert m.dtype == torch.float32 and l.dtype == torch.float32
    want = jax_partials(impl, q, k, v, None, 0.2, causal, dtype=jnp.bfloat16)
    assert want[0].dtype == jnp.bfloat16
    assert want[1].dtype == jnp.float32 and want[2].dtype == jnp.float32


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_values_match_jnp_path(causal):
    """bfloat16 partials against the jnp path, which the port follows: f32
    scores from the bf16 inputs, ``p`` rounded to bf16 before the PV
    product.  (The TPU kernels pre-scale q in bf16 instead, which moves
    ``m`` by up to a bf16 rounding unit; they are not the reference
    here.)"""
    q, k, v, _ = inputs(6, 1, 16, 16, 2, 32)
    o, m, l = port_partials(q, k, v, None, 0.2, causal, dtype=torch.bfloat16)
    want = jax_partials("force_jnp", q, k, v, None, 0.2, causal,
                        dtype=jnp.bfloat16)
    top = np.abs(as_np(want[0])).max()
    np.testing.assert_allclose(as_np(o), as_np(want[0]), rtol=0,
                               atol=4 * 2.0**-8 * top)
    for name, a, b in zip("ml", want[1:], (m, l)):
        rtol, atol = BANDS[name]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol, err_msg=name)


def random_partials(seed, b, t, h, d):
    """Two blocks' partials from the plain version (the first with a row
    that sees no key), as numpy."""
    q, k, v, mask = inputs(seed, b, t, t, h, d)
    mask[3] = False
    one = port_partials(q, k, v, mask, 0.3)
    two = port_partials(q, k[:, ::-1].copy(), v, None, 0.3)
    return [x.numpy() for x in (*one, *two)]


@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_merge_partials_matches_jax(acc_dtype):
    """The flash combine rule; a bfloat16 accumulator times the f32
    weights promotes to f32 on both sides."""
    parts = random_partials(4, 2, 16, 3, 32)
    jdt, tdt = getattr(jnp, acc_dtype), getattr(torch, acc_dtype)
    want = JFA.merge_partials(jnp.asarray(parts[0], jdt),
                              *(jnp.asarray(x) for x in parts[1:]))
    got = FA.merge_partials(torch.from_numpy(parts[0]).to(tdt),
                            *(torch.from_numpy(x) for x in parts[1:]))
    assert want[0].dtype == jnp.float32 and got[0].dtype == torch.float32
    assert_partials_close(want, got)


def test_merge_with_fully_masked_block_is_identity():
    """tests/test_kernels.py:174-184: merging a block whose rows see no key
    changes nothing."""
    q, k, v, _ = inputs(4, 1, 8, 8, 1, 32)
    o1, m1, l1 = port_partials(q, k, v, np.ones((8, 8), bool), 0.3)
    o0, m0, l0 = port_partials(q, k, v, np.zeros((8, 8), bool), 0.3)
    acc, m, l = FA.merge_partials(o1, m1, l1, o0, m0, l0)
    torch.testing.assert_close(acc, o1, rtol=1e-7, atol=0)
    assert torch.equal(m, m1)
    torch.testing.assert_close(l, l1, rtol=1e-7, atol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_blockwise_merge_equals_full_softmax(impl):
    """Partials of four key blocks folded with ``merge_partials`` equal
    full attention (the invariant the ring rests on), and the JAX
    package's blockwise result."""
    b, t, h, d = 2, 32, 2, 32
    q, k, v, _ = inputs(3, b, t, t, h, d)
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * scale
    expected = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), tv)

    def fold(partials, merge, zeros, full, where):
        m, l, acc = full((b, h, t), -np.inf), zeros((b, h, t)), zeros((b, t, h, d))
        blk = t // 4
        for i in range(4):
            sl = slice(i * blk, (i + 1) * blk)
            acc, m, l = merge(acc, m, l, *partials(sl))
        return acc / where(l)

    got = fold(lambda sl: FA.flash_block_partials(
                   tq, tk[:, sl], tv[:, sl], torch.ones((t, t // 4), dtype=torch.bool),
                   scale=scale),
               FA.merge_partials, torch.zeros,
               lambda s, x: torch.full(s, x), lambda l: l.transpose(1, 2)[..., None])
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-5)
    jax_got = fold(lambda sl: jax_partials(impl, q, k[:, sl], v[:, sl],
                                           np.ones((t, t // 4), bool), scale),
                   JFA.merge_partials, jnp.zeros,
                   lambda s, x: jnp.full(s, x, jnp.float32),
                   lambda l: jnp.moveaxis(l, 1, 2)[..., None])
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=1e-5, atol=1e-5)


def jax_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["mask", "rectangular"])
def test_causal_argument_checks(case):
    """``causal=True`` needs ``mask=None`` and ``Tq == Tk``; the message is
    the JAX package's."""
    q, k, v, mask = inputs(0, 1, 8, 8 if case == "mask" else 12, 1, 32)
    mask = mask if case == "mask" else None
    want = jax_error(lambda: jax_partials("force_jnp", q, k, v, mask, 0.2, True))
    got = jax_error(lambda: port_partials(q, k, v, mask, 0.2, True))
    assert got == want


def test_plain_path_is_differentiable_like_jax():
    """On CPU tensors the plain version is natively differentiable: the
    gradient of a loss of the normalised output matches the JAX jnp
    path's (rtol 1e-4, atol 1e-5: a longer f32 chain)."""
    import jax

    q, k, v, mask = inputs(8, 1, 12, 20, 2, 32)

    def jloss(q, k, v):
        o, _, l = JFA.flash_block_partials(q, k, v, jnp.asarray(mask), scale=0.2,
                                           force_jnp=True)
        return jnp.sum((o / jnp.moveaxis(l, 1, 2)[..., None]) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o, _, l = FA.flash_block_partials(tq, tk, tv, torch.from_numpy(mask), scale=0.2)
    ((o / l.transpose(1, 2)[..., None]) ** 2).sum().backward()
    for a, t in zip(want, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)


class OtherDevice(torch.Tensor):
    """A tensor that reports a device the kernels have no route for."""

    @property
    def device(self):
        return torch.device("xpu")


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU, nor on a CUDA device, nor a
    ``meta`` template of the verifier's abstract run is refused: nothing
    falls back to the plain version.  A ``meta`` tensor takes the
    kernels' shape rule: empty outputs, nothing computed."""
    q = torch.empty((1, 8, 1, 32), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        FA.flash_block_partials(*[q.as_subclass(OtherDevice)] * 3, None, scale=0.2)
    assert all(t.is_meta for t in FA.flash_block_partials(q, q, q, None, scale=0.2))
