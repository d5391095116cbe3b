"""The error-compensated 3xTF32 product of the f32 backward kernels.

``csrc/flash_bwd_tf32.cu`` computes every f32 product on the tensor
cores from TF32 halves: each operand x splits into big = tf32(x) and
small = tf32(x - big), both by ``cvt.rna.tf32.f32`` (round to nearest,
ties away from zero, 10 stored mantissa bits), and
a . b ~ a_small b_big + a_big b_small + a_big b_big accumulates in f32.
The card is needed to run the kernels; the arithmetic they rely on is
emulated here in numpy, bit for bit for the split.
"""

import numpy as np
import pytest

TRIALS, N = 1000, 128  # dot products of length D = 128, the full head dim


def to_tf32(x):
    """``cvt.rna.tf32.f32`` on finite f32 values: add half of the 13
    dropped bits to the magnitude's pattern, then clear them."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def split(x):
    """``(big, small)`` of the kernels' fragment loads."""
    big = to_tf32(x)
    return big, to_tf32((x - big).astype(np.float32))


def wide_range(shape, seed):
    """f32 values of both signs over 2^-40 .. 2^40."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp2(rng.uniform(-40, 40, shape))
    return x.astype(np.float32)


def test_split_halves_are_tf32_and_reconstruct_x_within_2_pow_minus_22():
    """big and small carry 10 stored mantissa bits each (their low 13 bits
    are zero), x - big is exact in f32, and big + small is x to within
    2^-22 |x| (the bound the kernels' note states)."""
    x = wide_range(100_000, seed=0)
    big, small = split(x)
    for h in (big, small):
        assert not (h.view(np.uint32) & np.uint32(0x1fff)).any()
    x64 = x.astype(np.float64)
    assert np.array_equal((x - big).astype(np.float64), x64 - big.astype(np.float64))
    err = np.abs(x64 - big.astype(np.float64) - small.astype(np.float64))
    assert (err <= 2.0**-22 * np.abs(x64)).all()
    # one half alone is 2^-11 off: the split is what buys the bits
    assert (np.abs(x64 - big) <= 2.0**-11 * np.abs(x64)).all()
    assert np.max(np.abs(x64 - big) / np.abs(x64)) > 2.0**-13


def test_to_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # the tf32 spacing at 1
    half = np.float32(2.0**-11)
    assert to_tf32(one + half) == one + ulp  # a tie goes away from zero
    assert to_tf32(-(one + half)) == -(one + ulp)
    below = np.nextafter(one + half, one, dtype=np.float32)
    assert to_tf32(below) == one


@pytest.mark.parametrize("seed", [1, 2])
def test_three_term_product_keeps_f32_accuracy_where_one_term_does_not(seed):
    """Over 1000 dot products of length 128 of random f32 vectors, each
    summed in f32 in the kernels' order (per element the small terms, then
    the big one), the largest error of 3xTF32 against float64, relative to
    sum |a b|, stays within 4 times that of the plain f32 product; one
    TF32 term (a_big b_big) is more than 100 times off."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((TRIALS, N)).astype(np.float32)
    b = rng.standard_normal((TRIALS, N)).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = np.einsum("ti,ti->t", a64, b64)
    size = np.einsum("ti,ti->t", np.abs(a64), np.abs(b64))

    def worst(total):
        return np.max(np.abs(total.astype(np.float64) - exact) / size)

    f32 = np.add.accumulate(a * b, axis=1, dtype=np.float32)[:, -1]
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    # each term is a product of two 11-bit significands: exact in f32
    terms = np.stack([a_small * b_big, a_big * b_small, a_big * b_big], axis=2)
    assert np.array_equal(terms[..., 2].astype(np.float64),
                          a_big.astype(np.float64) * b_big.astype(np.float64))
    three = np.add.accumulate(terms.reshape(TRIALS, 3 * N), axis=1,
                              dtype=np.float32)[:, -1]
    one = np.add.accumulate(a_big * b_big, axis=1, dtype=np.float32)[:, -1]
    assert worst(three) <= 4 * worst(f32)
    assert worst(one) > 100 * worst(f32)
