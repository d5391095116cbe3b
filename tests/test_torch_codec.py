"""The codecs and the error-feedback allreduce against the JAX package.

The byte math (``ops/_codec.py``), the knobs (``utils/config.py``) and
the fp8 and bf16 encode, decode and roundtrip (``ops/_compress.py``) are
held in-process against the JAX package's functions on the same inputs.
``ef_allreduce`` runs in ``tests/torch_ranks_throughput.py:
throughput_program`` on 2, 4 and 8 gloo ranks on the CPU (one world per
size, shared with ``test_torch_fusion.py`` and ``test_torch_async.py``)
and through ``mpx.compress.ef_allreduce`` on the 8-device CPU mesh.

Bands: the byte math, the knobs, the fp8 bytes and scales and both
roundtrips bit for bit against the JAX package's functions; the EF
allreduce's result rtol 1e-5 (an f32 SUM over the ranks,
tests/test_allreduce.py:62), its residual bit for bit (fp8: see
``test_ef_allreduce_matches_jax``), and with the codec off the residual
exactly zero.  Two differences from the JAX package are pinned: jitted,
its fp8 scale multiplies by the reciprocal of 448; and a chunk whose max
is below 448 * 2**-126 decodes to NaN there (its subnormal scale is
flushed to zero) and to its values here.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.ops import _codec as JC  # noqa: E402
from mpi4jax_tpu.ops import _compress as JZ  # noqa: E402
from mpi4jax_tpu.utils import config as JCFG  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_throughput as R  # noqa: E402
from mpi4jax_tpu_torch import compress  # noqa: E402
from mpi4jax_tpu_torch.ops import SUM, Op  # noqa: E402
from mpi4jax_tpu_torch.ops import _codec as TC  # noqa: E402
from mpi4jax_tpu_torch.ops import _compress as TZ  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.utils import config as TCFG  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]
NBYTES = [0, 4, 1020, 1024, 4096, 12345 * 4, 1 << 20]
CODEC_ARGS = [None, "off", "bf16", "fp8"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "throughput")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.throughput_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


# ---------------------------------------------------------------------------
# byte math and knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODEC_ARGS)
@pytest.mark.parametrize("nbytes", NBYTES)
def test_wire_bytes_and_ratio_match_jax(nbytes, codec):
    assert TC.wire_bytes(nbytes, codec) == JC.wire_bytes(nbytes, codec)
    assert TC.compression_ratio(nbytes, codec) == JC.compression_ratio(nbytes, codec)


def test_unknown_codec_raises_as_in_jax():
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="unknown wire codec"):
            mod.wire_bytes(16, "int4")
    with pytest.raises(ValueError, match="unknown wire codec"):
        TZ.roundtrip(torch.ones(3), "int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["", "off", "bf16", "fp8", "auto", "FP8 "])
def test_codec_for_and_compress_mode_match_jax(monkeypatch, mode, dtype):
    """The same variable, the same codec: ``auto`` is ``bf16`` without an
    autotune table, only float32 is compressed."""
    monkeypatch.setenv("MPI4JAX_TPU_COMPRESS", mode)
    assert TC.codec_for(4096, dtype) == JC.codec_for(4096, dtype)
    assert TCFG.compress_mode() == JCFG.compress_mode()
    assert compress.compress_mode() == mpx.compress.compress_mode()


@pytest.mark.parametrize("name,value", [
    ("MPI4JAX_TPU_COMPRESS", "int4"), ("MPI4JAX_TPU_FUSION", "always"),
    ("MPI4JAX_TPU_FUSION_BUCKET_BYTES", "4MiB"),
    ("MPI4JAX_TPU_OVERLAP_CHUNKS", "0")])
def test_bad_knob_values_raise_as_in_jax(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    read = {"MPI4JAX_TPU_COMPRESS": "compress_mode",
            "MPI4JAX_TPU_FUSION": "fusion_mode",
            "MPI4JAX_TPU_FUSION_BUCKET_BYTES": "fusion_bucket_bytes",
            "MPI4JAX_TPU_OVERLAP_CHUNKS": "overlap_chunks"}[name]
    for mod in (TCFG, JCFG):
        with pytest.raises(ValueError, match=name):
            getattr(mod, read)()


@pytest.mark.parametrize("env", [{}, {"MPI4JAX_TPU_FUSION": "force",
                                      "MPI4JAX_TPU_FUSION_BUCKET_BYTES": "1024",
                                      "MPI4JAX_TPU_OVERLAP_CHUNKS": "5"}])
def test_knob_values_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for read in ("fusion_mode", "fusion_bucket_bytes", "overlap_chunks"):
        assert getattr(TCFG, read)() == getattr(JCFG, read)()
    assert TCFG.COMPRESS_MODES == JCFG.COMPRESS_MODES
    assert TCFG.FUSION_MODES == JCFG.FUSION_MODES
    assert TCFG.DEFAULT_FUSION_BUCKET_BYTES == JCFG.DEFAULT_FUSION_BUCKET_BYTES


@pytest.mark.parametrize("old_k,rank_map,new_world", [
    (4, {0: 0, 1: 1, 2: 2, 3: 3}, 4), (4, {0: 0, 2: 1, 3: 2}, 3),
    (4, {1: 0, 3: 1}, 4), (2, {0: 1, 1: 0}, 3), (8, {7: 0}, 1),
    (3, {0: 5}, 2)])
def test_ef_reshard_rows_match_jax(old_k, rank_map, new_world):
    assert TC.ef_reshard_rows(old_k, rank_map, new_world) == JC.ef_reshard_rows(
        old_k, rank_map, new_world)


@pytest.mark.parametrize("args", [(4, {4: 0}, 2), (4, {0: 0}, 0), (2, {-1: 0}, 2)])
def test_ef_reshard_rows_refuse_as_jax(args):
    for mod in (TC, JC):
        with pytest.raises(ValueError):
            mod.ef_reshard_rows(*args)


def test_ef_reshard_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 3, 2), dtype=np.float32),
            "b": [rng.standard_normal((4, 5), dtype=np.float32)]}
    rank_map = {0: 0, 2: 1, 3: 2}
    want = JZ.ef_reshard(jax.tree.map(jnp.asarray, tree), rank_map, 5)
    got = TZ.ef_reshard({"a": torch.from_numpy(tree["a"]),
                         "b": [torch.from_numpy(tree["b"][0])]}, rank_map, 5)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))


# ---------------------------------------------------------------------------
# encode, decode, roundtrip
# ---------------------------------------------------------------------------


def codec_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ragged":  # 1000 elements: the last chunk holds 232
        return rng.standard_normal(1000, dtype=np.float32)
    if name == "zero_chunk":  # the first chunk all zeros (scale 1)
        x = rng.standard_normal((3, 256), dtype=np.float32)
        x[0] = 0
        return x
    if name == "rounding_edge":
        # each chunk's max, scaled, is 448 exactly; the others sit on and
        # beside e4m3 rounding midpoints of the scaled grid
        x = rng.standard_normal((4, 256), dtype=np.float32)
        for row, m in enumerate((448.0, 1.0, 3.0e-3, 7.5e4)):
            x[row, 0] = m
            x[row, 1:17] = m * (np.arange(1, 17, dtype=np.float32) / 16.0
                                + np.float32(1 / 64))
            x[row, 17:] = np.clip(x[row, 17:], -0.9, 0.9) * m
        return x
    if name == "subnormal":  # every chunk wholly subnormal, and one mixed
        x = (rng.standard_normal((2, 256)) * 1e-40).astype(np.float32)
        x[1, :8] = rng.standard_normal(8).astype(np.float32)
        return x
    if name == "wide_range":
        return (rng.standard_normal((5, 77))
                * 10.0 ** rng.integers(-30, 30, size=(5, 77))).astype(np.float32)
    if name == "one":
        return np.array([-2.5], np.float32)
    raise KeyError(name)


CODEC_CASES = ["ragged", "zero_chunk", "rounding_edge", "subnormal", "wide_range",
               "one"]


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("case", CODEC_CASES)
def test_fp8_encode_decode_bit_for_bit(case):
    x = codec_case(case)
    jq, js = JZ.encode_fp8(jnp.asarray(x))
    tq, ts = TZ.encode_fp8(torch.from_numpy(x))
    assert tq.dtype == TZ.fp8_wire_dtype() == torch.float8_e4m3fn
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), bits(jq))
    np.testing.assert_array_equal(bits(ts.numpy()), bits(js))
    got = TZ.decode_fp8(tq, ts, x.shape, x.size).numpy()
    np.testing.assert_array_equal(bits(got), bits(JZ.decode_fp8(jq, js, x.shape,
                                                               x.size)))


@pytest.mark.parametrize("codec", CODEC_ARGS)
@pytest.mark.parametrize("case", CODEC_CASES)
def test_roundtrip_bit_for_bit(case, codec):
    x = codec_case(case)
    got = TZ.roundtrip(torch.from_numpy(x), codec).numpy()
    np.testing.assert_array_equal(bits(got), bits(JZ.roundtrip(jnp.asarray(x), codec)))


def test_tiny_chunk_decodes_to_values_where_jax_gives_nan():
    """A chunk whose max lies below 448 * 2**-126 (its scale subnormal):
    the JAX package's scale flushes to zero and the chunk decodes to NaN;
    the port's decodes within e4m3's rounding of the values."""
    x = np.zeros(256, np.float32)
    x[:10] = np.linspace(1e-36, 3e-37, 10, dtype=np.float32)
    assert np.isnan(np.asarray(JZ.roundtrip(jnp.asarray(x), "fp8"))[:10]).all()
    got = TZ.roundtrip(torch.from_numpy(x), "fp8").numpy()
    np.testing.assert_allclose(got, x, rtol=2.0**-4, atol=0)


@pytest.mark.parametrize("codec", ["off", "bf16", "fp8"])
@pytest.mark.parametrize("op", ["SUM", "MIN", "LAND", "callable"])
def test_effective_and_dcn_codec_match_jax(monkeypatch, codec, op):
    monkeypatch.setenv("MPI4JAX_TPU_COMPRESS", codec)
    jop = jnp.add if op == "callable" else getattr(mpx, op)
    top = torch.add if op == "callable" else getattr(Op, op)
    assert TZ._effective(codec, top) == JZ._effective(codec, jop)
    for np_dtype, t_dtype in ((np.float32, torch.float32), (np.int32, torch.int32)):
        want = JZ.dcn_codec(jnp.zeros(8, np_dtype), 32, jop)
        assert TZ.dcn_codec(torch.zeros(8, dtype=t_dtype), 32, top) == want


# ---------------------------------------------------------------------------
# ef_allreduce over the ranks
# ---------------------------------------------------------------------------


def jax_ef(results, size):
    def compute():
        mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
        comm = mpx.Comm("x", mesh=mesh)
        grads, residual = (jax.tree.map(jnp.asarray, t) for t in R.ef_inputs(size))
        out = {}
        for codec in R.CODECS:
            @partial(mpx.spmd, comm=comm)
            def f(g, r):
                red, res, _ = mpx.compress.ef_allreduce(g, r, op=mpx.SUM, comm=comm)
                return red, res

            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("MPI4JAX_TPU_COMPRESS", codec)
                out[codec] = jax.tree.map(np.asarray, f(grads, residual))
        return out

    return results.get(f"jax-ef-{size}", compute)


def stacked(ranks, key, part):
    """Rank r's tree ``ranks[r][key][part]`` stacked over the ranks, as the
    JAX package's global tree."""
    trees = [r[key][part] for r in ranks]
    return [{k: np.stack([t[i][k] for t in trees]) for k in ("b", "w")}
            for i in range(len(trees[0]))]


def eager_ef(size, codec):
    """Each rank's ``g + r``, its roundtrip by the JAX package's functions
    called eagerly (their literal division by 448), the residual, and the
    sum of the roundtrips over the ranks."""
    grads, residual = R.ef_inputs(size)
    out = []
    for i, layer in enumerate(grads):
        res, red = {}, {}
        for k in ("b", "w"):
            comp = [jnp.asarray(layer[k][r]) + jnp.asarray(residual[i][k][r])
                    for r in range(size)]
            q = [JZ.roundtrip(c, codec) for c in comp]
            res[k] = np.stack([np.asarray(c - qq) for c, qq in zip(comp, q)])
            red[k] = np.sum(np.stack([np.asarray(qq) for qq in q]), axis=0)
            red[k] = np.broadcast_to(red[k], res[k].shape)
        out.append((res, red))
    return out


@pytest.mark.parametrize("codec", R.CODECS)
@pytest.mark.parametrize("size", SIZES)
def test_ef_allreduce_matches_jax(results, size, codec):
    """Against ``mpx.compress.ef_allreduce`` in an ``mpx.spmd`` region:
    the reduced gradients rtol 1e-5; the new residual bit for bit, except
    under fp8, where the jitted region scales by ``maxabs * (1/448)``
    (``test_jitted_jax_scales_by_the_reciprocal``) and a value may round
    to the next e4m3 step: there within one step (2**-3 of the largest
    value), and bit for bit with the JAX package's codec called eagerly."""
    ranks = port_run(results, size)
    red_want, res_want = jax_ef(results, size)[codec]
    res_got = stacked(ranks, f"ef/{codec}", 1)
    red_got = stacked(ranks, f"ef/{codec}", 0)
    grads, residual = R.ef_inputs(size)
    for i, (eager_res, eager_red) in enumerate(eager_ef(size, codec)):
        for k in ("b", "w"):
            msg = f"layer {i} {k}"
            if codec == "fp8":
                step = 2.0**-3 * np.abs(grads[i][k] + residual[i][k]).max()
                np.testing.assert_array_equal(bits(res_got[i][k]),
                                              bits(eager_res[k]), err_msg=msg)
                np.testing.assert_allclose(res_got[i][k], res_want[i][k], rtol=0,
                                           atol=step, err_msg=msg)
                np.testing.assert_allclose(red_got[i][k], eager_red[k], rtol=1e-5,
                                           atol=1e-6, err_msg=msg)
                np.testing.assert_allclose(red_got[i][k], red_want[i][k], rtol=1e-5,
                                           atol=size * step, err_msg=msg)
            else:
                np.testing.assert_array_equal(bits(res_got[i][k]),
                                              bits(res_want[i][k]), err_msg=msg)
                np.testing.assert_allclose(red_got[i][k], red_want[i][k], rtol=1e-5,
                                           atol=1e-6, err_msg=msg)


def test_jitted_jax_scales_by_the_reciprocal():
    """The difference the fp8 band above covers, pinned: jitted, the JAX
    package's ``maxabs / 448`` becomes ``maxabs * float32(1/448)`` (XLA
    rewrites a division by a constant); eagerly it is the division, which
    the port computes."""
    x = codec_case("ragged")
    jitted = np.asarray(jax.jit(JZ.encode_fp8)(jnp.asarray(x))[1])
    eager = np.asarray(JZ.encode_fp8(jnp.asarray(x))[1])
    maxabs = torch.from_numpy(x).abs().reshape(1, -1)
    maxabs = torch.nn.functional.pad(maxabs, (0, 24)).reshape(1, 4, 256).amax(-1, keepdim=True)
    recip = (maxabs * torch.tensor(1.0 / 448.0, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(bits(jitted), bits(recip))
    np.testing.assert_array_equal(bits(TZ.encode_fp8(torch.from_numpy(x))[1].numpy()),
                                  bits(eager))
    assert not np.array_equal(jitted, eager)


@pytest.mark.parametrize("size", SIZES)
def test_ef_residual_exactly_zero_with_the_codec_off(results, size):
    """From a zero residual, the codec off: the residual stays zero
    (``torch.equal``, not a band) and the result is the plain sum."""
    for r in port_run(results, size):
        red, res = r["ef/off/from_zero"]
        for layer in res:
            for leaf in layer.values():
                assert torch.equal(torch.from_numpy(leaf), torch.zeros(leaf.shape))
    grads, _ = R.ef_inputs(size)
    want = [{k: np.sum(v, axis=0) for k, v in layer.items()} for layer in grads]
    got = port_run(results, size)[0]["ef/off/from_zero"][0]
    for g, w in zip(got, want):
        for k in ("b", "w"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size", SIZES)
def test_ef_residual_is_the_rounding_under_a_codec(results, size):
    """Under bf16 and fp8 the residual is ``g + r - roundtrip(g + r)``:
    non-zero, and within the codec's rounding of the values (a leaf of one
    element is exact under fp8: it is its chunk's max)."""
    grads, residual = R.ef_inputs(size)
    for codec, rel in (("bf16", 2.0**-8), ("fp8", 2.0**-3)):
        res = stacked(port_run(results, size), f"ef/{codec}", 1)
        assert max(np.abs(layer[k]).max() for layer in res for k in layer) > 0
        for i, layer in enumerate(res):
            for k in ("b", "w"):
                comp = grads[i][k] + residual[i][k]
                assert np.all(np.abs(layer[k]) <= rel * np.abs(comp).max())


def test_ef_allreduce_refuses_a_mismatched_residual():
    g = [torch.ones(3), torch.ones(2)]
    with pytest.raises(ValueError, match="residual tree does not match"):
        compress.ef_allreduce(g, [torch.zeros(3)], op=SUM)
