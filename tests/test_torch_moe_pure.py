"""The port's MoE helpers (``mpi4jax_tpu_torch/parallel/moe.py``), the pure
half, against the JAX package's.

The gate, capacity and dispatch math takes the array module, so both
packages' functions run here on the same seeded numpy inputs and must
agree bit for bit: ``capacity_for`` (its errors too), ``init_moe_params``,
``gate_tokens``, ``dispatch_tensor``, ``expert_mlp`` and ``reference_moe``
over several ``(tokens, experts, factor)``.  Then the port's torch
branches against its numpy ones, the fold on torch against the numpy
reference, the capacity-chunks knob, and the bit-for-bit identity of the
chunked expert MLP (``expert_rows``) that the overlapped layer rests on.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.parallel import moe  # noqa: E402
from mpi4jax_tpu_torch.ops._async import overlap_chunk_split  # noqa: E402
from mpi4jax_tpu_torch.utils import config  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

jmoe = importlib.import_module("mpi4jax_tpu.parallel.moe")
jconfig = importlib.import_module("mpi4jax_tpu.utils.config")

# (tokens, experts, factor)
SHAPES = [(16, 4, 1.25), (32, 4, 1.25), (33, 8, 0.7), (9, 2, 3.0), (7, 8, 1.0),
          (100, 4, 2.0), (1, 1, 1.0)]


def _raises_alike(fn_a, fn_b):
    """Both raise the same type with the same message, or return equal."""
    try:
        want = fn_b()
    except Exception as e:  # noqa: BLE001 - the error is the comparison
        with pytest.raises(type(e)) as got:
            fn_a()
        assert str(got.value) == str(e)
        return
    assert fn_a() == want


@pytest.mark.parametrize("tokens,experts,factor", SHAPES + [
    (0, 4, 1.25), (8, 0, 1.25), (8, 2, 0.0), (8, 2, -1.0), (-3, 2, 1.0)])
def test_capacity_for_equals_jax(tokens, experts, factor):
    _raises_alike(lambda: moe.capacity_for(tokens, experts, factor),
                  lambda: jmoe.capacity_for(tokens, experts, factor))


@pytest.mark.parametrize("d,d_ff,experts,seed", [(8, 12, 4, 3), (16, 32, 4, 7),
                                                 (5, 7, 8, 0)])
def test_init_moe_params_bit_for_bit(d, d_ff, experts, seed):
    for rank in range(experts):
        got = moe.init_moe_params(d, d_ff, experts, rank=rank, seed=seed)
        want = jmoe.init_moe_params(d, d_ff, experts, rank=rank, seed=seed)
        assert got._fields == want._fields
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _tokens(tokens, d, seed=0):
    return np.random.default_rng(seed).standard_normal((tokens, d)).astype(np.float32)


@pytest.mark.parametrize("tokens,experts,factor", SHAPES)
def test_gate_and_dispatch_bit_for_bit(tokens, experts, factor):
    d = 6
    x = _tokens(tokens, d)
    w_gate = moe.init_moe_params(d, 4, experts, seed=1).w_gate
    a, gate = moe.gate_tokens(np, x, w_gate)
    ja, jgate = jmoe.gate_tokens(np, x, w_gate)
    assert a.tobytes() == ja.tobytes() and gate.tobytes() == jgate.tobytes()
    cap = moe.capacity_for(tokens, experts, factor)
    D = moe.dispatch_tensor(np, a, experts, cap)
    jD = jmoe.dispatch_tensor(np, ja, experts, cap)
    assert D.dtype == jD.dtype and D.tobytes() == jD.tobytes()


def test_expert_mlp_bit_for_bit():
    p = moe.init_moe_params(8, 12, 4, rank=2, seed=3)
    z = np.random.default_rng(2).standard_normal((4, 5, 8)).astype(np.float32)
    got = moe.expert_mlp(np, z, p.w_in, p.w_out)
    want = jmoe.expert_mlp(np, z, p.w_in, p.w_out)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tokens,experts,factor", [s for s in SHAPES if s[1] > 1])
@pytest.mark.parametrize("seed", [0, 3])
def test_reference_moe_bit_for_bit(tokens, experts, factor, seed):
    x = np.random.default_rng(seed + 10).standard_normal(
        (experts, tokens, 6)).astype(np.float32)
    got = moe.reference_moe(x, 9, experts, seed=seed, capacity_factor=factor)
    want = jmoe.reference_moe(x, 9, experts, seed=seed, capacity_factor=factor)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("tokens,experts,factor", SHAPES)
def test_torch_branches_match_numpy(tokens, experts, factor):
    d = 6
    x = _tokens(tokens, d, seed=4)
    w_gate = moe.init_moe_params(d, 4, experts, seed=2).w_gate
    a, gate = moe.gate_tokens(np, x, w_gate)
    ta, tgate = moe.gate_tokens(torch, torch.from_numpy(x), torch.from_numpy(w_gate))
    assert ta.numpy().tolist() == a.tolist()
    np.testing.assert_allclose(tgate.numpy(), gate, rtol=1e-6)
    cap = moe.capacity_for(tokens, experts, factor)
    tD = moe.dispatch_tensor(torch, ta, experts, cap)
    assert tD.dtype == torch.float32
    assert tD.numpy().tobytes() == moe.dispatch_tensor(np, a, experts, cap).tobytes()


def test_fold_on_torch_matches_the_numpy_reference():
    k, tokens, d, d_ff = 4, 16, 8, 12
    x = np.random.default_rng(5).standard_normal((k, tokens, d)).astype(np.float32)
    cap = moe.capacity_for(tokens, k)
    params = [moe.MoEParams(*(torch.from_numpy(v) for v in
                              moe.init_moe_params(d, d_ff, k, rank=r, seed=3)))
              for r in range(k)]
    got = moe.fold_layer(torch, torch.from_numpy(x), params, cap).numpy()
    np.testing.assert_allclose(got, moe.reference_moe(x, d_ff, k, seed=3),
                               rtol=1e-5, atol=1e-6)


def test_capacity_chunks_knob(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", raising=False)
    assert config.moe_capacity_chunks() == jconfig.moe_capacity_chunks() == 2
    for raw in ("1", "5", " 3 "):
        monkeypatch.setenv("MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", raw)
        assert config.moe_capacity_chunks() == jconfig.moe_capacity_chunks()
    for raw in ("0", "-2", "two"):
        monkeypatch.setenv("MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", raw)
        _raises_alike(config.moe_capacity_chunks, jconfig.moe_capacity_chunks)
    assert "MPI4JAX_TPU_MOE_CAPACITY_CHUNKS" in config.FLAG_NAMES


@pytest.mark.parametrize("k,cap,d,d_ff", [(4, 5, 8, 12), (4, 10, 16, 32),
                                          (4, 200, 64, 128), (2, 7, 8, 12),
                                          (4, 1280, 64, 32)])
def test_chunked_expert_rows_are_the_whole_buckets_bit_for_bit(k, cap, d, d_ff):
    """The overlapped layer's chunks run the expert MLP on capacity slices
    of the buckets; ``expert_rows`` computes every slot in the same fixed
    block whatever the chunking, so the chunks give the whole bucket's
    bits (the capacity chunking of phase 14, 1280 slots in 2 and 4, and
    chunks that cut a block)."""
    g = torch.Generator().manual_seed(k * cap)
    rec = torch.randn(k, cap, d, generator=g)
    w_in = torch.randn(d, d_ff, generator=g) * 0.2
    w_out = torch.randn(d_ff, d, generator=g) * 0.2
    whole = moe.expert_rows(rec, 0, cap, w_in, w_out)
    assert whole.shape == (k, cap, d)
    np.testing.assert_allclose(whole.numpy(), moe.expert_mlp(torch, rec, w_in, w_out)
                               .numpy(), rtol=1e-5, atol=1e-5)
    for chunks in (2, 3, 4, 7, cap):
        parts, off = [], 0
        for csz in overlap_chunk_split(cap, chunks):
            parts.append(moe.expert_rows(rec, off, off + csz, w_in, w_out))
            off += csz
        assert torch.equal(torch.cat(parts, dim=1), whole), chunks


def test_all_names_exported():
    assert sorted(moe.__all__) == sorted(jmoe.__all__)
    for name in moe.__all__:
        assert callable(getattr(moe, name))


def test_moe_params_from_jax_carries_the_examples_stack():
    """``convert.moe_params_from_jax`` on the JAX example's rank-stacked
    parameters (JAX arrays) gives each rank the weights it draws."""
    import importlib.util
    import pathlib

    from mpi4jax_tpu_torch import convert

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "moe_training.py"
    spec = importlib.util.spec_from_file_location("_moe_example", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    _x, _tgt, w_gate, w_in, w_out = ex.build_inputs(4)
    ranks = convert.moe_params_from_jax(jmoe.MoEParams(w_gate, w_in, w_out),
                                        device="cpu")
    assert len(ranks) == 4
    for r, got in enumerate(ranks):
        want = moe.init_moe_params(ex.D, ex.D_FF, 4, rank=r, seed=ex.SEED)
        assert isinstance(got, moe.MoEParams)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.numpy().tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="do not fit"):
        convert.moe_params_from_jax((w_gate, w_in, w_in), device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        convert.moe_params_from_jax((w_gate[0], w_in[0], w_out[0]), device="cpu")
    with pytest.raises(ValueError, match="fields"):
        convert.moe_params_from_jax((w_gate, w_in), device="cpu")
