"""How the flash-attention wrappers pick and feed their CUDA kernels.

Everything here runs without a card or ``nvcc``: the choice of kernel by
dtype, the layout the kernels are handed, the build specs and the
``ctypes`` signatures against the C functions the sources export.  The
kernels themselves run in ``tests/test_torch_cuda.py`` on the card.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.kernels import flash_attention as FA  # noqa: E402


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_route_by_dtype(dtype, causal):
    """bf16 takes the tensor-core kernels of flash_fwd_mma.cu, f32 the
    3xTF32 tensor-core kernels of flash_fwd_tf32.cu, each under its own
    counter's name."""
    name, spec_of, signatures = FA._fwd_route(dtype, causal)
    base = "flash_fwd_causal" if causal else "flash_fwd"
    if dtype == torch.bfloat16:
        assert (name, spec_of) == (base + "_mma", FA.fwd_mma_spec)
        assert spec_of()[0].name == "flash_fwd_mma.cu"
    else:
        assert (name, spec_of) == (base + "_tf32", FA.fwd_tf32_spec)
        assert spec_of()[0].name == "flash_fwd_tf32.cu"
    assert name + "_launch" in signatures
    assert FA._build.COUNTERS[name] is FA._build.counter_for(name)


def test_fwd_counters_are_distinct():
    counters = (FA.counter_tf32, FA.counter_causal_tf32, FA.counter_mma,
                FA.counter_causal_mma)
    assert len({id(c) for c in counters}) == 4
    assert FA.counter_tf32 is FA._build.counter_for("flash_fwd_tf32")
    assert FA.counter_causal_tf32 is FA._build.counter_for("flash_fwd_causal_tf32")
    assert FA.counter_mma is FA._build.counter_for("flash_fwd_mma")
    assert FA.counter_causal_mma is FA._build.counter_for("flash_fwd_causal_mma")


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_route_by_dtype(dtype, kind):
    """bf16 takes the tensor-core kernels of flash_bwd_mma.cu, f32 the
    3xTF32 tensor-core kernels of flash_bwd_tf32.cu, each under its own
    counter's name."""
    name, spec_of, signatures = FA._bwd_route(dtype, kind)
    if dtype == torch.bfloat16:
        assert (name, spec_of) == (f"flash_bwd_{kind}_mma", FA.mma_spec)
        assert spec_of()[0].name == "flash_bwd_mma.cu"
    else:
        assert (name, spec_of) == (f"flash_bwd_{kind}_tf32", FA.tf32_spec)
        assert spec_of()[0].name == "flash_bwd_tf32.cu"
    assert name + "_launch" in signatures
    assert FA._build.COUNTERS[name] is FA._build.counter_for(name)


def test_bwd_counters_are_distinct():
    counters = (FA.counter_bwd_dq_tf32, FA.counter_bwd_dkv_tf32,
                FA.counter_bwd_dq_mma, FA.counter_bwd_dkv_mma)
    assert len({id(c) for c in counters}) == 4
    assert FA.counter_bwd_dq_tf32 is FA._build.counter_for("flash_bwd_dq_tf32")
    assert FA.counter_bwd_dkv_tf32 is FA._build.counter_for("flash_bwd_dkv_tf32")


def _stride4_views(dtype):
    """(2, 90, 2, 64) views of (2, 90, 2, 68) tensors: strides multiples of
    4 but not of 8, data 8 bytes past a 16-byte boundary in bf16."""
    rng = np.random.default_rng(0)
    wide = [torch.from_numpy(rng.standard_normal((2, 90, 2, 68), dtype=np.float32))
            .to(dtype) for _ in range(3)]
    return tuple(x[..., 4:68] for x in wide)


def test_input_layout_copies_bf16_views_the_mma_kernels_cannot_read():
    views = _stride4_views(torch.bfloat16)
    assert views[0].stride() == (12240, 136, 68, 1)
    got = FA._input_layout(*views)
    for view, t in zip(views, got):
        assert t.is_contiguous() and t.data_ptr() != view.data_ptr()
        assert torch.equal(t, view)


def test_input_layout_reads_f32_and_aligned_bf16_in_place():
    views = _stride4_views(torch.float32)
    assert all(a is b for a, b in zip(FA._input_layout(*views), views))
    rng = np.random.default_rng(1)
    # a time slice of a contiguous bf16 tensor: strides multiples of 8
    full = torch.from_numpy(rng.standard_normal((2, 96, 2, 64), dtype=np.float32))
    sliced = tuple(full.bfloat16()[:, 8:72] for _ in range(3))
    assert all(a is b for a, b in zip(FA._input_layout(*sliced), sliced))


def test_mma_specs_cover_the_shared_header():
    """The four tensor-core sources include mma_bf16.cuh and list it in
    their spec, so an edit of the header rebuilds them."""
    for spec_of in (FA.fwd_mma_spec, FA.mma_spec, FA.tf32_spec, FA.fwd_tf32_spec):
        source, _, headers, fmad = spec_of()
        assert FA.MMA_HEADER in headers and FA.MMA_HEADER.exists() and fmad
        assert '#include "mma_bf16.cuh"' in source.read_text()


def test_tf32_spec_covers_its_header_and_the_old_source_is_gone():
    """The 3xTF32 source includes mma_tf32.cuh and lists it in its spec;
    the CUDA-core f32 backward it replaced is no longer in the tree."""
    source, _, headers, _ = FA.tf32_spec()
    assert FA.TF32_HEADER in headers and FA.TF32_HEADER.exists()
    assert '#include "mma_tf32.cuh"' in source.read_text()
    assert not (FA._build.CSRC / "flash_bwd.cu").exists()


def test_fwd_tf32_spec_covers_both_headers_and_the_old_source_is_gone():
    """The 3xTF32 forward includes mma_bf16.cuh and mma_tf32.cuh and lists
    both in its spec, so an edit of either rebuilds it; the CUDA-core f32
    forward it replaced is no longer in the tree."""
    source, _, headers, fmad = FA.fwd_tf32_spec()
    assert source.name == "flash_fwd_tf32.cu" and fmad
    assert headers == (FA.MMA_HEADER, FA.TF32_HEADER)
    for header in headers:
        assert f'#include "{header.name}"' in source.read_text()
    assert not (FA._build.CSRC / "flash_fwd.cu").exists()


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def exported(source):
    """``{name: [ctypes type of each parameter]}`` of the ``extern "C"``
    functions of a CUDA source."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source.read_text()):
        types = [re.sub(r"\s+\w+$", "", p.strip()) for p in params.split(",")]
        out[name] = [_CTYPES[t] for t in types]
    return out


@pytest.mark.parametrize("spec_of,signatures", [
    (FA.fwd_tf32_spec, FA._SIGNATURES), (FA.fwd_mma_spec, FA._FWD_MMA_SIGNATURES),
    (FA.tf32_spec, FA._TF32_SIGNATURES), (FA.mma_spec, FA._MMA_SIGNATURES),
], ids=["flash_fwd", "flash_fwd_mma", "flash_bwd", "flash_bwd_mma"])
def test_signatures_match_the_exported_functions(spec_of, signatures):
    """The argtypes the wrapper sets are the C functions' parameters, one
    for one (ctypes would pass a mismatch on silently)."""
    assert exported(spec_of()[0]) == {n: list(a) for n, a in signatures.items()}
