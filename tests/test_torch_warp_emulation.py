"""The flash backward's CUDA sources run on the host, warp instructions
emulated.

``mpi4jax_tpu_torch/csrc/host/`` emulates the CUDA pieces the backward
sources use: a block's threads run as coroutines that switch at every
barrier and warp-collective instruction, and ``mma.sync``, ``ldmatrix``
and ``cp.async`` are computed from every lane's operands.  Each test copies
the sources with their inline-asm helpers replaced by those emulations,
builds them with the host C++ compiler and holds the kernels against the
plain version on the CPU, in the band of ``tests/test_torch_cuda.py``.  So
the fragment maps, the permuted k of the 3xTF32 gradient products, the
staged masks and the causal and ragged bounds run here, where no card is;
the card runs the real instructions in ``tests/test_torch_cuda.py``.
Skips where no C++ compiler is found.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.kernels import flash_attention as FA  # noqa: E402

HOST = FA._build.CSRC / "host"
SOURCES = {"tf32": FA.BWD_SOURCE, "mma": FA.MMA_SOURCE}
SIGNATURES = {"tf32": FA._TF32_SIGNATURES, "mma": FA._MMA_SIGNATURES}

# each inline-asm helper of the headers, by name, and its emulation
EMULATED = {
    "cp_async16": "{ if (ok) memcpy(dst, src, 16); else memset(dst, 0, 16); }",
    "cp_async4": "{ if (ok) memcpy(dst, src, 4); else memset(dst, 0, 4); }",
    "cp_commit": "{}",
    "cp_wait": "{}",
    "ldsm4": "{ emu_ldsm4(r, p, false); }",
    "ldsm4t": "{ emu_ldsm4(r, p, true); }",
    "mma": "{ emu_mma_bf16(c, a, b0, b1); }",
    "mma1": "{ emu_mma_tf32(c, a, b0, b1); }",
}


def emulated_source(text):
    """``text`` with the body of every helper in EMULATED replaced and each
    ``<<<grid, NT, smem, stream>>>`` launch turned into ``launch_stub``."""
    for name, body in EMULATED.items():
        out, pos = [], 0
        for m in re.finditer(r"__device__ __forceinline__ [^\n(]*\b%s\(" % name, text):
            start = text.index("{", m.end())
            depth, end = 0, start
            while True:
                depth += {"{": 1, "}": -1}.get(text[end], 0)
                if depth == 0:
                    break
                end += 1
            out += [text[pos:start], body]
            pos = end + 1
        text = "".join(out) + text[pos:]
    assert "asm" not in re.sub(r"//[^\n]*", "", text)
    return re.sub(r"(\w+)<<<\s*(\w+),\s*(\w+),\s*\w+,\s*\w+\s*>>>\(a\)",
                  r"launch_stub(\1, \2, \3, a)", text)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """The backward libraries built for the host: ``tf32``, ``mma`` and
    ``tf32_truncating`` (each mma's sum truncated, as the tensor cores
    accumulate)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("warp_emulation")
    for f in (FA.MMA_HEADER, FA.TF32_HEADER):
        (out / f.name).write_text(emulated_source(f.read_text()))
    for f in SOURCES.values():  # and the blocks' dynamic shared memory
        (out / f.name).write_text(emulated_source(f.read_text())
                                  + "\nnamespace { float4 smem4[EMU_SMEM_MAX / 16]; }\n")
    libs = {}
    for name, src, flags in (("tf32", "tf32", []), ("mma", "mma", []),
                             ("tf32_truncating", "tf32", ["-DHOST_EMU_TRUNCATE"])):
        lib = out / f"lib{name}.so"
        subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", str(HOST),
                        *flags, "-o", str(lib), "-x", "c++",
                        str(out / SOURCES[src].name)], check=True)
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in SIGNATURES[src].items():
            getattr(libs[name], fn).argtypes = list(argtypes)
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def inputs(b, tq, tk, h, d, dtype, masked, causal, seed):
    """q, k, v, mask, m, g_o, g_l made from ``seed`` on the CPU; m from the
    plain forward."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32))
               .to(dtype) for t in (tq, tk, tk))
    mask = torch.from_numpy(rng.random((tq, tk)) < 0.8) if masked else None
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=d**-0.5, causal=causal)
    g_o = torch.from_numpy(rng.standard_normal((b, tq, h, d), dtype=np.float32)).to(dtype)
    g_l = torch.from_numpy(rng.standard_normal((b, h, tq), dtype=np.float32))
    return q, k, v, mask, m, g_o, g_l


def run(lib, kind, q, k, v, mask, m, g_o, g_l, causal):
    """``(dq, dk, dv)`` from the two launch functions of ``lib``."""
    b, tq, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask_u8 = None if mask is None else mask.contiguous().view(torch.uint8)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g_o.data_ptr(),
           None if mask_u8 is None else mask_u8.data_ptr(), m.data_ptr(), g_l.data_ptr())
    rest = (b, h, tq, k.shape[1], d, int(causal), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *g_o.stride()[:3], d**-0.5, None)
    assert getattr(lib, f"flash_bwd_dq_{kind}_launch")(*ins, dq.data_ptr(), *rest) == 0
    assert getattr(lib, f"flash_bwd_dkv_{kind}_launch")(*ins, dk.data_ptr(), dv.data_ptr(),
                                                         *rest) == 0
    return dq, dk, dv


def errors(want, got):
    """max|diff| of each gradient and its band (1e-3 max|ref| + 1e-4 in
    f32, 4 * 2^-8 max|ref| in bf16, as tests/test_torch_cuda.py)."""
    out = []
    for a, b in zip(want, got):
        assert b.dtype == a.dtype and bool(torch.isfinite(b).all())
        a, b = a.float(), b.float()
        top = a.abs().max().item()
        band = 4 * 2**-8 * top if want[0].dtype == torch.bfloat16 else 1e-3 * top + 1e-4
        out.append(((a - b).abs().max().item(), band))
    return out


# (b, tq, tk, h, d, masked, causal): ragged tiles (tq, tk past a multiple of
# 64), a key count past a multiple of 8 and of 4 (the mask staged byte by
# byte) and of 4 only (4-byte copies), each head dim
TF32_CASES = [
    (1, 16, 24, 1, 32, False, False), (1, 16, 24, 1, 32, True, False),
    (2, 8, 8, 3, 64, True, False), (1, 70, 90, 1, 128, False, False),
    (1, 70, 90, 1, 128, True, False), (1, 100, 132, 2, 32, True, False),
    (2, 16, 16, 2, 32, False, True), (1, 100, 100, 1, 64, False, True),
]


@pytest.mark.parametrize("b,tq,tk,h,d,masked,causal", TF32_CASES)
def test_emulated_tf32_backward_matches_plain(kernels, b, tq, tk, h, d, masked, causal):
    args = inputs(b, tq, tk, h, d, torch.float32, masked, causal, seed=tq + tk + d)
    got = run(kernels["tf32"], "tf32", *args, causal)
    want = FA.block_partials_bwd_plain(*args, scale=d**-0.5, causal=causal)
    for err, band in errors(want, got):
        assert err <= band


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_emulated_bf16_backward_matches_plain(kernels, masked):
    """The bf16 kernels, which the card has held in their band since they
    were written, hold it under the emulation too: a check of the
    emulated ldmatrix (both forms) and bf16 mma."""
    args = inputs(1, 70, 90, 1, 128, torch.bfloat16, masked, False, seed=3)
    got = run(kernels["mma"], "mma", *args, False)
    want = FA.block_partials_bwd_plain(*args, scale=128**-0.5)
    for err, band in errors(want, got):
        assert err <= band


def test_emulated_fully_masked_block_gives_zero(kernels):
    """No valid pair: m = -inf on every row, and dq = dk = dv = 0."""
    q, k, v, _, _, g_o, g_l = inputs(1, 40, 72, 2, 32, torch.float32, False, False, seed=4)
    none = torch.zeros((40, 72), dtype=torch.bool)
    _, m, _ = FA.block_partials_plain(q, k, v, none, scale=32**-0.5)
    assert bool(torch.isinf(m).all())
    for grad in run(kernels["tf32"], "tf32", q, k, v, none, m, g_o, g_l, False):
        assert bool((grad == 0).all())


@pytest.mark.parametrize("tq,tk", [(64, 2048), (2048, 64)], ids=["dq", "dkdv"])
def test_tf32_gradient_sums_survive_truncating_accumulation(kernels, tq, tk):
    """With each mma's f32 sum truncated toward zero, as the tensor cores
    accumulate, the gradients summed over 2048 rows stay within 2e-4 of
    plain (about 6e-6 of max|ref|): each streamed tile's sum goes into a
    zeroed partial, added by a rounding f32 add.  One accumulator over all
    2048 rows drifts to 5.6e-4 (dq) and 9.8e-4 (dk)."""
    args = inputs(1, tq, tk, 1, 32, torch.float32, False, False, seed=5)
    got = run(kernels["tf32_truncating"], "tf32", *args, False)
    want = FA.block_partials_bwd_plain(*args, scale=32**-0.5)
    for err, _ in errors(want, got):
        assert err <= 2e-4
