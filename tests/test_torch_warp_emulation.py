"""The flash kernels' CUDA sources run on the host, warp instructions
emulated.

``mpi4jax_tpu_torch/csrc/host/`` emulates the CUDA pieces the backward
sources and the forward sources of both dtypes use: a block's threads run as coroutines that
switch at every barrier and warp-collective instruction, and
``mma.sync``, ``ldmatrix``, ``__shfl_xor_sync`` and ``cp.async`` are
computed from every lane's operands.  Each test copies the sources with
their inline-asm helpers replaced by those emulations, builds them with
the host C++ compiler and holds the kernels against the plain version on
the CPU, in the band of ``tests/test_torch_cuda.py``.  So the fragment
maps, the permuted k of the 3xTF32 products, the online softmax's quad
shuffles, the staged masks (the bf16 forward's ride with its K and V in
two cp.async stages) and the causal and ragged bounds run here,
where no card is; the card runs the real instructions in
``tests/test_torch_cuda.py``.  The warps run in lockstep, except in the
last test, where each runs alone from one barrier to the next, so that a
shared stage refilled before every warp has read it gives a wrong
result.  Skips where no C++ compiler is found.
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
SOURCES = {"tf32": FA.BWD_SOURCE, "mma": FA.MMA_SOURCE, "fwd_tf32": FA.SOURCE,
           "fwd_mma": FA.FWD_MMA_SOURCE}
SIGNATURES = {"tf32": FA._TF32_SIGNATURES, "mma": FA._MMA_SIGNATURES,
              "fwd_tf32": FA._SIGNATURES, "fwd_mma": FA._FWD_MMA_SIGNATURES}

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
    """The libraries built for the host: the backward ``tf32`` and ``mma``,
    the f32 forward ``fwd_tf32``, the bf16 forward ``fwd_mma``, and
    ``tf32_truncating`` and ``fwd_tf32_truncating`` (each mma's sum
    truncated, as the tensor cores accumulate)."""
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
                             ("tf32_truncating", "tf32", ["-DHOST_EMU_TRUNCATE"]),
                             ("fwd_tf32", "fwd_tf32", []),
                             ("fwd_tf32_truncating", "fwd_tf32", ["-DHOST_EMU_TRUNCATE"]),
                             ("fwd_mma", "fwd_mma", [])):
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


# ---------------------------------------------------------------------------
# the forward: f32 (csrc/flash_fwd_tf32.cu) and bf16 (csrc/flash_fwd_mma.cu)
# ---------------------------------------------------------------------------


def run_fwd(lib, q, k, v, mask, causal):
    """``(o, m, l)`` from the forward launch function of ``lib``: the
    ``*_mma`` functions for bf16 inputs, the ``*_tf32`` ones for f32."""
    b, tq, h, d = q.shape
    o = torch.empty_like(q)
    m = torch.empty((b, h, tq), dtype=torch.float32)
    l = torch.empty_like(m)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    outs = (o.data_ptr(), m.data_ptr(), l.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    kind = "mma" if q.dtype == torch.bfloat16 else "tf32"
    if causal:
        err = getattr(lib, f"flash_fwd_causal_{kind}_launch")(*ptrs, *outs, b, h, tq, d,
                                                              *strides, d**-0.5, None)
    else:
        mask_u8 = None if mask is None else mask.contiguous().view(torch.uint8)
        err = getattr(lib, f"flash_fwd_{kind}_launch")(
            *ptrs, None if mask_u8 is None else mask_u8.data_ptr(), *outs, b, h, tq,
            k.shape[1], d, *strides, d**-0.5, None)
    assert err == 0
    return o, m, l


def fwd_errors(want, got, causal):
    """max|diff| of o, m, l where plain is finite, and each band: m 1e-6,
    l and o 1e-5, the causal o 1e-4, each as that much absolute plus that
    much of max|ref| (chip_smoke.py's FLASH_REL, FLASH_CAUSAL_O_REL, from
    tests/test_kernels.py:50-55); a bf16 o, causal or not, 4 * 2^-8 of
    max|ref| (its rounding unit, FLASH_BF16_O_REL) with no absolute term;
    infinities must agree exactly and no NaN may appear."""
    out = []
    for name, a, b in zip("oml", want, got):
        assert b.dtype == a.dtype
        a, b = a.float(), b.float()
        assert not bool(torch.isnan(b).any())
        fin = torch.isfinite(a)
        assert torch.equal(fin, torch.isfinite(b)) and torch.equal(a[~fin], b[~fin])
        rel = {"o": 1e-4 if causal else 1e-5, "m": 1e-6, "l": 1e-5}[name]
        atol = rel
        if name == "o" and want[0].dtype == torch.bfloat16:
            rel, atol = 4 * 2**-8, 0.0
        top = a[fin].abs().max().item() if bool(fin.any()) else 0.0
        err = (a[fin] - b[fin]).abs().max().item() if bool(fin.any()) else 0.0
        out.append((err, atol + rel * top))
    return out


def fwd_inputs(b, tq, tk, h, d, masked, seed, dtype=torch.float32):
    """q, k, v of ``dtype`` and the mask (p = 0.8, or None) made from
    ``seed``."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32))
               .to(dtype) for t in (tq, tk, tk))
    return q, k, v, torch.from_numpy(rng.random((tq, tk)) < 0.8) if masked else None


# (b, tq, tk, h, d, masked, causal): ragged tiles (tq past a multiple of
# 64 and of 128, tk past a multiple of 64 and of 128), a masked key count
# past a multiple of 8 and of 4 (the mask staged byte by byte) and of 4
# only (4-byte copies), each head dim, causal blocks of one and of two
# 128-query tiles
FWD_CASES = [
    (1, 70, 90, 1, 128, False, False), (1, 130, 70, 2, 128, False, False),
    (1, 70, 90, 1, 128, True, False), (1, 100, 132, 2, 32, True, False),
    (2, 8, 8, 3, 64, True, False), (1, 16, 24, 1, 32, False, False),
    (2, 16, 16, 2, 32, False, True), (1, 100, 100, 1, 64, False, True),
    (1, 200, 200, 1, 32, False, True),
]


@pytest.mark.parametrize("b,tq,tk,h,d,masked,causal", FWD_CASES)
def test_emulated_tf32_forward_matches_plain(kernels, b, tq, tk, h, d, masked, causal):
    q, k, v, mask = fwd_inputs(b, tq, tk, h, d, masked, seed=tq + tk + d)
    got = run_fwd(kernels["fwd_tf32"], q, k, v, mask, causal)
    want = FA.block_partials_plain(q, k, v, mask, scale=d**-0.5, causal=causal)
    for err, band in fwd_errors(want, got, causal):
        assert err <= band


def test_emulated_tf32_forward_fully_masked_block(kernels):
    """No valid pair: (o, m, l) = (0, -inf, 0) on every row, never NaN;
    and a mask that leaves a third of the rows one key gives those rows
    their plain partials and the rest (0, -inf, 0)."""
    q, k, v, _ = fwd_inputs(1, 40, 72, 2, 32, False, seed=4)
    o, m, l = run_fwd(kernels["fwd_tf32"], q, k, v,
                      torch.zeros((40, 72), dtype=torch.bool), False)
    assert bool(torch.isneginf(m).all()) and bool((l == 0).all()) and bool((o == 0).all())
    mask = torch.zeros((40, 72), dtype=torch.bool)
    mask[::3, 5] = True
    got = run_fwd(kernels["fwd_tf32"], q, k, v, mask, False)
    for err, band in fwd_errors(FA.block_partials_plain(q, k, v, mask, scale=32**-0.5),
                                got, False):
        assert err <= band


def test_tf32_forward_survives_truncating_accumulation(kernels):
    """With each mma's f32 sum truncated toward zero, as the tensor cores
    accumulate, 64 queries against 2048 keys at D = 128 hold every band:
    the scores sum 32 columns of D, and p v a 32-key tile, into zeroed
    partials added by rounding f32 adds.  Measured here: m 2.9e-6 (band
    5.4e-6), l 4.6e-4 (band 2.1e-3), o 4.1e-5 (band 2.1e-4); without the
    truncation m 2.2e-6, and most of it is the plain version's own f32
    rounding (against a float64 forward: plain 1.8e-6, kernel 7.5e-7
    untruncated, 1.5e-6 truncated).  With P V summed in one accumulator
    o misses its band (4.9e-4, a mutation run)."""
    q, k, v, _ = fwd_inputs(1, 64, 2048, 1, 128, False, seed=5)
    got = run_fwd(kernels["fwd_tf32_truncating"], q, k, v, None, False)
    want = FA.block_partials_plain(q, k, v, None, scale=128**-0.5)
    for err, band in fwd_errors(want, got, False):
        assert err <= band


# (b, tq, tk, h, d, masked, causal) of the bf16 forward: unmasked with a
# ragged last query and key tile, the full head dim; masked with a key
# count past a multiple of 4 (the mask staged byte by byte) and of 4 only
# (4-byte copies); causal blocks of one and of two 64-query tiles, one
# ragged; several query tiles over one ragged key tile
BF16_FWD_CASES = [
    (1, 70, 90, 1, 128, False, False), (1, 70, 90, 1, 128, True, False),
    (1, 100, 132, 2, 32, True, False), (2, 16, 16, 2, 32, False, True),
    (1, 100, 100, 1, 64, False, True), (1, 130, 70, 2, 128, False, False),
]


@pytest.mark.parametrize("b,tq,tk,h,d,masked,causal", BF16_FWD_CASES)
def test_emulated_bf16_forward_matches_plain(kernels, b, tq, tk, h, d, masked, causal):
    """The bf16 forward, which the card has held in its band since it was
    written, in the band under the emulation: its two cp.async stages of K,
    V and the mask, its fragment maps and its causal and ragged bounds."""
    q, k, v, mask = fwd_inputs(b, tq, tk, h, d, masked, seed=tq + tk + d,
                               dtype=torch.bfloat16)
    got = run_fwd(kernels["fwd_mma"], q, k, v, mask, causal)
    want = FA.block_partials_plain(q, k, v, mask, scale=d**-0.5, causal=causal)
    for err, band in fwd_errors(want, got, causal):
        assert err <= band


# ---------------------------------------------------------------------------
# warps run apart: each warp alone from one barrier to the next
# ---------------------------------------------------------------------------

# the emulation's warp-serial schedules (host_emu_schedule in
# csrc/host/cuda_runtime.h): warps in ascending and in descending order
WARP_ORDERS = {"ascending": 1, "descending": -1}

# (kernel, b, tq, tk, h, d, masked, causal): the staged mask by 4-byte
# copies and byte by byte, a causal forward of two query tiles, and the
# masked backward of each dtype, each over several key tiles; the bf16
# forward's masked stages by 4-byte copies over three key tiles, and its
# causal forward over four query tiles
APART_CASES = [
    ("fwd_tf32", 1, 100, 132, 2, 32, True, False),
    ("fwd_tf32", 1, 70, 90, 1, 128, True, False),
    ("fwd_tf32", 1, 200, 200, 1, 32, False, True),
    ("tf32", 1, 100, 132, 2, 32, True, False),
    ("mma", 1, 70, 90, 1, 128, True, False),
    ("fwd_mma", 1, 100, 132, 2, 32, True, False),
    ("fwd_mma", 1, 200, 200, 1, 32, False, True),
]


@pytest.fixture(params=WARP_ORDERS)
def warps_apart(request, kernels):
    """The libraries with every launch run warp-serial, in the order of the
    parameter; lockstep again afterwards."""
    for lib in kernels.values():
        lib.host_emu_schedule(WARP_ORDERS[request.param])
    yield kernels
    for lib in kernels.values():
        lib.host_emu_schedule(0)


@pytest.mark.parametrize("kind,b,tq,tk,h,d,masked,causal", APART_CASES)
def test_emulated_kernels_hold_with_warps_run_apart(warps_apart, kind, b, tq, tk, h, d,
                                                    masked, causal):
    """A shared stage that one warp refills while another still reads it,
    with no barrier between, gives a wrong result when the warps run one
    after another (the lockstep schedule cannot show it: there every warp
    reads before any writes).  Each kernel holds its band under both
    orders."""
    lib = warps_apart[kind]
    if kind.startswith("fwd"):
        dtype = torch.bfloat16 if kind == "fwd_mma" else torch.float32
        q, k, v, mask = fwd_inputs(b, tq, tk, h, d, masked, seed=tq + tk + d, dtype=dtype)
        got = run_fwd(lib, q, k, v, mask, causal)
        want = FA.block_partials_plain(q, k, v, mask, scale=d**-0.5, causal=causal)
        errs = fwd_errors(want, got, causal)
    else:
        dtype = torch.bfloat16 if kind == "mma" else torch.float32
        args = inputs(b, tq, tk, h, d, dtype, masked, causal, seed=tq + tk + d)
        got = run(lib, kind, *args, causal)
        errs = errors(FA.block_partials_bwd_plain(*args, scale=d**-0.5, causal=causal), got)
    for err, band in errs:
        assert err <= band
