"""Flash-attention block partials: the ring-attention hot op.

PyTorch counterpart of ``mpi4jax_tpu/kernels/flash_attention.py``.  One
ring step computes attention of the local queries against one K/V block,
as partials in the flash/log-sum-exp form that the caller merges across
steps (``merge_partials``):

    m      = rowmax(scores)                      (B, H, Tq)  f32
    l      = rowsum(exp(scores - m))             (B, H, Tq)  f32
    o_part = exp(scores - m) @ V                 (B, Tq, H, D) in q's dtype

with ``scores = (q . k) * scale`` in f32 and masked entries at ``-inf``.
A row with no attendable key gives ``m = -inf``, ``l = 0``, ``o = 0``.

``flash_block_partials`` dispatches on the tensors' device.  CPU tensors
take the plain version (``block_partials_plain``, op for op the JAX
package's jnp path, natively differentiable), or, with
``custom_backward=True``, the same autograd ``Function`` as the card (the
counterpart of the JAX package's ``interpret=True``).  CUDA tensors go
through ``FlashPartials``.  Its forward launches one kernel that
replaces the TPU kernel ``_kernel`` (non-causal, optional mask) or
``_kernel_causal`` (the causal diagonal block); its backward launches
two kernels that replace ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``.
Each is chosen by dtype, and each has its own launch counter:

- f32, on the tensor cores, every product an error-compensated 3xTF32
  ``mma.sync`` (the helpers of ``csrc/mma_tf32.cuh``):
  ``flash_fwd_tf32`` and ``flash_fwd_causal_tf32`` of
  ``csrc/flash_fwd_tf32.cu``, ``flash_bwd_dq_tf32`` and
  ``flash_bwd_dkv_tf32`` of ``csrc/flash_bwd_tf32.cu``;
- bf16, on the tensor cores (``mma.sync``, with the warp-level helpers
  of ``csrc/mma_bf16.cuh``): ``flash_fwd_mma`` and
  ``flash_fwd_causal_mma`` of ``csrc/flash_fwd_mma.cu``,
  ``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma`` of
  ``csrc/flash_bwd_mma.cu``.

A CUDA call launches the kernels or raises; nothing falls back to the
plain version.

The backward holds ``m`` constant, as the JAX package's custom VJP does:
its cotangent is dropped, which is exact for every consumer that merges
and normalises the partials (the result does not depend on the
stabilizer), and makes a function of ``m`` alone have zero gradient.

Bound on an H100: operations.  At B=4, T=4096, H=8, D=128 (the width
the JAX package measured its kernel at) a non-causal forward does
4 B H T^2 D = 2.749e11 operations: in f32 by 3xTF32 three times that
at the 494.7 TFLOP/s TF32 rate, 1.667 ms (4.10 ms at 67 TFLOP/s on the
CUDA cores), against 0.080 ms for its 269 MB of inputs and outputs; in
bf16 0.278 ms at the 989 TFLOP/s tensor-core rate; the dq
kernel does 6 B H T^2 D (6.15 ms on the CUDA cores) and the dk/dv kernel
8 B H T^2 D (8.21 ms), in f32 by 3xTF32 three times that at the 494.7
TFLOP/s TF32 rate (2.50 and 3.33 ms), in bf16 0.417 and 0.556 ms at the
989 TFLOP/s tensor-core rate; causal calls do T(T+1)/2 of the T^2 score
pairs.  Built with FMA contraction on: the parity with the plain
versions is a band, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = _build.CSRC / "flash_fwd_tf32.cu"
BWD_SOURCE = _build.CSRC / "flash_bwd_tf32.cu"
MMA_SOURCE = _build.CSRC / "flash_bwd_mma.cu"
FWD_MMA_SOURCE = _build.CSRC / "flash_fwd_mma.cu"
MMA_HEADER = _build.CSRC / "mma_bf16.cuh"  # included by all four sources
TF32_HEADER = _build.CSRC / "mma_tf32.cuh"  # included by SOURCE and BWD_SOURCE
HEAD_DIMS = (32, 64, 128)  # the head dims the kernels are built for
DTYPES = (torch.float32, torch.bfloat16)

counter_tf32 = _build.counter_for("flash_fwd_tf32")  # f32
counter_causal_tf32 = _build.counter_for("flash_fwd_causal_tf32")  # f32
counter_mma = _build.counter_for("flash_fwd_mma")  # bf16
counter_causal_mma = _build.counter_for("flash_fwd_causal_mma")  # bf16
counter_bwd_dq_tf32 = _build.counter_for("flash_bwd_dq_tf32")  # f32
counter_bwd_dkv_tf32 = _build.counter_for("flash_bwd_dkv_tf32")  # f32
counter_bwd_dq_mma = _build.counter_for("flash_bwd_dq_mma")
counter_bwd_dkv_mma = _build.counter_for("flash_bwd_dkv_mma")
_libs = {}  # loaded libraries by source

_C = ctypes
_STRIDES = [_C.c_longlong] * 9
_SIGNATURES = {
    "flash_fwd_tf32_launch": ([_C.c_void_p] * 7 + [_C.c_int] * 5 + _STRIDES
                              + [_C.c_float, _C.c_void_p]),
    "flash_fwd_causal_tf32_launch": ([_C.c_void_p] * 6 + [_C.c_int] * 4 + _STRIDES
                                     + [_C.c_float, _C.c_void_p]),
}
# the bf16 forward kernels take the same arguments
_FWD_MMA_SIGNATURES = {name.replace("_tf32_launch", "_mma_launch"): args
                       for name, args in _SIGNATURES.items()}
_BWD_STRIDES = [_C.c_longlong] * 12
_TF32_SIGNATURES = {
    "flash_bwd_dq_tf32_launch": ([_C.c_void_p] * 8 + [_C.c_int] * 6 + _BWD_STRIDES
                                 + [_C.c_float, _C.c_void_p]),
    "flash_bwd_dkv_tf32_launch": ([_C.c_void_p] * 9 + [_C.c_int] * 6 + _BWD_STRIDES
                                  + [_C.c_float, _C.c_void_p]),
}
# the bf16 kernels take the same arguments
_MMA_SIGNATURES = {name.replace("_tf32_launch", "_mma_launch"): args
                   for name, args in _TF32_SIGNATURES.items()}


def fwd_tf32_spec():
    """``(source, defines, headers, fmad)`` of the f32 tensor-core
    (3xTF32) forward kernels' build."""
    return SOURCE, {}, (MMA_HEADER, TF32_HEADER), True


def fwd_mma_spec():
    """``(source, defines, headers, fmad)`` of the bf16 tensor-core
    forward kernels' build."""
    return FWD_MMA_SOURCE, {}, (MMA_HEADER,), True


def tf32_spec():
    """``(source, defines, headers, fmad)`` of the f32 tensor-core
    (3xTF32) backward kernels' build."""
    return BWD_SOURCE, {}, (MMA_HEADER, TF32_HEADER), True


def mma_spec():
    """``(source, defines, headers, fmad)`` of the bf16 tensor-core
    backward kernels' build."""
    return MMA_SOURCE, {}, (MMA_HEADER,), True


def _loaded(spec_of, signatures):
    """The library of ``spec_of()``, built and loaded at first use."""
    source = spec_of()[0]
    if source not in _libs:
        _libs[source] = _build.load(spec_of(), signatures)
    return _libs[source]


def block_partials_plain(q, k, v, mask, *, scale: float, causal: bool = False):
    """The partials in plain PyTorch, op for op the JAX package's jnp path
    (``_partials_impl``): f32 scores from the upcast inputs, the mask as
    ``-inf``, ``p`` rounded to ``v``'s dtype before the PV product."""
    tq, tk = q.shape[1], k.shape[1]
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, -torch.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isinf(m), 0.0, m) if mask is not None else m
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.to(q.dtype), m, l


def _check_causal(q, k, mask, causal: bool) -> None:
    if causal:
        if mask is not None:
            raise ValueError("causal=True replaces mask; pass mask=None")
        if q.shape[1] != k.shape[1]:
            raise ValueError(
                f"causal=True is the diagonal-block pattern and needs "
                f"Tq == Tk, got {q.shape[1]} vs {k.shape[1]}"
            )


def block_partials_bwd_plain(q, k, v, mask, m, g_o, g_l, *, scale: float,
                             causal: bool = False):
    """``(dq, dk, dv)`` of the partials in plain PyTorch, by the backward
    kernels' formula (not by autograd): ``p = exp(s - m_safe)`` where a
    (query, key) pair is valid, else 0; ``dp = g_o v^T + g_l``;
    ``ds = p dp scale``; ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T g_o``.
    The inputs are upcast to f32 and the results cast to the primal
    dtypes; ``m``'s cotangent takes no part (see the module docstring)."""
    tq, tk = q.shape[1], k.shape[1]
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g_o))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf) + g_l.float()[..., None]
    ds = p * dp * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_shapes(q, k, v, mask) -> None:
    """The kernels' shape and dtype contract (``_check_kernel_inputs``
    without the memory layout)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_block_partials: q, k, v must be (B, T, H, D)")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if tuple(k.shape) != (b, tk, h, d) or tuple(v.shape) != (b, tk, h, d):
        raise ValueError(
            f"flash_block_partials: k and v must be {(b, tk, h, d)}, got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_block_partials: q, k, v must share one dtype, "
                         f"float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_block_partials: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_block_partials: B*H = {b * h} exceeds 65535")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (tq, k.shape[1])):
        raise ValueError(
            f"flash_block_partials: mask must be bool {(tq, k.shape[1])}")


def _check_kernel_inputs(q, k, v, mask) -> None:
    _check_kernel_shapes(q, k, v, mask)
    dev = q.device
    tq, tk = q.shape[1], k.shape[1]
    align = 4 * q.element_size()  # each thread loads 4 elements at once
    for t in (q, k, v):
        if t.device != dev:
            raise ValueError("flash_block_partials: q, k, v on different devices")
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % align:
            raise ValueError(
                "flash_block_partials: the kernels read (B, T, H, D) with a "
                "contiguous last dim, other strides multiples of 4 and "
                f"{align}-byte aligned data; got strides {t.stride()}"
            )
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (tq, tk) \
                or mask.device != dev:
            raise ValueError(
                f"flash_block_partials: mask must be bool {(tq, tk)} on {dev}")


def _meta_partials(q, k, v, mask):
    """The forward kernels' shape rule for ``meta`` tensors (the
    verifier's abstract run, ``analysis/``): ``(o, m, l)`` of the kernels'
    shapes and dtypes, nothing launched."""
    _check_kernel_shapes(q, k, v, mask)
    b, tq, h, _ = q.shape
    m = torch.empty((b, h, tq), dtype=torch.float32, device="meta")
    outs = torch.empty(q.shape, dtype=q.dtype, device="meta"), m, torch.empty_like(m)
    return _build.meta_outputs("flash_fwd", (q, k, v, mask), outs)


def _check_device(q) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_block_partials: unsupported device {q.device}")


def _kernel_partials(q, k, v, mask, scale: float, causal: bool):
    _check_device(q)
    _check_kernel_inputs(q, k, v, mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if b * h * tq == 0:
        return o, m, l
    q, k, v = _input_layout(q, k, v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    outs = (o.data_ptr(), m.data_ptr(), l.data_ptr())
    name, launch, launch_counter = _fwd_kernel(q, causal)
    if causal:
        err = launch(*ptrs, *outs, b, h, tq, d, *strides, scale, stream)
    else:
        mask_u8 = None if mask is None else mask.contiguous().view(torch.uint8)
        err = launch(*ptrs, None if mask_u8 is None else mask_u8.data_ptr(), *outs,
                     b, h, tq, tk, d, *strides, scale, stream)
    _build.raise_on_error(name, err)
    launch_counter.count(torch.cuda.is_current_stream_capturing())
    return o, m, l


def _fwd_route(dtype, causal: bool):
    """``(name, spec_of, signatures)`` of the forward kernel for ``dtype``:
    the tensor-core kernels of ``csrc/flash_fwd_mma.cu`` for bf16, the
    3xTF32 tensor-core kernels of ``csrc/flash_fwd_tf32.cu`` for f32."""
    name = "flash_fwd_causal" if causal else "flash_fwd"
    if dtype == torch.bfloat16:
        return name + "_mma", fwd_mma_spec, _FWD_MMA_SIGNATURES
    return name + "_tf32", fwd_tf32_spec, _SIGNATURES


def _fwd_kernel(q, causal: bool):
    """``(name, C function, counter)`` of the forward kernel for ``q``'s
    dtype (``_fwd_route``), its library built and loaded at first use."""
    name, spec_of, signatures = _fwd_route(q.dtype, causal)
    lib = _loaded(spec_of, signatures)
    return name, getattr(lib, name + "_launch"), _build.counter_for(name)


def _input_layout(q, k, v):
    """``(q, k, v)`` as the kernels of their dtype read them: the bf16
    kernels copy 16 bytes at once (``cp.async``), so a bf16 view whose
    strides are not multiples of 8 elements, or whose data is not 16-byte
    aligned, becomes a contiguous copy; f32 tensors, which the f32 kernels
    copy 4 elements at once (the input check asks for that layout), are
    read in place."""
    if q.dtype == torch.bfloat16:
        return tuple(_kernel_layout(t, 8) for t in (q, k, v))
    return q, k, v


def _kernel_layout(t, elems: int):
    """``t`` as a kernel that reads ``elems`` elements at once takes it:
    the last dim contiguous, the other strides multiples of ``elems`` and
    the data aligned to ``elems`` elements; else a contiguous copy (a copy
    of the layout, not of the computation)."""
    if t.stride(3) != 1 or any(s % elems for s in t.stride()[:3]) \
            or t.data_ptr() % (elems * t.element_size()):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _bwd_launch_args(q, k, v, mask, m, g_o, g_l, causal: bool):
    """The checks of a backward launch and the C arguments both kernels
    share: ``(keep, inputs, dims, strides, stream)``.  Both read 16 bytes
    at once (``cp.async``), 4 f32 or 8 bf16 elements: where q, k, v or g_o
    miss that alignment the kernels get a contiguous copy, so the backward
    takes every input the forward took (the forward's check already asks
    f32 for strides in multiples of 4 and 16-byte aligned data)."""
    _check_device(q)
    _check_kernel_inputs(q, k, v, mask)
    b, tq, h, d = q.shape
    if tuple(g_o.shape) != tuple(q.shape) or tuple(m.shape) != (b, h, tq) \
            or tuple(g_l.shape) != (b, h, tq):
        raise ValueError("flash_block_partials backward: g_o must be shaped "
                         f"like q {tuple(q.shape)}, m and g_l {(b, h, tq)}")
    elems = 8 if q.dtype == torch.bfloat16 else 4
    # a cotangent comes as autograd made it: the kernels read it by strides
    # when they can
    g_o = _kernel_layout(g_o.to(q.dtype), elems)
    q, k, v = _input_layout(q, k, v)
    m = m.float().contiguous()
    g_l = g_l.float().contiguous()
    mask_u8 = None if mask is None else mask.contiguous().view(torch.uint8)
    # the tensors ride along so that they outlive the launch
    keep = (q, k, v, g_o, m, g_l, mask_u8)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g_o.data_ptr(),
           None if mask_u8 is None else mask_u8.data_ptr(), m.data_ptr(),
           g_l.data_ptr())
    dims = (b, h, tq, k.shape[1], d, int(causal))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *g_o.stride()[:3])
    return keep, ins, dims, strides, torch.cuda.current_stream(q.device).cuda_stream


def _bwd_route(dtype, kind: str):
    """``(name, spec_of, signatures)`` of the ``kind`` ("dq" or "dkv")
    backward kernel for ``dtype``: the bf16 tensor-core kernels of
    ``csrc/flash_bwd_mma.cu`` for bf16, the 3xTF32 tensor-core kernels of
    ``csrc/flash_bwd_tf32.cu`` for f32."""
    if dtype == torch.bfloat16:
        return f"flash_bwd_{kind}_mma", mma_spec, _MMA_SIGNATURES
    return f"flash_bwd_{kind}_tf32", tf32_spec, _TF32_SIGNATURES


def _bwd_kernel(q, kind: str):
    """``(name, C function, counter)`` of the ``kind`` backward kernel for
    ``q``'s dtype (``_bwd_route``), its library built and loaded at first
    use."""
    name, spec_of, signatures = _bwd_route(q.dtype, kind)
    lib = _loaded(spec_of, signatures)
    return name, getattr(lib, name + "_launch"), _build.counter_for(name)


def flash_bwd_dq(q, k, v, mask, m, g_o, g_l, *, scale: float,
                 causal: bool = False):
    """``dq`` of the partials from one launch of ``flash_bwd_dq_mma``
    (bf16) or ``flash_bwd_dq_tf32`` (f32) (CUDA tensors; the arguments of
    ``block_partials_bwd``)."""
    keep, ins, dims, strides, stream = _bwd_launch_args(q, k, v, mask, m, g_o,
                                                        g_l, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    name, launch, counter = _bwd_kernel(q, "dq")
    err = launch(*ins, dq.data_ptr(), *dims, *strides, scale, stream)
    _build.raise_on_error(name, err)
    counter.count(torch.cuda.is_current_stream_capturing())
    del keep
    return dq


def flash_bwd_dkv(q, k, v, mask, m, g_o, g_l, *, scale: float,
                  causal: bool = False):
    """``(dk, dv)`` of the partials from one launch of
    ``flash_bwd_dkv_mma`` (bf16) or ``flash_bwd_dkv_tf32`` (f32) (CUDA
    tensors; the arguments of ``block_partials_bwd``)."""
    keep, ins, dims, strides, stream = _bwd_launch_args(q, k, v, mask, m, g_o,
                                                        g_l, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if dk.numel() == 0 or q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    name, launch, counter = _bwd_kernel(q, "dkv")
    err = launch(*ins, dk.data_ptr(), dv.data_ptr(), *dims, *strides, scale,
                 stream)
    _build.raise_on_error(name, err)
    counter.count(torch.cuda.is_current_stream_capturing())
    del keep
    return dk, dv


def block_partials_bwd(q, k, v, mask, m, g_o, g_l, *, scale: float,
                       causal: bool = False):
    """``(dq, dk, dv)`` of the partials from the saved ``(q, k, v, m)`` and
    the cotangents of ``o`` and ``l``: the plain version for CPU tensors,
    the two backward kernels for CUDA tensors (or raise)."""
    _check_causal(q, k, mask, causal)
    if q.device.type == "cpu":
        return block_partials_bwd_plain(q, k, v, mask, m, g_o, g_l,
                                        scale=scale, causal=causal)
    if q.device.type == "meta":  # the backward kernels' shape rule
        _check_kernel_shapes(q, k, v, mask)
        outs = tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                     for t in (q, k, v))
        return _build.meta_outputs("flash_bwd", (q, k, v, mask, m, g_o, g_l),
                                   outs)
    dq = flash_bwd_dq(q, k, v, mask, m, g_o, g_l, scale=scale, causal=causal)
    dk, dv = flash_bwd_dkv(q, k, v, mask, m, g_o, g_l, scale=scale,
                           causal=causal)
    return dq, dk, dv


class FlashPartials(torch.autograd.Function):
    """The partials with their blockwise backward (the JAX package's
    ``_partials`` custom VJP): the forward saves ``(q, k, v, m)``, the
    backward recomputes ``p`` tile by tile, so no (Tq, Tk) tensor is kept,
    and drops ``m``'s cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal):
        if q.device.type == "cpu":
            o, m, l = block_partials_plain(q, k, v, mask, scale=scale,
                                           causal=causal)
        elif q.device.type == "meta":
            o, m, l = _meta_partials(q, k, v, mask)
        else:
            o, m, l = _kernel_partials(q, k, v, mask, scale, causal)
        ctx.save_for_backward(q, k, v, m)
        ctx.mask, ctx.scale, ctx.causal = mask, scale, causal
        return o, m, l

    @staticmethod
    def backward(ctx, g_o, _g_m, g_l):
        q, k, v, m = ctx.saved_tensors
        dq, dk, dv = block_partials_bwd(q, k, v, ctx.mask, m, g_o, g_l,
                                        scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_block_partials(q, k, v, mask, *, scale: float, causal: bool = False,
                         custom_backward: bool = False):
    """Streaming-softmax partials of ``softmax(q k^T * scale) v`` for one
    K/V block.

    ``q``: (B, Tq, H, D); ``k``/``v``: (B, Tk, H, D), float32 or bfloat16;
    ``mask``: (Tq, Tk) bool, True = attend (shared across batch and
    heads), or ``None`` for no masking.  ``causal=True`` (requires
    ``mask=None`` and ``Tq == Tk``) is the triangular diagonal block,
    computed by the kernel that skips the key tiles wholly after a query
    tile.  Returns ``(o_part, m, l)``: (B, Tq, H, D) in ``q``'s dtype,
    (B, H, Tq) and (B, H, Tq) in float32.  CUDA tensors launch the
    kernels (forward, and backward under autograd), or raise.  CPU
    tensors take the natively differentiable plain version, or with
    ``custom_backward=True`` the plain forward and backward of the
    blockwise ``FlashPartials``.  ``meta`` tensors (the verifier's
    abstract run) take the kernels' shape rule and launch nothing."""
    _check_causal(q, k, mask, causal)
    if q.device.type == "meta" and not torch.is_grad_enabled():
        return _meta_partials(q, k, v, mask)
    if q.device.type == "cpu" and not custom_backward:
        return block_partials_plain(q, k, v, mask, scale=scale, causal=causal)
    return FlashPartials.apply(q, k, v, mask, scale, causal)


def merge_partials(acc, m, l, o_new, m_new, l_new):
    """Log-sum-exp merge of two partial-attention states (the flash combine
    rule); ``m``/``l`` are (B, H, Tq), ``acc``/``o_new`` (B, Tq, H, D).  A
    bfloat16 ``acc`` times the f32 weights gives an f32 result, as in the
    JAX package."""
    m_out = torch.maximum(m, m_new)
    m_safe = torch.where(torch.isinf(m_out), 0.0, m_out)
    c_old = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
    c_new = torch.where(torch.isinf(m_new), 0.0, torch.exp(m_new - m_safe))
    l_out = l * c_old + l_new * c_new

    def to_qhd(c):
        return c.transpose(1, 2)[..., None]

    acc_out = acc * to_qhd(c_old) + o_new * to_qhd(c_new)
    return acc_out, m_out, l_out
