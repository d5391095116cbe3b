"""Flash-attention block partials: the ring-attention hot op.

PyTorch counterpart of ``mpi4jax_tpu/kernels/flash_attention.py`` (its
forward).  One ring step computes attention of the local queries against
one K/V block, as partials in the flash/log-sum-exp form that the caller
merges across steps (``merge_partials``):

    m      = rowmax(scores)                      (B, H, Tq)  f32
    l      = rowsum(exp(scores - m))             (B, H, Tq)  f32
    o_part = exp(scores - m) @ V                 (B, Tq, H, D) in q's dtype

with ``scores = (q . k) * scale`` in f32 and masked entries at ``-inf``.
A row with no attendable key gives ``m = -inf``, ``l = 0``, ``o = 0``.

``flash_block_partials`` dispatches on the tensors' device: CPU tensors
take the plain version (``block_partials_plain``, op for op the JAX
package's jnp path, natively differentiable); CUDA tensors launch one of
the two kernels of ``csrc/flash_fwd.cu``, which replace the TPU kernels
``_kernel`` (non-causal, optional mask: ``flash_fwd``) and
``_kernel_causal`` (the causal diagonal block: ``flash_fwd_causal``), or
raise.  The kernels have no backward yet (ROADMAP Queue 2): a CUDA call
whose inputs require grad raises instead of returning partials whose
gradient would be wrong.

Bound on an H100: operations.  At B=4, T=4096, H=8, D=128 (the width
the JAX package measured its kernel at) a non-causal call does
4 B H T^2 D = 2.749e11 f32 operations, 4.10 ms at 67 TFLOP/s on the CUDA
cores, against 0.080 ms for its 269 MB of inputs and outputs; the causal
call does T(T+1)/2 of the T^2 score pairs.  Built with FMA contraction
on: the parity with the plain version is a band, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = _build.CSRC / "flash_fwd.cu"
HEAD_DIMS = (32, 64, 128)  # the head dims the kernels are built for
DTYPES = (torch.float32, torch.bfloat16)

counter = _build.counter_for("flash_fwd")
counter_causal = _build.counter_for("flash_fwd_causal")
_lib = None

_C = ctypes
_STRIDES = [_C.c_longlong] * 9
_SIGNATURES = {
    "flash_fwd_launch": ([_C.c_void_p] * 7 + [_C.c_int] * 6 + _STRIDES
                         + [_C.c_float, _C.c_void_p]),
    "flash_fwd_causal_launch": ([_C.c_void_p] * 6 + [_C.c_int] * 5 + _STRIDES
                                + [_C.c_float, _C.c_void_p]),
}


def spec():
    """``(source, defines, headers, fmad)`` of the kernels' build."""
    return SOURCE, {}, (), True


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(spec(), _SIGNATURES)
    return _lib


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


def refuse_grad(what: str, *tensors) -> None:
    """Raise if autograd would record ``tensors``: the kernels (and the
    multi-rank exchanges) have no backward yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: no gradient on this path yet; the backward kernels "
            "(_bwd_dq_kernel, _bwd_dkv_kernel) are ROADMAP Queue 2. Call it "
            "under torch.no_grad(), or on CPU tensors for the differentiable "
            "plain version"
        )


def _check_kernel_inputs(q, k, v, mask) -> None:
    dev = q.device
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


def _kernel_partials(q, k, v, mask, scale: float, causal: bool):
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_block_partials: unsupported device {q.device}")
    refuse_grad("flash_block_partials on CUDA", q, k, v)
    _check_kernel_inputs(q, k, v, mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if b * h * tq == 0:
        return o, m, l
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    bf16 = int(q.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    outs = (o.data_ptr(), m.data_ptr(), l.data_ptr())
    if causal:
        err = _library().flash_fwd_causal_launch(
            *ptrs, *outs, b, h, tq, d, bf16, *strides, scale, stream)
        _build.raise_on_error("flash_fwd_causal", err)
        counter_causal.count(torch.cuda.is_current_stream_capturing())
    else:
        mask_u8 = None if mask is None else mask.contiguous().view(torch.uint8)
        err = _library().flash_fwd_launch(
            *ptrs, None if mask_u8 is None else mask_u8.data_ptr(), *outs,
            b, h, tq, tk, d, bf16, *strides, scale, stream)
        _build.raise_on_error("flash_fwd", err)
        counter.count(torch.cuda.is_current_stream_capturing())
    return o, m, l


def flash_block_partials(q, k, v, mask, *, scale: float, causal: bool = False):
    """Streaming-softmax partials of ``softmax(q k^T * scale) v`` for one
    K/V block.

    ``q``: (B, Tq, H, D); ``k``/``v``: (B, Tk, H, D), float32 or bfloat16;
    ``mask``: (Tq, Tk) bool, True = attend (shared across batch and
    heads), or ``None`` for no masking.  ``causal=True`` (requires
    ``mask=None`` and ``Tq == Tk``) is the triangular diagonal block,
    computed by the kernel that skips the key tiles wholly after a query
    tile.  Returns ``(o_part, m, l)``: (B, Tq, H, D) in ``q``'s dtype,
    (B, H, Tq) and (B, H, Tq) in float32.  CPU tensors take the plain
    version; CUDA tensors launch a kernel, or raise."""
    _check_causal(q, k, mask, causal)
    if q.device.type == "cpu":
        return block_partials_plain(q, k, v, mask, scale=scale, causal=causal)
    return _kernel_partials(q, k, v, mask, scale, causal)


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
