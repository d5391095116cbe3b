"""Sequence-parallel attention on the communication ops, forward and backward.

PyTorch counterpart of ``mpi4jax_tpu/attention.py``.  Every function takes
rank-local ``(B, T, H, D)`` tensors; the global sequence is the
rank-order concatenation of the shards.

- ``ring_attention`` (Liu et al. 2023): each rank keeps its queries and
  rotates its K/V shard around the ring with ``sendrecv(dest=shift(1))``,
  folding one block of partials per step (``merge_partials``).  Causal
  runs skip the blocks that lie wholly in the future (a rank computes
  steps ``0..rank``), drop the mask on the blocks wholly in the past and
  run the diagonal block through the causal kernel.  Every rank rotates
  at every step, computed or not.  Its gradient is the memory-efficient
  backward of the JAX package (``_RingAttention``): only rank-local
  tensors are saved, K/V are rotated around the ring again, and the dK/dV
  accumulators travel with their blocks back to their owners.
- ``ulysses_attention`` (Jacobs et al. 2023): one ``alltoall`` re-shards
  from sequence-parallel to head-parallel, full-sequence flash attention
  runs on the local head group, and one more ``alltoall`` shards back;
  autograd runs the same exchanges (``alltoall`` is its own transpose)
  in its backward.

The block partials and their backward come from
``kernels/flash_attention.py``: the CUDA kernels on the card, the plain
versions on the CPU.  Every function here composes with ``torch.func``
(``vmap``, ``grad``, ``vjp``, ``jacrev``): the exchanges and the
partials have vmap rules of their own, one exchange and one launch a
call.  ``ring_attention(memory_efficient_grad=False)``
differentiates through the forward op by op: the partials' own backward,
the merges, and the transposes of the rotations (``sendrecv``'s reverse
route).  Every rank must run the transpose of every rotation, in the same
order: K and V rotate as one stacked tensor (two chains could be ordered
differently by autograd on ranks whose graphs differ, and gloo would then
swap dK and dV of equal shapes without an error), and the last rotation
is tied to the output (``_Tie``), so that a causal rank, which stops
computing after its own step, still runs the rotations' backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kernels.flash_attention import (
    block_partials_bwd,
    flash_block_partials,
    merge_partials,
)
from .ops.alltoall import alltoall
from .ops.sendrecv import sendrecv
from .parallel.comm import Comm
from .parallel.rankspec import shift

__all__ = [
    "flash_attention",
    "reference_attention",
    "ring_attention",
    "ulysses_attention",
]


def reference_attention(q, k, v, *, causal: bool = False):
    """Plain full attention (B, T, H, D): the single-device ground truth,
    which materialises the (T, T) scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _to_qhd(x):
    """(B, H, T) row statistics -> (B, T, H, 1), to scale (B, T, H, D)."""
    return x.transpose(1, 2)[..., None]


def _normalize(acc, l, dtype):
    """``acc / l`` per row (rows with ``l = 0`` stay 0), in ``dtype``."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / _to_qhd(l_safe)).to(dtype)


def flash_attention(q, k, v, causal: bool = False):
    """Single-device attention through one call of the flash partials and
    the normalisation, so the (T, T) scores never reach device memory,
    forward or backward (the partials' blockwise backward kernels)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, _, l = flash_block_partials(q, k, v, None, scale=scale, causal=causal)
    return _normalize(o, l, q.dtype)


def _comm_of(comm: Optional[Comm], what: str) -> Comm:
    if comm is None:
        raise ValueError(f"{what}: pass comm= (no default communicator yet)")
    return comm


def ring_attention(q, k, v, *, comm: Optional[Comm] = None,
                   causal: bool = False, memory_efficient_grad: bool = True):
    """Exact blockwise attention over a K/V ring; returns this rank's shard
    of the output.

    ``memory_efficient_grad=True`` (default) differentiates through the
    ring's own backward (``_RingAttention``), which saves only rank-local
    tensors and re-rotates K/V.  ``False`` differentiates through the
    forward op by op (see the module docstring): it keeps every block's
    partials for the backward and recomputes no forward."""
    comm = _comm_of(comm, "ring_attention")
    if memory_efficient_grad:
        return _RingAttention.apply(q, k, v, comm, causal)[0]
    out, _m, _l = _ring_forward(q, k, v, comm, causal)
    return out


class _Tie(torch.autograd.Function):
    """``out`` with ``tied`` made inputs of it: the backward passes ``out``'s
    cotangent through and gives ``tied`` zeros, so that autograd runs the
    backward of whatever produced ``tied`` on every rank.  Its vmap rule is
    generated (a clone and a pass-through batch as they are).  The zeros
    are made like ``tied``, so that under ``vmap`` they are batched as it
    is: the rotations' transposes then send equal messages on every rank,
    whether a rank's causal ring read its last block or not."""

    generate_vmap_rule = True

    @staticmethod
    def forward(out, tied):
        return out.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (tied,) = ctx.saved_tensors
        return g, torch.zeros_like(tied)

    @staticmethod
    def jvp(ctx, t_out, _):
        return t_out


def _ring_forward(q, k, v, comm: Comm, causal: bool):
    """The ring forward; returns the normalised output and the final
    streaming-softmax stats ``(m, l)``.  Where autograd follows K or V,
    they rotate as one stacked tensor and the last rotation is tied to the
    output (the op-by-op backward's order; see the module docstring);
    elsewhere as two exchanges a step, which time faster through gloo's
    host staging (PERF.md, ``chip_smoke.py --ring``)."""
    size, rank = comm.Get_size(), comm.Get_rank()
    b, t_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)

    m = torch.full((b, h, t_loc), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, t_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros_like(q)
    k_blk, v_blk = k, v
    stacked = size > 1 and torch.is_grad_enabled() and (k.requires_grad
                                                          or v.requires_grad)
    kv = torch.stack([k, v]) if stacked else None
    for step in range(size):
        # k_blk holds the shard of rank - step (mod size): the diagonal
        # block at step 0, wholly past keys while step <= rank, wholly
        # future keys after that (skipped when causal)
        if not causal or step <= rank:
            o_new, m_new, l_new = flash_block_partials(
                q, k_blk, v_blk, None, scale=scale,
                causal=causal and step == 0)
            acc, m, l = merge_partials(acc, m, l, o_new, m_new, l_new)
        if step + 1 < size and stacked:
            kv, _ = sendrecv(kv, kv, dest=shift(1), comm=comm)
            k_blk, v_blk = kv.unbind(0)
        elif step + 1 < size:
            k_blk, _ = sendrecv(k_blk, k_blk, dest=shift(1), comm=comm)
            v_blk, _ = sendrecv(v_blk, v_blk, dest=shift(1), comm=comm)
    out = _normalize(acc, l, q.dtype)
    if stacked:
        out = _Tie.apply(out, kv)
    return out, m, l


class _RingAttention(torch.autograd.Function):
    """The ring with the JAX package's memory-efficient backward
    (``_ring_me_fwd``/``_ring_me_bwd``).

    With the final stats ``(m, l)`` the output decomposes over blocks as
    ``out = sum_b o_b e^{m_b - m} / l``, so block b's partials get the
    cotangents ``g_o_b = (g / l) e^{m_b - m}`` and
    ``g_l_b = -(sum_d g out / l) e^{m_b - m}``; the weights' own
    derivative (the ``m_b`` cotangent) is dropped, exact because the
    decomposition does not depend on the stabilizers.  Each step
    recomputes one block's ``m_b`` with a forward call, runs the backward
    of the partials on it, and adds dK/dV into buffers that rotate with
    the block: after ``size`` hops every rank holds its own dK/dV with
    every rank's contributions.  Per rank the backward makes
    ``2 (size - 1)`` K/V rotations and ``2 size`` dK/dV ones.

    Under ``torch.func`` the vmap rule is generated: forward and backward
    run on the batched tensors, whose rotations (``sendrecv``) and
    partials (``flash_block_partials``, ``block_partials_bwd``) have rules
    of their own, one exchange and one launch a call; the accumulators
    are therefore added out of place.  Forward mode raises, as the JAX
    package's ``custom_vjp`` does."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, comm, causal):
        # (m, l) are outputs so that setup_context can save them
        return _ring_forward(q, k, v, comm, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, comm, causal = inputs
        out, m, l = output
        ctx.mark_non_differentiable(m, l)
        # rank-local residuals only: O(T / size) per rank
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.comm, ctx.causal = comm, causal

    @staticmethod
    def backward(ctx, g, _g_m, _g_l):
        q, k, v, out, m, l = ctx.saved_tensors
        comm, causal = ctx.comm, ctx.causal
        size, rank = comm.Get_size(), comm.Get_rank()
        scale = 1.0 / math.sqrt(q.shape[-1])
        l_safe = torch.where(l == 0.0, 1.0, l)
        m_safe = torch.where(torch.isinf(m), 0.0, m)
        g = g.float()
        # cotangents of the (acc, l) pair that gave out = acc / l
        g_acc = g / _to_qhd(l_safe)
        g_l = -(g * out.float()).sum(-1).transpose(1, 2) / l_safe

        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(size):
            if not causal or step <= rank:
                blk_causal = causal and step == 0
                _, m_b, _ = flash_block_partials(q, k_blk, v_blk, None,
                                                 scale=scale, causal=blk_causal)
                w = torch.exp(m_b - m_safe)  # stabilizer reweight
                g_ob = (g_acc * _to_qhd(w)).to(q.dtype)
                dq_b, dk_b, dv_b = block_partials_bwd(
                    q, k_blk, v_blk, None, m_b, g_ob, g_l * w, scale=scale,
                    causal=blk_causal)
                dq = dq + dq_b.float()
                dk = dk + dk_b.float()
                dv = dv + dv_b.float()
            # dK/dV travel with their block and need all size hops to get
            # home; K/V are not read after the last step
            if step + 1 < size:
                k_blk, _ = sendrecv(k_blk, k_blk, dest=shift(1), comm=comm)
                v_blk, _ = sendrecv(v_blk, v_blk, dest=shift(1), comm=comm)
            dk, _ = sendrecv(dk, dk, dest=shift(1), comm=comm)
            dv, _ = sendrecv(dv, dv, dest=shift(1), comm=comm)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise TypeError(
            "ring_attention(memory_efficient_grad=True): forward-mode "
            "differentiation (jvp, jacfwd) is not supported by the ring's "
            "own backward, as the JAX package's custom_vjp ring refuses it; "
            "pass memory_efficient_grad=False to differentiate through the "
            "forward op by op")


def ulysses_attention(q, k, v, *, comm: Optional[Comm] = None,
                      causal: bool = False):
    """Exact attention by all-to-all head exchange.  Input shards
    ``(B, T_local, H, D)`` with ``H % size == 0``.  Differentiable: the
    backward runs the transposes of the four ``alltoall`` exchanges and
    the partials' backward on the local head group."""
    comm = _comm_of(comm, "ulysses_attention")
    size = comm.Get_size()
    b, t_loc, h, d = q.shape
    if h % size != 0:
        raise ValueError(f"ulysses needs heads ({h}) divisible by ranks ({size})")
    h_loc = h // size

    def seq_to_heads(x):
        # (B, T_l, H, D) -> rows = head groups -> (B, T_g, H/size, D)
        x = x.reshape(b, t_loc, size, h_loc, d).permute(2, 0, 1, 3, 4)
        x, _ = alltoall(x, comm=comm)  # row i: rank i's T_l for my heads
        return x.permute(1, 0, 2, 3, 4).reshape(b, size * t_loc, h_loc, d)

    def heads_to_seq(x):
        # (B, T_g, H/size, D) -> (B, T_l, H, D)
        x = x.reshape(b, size, t_loc, h_loc, d).permute(1, 0, 2, 3, 4)
        x, _ = alltoall(x, comm=comm)
        return x.permute(1, 2, 0, 3, 4).reshape(b, t_loc, h, d)

    out = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal)
    return heads_to_seq(out)
