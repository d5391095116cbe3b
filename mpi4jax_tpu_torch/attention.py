"""Sequence-parallel attention on the communication ops: the forward.

PyTorch counterpart of ``mpi4jax_tpu/attention.py``.  Every function takes
rank-local ``(B, T, H, D)`` tensors; the global sequence is the
rank-order concatenation of the shards.

- ``ring_attention`` (Liu et al. 2023): each rank keeps its queries and
  rotates its K/V shard around the ring with ``sendrecv(dest=shift(1))``,
  folding one block of partials per step (``merge_partials``).  Causal
  runs skip the blocks that lie wholly in the future (a rank computes
  steps ``0..rank``), drop the mask on the blocks wholly in the past and
  run the diagonal block through the causal kernel.  Every rank rotates
  at every step, computed or not.
- ``ulysses_attention`` (Jacobs et al. 2023): one ``alltoall`` re-shards
  from sequence-parallel to head-parallel, full-sequence flash attention
  runs on the local head group, and one more ``alltoall`` shards back.

The block partials come from ``kernels/flash_attention.py``: the CUDA
kernels on the card, the plain version on the CPU.  Only the forward is
ported: the ring's memory-efficient backward and the backward kernels are
ROADMAP Queue 2.  A multi-rank call whose inputs require grad raises, as
does any kernel call, since ``torch.distributed`` records no gradient for
the exchanged blocks; one rank on the CPU stays differentiable.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kernels.flash_attention import (
    flash_block_partials,
    merge_partials,
    refuse_grad,
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


def _normalize(acc, l, dtype):
    """``acc / l`` per row (rows with ``l = 0`` stay 0), in ``dtype``."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe.transpose(1, 2)[..., None]).to(dtype)


def flash_attention(q, k, v, causal: bool = False):
    """Single-device attention through one call of the flash partials and
    the normalisation, so the (T, T) scores never reach device memory."""
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
    of the output.  ``memory_efficient_grad`` is accepted for parity with
    the JAX package, whose custom backward is not ported yet."""
    comm = _comm_of(comm, "ring_attention")
    out, _m, _l = _ring_forward(q, k, v, comm, causal)
    return out


def _ring_forward(q, k, v, comm: Comm, causal: bool):
    """The ring forward; returns the normalised output and the final
    streaming-softmax stats ``(m, l)``."""
    size, rank = comm.Get_size(), comm.Get_rank()
    if size > 1:
        refuse_grad("ring_attention over several ranks", q, k, v)
    b, t_loc, h, d = q.shape
    scale = 1.0 / math.sqrt(d)

    m = torch.full((b, h, t_loc), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, t_loc), dtype=torch.float32, device=q.device)
    acc = torch.zeros_like(q)
    k_blk, v_blk = k, v
    for step in range(size):
        # k_blk holds the shard of rank - step (mod size): the diagonal
        # block at step 0, wholly past keys while step <= rank, wholly
        # future keys after that (skipped when causal)
        if not causal or step <= rank:
            o_new, m_new, l_new = flash_block_partials(
                q, k_blk, v_blk, None, scale=scale,
                causal=causal and step == 0)
            acc, m, l = merge_partials(acc, m, l, o_new, m_new, l_new)
        if step + 1 < size:
            k_blk, _ = sendrecv(k_blk, k_blk, dest=shift(1), comm=comm)
            v_blk, _ = sendrecv(v_blk, v_blk, dest=shift(1), comm=comm)
    return _normalize(acc, l, q.dtype), m, l


def ulysses_attention(q, k, v, *, comm: Optional[Comm] = None,
                      causal: bool = False):
    """Exact attention by all-to-all head exchange.  Input shards
    ``(B, T_local, H, D)`` with ``H % size == 0``."""
    comm = _comm_of(comm, "ulysses_attention")
    size = comm.Get_size()
    b, t_loc, h, d = q.shape
    if h % size != 0:
        raise ValueError(f"ulysses needs heads ({h}) divisible by ranks ({size})")
    if size > 1:
        refuse_grad("ulysses_attention over several ranks", q, k, v)
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
