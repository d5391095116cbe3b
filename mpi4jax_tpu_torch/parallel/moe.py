"""Expert-parallel mixture-of-experts: capacity-bucketed ``alltoall``
dispatch and combine around a per-expert MLP.

PyTorch counterpart of ``mpi4jax_tpu/parallel/moe.py``.  ``k`` ranks each
own one expert, a top-1 gate routes each rank's tokens, and the layer's
two exchanges are alltoalls:

- **dispatch**: every rank buckets its tokens by expert into a
  ``(experts, capacity, d)`` buffer (tokens beyond an expert's capacity
  are dropped, the top-1 discipline) and one ``alltoall`` ships bucket
  ``e`` to rank ``e``;
- **expert compute**: each rank runs its expert's MLP over the
  ``k * capacity`` rows it received;
- **combine**: the mirror ``alltoall`` ships every processed bucket back
  to its source, where the gate probability weighs it into the output
  (a dropped token's row is zero).

With ``chunks > 1`` (default ``MPI4JAX_TPU_MOE_CAPACITY_CHUNKS``, 2) the
expert compute and the combine split into capacity chunks: chunk ``i``'s
combine is issued with ``alltoall_start`` (``ops/_async.py``) before
chunk ``i+1``'s MLP runs, and the waits land after the last chunk's
compute.  The exchanges are the port's flat ``alltoall``: the JAX
package's hierarchical ICI/DCN lowering waits for the topology layer
(``ops/_hierarchy.py``, ``parallel/topology.py``, ROADMAP "Blocked").

**Determinism contract**, as in the JAX package: the gate and capacity
math is pure and seeded (``init_moe_params`` draws the JAX package's
weights from the same numpy seeds), every bucket operation is a one-hot
``einsum`` (a product by 1 and sums of zeros: exact in f32), and dispatch
and combine are fixed permutations.  So the layer on ``k`` ranks equals
the single-process :func:`reference_moe` fold up to the expert MLP's
products, and the chunked combine equals the synchronous one bit for
bit: the expert MLP runs in fixed blocks of ``MLP_BLOCK`` capacity slots
whatever the chunking (``expert_rows``; the JAX package runs one product
a chunk, which on cuBLAS changes the last bits with the chunk's row
count).  The tests pin it on the CPU, ``chip_smoke.py`` phase 14 on the
card.

The gate helpers take the array module ``xp`` (``numpy`` or ``torch``) as
the JAX package's take ``numpy`` or ``jax.numpy``, so the pure tests drive
the same functions on numpy arrays; :func:`reference_moe` is a numpy fold
(:func:`fold_layer` is the same fold on either module).  The layer's
gradients flow through the ``alltoall``'s transpose (``ops/alltoall.py:
_AllToAll``); a start whose payload autograd follows runs the synchronous
exchange (``ops/_async.py``), so the overlap pipeline differentiates too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = [
    "MoEParams",
    "capacity_for",
    "init_moe_params",
    "gate_tokens",
    "dispatch_tensor",
    "expert_mlp",
    "moe_layer",
    "reference_moe",
]


def _is_torch(xp) -> bool:
    return getattr(xp, "__name__", "") == "torch"


def capacity_for(tokens: int, experts: int, factor: float = 1.25) -> int:
    """Per-expert token capacity of one rank's dispatch bucket:
    ``ceil(tokens * factor / experts)``, at least 1; every rank shares it,
    so the dispatch ``alltoall`` has one shape on every rank."""
    if tokens < 1 or experts < 1:
        raise ValueError(
            f"capacity_for needs tokens >= 1 and experts >= 1, got "
            f"tokens={tokens}, experts={experts}"
        )
    if factor <= 0:
        raise ValueError(f"capacity factor must be > 0, got {factor}")
    return max(1, -(-int(tokens * factor) // experts))


class MoEParams(NamedTuple):
    """One rank's MoE parameters: the router, the same on every rank, and
    this rank's expert MLP (rank ``e`` owns expert ``e``)."""

    w_gate: object   # (d, experts), replicated
    w_in: object     # (d, d_ff), this rank's expert, layer 1
    w_out: object    # (d_ff, d), this rank's expert, layer 2


def init_moe_params(d: int, d_ff: int, experts: int, rank: int = 0,
                    seed: int = 0) -> MoEParams:
    """Rank ``rank``'s parameters as float32 numpy arrays, drawn as the JAX
    package draws them: the router from ``seed`` (the same on every rank),
    the expert from ``seed * 7919 + 31 + rank``."""
    gate_rng = np.random.default_rng(seed)
    w_gate = gate_rng.standard_normal((d, experts)).astype(np.float32) * 0.3
    ex_rng = np.random.default_rng(seed * 7919 + 31 + rank)
    w_in = ex_rng.standard_normal((d, d_ff)).astype(np.float32) * 0.2
    w_out = ex_rng.standard_normal((d_ff, d)).astype(np.float32) * 0.2
    return MoEParams(w_gate=w_gate, w_in=w_in, w_out=w_out)


def gate_tokens(xp, x, w_gate):
    """Top-1 gating of tokens ``x`` (``(tokens, d)``): ``(assignment,
    gate_prob)``, the expert each token routes to and its softmax
    probability."""
    logits = x @ w_gate
    a = xp.argmax(logits, axis=-1)
    z = xp.exp(logits - xp.amax(logits, axis=-1, keepdims=True))
    probs = z / xp.sum(z, axis=-1, keepdims=True)
    take = xp.take_along_dim if _is_torch(xp) else xp.take_along_axis
    gate = take(probs, a[:, None], axis=-1)[:, 0]
    return a, gate


def dispatch_tensor(xp, assignment, experts: int, capacity: int):
    """The one-hot dispatch tensor ``D[t, e, c]``: 1 where token ``t`` is
    the ``c``-th token (in position order) routed to expert ``e`` and
    ``c < capacity``.  Bucketing, un-bucketing and the combine are einsums
    against it: no data-dependent gather order."""
    if _is_torch(xp):
        def arange(n):
            return xp.arange(n, device=assignment.device)

        def f32(mask):
            return mask.to(xp.float32)
    else:
        arange = xp.arange

        def f32(mask):
            return mask.astype(xp.float32)

    onehot = f32(assignment[:, None] == arange(experts)[None, :])
    pos = xp.cumsum(onehot, axis=0) * onehot - onehot  # 0-based in-bucket
    slot = f32(pos[:, :, None] == arange(capacity)[None, None, :])
    return slot * onehot[:, :, None]


def expert_mlp(xp, z, w_in, w_out):
    """One expert's feed-forward over a token block: a ``tanh`` MLP (on
    torch, the block's rows as one 2-D product each layer)."""
    if not _is_torch(xp):
        return xp.tanh(z @ w_in) @ w_out
    rows = z.reshape(-1, z.shape[-1])
    out = xp.tanh(rows @ w_in) @ w_out
    return out.reshape(tuple(z.shape[:-1]) + (out.shape[-1],))


# capacity slots of one block of the expert MLP (``expert_rows``)
MLP_BLOCK = 64


def expert_rows(received, lo: int, hi: int, w_in, w_out):
    """Capacity slots ``[lo, hi)`` of every source's bucket (``received``,
    ``(k, capacity, d)``, a torch tensor) through the expert MLP, in
    blocks of ``MLP_BLOCK`` slots aligned at multiples of ``MLP_BLOCK``
    (the last zero-padded), each one product of ``k * MLP_BLOCK`` rows.

    A row's bits then do not depend on the chunking: every chunk size
    computes each slot in the same block, at the same row of a product of
    the same shape.  One product over a chunk's rows would not do: cuBLAS
    and the CPU's BLAS pick their kernels by the row count, and the
    chunked layer drifted from the synchronous one by up to 4.3e-5 at
    ``d`` 1024, ``d_ff`` 2048 on an H100 (and in the last bit at the
    tests' width), outside ``tests/test_moe.py``'s band.  A block a chunk
    boundary cuts is computed by both chunks."""
    import torch
    import torch.nn.functional as F

    _k, cap, _d = received.shape
    parts = []
    for b0 in range((lo // MLP_BLOCK) * MLP_BLOCK, hi, MLP_BLOCK):
        b1 = min(b0 + MLP_BLOCK, cap)
        block = F.pad(received[:, b0:b1], (0, 0, 0, MLP_BLOCK - (b1 - b0)))
        out = expert_mlp(torch, block, w_in, w_out)
        parts.append(out[:, max(lo, b0) - b0:min(hi, b1) - b0])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def moe_layer(x, params: MoEParams, *, comm=None, token=None,
              capacity_factor: float = 1.25, chunks: Optional[int] = None):
    """The expert-parallel MoE layer on this rank's tokens ``x``
    (``(tokens, d)``; ``params`` this rank's tensors on ``x``'s device,
    ``convert.moe_params_from_jax`` carries the JAX package's): gate,
    capacity-bucketed dispatch ``alltoall``, this rank's expert MLP,
    combine ``alltoall``, gate-weighted output.

    ``chunks`` (default ``MPI4JAX_TPU_MOE_CAPACITY_CHUNKS``) pipelines the
    combine as the module docstring says; ``chunks=1`` is the synchronous
    layer.  The async starts need a region: outside one the layer opens
    its own over ``comm``.  Returns ``(y, token)``, ``y`` shaped like
    ``x``; a token dropped beyond its expert's capacity gives a zero
    row."""
    from .region import current_context, resolve_comm, spmd

    comm = resolve_comm(comm)
    if current_context() is None:
        return spmd(_layer, comm=comm, unroll=1)(x, params, comm, token,
                                                 capacity_factor, chunks)
    return _layer(x, params, comm, token, capacity_factor, chunks)


def _layer(x, params, comm, token, capacity_factor, chunks):
    import torch

    from ..ops import _async
    from ..ops.alltoall import alltoall
    from ..utils import config

    k = comm.Get_size()
    tokens, _d = x.shape
    capacity = capacity_for(tokens, k, capacity_factor)
    if chunks is None:
        chunks = config.moe_capacity_chunks()
    chunks = max(1, min(int(chunks), capacity))

    a, gate = gate_tokens(torch, x, params.w_gate)
    D = dispatch_tensor(torch, a, k, capacity)          # (tokens, k, cap)
    dispatch = torch.einsum("tec,td->ecd", D, x)        # (k, cap, d)
    received, tok = alltoall(dispatch, comm=comm, token=token)
    # received[g, c]: rank g's c-th token for this rank's expert

    w_in, w_out = params.w_in, params.w_out
    sizes = _async.overlap_chunk_split(capacity, chunks)
    if len(sizes) == 1:
        processed = expert_rows(received, 0, capacity, w_in, w_out)
        combined, tok = alltoall(processed, comm=comm, token=tok)
    else:
        # chunk i's combine is in flight while chunk i+1's MLP runs
        handles, off = [], 0
        for csz in sizes:
            out = expert_rows(received, off, off + csz, w_in, w_out)
            off += csz
            h, tok = _async.alltoall_start(out, comm=comm, token=tok)
            handles.append(h)
        parts = []
        for h in handles:
            part, tok = _async.alltoall_wait(h, token=tok)
            parts.append(part)
        combined = torch.cat(parts, dim=1)
    # combined[e, c]: this rank's c-th token as expert e processed it
    y = torch.einsum("tec,ecd->td", D, combined) * gate[:, None]
    return y, tok


def fold_layer(xp, x_global, params, capacity: int):
    """The whole layer over ``k`` ranks in one process: ``x_global`` is
    ``(k, tokens, d)`` (rank-major), ``params`` each rank's
    :class:`MoEParams` in the same module's arrays; returns the matching
    ``(k, tokens, d)`` output.  No wire is simulated: dispatch and combine
    are fixed permutations.  On torch the expert MLP runs in the layer's
    blocks (``expert_rows``), so that the fold on one device gives the
    layer's bits there; on numpy it is the JAX package's one product a
    bucket."""
    k = x_global.shape[0]
    experts = k
    disp, Ds, gates = [], [], []
    for r in range(k):
        a, gate = gate_tokens(xp, x_global[r], params[r].w_gate)
        D = dispatch_tensor(xp, a, experts, capacity)
        Ds.append(D)
        gates.append(gate)
        disp.append(xp.einsum("tec,td->ecd", D, x_global[r]))
    disp = xp.stack(disp)                       # (k, e, c, d)
    # alltoall: expert e receives bucket e of every rank
    received = xp.stack([disp[:, e] for e in range(experts)])  # (e, k, c, d)
    mlp = ((lambda z, p: expert_rows(z, 0, capacity, p.w_in, p.w_out))
           if _is_torch(xp) else (lambda z, p: expert_mlp(xp, z, p.w_in, p.w_out)))
    processed = xp.stack([mlp(received[e], params[e]) for e in range(experts)])
    # combine: rank r's view of expert e's output bucket
    return xp.stack([
        xp.einsum("tec,ecd->td", Ds[r], processed[:, r]) * gates[r][:, None]
        for r in range(k)])


def reference_moe(x_global, d_ff: int, experts: int, *, seed: int = 0,
                  capacity_factor: float = 1.25):
    """Single-process numpy reference of the whole layer: ``x_global`` is
    ``(ranks, tokens, d)`` and the result the matching global output.
    Rebuilds every expert's weights from the seeded init the ranks use and
    replays the same capacity discipline (the JAX package's fold, bit for
    bit)."""
    k, tokens, d = x_global.shape
    assert k == experts, (k, experts)
    capacity = capacity_for(tokens, experts, capacity_factor)
    params = [init_moe_params(d, d_ff, experts, rank=r, seed=seed)
              for r in range(k)]
    return fold_layer(np, x_global, params, capacity).astype(
        x_global.dtype, copy=False)
