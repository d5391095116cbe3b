"""The serving workload: a small tensor-parallel transformer decoder.

PyTorch counterpart of ``mpi4jax_tpu/serving/model.py``.  Megatron-style
tensor parallelism over the serving comm: QKV and the MLP up-projection
are COLUMN-parallel (each rank holds ``heads / k`` attention heads and
``ffn / k`` hidden units), the attention output and MLP down-projections
ROW-parallel: each rank computes a partial sum that exactly TWO SUM
``allreduce``s a layer complete (``[bucket, dim]`` in decode, ``[bucket,
P, dim]`` in prefill).  They are the serving hot path's whole
communication, and their leading dimension is the BUCKET.

The products are ``torch.matmul`` and the attention ``torch.einsum``, as
the JAX package computes them with ``@`` and ``jnp.einsum`` outside any
Pallas kernel: no kernel of the port runs here.

Both step functions are module-level and shape-polymorphic (every size
comes from the argument shapes), rank bodies run inside a region
(``spmd``, or ``compile`` which pins them): the allreduces take the
region's comm.  Conventions (rank-local tensors; ``B`` = bucket, ``L`` =
max_len, ``S`` = KV slots, ``Hl`` = local heads, ``dh`` = head dim,
``Fl`` = local ffn):

- ``kk``/``vv`` ``[S+1, L, Hl, dh]``: this rank's heads of the KV pool;
  row ``S`` is the padding lanes' scratch row (``serving/kvcache.py``);
- ``tok_table [S+1, L] int32``: token ``i`` of a sequence at column
  ``i`` (prompt at ``0..plen-1``, generated from ``plen`` on);
- ``lens [B] int32``: KV entries present per lane; the lane's latest
  token sits at column ``lens`` and the NEXT decode step writes its KV
  (after prefill ``lens == plen``, with the first generated token at
  column ``plen``);
- sampling is greedy argmax (the first of equal maxima, as
  ``jnp.argmax``), the same on every rank because the logits come from
  allreduced activations.

Every write is out of place (``kvcache.py``), so a step leaves its
arguments as they were.  ``decode_step`` keeps the megastep carry
contract: 11 tensors in, a like-structured 11-tuple out with the same
dtypes (``argmax``'s int64 is cast back to int32), so
``compile(..., unroll=N)`` runs it as an N-token megastep.

The parameters: one unsharded master (numpy, float32, the JAX package's
seeded draws in its order, so the master is bit for bit the JAX
package's), and rank ``r``'s shards of it (:func:`shard_params`);
:func:`global_params` gives the JAX package's layout, every rank's
shard stacked on a leading axis, which ``convert.serving_state_from_jax``
and the tests read.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["decode_step", "global_params", "init_master", "prefill_logits",
           "prefill_step", "shard_params"]

NEG_INF = -1e9


def _attention_mix(x, wo, w1, w2):
    """Row-parallel attention-out and MLP: the two partial-sum products
    and their completing allreduces (the serving comm pattern)."""
    from ..ops import SUM, allreduce

    attn_full, _ = allreduce(x @ wo, op=SUM)
    return attn_full, lambda y: allreduce(
        torch.relu(y @ w1) @ w2, op=SUM)[0]


def _softmax_last(scores):
    """The JAX package's softmax: ``exp(s - max)`` over its sum."""
    att = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return att / att.sum(dim=-1, keepdim=True)


def decode_step(emb, wqkv, wo, w1, w2, kk, vv, tok_table, last_tok, lens,
                slots):
    """One token step for a bucketed batch of lanes (rank body).

    Embeds each lane's latest token (column ``lens``), writes its K/V at
    position ``lens``, attends over ``0..lens``, and records the sampled
    next token at column ``lens + 1``.  Returns the whole carry
    (parameters included, unchanged): the megastep contract.
    """
    from .kvcache import scatter_step

    n_local_heads, head_dim = kk.shape[2], kk.shape[3]
    max_len = kk.shape[1]
    batch = last_tok.shape[0]
    slots_l, lens_l = slots.long(), lens.long()

    x = emb[last_tok.long()]                       # [B, D]
    qkv = (x @ wqkv).reshape(batch, 3, n_local_heads, head_dim)
    q = qkv[:, 0] * (head_dim ** -0.5)
    kk = scatter_step(kk, slots, lens, qkv[:, 1])
    vv = scatter_step(vv, slots, lens, qkv[:, 2])

    krows = kk[slots_l]                            # [B, L, Hl, dh]
    vrows = vv[slots_l]
    scores = torch.einsum("bhd,blhd->bhl", q, krows)
    live = (torch.arange(max_len, device=lens.device)[None, :]
            <= lens_l[:, None])
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    att = _softmax_last(scores)
    ctx = torch.einsum("bhl,blhd->bhd", att, vrows)
    ctx = ctx.reshape(batch, n_local_heads * head_dim)

    attn_full, mlp = _attention_mix(ctx, wo, w1, w2)
    x = x + attn_full
    x = x + mlp(x)

    logits = x @ emb.T                             # [B, V], replicated
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    tok_table = tok_table.index_put((slots_l, lens_l + 1), nxt)
    return (emb, wqkv, wo, w1, w2, kk, vv, tok_table, nxt, lens + 1, slots)


def _prefill_block(emb, wqkv, wo, w1, w2, n_local_heads, head_dim, prompts):
    """The block over a padded prompt buffer: ``(qkv, x)``, the
    projections ``[B, P, 3, Hl, dh]`` and the block's output ``[B, P, D]``
    (replicated after the two allreduces)."""
    batch, pad_len = prompts.shape
    x = emb[prompts.long()]                        # [B, P, D]
    qkv = (x @ wqkv).reshape(batch, pad_len, 3, n_local_heads, head_dim)
    q = qkv[:, :, 0] * (head_dim ** -0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, qkv[:, :, 1])
    causal = torch.tril(torch.ones((pad_len, pad_len), dtype=torch.bool,
                                   device=prompts.device))
    scores = torch.where(causal[None, None, :, :], scores, NEG_INF)
    att = _softmax_last(scores)
    ctx = torch.einsum("bhqk,bkhd->bqhd", att, qkv[:, :, 2])
    ctx = ctx.reshape(batch, pad_len, n_local_heads * head_dim)

    attn_full, mlp = _attention_mix(ctx, wo, w1, w2)
    x = x + attn_full
    x = x + mlp(x)
    return qkv, x


def _last_logits(emb, x, plens):
    """The logits ``[B, V]`` at each lane's last live position."""
    x_last = x[torch.arange(x.shape[0], device=x.device), plens.long() - 1]
    return x_last @ emb.T


def prefill_step(emb, wqkv, wo, w1, w2, kk, vv, tok_table, prompts, plens,
                 slots):
    """Prompt processing for a bucketed batch (rank body).

    Causal self-attention over the padded prompt buffer ``[B, P]``, K/V
    written for every position (what lies past ``plen`` is masked by
    ``lens`` downstream and overwritten as the sequence grows), and the
    FIRST generated token sampled from the last live position and
    recorded at column ``plen``.  Returns ``(kk, vv, tok_table,
    first_token)``.
    """
    from .kvcache import scatter_prefill

    qkv, x = _prefill_block(emb, wqkv, wo, w1, w2, kk.shape[2], kk.shape[3],
                            prompts)
    kk = scatter_prefill(kk, slots, qkv[:, :, 1])
    vv = scatter_prefill(vv, slots, qkv[:, :, 2])
    first = torch.argmax(_last_logits(emb, x, plens), dim=-1).to(torch.int32)
    tok_table = tok_table.index_put((slots.long(), plens.long()), first)
    return (kk, vv, tok_table, first)


def prefill_logits(emb, wqkv, wo, w1, w2, prompts, plens, *, head_dim):
    """The logits ``[B, V]`` that ``prefill_step`` samples its first token
    from (rank body; the port's addition): how close the two largest are
    says whether a greedy token could turn on the last bit of a sum."""
    _qkv, x = _prefill_block(emb, wqkv, wo, w1, w2, wo.shape[0] // head_dim,
                             head_dim, prompts)
    return _last_logits(emb, x, plens)


# ---------------------------------------------------------------------------
# parameters: one unsharded master copy, re-sharded per world size
# ---------------------------------------------------------------------------
#
# The master lives on the host (numpy) and is what the elastic ShardStore
# commits: after a drain shrinks the tensor-parallel group, the survivors
# re-derive their k'-way shards from it, the same on every rank, with no
# exchange.


def init_master(vocab: int, dim: int, heads: int, head_dim: int, ffn: int,
                seed: int = 0) -> dict:
    """Seeded unsharded parameters (numpy, float32), drawn as the JAX
    package draws them."""
    if dim != heads * head_dim:
        raise ValueError(
            f"dim ({dim}) must equal heads * head_dim "
            f"({heads} * {head_dim})"
        )
    rng = np.random.default_rng(seed)

    def w(*shape, scale):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    return {
        "emb": w(vocab, dim, scale=0.1),
        "wqkv": w(dim, 3, heads, head_dim, scale=dim ** -0.5),
        "wo": w(heads, head_dim, dim, scale=dim ** -0.5),
        "w1": w(dim, ffn, scale=dim ** -0.5),
        "w2": w(ffn, dim, scale=ffn ** -0.5),
    }


def _rank_shards(master: dict, k: int, rank: int) -> tuple:
    """Rank ``rank``'s five numpy blocks of the master at world size ``k``:
    ``emb`` replicated, QKV and MLP-up column-parallel (head and
    hidden-unit blocks), attention-out and MLP-down row-parallel."""
    heads, head_dim = master["wqkv"].shape[2], master["wqkv"].shape[3]
    dim, ffn = master["w1"].shape
    if heads % k or ffn % k:
        raise ValueError(
            f"heads ({heads}) and ffn ({ffn}) must both divide by the "
            f"tensor-parallel world size {k}"
        )
    if not 0 <= rank < k:
        raise ValueError(f"rank {rank} out of range for {k} ranks")
    hl, fl = heads // k, ffn // k
    r = rank
    return (master["emb"],
            master["wqkv"][:, :, r * hl:(r + 1) * hl, :].reshape(
                dim, 3 * hl * head_dim),
            master["wo"][r * hl:(r + 1) * hl].reshape(hl * head_dim, dim),
            master["w1"][:, r * fl:(r + 1) * fl],
            master["w2"][r * fl:(r + 1) * fl, :])


def shard_params(master: dict, k: int, rank: int, device=None) -> tuple:
    """Rank ``rank``'s five parameter tensors (f32, on ``device``; ``None``
    keeps them on the CPU) at tensor-parallel world size ``k``: the JAX
    package's ``shard_params(master, k)[i][rank]`` for each of the five."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in _rank_shards(master, k, rank))


def global_params(master: dict, k: int) -> tuple:
    """The JAX package's ``shard_params(master, k)``: the five numpy arrays
    with every rank's shard stacked on a leading axis."""
    blocks = [_rank_shards(master, k, r) for r in range(k)]
    return tuple(np.stack([b[i] for b in blocks]) for i in range(5))
