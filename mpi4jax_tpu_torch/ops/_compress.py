"""The codecs' encode and decode, and the error-feedback allreduce.

PyTorch counterpart of the part of ``mpi4jax_tpu/ops/_compress.py`` that
runs on one host (byte math in ``ops/_codec.py``):

- ``bf16``: a cast to bfloat16 and back, one rounding;
- ``fp8``: per-chunk max-abs scaled float8_e4m3fn: a float32 payload,
  padded with zeros to whole chunks of ``FP8_CHUNK``, gets one scale
  ``maxabs / 448`` a chunk (1 for an all-zero chunk), and each element
  ``x / scale`` rounded to e4m3fn.  The scale is divided by a 0-dim
  tensor, never by the Python number 448 (a CUDA division by a Python
  number multiplies by its reciprocal), so the scales and the bytes are
  the JAX package's bit for bit; every scaled value is at most 448 in
  magnitude, where PyTorch's cast (which saturates above 448) and the
  JAX package's (NaN above 464) agree.  The JAX package runs this with
  float32 subnormals flushed to zero (XLA on the CPU, as a TPU has
  none), so the port flushes them too where that changes a result: in
  the input of the encode and the output of the decode.  It does not
  flush the scale: below ``448 * 2**-126`` the JAX package's scale
  flushes to zero and its chunk decodes to NaN, the port's to the values.

``ef_allreduce`` is the error-feedback allreduce of a gradient tree: per
leaf, ``comp = g + residual``, ``q = roundtrip(comp, codec)``, the new
residual ``comp - q``, and ``q`` allreduced.  With the codec off the
roundtrip is the identity and the residual stays exactly zero.

The inter-host appliers (``inter_allreduce``, ``inter_reduce_scatter``,
``inter_alltoall``, ``inter_bcast`` and the fp8 butterfly) are the
compressed twins of the inter-host phases of ``ops/_hierarchy.py``, run
only where the codec resolved for a float32 payload's bucket is on, and
only on that leg: the one place where a codec shrinks the bytes that
travel (``wire_inter_bytes``).  ``bf16`` casts, runs the exact exchange on
the bf16 tensor and casts back (reduction arithmetic in bf16); ``fp8``
has no reduction arithmetic, so its allreduce and reduce-scatter are a
butterfly whose every stage ships the encoded (q, scale) pair and adds in
float32 on the receiving side, SUM only (any other ``Op`` takes bf16);
the pure-routing legs (alltoall, bcast) encode once and ship the pair.
Elsewhere the codec changes the values (through the roundtrip), not the
bytes.
"""

from __future__ import annotations

import torch

from ..utils.tree import tree_flatten, tree_map
from . import _codec

FP8_CHUNK = _codec.FP8_CHUNK
_QMAX = 448.0  # float8_e4m3fn's largest finite value


def fp8_wire_dtype() -> torch.dtype:
    """The dtype fp8-quantized elements ship as: float8_e4m3fn."""
    return torch.float8_e4m3fn


def _flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with float32 subnormals replaced by zeros of their sign."""
    return torch.where(t.abs() < torch.finfo(torch.float32).tiny, t * 0, t)


def _encode_rows(x2d: torch.Tensor):
    """Quantize a (rows, cols) float32 tensor per chunk of ``FP8_CHUNK``:
    ``q`` (rows, nchunks, FP8_CHUNK) float8_e4m3fn and ``scale``
    (rows, nchunks, 1) float32."""
    rows, cols = x2d.shape
    padded = -(-max(cols, 1) // FP8_CHUNK) * FP8_CHUNK
    xp = torch.nn.functional.pad(_flush_subnormal(x2d), (0, padded - cols))
    ch = xp.reshape(rows, padded // FP8_CHUNK, FP8_CHUNK)
    maxabs = ch.abs().amax(dim=-1, keepdim=True)
    qmax = torch.tensor(_QMAX, dtype=maxabs.dtype, device=maxabs.device)
    scale = torch.where(maxabs > 0, maxabs / qmax, torch.ones_like(maxabs))
    q = (ch / scale).to(torch.float8_e4m3fn)
    return q, scale.to(torch.float32)


def _decode_rows(q: torch.Tensor, scale: torch.Tensor, cols: int) -> torch.Tensor:
    """Inverse of ``_encode_rows``: (rows, cols) float32."""
    ch = _flush_subnormal(q.to(torch.float32) * scale)
    return ch.reshape(ch.shape[0], -1)[:, :cols]


def encode_fp8(x: torch.Tensor):
    """``(q, scale)`` of any-shape float32 ``x``, as one row."""
    return _encode_rows(x.reshape(1, -1))


def decode_fp8(q: torch.Tensor, scale: torch.Tensor, shape, n: int) -> torch.Tensor:
    """Back to ``shape`` (``n`` elements) from ``encode_fp8``'s pair."""
    return _decode_rows(q, scale, n).reshape(shape)


def roundtrip(x: torch.Tensor, codec) -> torch.Tensor:
    """``x`` through ``codec`` and back (``None``/``"off"``: ``x`` itself):
    the error the codec brings."""
    if not codec or codec == "off":
        return x
    if codec == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if codec == "fp8":
        q, s = encode_fp8(x)
        return decode_fp8(q, s, x.shape, x.numel()).to(x.dtype)
    raise ValueError(f"unknown wire codec {codec!r}")


def _effective(codec, op):
    """fp8 has reduction arithmetic for SUM only: any other ``Op`` takes
    the bf16 cast."""
    from ._base import SUM

    if codec == "fp8" and op is not None and op != SUM:
        return "bf16"
    return codec


# ---------------------------------------------------------------------------
# the compressed inter-host phases (the _hierarchy inter-phase twins)
# ---------------------------------------------------------------------------


def _fp8_butterfly_allreduce(x: torch.Tensor, comm) -> torch.Tensor:
    """SUM allreduce over ``comm`` shipping (q, scale) pairs: the
    suffix-fold butterfly (after the round of offset ``w`` position ``p``
    holds the fold of ``[p, p + 2w)``), every stage's traffic encoded and
    the accumulation in float32; position 0's fold is encoded once and
    broadcast."""
    from ._algos import apply_doubling_bcast, exchange_round

    members = comm.members()
    k = len(members)
    pos = comm.Get_rank()
    acc = x
    w = 1
    while w < k:
        q, s = encode_fp8(acc)
        dest = members[pos - w] if pos >= w else None
        src = members[pos + w] if pos + w < k else None
        rq = exchange_round(q if dest is not None else None, dest,
                            q if src is not None else None, src)
        rs = exchange_round(s if dest is not None else None, dest,
                            s if src is not None else None, src)
        if src is not None:
            acc = acc + decode_fp8(rq, rs, acc.shape, acc.numel())
        w *= 2
    q, s = encode_fp8(acc)
    q = apply_doubling_bcast(q, comm, 0)
    s = apply_doubling_bcast(s, comm, 0)
    return decode_fp8(q, s, acc.shape, acc.numel())


def inter_allreduce(v, op, plan, shard_bytes, codec):
    """Compressed inter-host allreduce (``_hierarchy._inter_allreduce``'s
    twin): ring or butterfly on a bf16 cast, or the fp8 butterfly for
    SUM."""
    from . import _algos
    from ._base import Op

    codec = _effective(codec, op)
    if codec == "fp8":
        return _fp8_butterfly_allreduce(v, plan.inter).to(v.dtype)
    v16 = v.to(torch.bfloat16)
    ring_ok = isinstance(op, Op)
    if _algos.resolve_dcn_algo(shard_bytes, plan.h, ring_ok) == "ring":
        out = _algos.apply_ring_allreduce(v16, op, plan.inter, plan.h)
    else:
        out = _algos.apply_butterfly_allreduce(v16, op, plan.inter)
    return out.to(v.dtype)


def inter_reduce_scatter(blocks, op, plan, codec):
    """Compressed inter-host reduce-scatter
    (``_hierarchy._inter_reduce_scatter``'s twin)."""
    from . import _algos

    codec = _effective(codec, op)
    h = plan.h
    if codec == "fp8":
        full = _fp8_butterfly_allreduce(blocks, plan.inter)
        return full[plan.inter.Get_rank()].to(blocks.dtype)
    b16 = blocks.to(torch.bfloat16)
    nbytes = blocks.numel() * blocks.element_size()
    if _algos.resolve_dcn_algo(nbytes, h) == "ring":
        out = _algos.apply_ring_reduce_scatter(b16, op, plan.inter, h)
    else:
        full = _algos.apply_butterfly_allreduce(b16, op, plan.inter)
        out = full[plan.inter.Get_rank()]
    return out.to(blocks.dtype)


def inter_alltoall(z, plan, h, codec):
    """Compressed inter-host alltoall exchange: pure routing, encoded once
    per destination block, so each receiver decodes exactly its blocks."""
    from . import _algos

    if codec == "bf16":
        w = _algos.apply_pairwise_alltoall(z.to(torch.bfloat16), plan.inter, h)
        return w.to(z.dtype)
    s = tuple(z.shape[1:])
    q, scale = _encode_rows(z.reshape(h, -1))
    wq = _algos.apply_pairwise_alltoall(q, plan.inter, h)
    ws = _algos.apply_pairwise_alltoall(scale, plan.inter, h)
    cols = z.numel() // h
    return _decode_rows(wq, ws, cols).reshape((h,) + s).to(z.dtype)


def inter_bcast(v, plan, b0, codec):
    """Compressed inter-host broadcast (``_hierarchy._inter_bcast``'s
    twin): encoded once at the root, shipped, decoded on arrival; fp8
    always takes the doubling broadcast (van de Geijn would re-chunk the
    scale blocks)."""
    from . import _algos

    if codec == "bf16":
        v16 = v.to(torch.bfloat16)
        if _algos.resolve_dcn_algo(v.numel() * v.element_size(),
                                   plan.h) == "ring":
            out = _algos.apply_vdg_bcast(v16, plan.inter, b0, plan.h)
        else:
            out = _algos.apply_doubling_bcast(v16, plan.inter, b0)
        return out.to(v.dtype)
    q, s = encode_fp8(v)
    q = _algos.apply_doubling_bcast(q, plan.inter, b0)
    s = _algos.apply_doubling_bcast(s, plan.inter, b0)
    return decode_fp8(q, s, v.shape, v.numel()).to(v.dtype)


def dcn_codec(v: torch.Tensor, nbytes: int, op=None):
    """The codec for ``v`` (``None``: exact): float32 only, and only an
    ``Op`` where a reduction is involved (a callable sees exact values)."""
    from ._base import Op

    if v.dtype != torch.float32:
        return None
    if op is not None and not isinstance(op, Op):
        return None
    return _codec.codec_for(int(nbytes), "float32")


def ef_zeros_like(tree):
    """A zero residual for ``tree``: the error feedback's first state."""
    return tree_map(torch.zeros_like, tree)


def ef_allreduce(grads, residual, op=None, *, comm=None):
    """Error-feedback allreduce of a gradient tree (see the module
    docstring).  Issues one ``allreduce`` a leaf, in the JAX package's
    leaf order, before using any, so that fusion packs them.  Returns
    ``(reduced_tree, new_residual_tree, token)``."""
    from ..analysis import hook as _ana_hook
    from ._base import SUM
    from .allreduce import allreduce

    op = SUM if op is None else op
    leaves, unflatten = tree_flatten(grads)
    res_leaves = tree_flatten(residual)[0]
    if len(res_leaves) != len(leaves):
        raise ValueError(
            "ef_allreduce: residual tree does not match the gradient tree "
            f"({len(res_leaves)} vs {len(leaves)} leaves); initialize it "
            "with ef_zeros_like(grads)")
    outs, new_res, token = [], [], None
    for g, r in zip(leaves, res_leaves):
        codec = dcn_codec(g, g.numel() * g.element_size(), op)
        comp = g + r
        q = roundtrip(comp, codec)
        new_res.append((comp - q).to(g.dtype))
        out, token = allreduce(q, op, comm=comm, token=token)
        # an error-feedback step: arms the verifier's approximate-lineage
        # seeds (analysis/dataflow.py:graph_arms_approx)
        _ana_hook.mark_last_event("ef", True)
        outs.append(out)
    return unflatten(outs), unflatten(new_res), token


def ef_reshard(residual, rank_map, new_world: int):
    """Re-shard a residual tree whose leaves stack every rank's residual
    (leading dimension the old world) across an elastic reconfiguration:
    survivors keep their row under ``rank_map``, ranks that join cold get
    zeros (``_codec.ef_reshard_rows``)."""

    def reshard_leaf(leaf):
        rows = _codec.ef_reshard_rows(int(leaf.shape[0]), rank_map, new_world)
        zero = torch.zeros_like(leaf[0])
        return torch.stack([leaf[o] if o is not None else zero for o in rows])

    return tree_map(reshard_leaf, residual)
