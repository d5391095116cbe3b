"""Codec bookkeeping: which codec applies, the bytes it puts on a wire, and
how an error-feedback residual re-shards.

The port's own copy of ``mpi4jax_tpu/ops/_codec.py`` (plain Python; the
port imports nothing of the JAX package).  The codecs:

- ``bf16``: a float32 payload cast to bfloat16 and back, 2 bytes an
  element;
- ``fp8``: per-chunk max-abs scaled float8_e4m3fn, ``FP8_CHUNK`` elements
  a float32 scale, 1 byte an element plus the scales;
- ``off``: none.

Only float32 payloads are compressed.  In the JAX package the codec acts
on the inter-host leg of the hierarchical lowerings; the port has no
multi-host lowering yet, so the codec acts only through
``compress.ef_allreduce``'s roundtrip and ``wire_bytes`` counts what a
compressed wire would carry, not what the port's exchanges move.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..utils import config

# elements per fp8 scale: the scale costs 1.6 % of the quantized bytes
FP8_CHUNK = 256
_F32_ITEMSIZE = 4
CODECS = ("off", "bf16", "fp8")


def wire_bytes(nbytes: int, codec: Optional[str]) -> int:
    """Bytes on the wire for a float32 payload of ``nbytes`` under
    ``codec`` (``None`` or ``"off"``: exact)."""
    if not codec or codec == "off":
        return nbytes
    if codec == "bf16":
        return nbytes // 2
    if codec == "fp8":
        elems = nbytes // _F32_ITEMSIZE
        nchunks = -(-elems // FP8_CHUNK) if elems else 0
        return elems + _F32_ITEMSIZE * nchunks
    raise ValueError(f"unknown wire codec {codec!r} (expected one of {CODECS})")


def codec_for(nbytes: int, dtype: str = "float32") -> Optional[str]:
    """The codec for a payload of ``nbytes`` and ``dtype`` (``None``:
    exact): ``config.compress_mode``, for float32 only."""
    if dtype != "float32":
        return None
    mode = config.compress_mode(payload_bytes=nbytes)
    return None if mode == "off" else mode


def compression_ratio(nbytes: int, codec: Optional[str]) -> float:
    """Logical over wire bytes: 2.0 for bf16; 1.0 exact or empty."""
    wire = wire_bytes(nbytes, codec)
    return (nbytes / wire) if wire else 1.0


def ef_reshard_rows(old_k: int, rank_map: Dict[int, int],
                    new_world: int) -> List[Optional[int]]:
    """For each rank of a world of ``new_world``, the row of an old
    residual of leading dimension ``old_k`` it carries on, under the
    shrink's ``{old_rank: new_rank}`` map; ``None`` for a rank that joins
    cold, whose residual must be zeroed."""
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1 (got {new_world})")
    rows: List[Optional[int]] = [None] * new_world
    for old, new in rank_map.items():
        if not 0 <= old < old_k:
            raise ValueError(f"rank_map old rank {old} out of range for a "
                             f"residual of leading dimension {old_k}")
        if 0 <= new < new_world:
            rows[new] = old
    return rows
