"""``compress``: the codecs and error feedback, public.

The counterpart of ``mpi4jax_tpu/compress.py``:

- byte math and resolution (``ops/_codec.py``): ``wire_bytes``,
  ``codec_for``, ``compression_ratio``, ``ef_reshard_rows``;
- encode, decode and error feedback (``ops/_compress.py``):
  ``ef_allreduce``, ``ef_zeros_like``, ``ef_reshard``, ``roundtrip``,
  ``encode_fp8``, ``decode_fp8``, ``fp8_wire_dtype``;
- the codec in force, ``compress_mode`` (``MPI4JAX_TPU_COMPRESS``).

Off by default: ``ef_allreduce`` is then the plain allreduce of every
leaf and the residual stays exactly zero.  A compressed run is not bit
for bit the exact one; the loss curve's distance to the exact run is the
contract (``models/data_parallel_training.py``).  The port has no
multi-host lowering yet, so no codec shrinks the bytes its exchanges
move.
"""

from .ops._codec import (  # noqa: F401
    CODECS,
    FP8_CHUNK,
    codec_for,
    compression_ratio,
    ef_reshard_rows,
    wire_bytes,
)
from .ops._compress import (  # noqa: F401
    decode_fp8,
    ef_allreduce,
    ef_reshard,
    ef_zeros_like,
    encode_fp8,
    fp8_wire_dtype,
    roundtrip,
)
from .utils.config import compress_mode  # noqa: F401

__all__ = [
    "CODECS",
    "FP8_CHUNK",
    "codec_for",
    "compression_ratio",
    "compress_mode",
    "decode_fp8",
    "ef_allreduce",
    "ef_reshard",
    "ef_reshard_rows",
    "ef_zeros_like",
    "encode_fp8",
    "fp8_wire_dtype",
    "roundtrip",
    "wire_bytes",
]
