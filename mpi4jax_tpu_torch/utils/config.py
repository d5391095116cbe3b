"""The knobs of the throughput and dispatch layers, read from the JAX
package's variables.

PyTorch counterpart of the part of ``mpi4jax_tpu/utils/config.py`` that
fusion, the async collectives, the codec and the megastep loops read; the
names, choices and defaults are the same, so a user's settings carry over:

- ``MPI4JAX_TPU_COMPRESS``: ``off`` (default), ``bf16``, ``fp8`` or
  ``auto``, the codec of ``compress.ef_allreduce``'s roundtrip;
- ``MPI4JAX_TPU_FUSION``: ``off`` (default), ``auto`` or ``force``
  (``ops/_fusion.py``; ``set_fusion_mode`` overrides it);
- ``MPI4JAX_TPU_FUSION_BUCKET_BYTES``: the byte cap of a fusion bucket,
  4 MiB by default;
- ``MPI4JAX_TPU_OVERLAP_CHUNKS``: the chunks an async collective is split
  into, 2 by default, at least 1;
- ``MPI4JAX_TPU_UNROLL_DEFAULT``: the megastep trip count of an ``spmd``
  or ``compile`` call without ``unroll=`` (``parallel/megastep.py``), 1
  (no loop) by default, at least 1.

The JAX package resolves these as default < autotune table < environment.
The port has no autotune table yet (``autotune/`` is not ported), so here
it is default < environment, and ``auto`` compression resolves to ``bf16``,
as the JAX package does when its table has no entry.  An unset or empty
variable takes the default; a value outside the choices, or an integer
below its minimum, raises ``ValueError``.

A pinned program (``aot/pinning.py``) captures the configuration once:
``config_stamp()`` is the override epoch, which every programmatic
override bumps (``bump_config_epoch``; ``set_fusion_mode`` does), and the
raw values of ``FLAG_NAMES``.
"""

from __future__ import annotations

import os
from typing import Optional

COMPRESS_MODES = ("off", "bf16", "fp8", "auto")
FUSION_MODES = ("off", "auto", "force")
DEFAULT_FUSION_BUCKET_BYTES = 4 << 20
DEFAULT_OVERLAP_CHUNKS = 2

# every variable that shapes what the port runs, and the JAX package's
# storage-only and dispatch-only knobs (aot/invalidation.py exempts those
# three from a pin's stamp, as the JAX package does; the port reads no
# value of them: it has no persistent tier and no C++ dispatch)
FLAG_NAMES = (
    "MPI4JAX_TPU_COMPRESS",
    "MPI4JAX_TPU_FUSION",
    "MPI4JAX_TPU_FUSION_BUCKET_BYTES",
    "MPI4JAX_TPU_OVERLAP_CHUNKS",
    "MPI4JAX_TPU_UNROLL_DEFAULT",
    "MPI4JAX_TPU_COMPILE_CACHE_DIR",
    "MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES",
    "MPI4JAX_TPU_CPP_DISPATCH",
)

_config_epoch = 0


def config_epoch() -> int:
    """The count of programmatic overrides applied so far."""
    return _config_epoch


def bump_config_epoch() -> None:
    """Called by every programmatic override: a pin captured before it
    goes stale.  A change of the environment needs no bump (the stamp
    reads the variables themselves)."""
    global _config_epoch
    _config_epoch += 1


def env_fingerprint() -> tuple:
    """The raw value of every variable of ``FLAG_NAMES``, unparsed."""
    return tuple(map(os.environ.get, FLAG_NAMES))


def config_stamp() -> tuple:
    """``(config_epoch(), env_fingerprint())``: equal stamps, equal
    configuration."""
    return (_config_epoch, env_fingerprint())


def _choice(name: str, choices, default: str) -> str:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    val = raw.lower().strip()
    if val not in choices:
        raise ValueError(f"Environment variable {name}={raw!r} must be one of "
                         f"{choices}")
    return val


def _int(name: str, default: int, minimum: int = 0) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = int(raw)
    except ValueError as e:
        raise ValueError(f"Environment variable {name}={raw!r} could not be "
                         "parsed as an integer") from e
    if val < minimum:
        raise ValueError(f"Environment variable {name}={raw!r} must be >= "
                         f"{minimum}")
    return val


def compress_mode(payload_bytes: Optional[int] = None) -> str:
    """The codec (``MPI4JAX_TPU_COMPRESS``): ``off``, ``bf16`` or ``fp8``;
    ``auto`` gives ``bf16``.  ``payload_bytes`` is the JAX package's
    argument, which only its autotune table reads."""
    mode = _choice("MPI4JAX_TPU_COMPRESS", COMPRESS_MODES, "off")
    return "bf16" if mode == "auto" else mode


def fusion_mode() -> str:
    """The fusion mode (``MPI4JAX_TPU_FUSION``): ``off``, ``auto`` or
    ``force``."""
    return _choice("MPI4JAX_TPU_FUSION", FUSION_MODES, "off")


def fusion_bucket_bytes() -> int:
    """The byte cap of a fusion bucket (``MPI4JAX_TPU_FUSION_BUCKET_BYTES``)."""
    return _int("MPI4JAX_TPU_FUSION_BUCKET_BYTES", DEFAULT_FUSION_BUCKET_BYTES)


def overlap_chunks(payload_bytes: Optional[int] = None) -> int:
    """The chunks of an async collective (``MPI4JAX_TPU_OVERLAP_CHUNKS``);
    ``payload_bytes`` as in ``compress_mode``."""
    return _int("MPI4JAX_TPU_OVERLAP_CHUNKS", DEFAULT_OVERLAP_CHUNKS, minimum=1)


def unroll_default() -> int:
    """The megastep trip count of a call without ``unroll=``
    (``MPI4JAX_TPU_UNROLL_DEFAULT``; 1, no loop, by default)."""
    return _int("MPI4JAX_TPU_UNROLL_DEFAULT", 1, minimum=1)
