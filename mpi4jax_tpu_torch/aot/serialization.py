"""The persistent tier's payloads: built libraries and pin records.

PyTorch counterpart of ``mpi4jax_tpu/aot/serialization.py``.  There a
payload is a serialized XLA executable.  A CUDA graph cannot be
serialized, so the port stores the two things a cold start would
otherwise rebuild or rediscover:

- a built native library: the ``.so`` file's bytes.  ``load_library``
  writes them where the build would have put the library (atomically) and
  opens them with ``ctypes``; a library ``ctypes`` refuses is deleted and
  reads as a miss, and the caller rebuilds it from source (never the
  plain version);
- a pin record: plain JSON, ``{"schema", "fn", "libraries": [{"key",
  "name"}, ...]}``, the libraries the pin's first run loaded, named by
  their tier keys and file names (``aot/pinning.py``).

As in the JAX package, ``dumps_*`` return ``None`` rather than raise, and
``loads_*`` return ``None`` on anything they cannot read; the caller
treats that as a miss (the container's digest, ``diskcache.unpack``,
already filtered bit-rot).
"""

from __future__ import annotations

import ctypes
import json
import os
from pathlib import Path
from typing import Optional

from .keys import KEY_SCHEMA

__all__ = ["dumps_library", "load_library", "dumps_record", "loads_record"]


def dumps_library(path) -> Optional[bytes]:
    """The bytes of a built library, or ``None`` when it cannot be read."""
    try:
        return Path(path).read_bytes()
    except OSError:
        return None


def load_library(data: bytes, dest) -> bool:
    """Write a library's bytes to ``dest`` (atomically) and open it with
    ``ctypes``; False, with ``dest`` removed, when either fails."""
    dest = Path(dest)
    tmp = dest.with_suffix(f".{os.getpid()}.tier.tmp")
    try:
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp.write_bytes(data)
        ctypes.CDLL(str(tmp))
        os.replace(tmp, dest)
        return True
    except OSError:
        for p in (tmp, dest):
            try:
                p.unlink()
            except OSError:
                pass
        return False


def dumps_record(fn: str, libraries) -> Optional[bytes]:
    """A pin record's payload: the function's name and the libraries
    (``{"key", "name"}`` each) its first run loaded."""
    try:
        return json.dumps({"schema": KEY_SCHEMA, "fn": str(fn),
                           "libraries": [{"key": str(lib["key"]),
                                          "name": str(lib["name"])}
                                         for lib in libraries]},
                          sort_keys=True).encode()
    except (TypeError, ValueError, KeyError):
        return None


def loads_record(data: bytes) -> Optional[dict]:
    """A pin record back, or ``None`` when it is not one of this schema."""
    try:
        rec = json.loads(data.decode())
    except (UnicodeDecodeError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("schema") != KEY_SCHEMA:
        return None
    libs = rec.get("libraries")
    if not isinstance(libs, list) or not all(
            isinstance(lib, dict) and isinstance(lib.get("key"), str)
            and isinstance(lib.get("name"), str)
            and "/" not in lib["name"] and lib["name"].endswith(".so")
            for lib in libs):
        return None
    return rec
