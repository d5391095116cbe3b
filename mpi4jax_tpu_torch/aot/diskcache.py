"""The persistent tier: the on-disk artifact store (pure Python).

PyTorch counterpart of ``mpi4jax_tpu/aot/diskcache.py``, the same store
with the port's own schema directory.  Layout (under
``MPI4JAX_TPU_COMPILE_CACHE_DIR``)::

    <dir>/mpx-torch-aot-v1/<key[:2]>/<key>.bin

One artifact per key (``keys.derive_key``, 64 hex characters): a built
native library or a pin record (``aot/serialization.py``).  The container
is the JAX package's, so a torn write, a truncated copy or bit-rot reads
as a MISS, never as a wrong library::

    MAGIC (8 bytes)  b"MPXAOT1\\n"
    LENGTH (8 bytes) big-endian payload byte count
    PAYLOAD          opaque bytes (aot/serialization.py owns the format)
    DIGEST (32)      sha256(PAYLOAD)

Writes are atomic (a temporary file in the same directory, then
``os.replace``), so ranks racing on one key are safe: the last writer
wins with an identical artifact.  A read touches the file's mtime, so
eviction is LRU: after each write the store is trimmed oldest first to
``MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES`` (0 = unbounded), the artifact just
written last.

The counters (process-local, always on; ``cache_stats()["disk_cache"]``)
are mirrored into the telemetry meters ``disk_cache.{hits,misses,writes,
evictions,bytes}`` when telemetry is on.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
from typing import Callable, List, Optional, Tuple

from ..telemetry import core as _telemetry
from ..utils import config
from .keys import KEY_SCHEMA

MAGIC = b"MPXAOT1\n"
_HEADER = len(MAGIC) + 8
_DIGEST = 32

_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0, "writes": 0, "evictions": 0, "bytes": 0}


def enabled() -> bool:
    """True when ``MPI4JAX_TPU_COMPILE_CACHE_DIR`` names a directory."""
    return bool(config.compile_cache_dir())


def cache_root(base: Optional[str] = None) -> Optional[str]:
    """The versioned root (``<dir>/mpx-torch-aot-v1``), or ``None`` when
    the tier is off."""
    base = config.compile_cache_dir() if base is None else base
    if not base:
        return None
    return os.path.join(base, KEY_SCHEMA)


def _path_for(root: str, key: str) -> str:
    return os.path.join(root, key[:2], key + ".bin")


def _bump(name: str, n: int = 1) -> None:
    with _lock:
        _stats[name] += n
    _telemetry.meter(f"disk_cache.{name}", n)


def pack(payload: bytes) -> bytes:
    """Wrap a payload in the self-verifying container."""
    return (MAGIC + len(payload).to_bytes(8, "big") + payload
            + hashlib.sha256(payload).digest())


def unpack(data: bytes) -> Optional[bytes]:
    """Unwrap a container; ``None`` on any corruption (bad magic, short
    read, length or digest mismatch)."""
    if len(data) < _HEADER + _DIGEST or not data.startswith(MAGIC):
        return None
    length = int.from_bytes(data[len(MAGIC):_HEADER], "big")
    if len(data) != _HEADER + length + _DIGEST:
        return None
    payload = data[_HEADER:_HEADER + length]
    if hashlib.sha256(payload).digest() != data[_HEADER + length:]:
        return None
    return payload


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def get(key: str, base: Optional[str] = None,
        use: Optional[Callable[[bytes], bool]] = None) -> Optional[bytes]:
    """Fetch an artifact; ``None`` on a miss.  A corrupt artifact is
    deleted and counts as a miss (the caller rebuilds and rewrites), and so
    is one that ``use`` (given the payload) reports it could not use: a
    library ``ctypes`` refuses, say."""
    root = cache_root(base)
    if root is None:
        return None
    path = _path_for(root, key)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        _bump("misses")
        return None
    payload = unpack(data)
    if payload is None or (use is not None and not use(payload)):
        # a corrupt artifact would be read, and missed, at every cold start
        _remove(path)
        _bump("misses")
        return None
    try:
        os.utime(path)  # the LRU touch
    except OSError:
        pass
    _bump("hits")
    return payload


def put(key: str, payload: bytes, base: Optional[str] = None) -> bool:
    """Store an artifact atomically, then trim the store to the byte cap.
    Returns False, and never raises, when the tier is off or the file
    system refuses: a cache must never take the program down."""
    root = cache_root(base)
    if root is None:
        return False
    path = _path_for(root, key)
    data = pack(payload)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-" + key[:8])
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            _remove(tmp)
            raise
    except OSError:
        return False
    _bump("writes")
    _bump("bytes", len(data))
    _evict_to_fit(root, config.compile_cache_max_bytes(), keep=path)
    return True


def _entries(root: str) -> List[Tuple[float, int, str]]:
    """(mtime, size, path) of every artifact under ``root``."""
    out = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".bin"):
                continue
            p = os.path.join(dirpath, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((st.st_mtime, st.st_size, p))
    return out


def _evict_to_fit(root: str, max_bytes: int, keep: Optional[str] = None) -> int:
    """Remove the oldest artifacts until the store fits ``max_bytes`` (0 =
    unbounded).  ``keep``, the artifact just written, goes last."""
    if not max_bytes:
        return 0
    entries = _entries(root)
    total = sum(size for _, size, _ in entries)
    if total <= max_bytes:
        return 0
    evicted = 0
    entries.sort(key=lambda e: (e[2] == keep, e[0]))
    for _, size, path in entries:
        if total <= max_bytes:
            break
        try:
            os.remove(path)
        except OSError:
            continue
        total -= size
        evicted += 1
    if evicted:
        _bump("evictions", evicted)
    return evicted


def stats(base: Optional[str] = None) -> dict:
    """The process-local counters and the store's entries and bytes on
    disk: ``{"enabled", "dir", "hits", "misses", "writes", "evictions",
    "bytes", "entries", "disk_bytes"}``, the JAX package's keys."""
    with _lock:
        out = dict(_stats)
    root = cache_root(base)
    out["enabled"] = root is not None
    out["dir"] = config.compile_cache_dir() if base is None else base
    entries = _entries(root) if root is not None and os.path.isdir(root) \
        else []
    out["entries"] = len(entries)
    out["disk_bytes"] = sum(size for _, size, _ in entries)
    return out


def reset_stats() -> None:
    """Zero the process-local counters (the artifacts on disk stay)."""
    with _lock:
        for k in _stats:
            _stats[k] = 0
