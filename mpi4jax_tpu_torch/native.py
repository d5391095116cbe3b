"""Native host hooks: building, loading and calling ``csrc/host_hooks.cc``.

PyTorch counterpart of ``mpi4jax_tpu/native.py``.  The JAX package
threads its hooks into compiled programs as XLA FFI custom calls tied to
the op's inputs and outputs; the port runs its ops eagerly, so each hook
is a plain host call through ``ctypes``, and program order is the
ordering:

- ``op_begin``/``op_end``: the per-op runtime log in the reference's
  format (``r{rank} | {id} | MPI_X`` and ``... done with code 0
  ({elapsed}s)``), with the op's latency measured on the host;
- ``abort_if``: kill the process when a predicate holds (fail-fast);
- ``wallclock``: seconds since the library's first read;
- ``watchdog_arm``/``watchdog_disarm``/``watchdog_drain``: the collective
  watchdog's registry and its C++ monitor thread
  (``resilience/watchdog.py``), which keeps watching while every Python
  thread is wedged.

``build()`` compiles the source with ``g++ -O2 -fPIC -shared -std=c++17
-pthread`` into the package's git-ignored ``_build/`` directory, named by
a hash of the source, at first use (``available()``), as
``kernels/_build.py`` does for the CUDA sources; ``python -m
mpi4jax_tpu_torch.native build`` builds it ahead.  The library has its
own name, so its registry never shares state with the JAX package's
``libmpx_hooks.so``.  Without ``g++`` the hooks fall back to Python
(``host_fatal``, the watchdog's Python registry) and runtime tracing is
off, as in the JAX package without its library.  With
``MPI4JAX_TPU_COMPILE_CACHE_DIR`` set, ``build`` goes through the
persistent tier as ``kernels/_build.py:build`` does (``library_key``);
``stats()["compiles"]`` counts the ``g++`` invocations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent
SOURCE = PKG / "csrc" / "host_hooks.cc"
BUILD_DIR = PKG / "_build"

_C = ctypes.c_char_p
_SIGNATURES = {
    "mpx_op_begin": ([ctypes.c_uint32, _C, _C, _C], None),
    "mpx_op_end": ([ctypes.c_uint32, _C, _C], None),
    "mpx_abort_if": ([ctypes.c_uint32, ctypes.c_uint32, _C], None),
    "mpx_wallclock": ([], ctypes.c_double),
    "mpx_watchdog_arm": ([ctypes.c_uint32, _C, _C, _C, ctypes.c_double], None),
    "mpx_watchdog_disarm": ([ctypes.c_uint32, _C], None),
    "mpx_watchdog_inflight": ([], ctypes.c_int),
    "mpx_watchdog_drain": ([], ctypes.c_int),
}

_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_stats = {"compiles": 0}


def stats() -> dict:
    """``compiles``: ``g++`` invocations of this process."""
    return dict(_stats)


def reset_stats() -> None:
    _stats["compiles"] = 0


def library_path() -> Path:
    """Where ``build()`` puts the library: named by a hash of the source,
    so an edited source builds anew."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmpx_torch_hooks_{digest}.so"


def library_key() -> str:
    """The persistent tier's key of the library: the fingerprint of the
    source and the flags, the host's architecture and the toolchain."""
    import platform

    from .aot import keys

    target = platform.machine()
    return keys.derive_key(
        keys.fingerprint(SOURCE.read_bytes() + " ".join(_FLAGS).encode()),
        target, _FLAGS, keys.toolchain_versions("g++", target))


def build(verbose: bool = True) -> str:
    """Compile ``csrc/host_hooks.cc`` into ``_build/`` (reused when already
    built from the same bytes, fetched from the persistent tier when it
    holds it); returns the library's path.  Raises when ``g++`` fails."""
    out = library_path()
    if out.exists():
        return str(out)
    from .aot import diskcache
    from .kernels import _build

    key = None
    if diskcache.enabled():
        key = library_key()
        if _build.from_tier(key, out):
            return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(SOURCE), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    res = subprocess.run(cmd, capture_output=True, text=True)
    _stats["compiles"] += 1
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {SOURCE.name}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    if key is not None:
        _build.to_tier(key, out)
    return str(out)


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; ``None`` (remembered) when
    it cannot be built."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(build(verbose=False))
    except (OSError, RuntimeError):
        _load_failed = True
        return None
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return _lib


def _required() -> ctypes.CDLL:
    """The library, loaded (and built) if need be; raises without it."""
    lib = _lib if _lib is not None else _load()
    if lib is None:
        raise RuntimeError(
            f"the native hooks library could not be built from {SOURCE} "
            "(g++ -O2 -fPIC -shared -std=c++17 -pthread); run "
            "`python -m mpi4jax_tpu_torch.native build` to see why")
    return lib


def available() -> bool:
    """True if the hooks library is built (building it now if need be)
    and loads."""
    return _load() is not None


def runtime_tracing_supported() -> bool:
    """Whether runtime op tracing can run: the library is there.  The
    port's hooks are host calls, so they run whatever device the tensors
    are on (the JAX package's run on its CPU backend only)."""
    return available()


def watchdog_supported() -> bool:
    """Whether the C++ registry and monitor can back the watchdog."""
    return available()


def _b(text: str) -> bytes:
    return str(text).encode()


def op_begin(opname: str, call_id: str, rank, detail: str = "") -> None:
    """Log the op's entry and start its latency clock."""
    _required().mpx_op_begin(int(rank), _b(opname), _b(call_id), _b(detail))


def op_end(opname: str, call_id: str, rank) -> None:
    """Log the op's completion with its elapsed time."""
    _required().mpx_op_end(int(rank), _b(opname), _b(call_id))


def abort_if(pred, rank, message: str) -> bool:
    """Kill the process if ``pred`` holds (fail-fast): the trip is first
    recorded as a telemetry incident (meter, flushed journal instant), then
    the library prints ``r{rank} | FATAL: {message}`` and aborts, or
    ``host_fatal`` does without the library.  Returns ``pred``."""
    pred = bool(pred)
    if pred:
        from .telemetry import journal

        journal.incident("numeric_guard.trips", "numeric_guard_trip", rank,
                         message)
        if available():
            _required().mpx_abort_if(1, int(rank), _b(message))
        host_fatal(rank, message)
    return pred


def host_line(rank, text: str) -> None:
    """A diagnostic line in the runtime-log format (``r{rank} | ...``)."""
    print(f"r{int(rank)} | {text}", file=sys.stderr, flush=True)


def host_fatal(rank, text: str) -> None:
    """Print in ``abort_if``'s FATAL format and kill the process."""
    print(f"r{int(rank)} | FATAL: {text}", file=sys.stderr, flush=True)
    os.abort()


def watchdog_arm(opname: str, call_id: str, rank, axes: str,
                 timeout: float) -> None:
    """Register one in-flight collective with the C++ watchdog."""
    _required().mpx_watchdog_arm(int(rank), _b(opname), _b(call_id),
                                 _b(axes), float(timeout))


def watchdog_disarm(call_id: str, rank) -> None:
    """Deregister the oldest entry under ``(call_id, rank)``."""
    _required().mpx_watchdog_disarm(int(rank), _b(call_id))


def watchdog_inflight() -> int:
    """Entries in the C++ registry (0 without the library)."""
    return _lib.mpx_watchdog_inflight() if _lib is not None else 0


def watchdog_drain() -> int:
    """Drop every entry of the C++ registry; returns the count dropped (0
    when the library was never loaded)."""
    return _lib.mpx_watchdog_drain() if _lib is not None else 0


_py_wallclock_base: Optional[float] = None


def host_clock():
    """``(mono, wall)`` for the telemetry journal: monotonic seconds on a
    process base taken at first use, and ``time.time()``, the clock the
    merge lays ranks' timelines out on."""
    global _py_wallclock_base
    if _py_wallclock_base is None:
        _py_wallclock_base = time.perf_counter()
    return time.perf_counter() - _py_wallclock_base, time.time()


def wallclock() -> float:
    """Seconds since the first ``wallclock`` read of this process (the
    library's clock, or Python's without it); only differences mean
    anything."""
    if available():
        return _required().mpx_wallclock()
    return host_clock()[0]


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv[:1] == ["build"]:
        print(f"built {build()}")
        return 0
    print("usage: python -m mpi4jax_tpu_torch.native build", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
