"""Key derivation of a pinned program and of the persistent tier (pure
Python).

PyTorch counterpart of ``mpi4jax_tpu/aot/keys.py``, the port's own copy.
There a key names a compiled XLA artifact for the on-disk cache.  A CUDA
graph cannot be serialized, so the port's persistent tier
(``aot/diskcache.py``) stores two other things under such keys:

- a built native library (``kernels/_build.py:build``, ``native.py:build``),
  keyed by the fingerprint of its source, headers and flags, its target
  and ``toolchain_versions()``;
- a pin record (``aot/pinning.py``), keyed by what a pin captured: the
  function (its qualified name and code), the shapes, dtypes and devices
  of its dynamic arguments, its static values, its comm's shape and its
  unroll.  ``PinnedProgram.key`` is the same derivation with the
  donation added.

Every part is the same in every process: no comm uid, no address.  The
tier's artifacts live under ``<dir>/KEY_SCHEMA``, a name of the port's own,
so the JAX package's ``mpx-aot-v1`` and the port's can share one
directory.

Canonicalization is deliberately dumb and total: nested tuples, lists,
sets, dicts, strings, numbers, ``None`` and bytes render to one
deterministic string.  Objects whose ``repr`` shows a memory address are
rejected: a process-local identity must not enter a key.
"""

from __future__ import annotations

import functools
import hashlib
import re
import subprocess

# the tier's directory under MPI4JAX_TPU_COMPILE_CACHE_DIR, and the first
# part of every key: bump when the canonical form or an artifact's payload
# changes incompatibly (old entries then never match and age out)
KEY_SCHEMA = "mpx-torch-aot-v1"

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def canonical(obj) -> str:
    """Deterministic string form of a key part; ``TypeError`` on anything
    whose ``repr`` carries a memory address.  An object with a ``key``
    attribute canonicalizes through it."""
    key = getattr(obj, "key", None)
    if key is not None and not isinstance(obj, (str, bytes, dict)):
        return canonical(key)
    if obj is None or isinstance(obj, (bool, int, float)):
        return repr(obj)
    if isinstance(obj, str):
        return repr(obj)
    if isinstance(obj, bytes):
        return "b:" + hashlib.sha256(obj).hexdigest()
    if isinstance(obj, (tuple, list)):
        return "(" + ",".join(canonical(x) for x in obj) + ")"
    if isinstance(obj, (set, frozenset)):
        return "{" + ",".join(sorted(canonical(x) for x in obj)) + "}"
    if isinstance(obj, dict):
        return ("{" + ",".join(
            f"{canonical(k)}:{canonical(v)}" for k, v in
            sorted(obj.items(), key=lambda kv: canonical(kv[0]))
        ) + "}")
    text = repr(obj)
    if _ADDR_RE.search(text):
        raise TypeError(
            f"cannot derive a stable key from {type(obj).__name__} "
            f"(repr carries a memory address): {text[:80]}"
        )
    return f"{type(obj).__name__}:{text}"


def fingerprint(text) -> str:
    """SHA-256 hex digest of a program text (str or bytes)."""
    if isinstance(text, str):
        text = text.encode()
    return hashlib.sha256(text).hexdigest()


def derive_key(program_fingerprint: str, mesh_descriptor, dynamic_token,
               versions) -> str:
    """SHA-256 over the canonical parts: a 64-character hex string."""
    parts = "\n".join((
        KEY_SCHEMA,
        str(program_fingerprint),
        canonical(mesh_descriptor),
        canonical(dynamic_token),
        canonical(versions),
    ))
    return hashlib.sha256(parts.encode()).hexdigest()


@functools.lru_cache(maxsize=None)
def _compiler_version(compiler: str) -> str:
    try:
        res = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return (res.stdout + res.stderr).strip()


def toolchain_versions(compiler: str = "nvcc", target: str = "sm_90a") -> tuple:
    """``(torch, torch.version.cuda, the compiler's --version text,
    target)``: a built library is not portable across compilers or
    targets, so all four are key parts.  ``compiler`` is the path or name
    of ``nvcc`` or ``g++`` (its text is read once a process)."""
    import torch

    return (torch.__version__, torch.version.cuda,
            _compiler_version(str(compiler)), target)
