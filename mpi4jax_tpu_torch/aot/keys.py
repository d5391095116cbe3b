"""Key derivation of a pinned program (pure Python).

PyTorch counterpart of ``mpi4jax_tpu/aot/keys.py``, the port's own copy.
There a key names a compiled XLA artifact for the on-disk cache; here
``PinnedProgram.key`` names what a pin captured: the function, the
shapes, dtypes and devices of its dynamic arguments, its static values,
its comm and its unroll (``aot/pinning.py:program_key``).  The port has
no persistent tier yet (a CUDA graph cannot be serialized), so the key
identifies a pin and stores nothing.

Canonicalization is deliberately dumb and total: nested tuples, lists,
sets, dicts, strings, numbers, ``None`` and bytes render to one
deterministic string.  Objects whose ``repr`` shows a memory address are
rejected: a process-local identity must not enter a key.
"""

from __future__ import annotations

import hashlib
import re

# bump when the canonical form changes incompatibly
KEY_SCHEMA = "mpx-torch-pin-v1"

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
