"""Per-op debug logging and native runtime tracing switches.

PyTorch counterpart of ``mpi4jax_tpu/utils/debug.py``'s switches: both
start from the environment at import (``MPI4JAX_TPU_DEBUG``,
``MPI4JAX_TPU_TRACE``) and each setter bumps the configuration epoch, so
a pinned program captured before it goes stale (``aot/invalidation.py``)
and the dispatch point re-reads its state (``ops/_base.py:run_body``).

With runtime tracing on, every op prints the reference's begin and
completion lines through the native hooks (``native.py``).  With logging
on, every op prints the reference's debug line ``r{rank} | {id} |
MPI_X`` from Python as it starts (the JAX package prints it from the
device, with the op's details).
"""

from .config import bump_config_epoch, debug_enabled, trace_enabled

__all__ = ["set_logging", "get_logging", "set_runtime_tracing",
           "get_runtime_tracing"]

_logging_enabled = debug_enabled()
_tracing_enabled = trace_enabled()


def set_logging(enabled: bool) -> None:
    """Turn the per-op debug logging on or off."""
    global _logging_enabled
    _logging_enabled = bool(enabled)
    bump_config_epoch()


def get_logging() -> bool:
    return _logging_enabled


def set_runtime_tracing(enabled: bool) -> None:
    """Turn native runtime op tracing (host begin/end lines with the op's
    latency, ``native.py``) on or off."""
    global _tracing_enabled
    _tracing_enabled = bool(enabled)
    bump_config_epoch()


def get_runtime_tracing() -> bool:
    return _tracing_enabled
