"""Program pinning: ``compile``, staleness and the pin counters.

PyTorch counterpart of ``mpi4jax_tpu/aot/__init__.py``.

- ``compile(fn, *example_args, comm=..., donate_argnums=...,
  static_argnums=..., unroll=N)`` returns a ``PinnedProgram``: on one
  CUDA rank a captured CUDA graph (a megastep of N steps for ``unroll=N``,
  ``parallel/megastep.py``), elsewhere the same body run eagerly
  (``pinning.py``);
- staleness (``invalidation.py``): ``StaleProgramError`` (MPX129) when a
  pinned program is called after a knob or an override moved;
- ``keys.py``: the key of what a pin captured;
- ``compile_step(fn, unroll=N)``: the elastic loop's adapter
  (``pinning.py:ElasticStep``), a pin per world that
  ``resilience/elastic.py:run`` re-pins after a shrink.

The JAX package's persistent tier (``diskcache.py``, ``serialization.py``,
``fastpath.py``, ``warm.py``, the ``aot`` command line) is not ported
(ROADMAP Queue 1 item 6).
"""

from . import keys  # noqa: F401
from .invalidation import StaleProgramError, WorldStamp  # noqa: F401
from .pinning import ElasticStep, PinnedProgram, compile, compile_step  # noqa: F401
from .pinning import reset_stats as _reset_pin_stats
from .pinning import stats as _pin_stats


def stats() -> dict:
    """The pin counters, under ``"aot"`` as in the JAX package (which also
    reports its disk cache there)."""
    return {"aot": _pin_stats()}


def reset_stats() -> None:
    """Zero the process-local pin counters."""
    _reset_pin_stats()


__all__ = [
    "compile",
    "compile_step",
    "ElasticStep",
    "PinnedProgram",
    "StaleProgramError",
    "WorldStamp",
    "stats",
    "reset_stats",
]
