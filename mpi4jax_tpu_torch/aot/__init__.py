"""Program pinning, staleness and the persistent tier.

PyTorch counterpart of ``mpi4jax_tpu/aot/__init__.py``.

- ``compile(fn, *example_args, comm=..., donate_argnums=...,
  static_argnums=..., unroll=N)`` returns a ``PinnedProgram``: on one
  CUDA rank a captured CUDA graph (a megastep of N steps for ``unroll=N``,
  ``parallel/megastep.py``), elsewhere the same body run eagerly
  (``pinning.py``); its call replays the graph, the port's fast path
  (``fastpath.py``);
- staleness (``invalidation.py``): ``StaleProgramError`` (MPX129) when a
  pinned program is called after a knob or an override moved;
- ``keys.py``: the keys of what a pin captured and of a built library;
- the persistent tier (``MPI4JAX_TPU_COMPILE_CACHE_DIR``,
  ``diskcache.py`` and ``serialization.py``): the built kernel libraries
  and one record a pin, so that a second process builds nothing;
  ``through_disk_cache`` routes a function's first calls through it, and
  ``python -m mpi4jax_tpu_torch.aot warm MANIFEST`` fills it ahead of the
  first job (``warm.py``, ``__main__.py``);
- ``compile_step(fn, unroll=N)``: the elastic loop's adapter
  (``pinning.py:ElasticStep``), a pin per world that
  ``resilience/elastic.py:run`` re-pins after a shrink.
"""

from . import diskcache, fastpath, keys, warm  # noqa: F401
from .invalidation import StaleProgramError, WorldStamp  # noqa: F401
from .pinning import (  # noqa: F401
    ElasticStep,
    PinnedProgram,
    compile,
    compile_step,
    through_disk_cache,
)
from .pinning import reset_stats as _reset_pin_stats
from .pinning import stats as _pin_stats


def stats() -> dict:
    """The persistent tier of ``cache_stats()``: the pin counters under
    ``"aot"`` and the disk tier's counters and footprint under
    ``"disk_cache"``, as in the JAX package."""
    return {"aot": _pin_stats(), "disk_cache": diskcache.stats()}


def reset_stats() -> None:
    """Zero the process-local pin, disk-tier and build counters (the
    artifacts on disk stay)."""
    from .. import native
    from ..kernels import _build

    _reset_pin_stats()
    diskcache.reset_stats()
    _build.reset_stats()
    native.reset_stats()


__all__ = [
    "compile",
    "compile_step",
    "ElasticStep",
    "PinnedProgram",
    "StaleProgramError",
    "WorldStamp",
    "through_disk_cache",
    "stats",
    "reset_stats",
]
