"""Feedback-directed tuning of the performance knobs.

PyTorch counterpart of ``mpi4jax_tpu/autotune/``.
``autotune(comm=..., budget_s=..., save=...)`` measures the knobs on the
actual ranks (``runner.py`` over the sweeps of ``sweeps.py``), fits them
(``fit.py``) and emits an ``mpx-tuning/1`` file (``schema.py``) that the
config layer serves between the defaults and the environment
(``MPI4JAX_TPU_TUNING``, ``load_tuning``).  Offline::

    python -m mpi4jax_tpu_torch.autotune --budget-s 60 --save tuning.json

This ``__init__`` imports only the pure halves (schema and fitters); the
measuring runner loads at the first call.
"""

from .fit import (  # noqa: F401
    analytic_crossover,
    auto_commit_interval,
    chunk_buckets,
    measured_crossover,
    pick_min,
)
from .schema import (  # noqa: F401
    COST_SCHEMA,
    KNOB_FLAGS,
    SCHEMA,
    TuningFile,
    load_tuning_file,
    stamp_of,
    validate_tuning_dict,
)

__all__ = [
    "SCHEMA",
    "COST_SCHEMA",
    "KNOB_FLAGS",
    "TuningFile",
    "load_tuning_file",
    "stamp_of",
    "validate_tuning_dict",
    "measured_crossover",
    "analytic_crossover",
    "pick_min",
    "chunk_buckets",
    "auto_commit_interval",
    "autotune",
    "AutotuneResult",
]


def autotune(*args, **kwargs):
    """See :func:`mpi4jax_tpu_torch.autotune.runner.autotune` (loaded at
    the first call)."""
    from .runner import autotune as _autotune

    return _autotune(*args, **kwargs)


def __getattr__(name):
    if name == "AutotuneResult":
        from .runner import AutotuneResult

        return AutotuneResult
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
