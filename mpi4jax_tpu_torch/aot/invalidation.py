"""Pinned-program staleness: capture the world once, refuse it moved.

PyTorch counterpart of ``mpi4jax_tpu/aot/invalidation.py``.  A
``PinnedProgram`` (``aot/pinning.py``) replays what it captured (a CUDA
graph on one CUDA rank) and reads no knob per call, so a knob moved after
the pin would go unnoticed: fusion switched on after a graph captured the
unfused collectives, say.  So a ``WorldStamp`` captures the world once,
at the pin:

- the configuration stamp (``utils/config.config_stamp``): the override
  epoch plus the raw value of every variable of ``config.FLAG_NAMES``
  except the storage-only and dispatch-only ones, which shape nothing a
  pin runs;
- the elastic epoch.  ``resilience/elastic.py`` is not ported yet, so it
  is 0, as the JAX package's is in a world that never churned.

A call checks two things: the epochs (ints, first), then the raw
variables.  A failed check raises ``StaleProgramError`` tagged MPX129,
naming what moved and the re-pin.  Staleness follows the world, not the
program: setting a variable back to its captured value makes the pin
valid again.  An override moves the epoch for good.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils import config

# where a compiled artifact is stored: shapes no program
STORAGE_ONLY_FLAGS = (
    "MPI4JAX_TPU_COMPILE_CACHE_DIR",
    "MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES",
)

# how an artifact already pinned is driven: shapes no program
DISPATCH_ONLY_FLAGS = ("MPI4JAX_TPU_CPP_DISPATCH",)

_WORLD_FLAG_NAMES = tuple(
    n for n in config.FLAG_NAMES
    if n not in STORAGE_ONLY_FLAGS + DISPATCH_ONLY_FLAGS
)


def _world_stamp_value() -> tuple:
    return (config.config_epoch(),
            tuple(map(os.environ.get, _WORLD_FLAG_NAMES)))


class StaleProgramError(RuntimeError):
    """A pinned program was called after the world it was pinned for moved
    (a knob or an override).  ``mpx_code == "MPX129"``; re-pin with
    ``program.repin()`` or a fresh ``compile``."""

    mpx_code = "MPX129"


# the elastic layer is not ported: a world without it is at epoch 0.  The
# import is tried once, since a failed import searches the path again at
# every attempt (about 0.1 ms, more than the rest of a pinned call)
try:
    from ..resilience.elastic import current_epoch as _elastic_epoch
except ImportError:
    _elastic_epoch = None


def _current_epoch() -> int:
    return 0 if _elastic_epoch is None else _elastic_epoch()


class WorldStamp:
    """One captured (configuration stamp, elastic epoch) pair and its
    check."""

    __slots__ = ("stamp", "epoch")

    def __init__(self, stamp, epoch: int):
        self.stamp = stamp
        self.epoch = epoch

    @classmethod
    def capture(cls) -> "WorldStamp":
        return cls(_world_stamp_value(), _current_epoch())

    def is_current(self) -> bool:
        """The epochs first (an int compare each), then the raw
        variables."""
        return (self.epoch == _current_epoch()
                and self.stamp == _world_stamp_value())

    def describe_staleness(self) -> Optional[str]:
        """What moved since the capture, ``None`` if nothing did."""
        cur_epoch = _current_epoch()
        if self.epoch != cur_epoch:
            return (f"the elastic communication epoch advanced "
                    f"({self.epoch} -> {cur_epoch})")
        cur = _world_stamp_value()
        if self.stamp == cur:
            return None
        changed = [name for name, a, b in
                   zip(_WORLD_FLAG_NAMES, self.stamp[1], cur[1]) if a != b]
        if changed:
            return ("configuration flag(s) changed since the pin: "
                    + ", ".join(changed))
        return ("the configuration epoch moved (a set_* override was "
                "applied since the pin)")

    def check(self, what: str = "pinned program") -> None:
        """Raise ``StaleProgramError`` (MPX129) unless current."""
        why = None if self.is_current() else self.describe_staleness()
        if why is None:
            return
        raise StaleProgramError(
            f"{what} is stale: {why}.  A pinned program replays what it "
            "captured and reads no knob per call, so it cannot follow the "
            "new world: re-pin it (program.repin(), or a fresh "
            "mpi4jax_tpu_torch.compile) [MPX129]")
