"""Carry state and configuration across from the JAX package.

The JAX package keeps the shallow-water state as stacked blocks
``(nproc, ny_l, nx_l)``; rank ``r`` of the port holds ``global[r]``.  Both
functions take plain numpy arrays and dicts, so nothing here imports JAX:
``np.asarray`` each JAX field and ``dataclasses.asdict`` the JAX config
first.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .models.shallow_water import Config, State
from .parallel.mesh import resolve_device


def config_from_jax(cfg_fields: dict) -> Config:
    """The port's ``Config`` from the JAX ``Config``'s fields as a dict;
    keys the port does not know raise ``TypeError``."""
    known = {f.name for f in fields(Config)}
    unknown = set(cfg_fields) - known
    if unknown:
        raise TypeError(f"config_from_jax: unknown Config fields {sorted(unknown)}")
    return Config(**cfg_fields)


def state_from_jax(arrays, cfg: Config, rank: int = 0, device=None) -> State:
    """Rank ``rank``'s local ``State`` from the six stacked-block arrays
    (h, u, v, dh, du, dv), each ``(nproc, ny_l, nx_l)``."""
    device = resolve_device(device)
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != len(State._fields):
        raise ValueError(f"state_from_jax: expected 6 fields, got {len(arrays)}")
    want = (cfg.nproc, cfg.ny_local, cfg.nx_local)
    for name, a in zip(State._fields, arrays):
        if a.shape != want:
            raise ValueError(
                f"state_from_jax: field {name} has shape {a.shape}, want {want}"
            )
    if not 0 <= rank < cfg.nproc:
        raise ValueError(f"rank {rank} out of range for {cfg.nproc} ranks")
    return State(*(
        torch.from_numpy(np.ascontiguousarray(a[rank], np.float32)).to(device)
        for a in arrays
    ))
