"""Entry point: one shallow-water step as a callable with its example input.

Counterpart of ``__graft_entry__.py:entry``.
"""

from __future__ import annotations

from .models.shallow_water import (
    Config,
    initial_state,
    make_mesh_and_comm,
    select_step,
)


def _tiny_config(nproc_y: int, nproc_x: int) -> Config:
    return Config(nproc_y=nproc_y, nproc_x=nproc_x, nx=8 * nproc_x, ny=8 * nproc_y)


def entry(device=None):
    """Return ``(fn, (state,))``: one model step of the tiny single-rank
    config, through the shipped single-device kernel (``"auto"``), on
    ``device`` (default: the GPU)."""
    cfg = _tiny_config(1, 1)
    _, comm = make_mesh_and_comm(cfg, device=device)
    step = select_step("auto", cfg)

    def fn(state):
        return step(state, cfg, comm, first_step=False)

    return fn, (initial_state(cfg, device=comm.device),)
