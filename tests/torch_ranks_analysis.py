"""Rank programs of the collective verifier's tests (no JAX: every rank
imports this module afresh).

``ambient_program`` runs one clean program, the walled shallow-water
solver's stepper on a (2, 2) grid, under the verifier's three ambient
modes, and reports for each its outputs, the abstract runs and
verifications each call made, and the exchanges each call made.
"""

from dataclasses import replace

import numpy as np

from mpi4jax_tpu_torch import clear_caches, set_analyze_mode, spmd
from mpi4jax_tpu_torch.analysis import crossrank
from mpi4jax_tpu_torch.models import shallow_water as SW
from mpi4jax_tpu_torch.ops import _staging

SW_SIZE = (64, 32)
MODES = ("off", "warn", "error")


def ambient_program(rank: int, steps: int = 3) -> dict:
    cfg = replace(SW.Config(nx=SW_SIZE[0], ny=SW_SIZE[1], nproc_y=2, nproc_x=2),
                  periodic_x=False)
    _, comm = SW.make_mesh_and_comm(cfg, device="cpu")
    first, multi = SW.make_stepper(cfg, comm, fast="wide2")
    prog = spmd(lambda s: multi(first(s), steps), comm=comm)
    out = {}
    try:
        for mode in MODES:
            set_analyze_mode(mode)
            clear_caches()
            state = SW.initial_state(cfg, rank=comm.Get_rank(), device="cpu")
            for call in (1, 2):
                runs, ver = crossrank.stats["runs"], crossrank.stats["verifications"]
                calls = _staging.stats.calls
                res = prog(state)
                out[f"{mode}/{call}/runs"] = crossrank.stats["runs"] - runs
                out[f"{mode}/{call}/verifications"] = (
                    crossrank.stats["verifications"] - ver)
                out[f"{mode}/{call}/exchanges"] = _staging.stats.calls - calls
                out[f"{mode}/{call}/state"] = np.stack(
                    [f.numpy() for f in res])
    finally:
        set_analyze_mode(None)
    return out
