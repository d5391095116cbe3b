"""The fused modes ("pallas", "pallas2", "pallas3") against the JAX package.

The port's ``make_stepper(fast=mode)`` on the CPU (the kernel's plain
version) against the JAX package's fused kernel in interpret mode, over
runs that mix the Euler first step, whole chunk calls and single-step
remainders, as ``tests/test_examples.py:test_pallas_chunk_step_matches_fast_steps``
does.  The JAX side composes its per-call kernels exactly as its
``_run_steps`` does (first step, then whole chunks, then single steps), so
each kernel variant compiles once per grid.  Band: ``5e-6 + 1e-6 * max|a|``.
"""

import functools
import os
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

PBLK = J._PBLK
# two of the JAX suite's Pallas grid cases: one partial block, and two full
# blocks plus a partial trailing one (nx_local = 42)
GRIDS = [(PBLK - 8, 48), (2 * PBLK + 14, 40)]
MODES = [
    ("pallas", (10, 11)),
    ("pallas2", (10, 11)),  # whole pairs; pairs + a single remainder
    ("pallas3", (9, 11)),   # whole triples; triples + two singles
]
CHUNK = {"pallas": 1, "pallas2": 2, "pallas3": 3}


@functools.lru_cache(maxsize=None)
def _jax_kernel(ny, nx, first, nsteps):
    cfg = J.Config(nx=nx, ny=ny)
    _, comm = J.make_mesh_and_comm(cfg, devices=jax.devices()[:1])

    @partial(mpx.spmd, comm=comm)
    def call(state):
        return J.model_step_pallas(state, cfg, comm, first, nsteps=nsteps)

    return call


@functools.lru_cache(maxsize=None)
def _jax_run(ny, nx, mode, total):
    """``total`` steps (the first one Euler) of the JAX fused mode."""
    cfg = J.Config(nx=nx, ny=ny)
    chunk = CHUNK[mode]
    state = _jax_kernel(ny, nx, True, 1)(J.initial_state(cfg))
    nchunks, rem = divmod(total - 1, chunk)
    for _ in range(nchunks):
        state = _jax_kernel(ny, nx, False, chunk)(state)
    for _ in range(rem):
        state = _jax_kernel(ny, nx, False, 1)(state)
    return [np.asarray(f)[0] for f in state]


@pytest.mark.parametrize("mode,total", [(m, n) for m, ns in MODES for n in ns])
@pytest.mark.parametrize("ny,nx", GRIDS)
def test_fused_mode_matches_jax(ny, nx, mode, total):
    cfg = P.Config(nx=nx, ny=ny)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    first, multi = P.make_stepper(cfg, comm, fast=mode)
    got = multi(first(P.initial_state(cfg, device="cpu")), total - 1)
    for name, a, b in zip(J.State._fields, _jax_run(ny, nx, mode, total), got):
        bound = 5e-6 + 1e-6 * np.abs(a).max()
        err = np.abs(a - b.numpy()).max()
        assert err <= bound, (
            f"field {name} diverged (ny={ny}, nx={nx}, {mode}, {total} steps): "
            f"{err:.3e} > {bound:.3e}")


@pytest.mark.parametrize("mode", ["pallas", "pallas2", "pallas3"])
@pytest.mark.parametrize("ny,nx", GRIDS)
def test_fused_mode_equals_fast_step_in_port(ny, nx, mode):
    """In the port the fused plain version and ``model_step_fast`` evaluate
    the same operations in the same order: bitwise equal over 11 steps."""
    cfg = P.Config(nx=nx, ny=ny)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    s0 = P.initial_state(cfg, device="cpu")
    outs = []
    for fast in (True, mode):
        first, multi = P.make_stepper(cfg, comm, fast=fast)
        outs.append(multi(first(s0), 10))
    for name, a, b in zip(P.State._fields, *outs):
        assert torch.equal(a, b), name
