"""The split-phase kernel's module: its plain versions, its margins, its wrapper.

- ``sw_phase1_plain`` and ``sw_phase2_plain`` (the plain versions the CPU
  runs) against the JAX package's ``_phase1_window`` and
  ``_phase2_window`` evaluated with ``jnp.roll`` over the whole local array,
  as ``model_step_pallas_halo``'s interpret branch does, at the offsets of
  the (1,1) rank and of interior and edge ranks of (2,4), both boundary
  modes.  Band ``5e-6 + 1e-6 * max|a|`` (tests/test_examples.py), on every
  cell, the halo ring included.
- Each phase's dependency radius, measured by NaN injection, is the
  margin of ``csrc/sw_phase.cu``'s strips and chunks.
- The wrappers' dispatch.  The kernel's source runs on the host, bit for
  bit against the plain versions, in ``tests/test_torch_sw_emulation.py``;
  on the card in ``tests/test_torch_cuda.py``.
"""

import os
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

from mpi4jax_tpu_torch.kernels import sw_phase as K  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

BAND = (5e-6, 1e-6)
# (grid, rank) cases: the single rank, then (2,4)'s corner ranks 0 and 7,
# an edge rank 2 and an interior-column rank 5
RANK_CASES = [((1, 1), 0), ((2, 4), 0), ((2, 4), 2), ((2, 4), 5), ((2, 4), 7)]


def configs(grid, periodic, nx=64, ny=32):
    j = replace(J.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                periodic_x=periodic)
    p = replace(P.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                periodic_x=periodic)
    return j, p


def offsets(cfg, rank):
    py, px = divmod(rank, cfg.nproc_x)
    return py * (cfg.ny_local - 2), px * (cfg.nx_local - 2)


def local_fields(cfg, rank, seed=0):
    """Rank ``rank``'s block of the initial state with every field,
    tendencies included, perturbed by seeded numpy noise at its own
    scale; numpy f32 arrays."""
    base = [f.numpy() for f in P.initial_state(cfg, rank=rank, device="cpu")]
    rng = np.random.default_rng(seed + rank)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    return [(b + s * rng.standard_normal(b.shape)).astype(np.float32)
            for b, s in zip(base, scales)]


def jax_indices(shape, off):
    iy = jnp.arange(shape[0])[:, None]
    ix = jnp.arange(shape[1])[None, :]
    return iy, ix, iy + off[0], ix + off[1]


def assert_band(want, got, what):
    for k, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        b = b.numpy()
        bound = BAND[0] + BAND[1] * np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= bound, f"{what} output {k}: {err:.3e} > {bound:.3e}"


# ---------------------------------------------------------------------------
# plain versions against the JAX windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("grid,rank", RANK_CASES,
                         ids=[f"{g[0]}x{g[1]}-r{r}" for g, r in RANK_CASES])
def test_phase1_plain_matches_jax_window(grid, rank, periodic, first):
    jcfg, pcfg = configs(grid, periodic)
    fields = local_fields(pcfg, rank)
    off = offsets(pcfg, rank)
    iy, ix, giy, gix = jax_indices(fields[0].shape, off)
    want = J._phase1_window(jcfg, first, iy, ix, giy, gix,
                            tuple(map(jnp.asarray, fields)), jnp.roll)
    got = K.sw_phase1(tuple(map(torch.from_numpy, fields)), pcfg, first, off)
    assert_band(want, got, f"phase 1 {grid} r{rank}")


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("grid,rank", RANK_CASES,
                         ids=[f"{g[0]}x{g[1]}-r{r}" for g, r in RANK_CASES])
def test_phase2_plain_matches_jax_window(grid, rank, periodic):
    jcfg, pcfg = configs(grid, periodic)
    fields = local_fields(pcfg, rank)
    off = offsets(pcfg, rank)
    iy, ix, giy, gix = jax_indices(fields[0].shape, off)
    want = J._phase2_window(jcfg, iy, ix, giy, gix, jnp.asarray(fields[1]),
                            jnp.asarray(fields[2]), jnp.roll)
    got = K.sw_phase2(torch.from_numpy(fields[1]), torch.from_numpy(fields[2]),
                      pcfg, off)
    assert_band(want, got, f"phase 2 {grid} r{rank}")


# ---------------------------------------------------------------------------
# the kernel's margins: each phase's dependency radius
# ---------------------------------------------------------------------------


def nan_spread(phase, field):
    """The farthest (rows, cols) a NaN planted in one input cell of
    ``field`` reaches in the phase's outputs (periodic distance, the
    kernel's addressing), over plantings at the walls, the corners and in
    the interior, on walled edge ranks and an interior rank."""
    spread = [0, 0]
    for grid, rank, periodic in [((2, 4), 0, False), ((2, 4), 7, False),
                                 ((2, 4), 5, True), ((1, 1), 0, False)]:
        _, cfg = configs(grid, periodic)
        base = [torch.from_numpy(f) for f in local_fields(cfg, rank, seed=2)]
        ny, nx = base[0].shape
        off = offsets(cfg, rank)
        points = [(ny // 2, nx // 2), (0, 0), (1, 1), (ny - 1, nx - 1),
                  (ny - 2, nx - 2), (0, nx // 2), (ny - 2, 3), (4, nx - 2)]
        for y, x in points:
            fields = [f.clone() for f in base]
            if phase == 1:
                fields[field][y, x] = float("nan")
                outs = K.sw_phase1_plain(fields, cfg, False, off)
            else:
                fields[1 + field][y, x] = float("nan")
                outs = K.sw_phase2_plain(fields[1], fields[2], cfg, off)
            for out in outs:
                ys, xs = torch.nonzero(torch.isnan(out), as_tuple=True)
                for a, b in zip(ys.tolist(), xs.tolist()):
                    spread[0] = max(spread[0], min((a - y) % ny, (y - a) % ny))
                    spread[1] = max(spread[1], min((b - x) % nx, (x - b) % nx))
    return tuple(spread)


@pytest.mark.parametrize("phase,field", [(1, k) for k in range(6)] + [(2, 0), (2, 1)])
def test_dependency_radius_within_margins(phase, field):
    radius = K.PHASE1_RADIUS if phase == 1 else K.PHASE2_RADIUS
    spread = nan_spread(phase, field)
    assert spread[0] <= radius[0] and spread[1] <= radius[1], spread


@pytest.mark.parametrize("phase", [1, 2])
def test_margins_are_the_measured_radius(phase):
    """The margins are no wider than the farthest reach of any input."""
    radius = K.PHASE1_RADIUS if phase == 1 else K.PHASE2_RADIUS
    fields = range(6) if phase == 1 else range(2)
    spreads = [nan_spread(phase, f) for f in fields]
    assert (max(s[0] for s in spreads), max(s[1] for s in spreads)) == radius


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_wrappers_on_cpu_are_the_plain_versions():
    _, cfg = configs((2, 4), False)
    fields = tuple(map(torch.from_numpy, local_fields(cfg, 5)))
    off = offsets(cfg, 5)
    before = K.counter.launches
    got1 = K.sw_phase1(fields, cfg, False, off)
    got2 = K.sw_phase2(fields[1], fields[2], cfg, off)
    want1 = K.sw_phase1_plain(fields, cfg, False, off)
    want2 = K.sw_phase2_plain(fields[1], fields[2], cfg, off)
    assert all(torch.equal(a, b) for a, b in zip(want1 + want2, got1 + got2))
    assert K.counter.launches == before  # no kernel ran


def test_split_phase_step_is_model_step_fast_on_one_rank():
    """On one rank the split-phase step and ``model_step_fast`` run the
    same operations in the same order: the same bits over 12 steps."""
    _, cfg = configs((1, 1), False, 48, 24)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    outs = []
    for fast in (True, "pallas_halo"):
        first, multi = P.make_stepper(cfg, comm, fast=fast)
        outs.append(multi(first(P.initial_state(cfg, device="cpu")), 11))
    for name, a, b in zip(P.State._fields, *outs):
        assert torch.equal(a, b), name
