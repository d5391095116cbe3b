"""The fused step kernel's module: its plain version, its tiling, its wrapper.

- ``sw_steps_plain`` (the plain version the CPU runs) against the JAX
  package's ``model_step_pallas`` in interpret mode, one call at a time, for
  every (first step, nsteps) the kernel takes, on two of the JAX suite's
  Pallas grid cases.  Band: ``5e-6 + 1e-6 * max|a|`` (tests/test_examples.py).
- The CUDA kernel's decomposition, run in PyTorch: the blocks the source
  lays out (strips of ``EXT`` columns and chunks of rows, gathered with
  periodic addressing, margins of ``nsteps * INTERIOR_RADIUS`` and, in the
  two seam strips, ``nsteps * STEP_RADIUS[1]`` columns; reported by the
  source built for the host, ``tests/torch_sw_host.py``) reproduce the
  whole-array plain version bit for bit.  One step's dependency radius,
  measured by NaN injection, lies inside ``STEP_RADIUS`` near the seam,
  is ``INTERIOR_RADIUS`` away from it, and in array rows (which never
  wrap) reaches no farther at the walls.  ``tests/test_torch_sw_emulation.py``
  runs the CUDA source itself on the host.
- The wrapper's dispatch and checks.  Tests of the kernel itself need a
  CUDA device and ``nvcc``: they are in ``tests/test_torch_cuda.py``.
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

from mpi4jax_tpu_torch.kernels import sw_steps as K  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401
from torch_sw_host import host_libs, steps_blocks  # noqa: E402

pytest_plugins = ["leaked_env_guard"]

PBLK = J._PBLK
# the JAX suite's Pallas grid cases (tests/test_examples.py:_pallas_grid_cases)
GRID_CASES = [(PBLK - 8, 48), (PBLK - 2, 48), (2 * PBLK - 2, 48), (2 * PBLK + 14, 40)]
# one partial block, and two full blocks plus a partial trailing one
JAX_CASES = [GRID_CASES[0], GRID_CASES[3]]
STEP_CASES = [(True, 1), (False, 1), (False, 2), (False, 3)]


def perturbed_state(ny, nx, seed=0):
    """The initial state with every field, tendencies included, perturbed
    by seeded numpy noise at the fields' own scales; numpy f32 arrays."""
    cfg = P.Config(nx=nx, ny=ny)
    base = [f.numpy() for f in P.initial_state(cfg, device="cpu")]
    rng = np.random.default_rng(seed)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    return [(b + s * rng.standard_normal(b.shape)).astype(np.float32)
            for b, s in zip(base, scales)]


# ---------------------------------------------------------------------------
# plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_call(ny, nx, first, nsteps):
    cfg = J.Config(nx=nx, ny=ny)
    _, comm = J.make_mesh_and_comm(cfg, devices=jax.devices()[:1])

    @partial(mpx.spmd, comm=comm)
    def call(state):
        return J.model_step_pallas(state, cfg, comm, first, nsteps=nsteps)

    return call


@pytest.mark.parametrize("first,nsteps", STEP_CASES)
@pytest.mark.parametrize("ny,nx", JAX_CASES)
def test_plain_matches_jax_kernel(ny, nx, first, nsteps):
    fields = perturbed_state(ny, nx)
    want = _jax_call(ny, nx, first, nsteps)(J.State(*(f[None] for f in fields)))
    got = K.sw_steps(tuple(torch.from_numpy(f) for f in fields),
                     P.Config(nx=nx, ny=ny), first, nsteps)
    for name, a, b in zip(J.State._fields, want, got):
        a = np.asarray(a)[0]
        bound = 5e-6 + 1e-6 * np.abs(a).max()
        err = np.abs(a - b.numpy()).max()
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


# ---------------------------------------------------------------------------
# the kernel's tiling, emulated
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def steps_lib(tmp_path_factory):
    return host_libs(tmp_path_factory)["sw_steps"]


def tiled_steps(lib, fields, cfg, first, nsteps):
    """What ``csrc/sw_steps.cu`` computes, block by block (as the source
    lays them out): gather each block's ``EXT`` columns and its rows grown
    by its margins by periodic addressing, run ``nsteps`` steps on the
    window alone (rolls wrap inside it, so the margins fill with garbage),
    keep the output rows and columns."""
    ny, nx = fields[0].shape
    outs = [torch.full_like(f, float("nan")) for f in fields]
    for oy, h, ox, w, my, mx in steps_blocks(lib, ny, nx, nsteps)[0]:
        gy = torch.arange(oy - my, oy + h + my) % ny
        gx = torch.arange(ox - mx, ox - mx + K.EXT) % nx
        win = [f[gy][:, gx] for f in fields]
        first_ = first
        for _ in range(nsteps):
            win = K._step_window(cfg, first_, ny, gy[:, None], gx[None, :],
                                 win, torch.roll)
            first_ = False
        for o, wf in zip(outs, win):
            o[oy:oy + h, ox:ox + w] = wf[my:my + h, mx:mx + w]
    return outs


# (ny, nx): the JAX suite's cases and an 8 x 8 domain are one strip over
# both seams; 300 columns put the two seam strips side by side, 600 and
# 850 interior strips between them and a ragged last one; every case has
# several chunks of rows, the last one ragged
TILE_CASES = GRID_CASES + [(8, 8), (20, 300), (40, 600), (14, 850)]


@pytest.mark.parametrize("first,nsteps", STEP_CASES)
@pytest.mark.parametrize("ny,nx", TILE_CASES)
def test_tiles_with_margins_reproduce_whole_array(steps_lib, ny, nx, first, nsteps):
    cfg = P.Config(nx=nx, ny=ny)
    fields = tuple(torch.from_numpy(f) for f in perturbed_state(ny, nx, seed=1))
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    got = tiled_steps(steps_lib, fields, cfg, first, nsteps)
    for name, a, b in zip(J.State._fields, want, got):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("nsteps", [1, 2, 3])
@pytest.mark.parametrize("ny,nx", [(1802, 3602), (902, 1802), (13, 150), (9, 8), (40, 600)])
def test_layout_covers_every_cell_once(steps_lib, ny, nx, nsteps):
    """The strips and chunks tile the array exactly, the first and last
    strips with the seam margin, the others with the interior one."""
    blocks, _ = steps_blocks(steps_lib, ny, nx, nsteps)
    covered = torch.zeros(ny, nx, dtype=torch.int32)
    for oy, h, ox, w, my, mx in blocks:
        covered[oy:oy + h, ox:ox + w] += 1
        assert my == K.INTERIOR_RADIUS[0] * nsteps and w + 2 * mx <= K.EXT
        edge = ox == 0 or ox + w == nx
        assert mx == nsteps * (K.STEP_RADIUS[1] if edge else K.INTERIOR_RADIUS[1])
    assert bool((covered == 1).all())


def nan_spread(field, points, wrap=True):
    """The farthest (rows, cols) a NaN planted at each of ``points`` in one
    input field reaches in one step's outputs: periodic distance, or, with
    ``wrap=False``, distance in array rows (signed, so a reach across the
    walls through the periodic rows would show as a long one)."""
    ny, nx = 32, 42
    cfg = P.Config(nx=nx - 2, ny=ny - 2)
    base = [torch.from_numpy(f) for f in perturbed_state(ny - 2, nx - 2, seed=2)]
    spread = [0, 0]
    for y, x in points:
        fields = [f.clone() for f in base]
        fields[field][y, x] = float("nan")
        for out in K.sw_steps_plain(fields, cfg, False, 1):
            ys, xs = torch.nonzero(torch.isnan(out), as_tuple=True)
            for a, b in zip(ys.tolist(), xs.tolist()):
                dy = min((a - y) % ny, (y - a) % ny) if wrap else abs(a - y)
                spread[0] = max(spread[0], dy)
                spread[1] = max(spread[1], min((b - x) % nx, (x - b) % nx))
    return spread


@pytest.mark.parametrize("field", range(6), ids=J.State._fields)
def test_one_step_dependency_radius_within_margins(field):
    """A NaN planted in one input cell reaches only outputs within
    ``STEP_RADIUS`` of it (periodic distance), at the walls, at the periodic
    seam columns and in the interior: the seam strips' margins."""
    ny, nx = 32, 42
    spread = nan_spread(field, [(15, 20), (15, 0), (15, 1), (15, nx - 1), (15, nx - 2),
                                (0, 5), (1, 20), (ny - 1, 7), (ny - 2, 20), (ny - 3, 0),
                                (2, nx - 1)])
    assert spread[0] <= K.STEP_RADIUS[0] and spread[1] <= K.STEP_RADIUS[1]


# planted cells whose one-step cone (radius 2) reaches neither a seam column
# (0 and nx-1, or 1 and nx-2, which the fix copies into them) nor a wall
# row (0, ny-1) of the 32 x 42 array
AWAY_FROM_SEAMS = [(y, x) for y in (3, 4, 15, 27, 28) for x in (4, 5, 20, 36, 37)]


@pytest.mark.parametrize("field", range(6), ids=J.State._fields)
def test_one_step_radius_away_from_the_seams_is_the_interior_margin(field):
    spread = nan_spread(field, AWAY_FROM_SEAMS)
    assert spread[0] <= K.INTERIOR_RADIUS[0] and spread[1] <= K.INTERIOR_RADIUS[1], spread


def test_interior_margin_is_the_measured_radius():
    spreads = [nan_spread(f, AWAY_FROM_SEAMS) for f in range(6)]
    assert (max(s[0] for s in spreads), max(s[1] for s in spreads)) == K.INTERIOR_RADIUS


@pytest.mark.parametrize("field", range(6), ids=J.State._fields)
def test_wall_rows_reach_no_farther_in_array_rows(field):
    """Every row, the walls and their neighbours included, at the seam
    columns and inside: no output row lies more than INTERIOR_RADIUS[0]
    array rows from a planted cell, so no chunk needs a wider row margin
    and no chunk reads across the walls."""
    points = [(y, x) for y in range(32) for x in (0, 1, 20, 41)]
    assert nan_spread(field, points, wrap=False)[0] <= K.INTERIOR_RADIUS[0]


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,nsteps", STEP_CASES)
def test_wrapper_on_cpu_is_the_plain_version(first, nsteps):
    cfg = P.Config(nx=40, ny=24)
    fields = tuple(torch.from_numpy(f) for f in perturbed_state(24, 40))
    before = K.counter.launches
    got = K.sw_steps(fields, cfg, first, nsteps)
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert K.counter.launches == before  # no kernel ran


@pytest.mark.parametrize("nsteps", [0, 4])
def test_wrapper_rejects_step_counts(nsteps):
    cfg = P.Config(nx=8, ny=8)
    fields = tuple(P.initial_state(cfg, device="cpu"))
    with pytest.raises(ValueError, match="1..3"):
        K.sw_steps(fields, cfg, False, nsteps)


@pytest.mark.parametrize("cfg", [
    P.Config(nx=8, ny=8, periodic_x=False),
    P.Config(nx=16, ny=16, nproc_y=2, nproc_x=2),
], ids=["walls", "multi-rank"])
def test_wrapper_rejects_ineligible_configs(cfg):
    fields = tuple(torch.zeros(cfg.ny_local, cfg.nx_local) for _ in range(6))
    with pytest.raises(ValueError, match="single-rank periodic-x"):
        K.sw_steps(fields, cfg, False, 1)


def test_step_constants_round_like_jax():
    cfg = P.Config(nx=3600, ny=1800)
    c = K.step_constants(cfg)
    assert c.dt == float(np.float32(J.Config(nx=3600, ny=1800).dt))
    assert c.g == float(np.float32(9.81)) and c.visc == float(np.float32(cfg.lateral_viscosity))
