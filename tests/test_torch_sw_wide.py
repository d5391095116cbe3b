"""The wide-halo kernel's module: its plain version, its tiling, its wrapper.

- ``sw_wide_plain`` (the plain version the CPU runs) against the JAX
  package's ``_wide_kernel_call(interpret=True)`` on the same widened
  frames, inside ``mpx.spmd`` on the (1,1) and (2,4) meshes (so every
  rank's frame offsets come from the JAX package's own ``_rank_offsets``),
  both boundary modes, one and two steps, Euler and AB-2.  The frames hold
  zero depths beyond the walls, as ``_wide_exchange`` builds them there,
  so the garbage region holds inf and NaN.  Compared on the crop region
  ``[m-1, m-1+ny_l) x [m-1, m-1+nx_l)``, band ``5e-6 + 1e-6 * max|a|``
  (tests/test_examples.py:291).
- ``csrc/sw_wide.cu``'s decomposition, run in PyTorch: the blocks the
  source lays out (strips and chunks over the crop only, gathered with
  periodic addressing, margins of ``nsteps * STEP_RADIUS``; reported by
  the source built for the host, ``tests/torch_sw_host.py``) reproduce
  the whole-frame plain version bit for bit on the crop, and one step's
  dependency radius, measured by NaN injection, is ``STEP_RADIUS``.
- The wrapper's dispatch.  Tests of the kernel itself need a card: they are
  in ``tests/test_torch_cuda.py``.
"""

import os
import sys
from dataclasses import replace
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

from mpi4jax_tpu_torch.kernels import sw_wide as K  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401
from torch_sw_host import host_libs, wide_blocks  # noqa: E402

pytest_plugins = ["leaked_env_guard"]

STEP_CASES = [(True, 1), (False, 1), (False, 2)]


def configs(grid, periodic, nx=64, ny=32):
    j = replace(J.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                periodic_x=periodic)
    p = replace(P.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                periodic_x=periodic)
    return j, p


def frame_offsets(cfg, rank, m):
    py, px = divmod(rank, cfg.nproc_x)
    return py * (cfg.ny_local - 2) - (m - 1), px * (cfg.nx_local - 2) - (m - 1)


def frames(cfg, m, seed=0, zero_beyond_walls=True):
    """Every rank's widened frame, six fields ``(nproc, ny_w, nx_w)``, cut
    from one seeded global array that extends ``m - 1`` cells beyond the
    domain's border: depths near 100, the rest noise at each field's
    scale, and, where asked, zeros beyond the walls (as ``_wide_exchange``
    leaves them)."""
    e = m - 1
    gy, gx = cfg.ny + 2 + 2 * e, cfg.nx + 2 + 2 * e
    rng = np.random.default_rng(seed)
    scales = (0.5, 0.1, 0.1, 1e-4, 1e-5, 1e-5)
    glob = [s * rng.standard_normal((gy, gx)) for s in scales]
    glob[0] += 100.0
    if zero_beyond_walls:
        beyond = np.zeros((gy, gx), bool)
        beyond[:e] = beyond[gy - e:] = True
        if not cfg.periodic_x:
            beyond[:, :e] = beyond[:, gx - e:] = True
        for g in glob:
            g[beyond] = 0.0
    ny_w, nx_w = cfg.ny_local + 2 * e, cfg.nx_local + 2 * e
    out = []
    for g in glob:
        blocks = []
        for r in range(cfg.nproc):
            oy, ox = frame_offsets(cfg, r, m)
            blocks.append(g[oy + e:oy + e + ny_w, ox + e:ox + e + nx_w])
        out.append(np.stack(blocks).astype(np.float32))
    return out


def crop(a, cfg, m):
    return a[..., m - 1:m - 1 + cfg.ny_local, m - 1:m - 1 + cfg.nx_local]


# ---------------------------------------------------------------------------
# plain version against the JAX kernel call (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,nsteps", STEP_CASES)
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("grid", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_plain_matches_jax_kernel_call(grid, periodic, first, nsteps):
    jcfg, pcfg = configs(grid, periodic)
    m = J._margin_rows(nsteps)
    data = frames(pcfg, m)
    _, comm = J.make_mesh_and_comm(jcfg, devices=jax.devices()[:jcfg.nproc])

    @partial(mpx.spmd, comm=comm)
    def call(*fs):
        return J._wide_kernel_call(tuple(fs), jcfg, first, nsteps, m, True)

    want = [np.asarray(a) for a in call(*map(jnp.asarray, data))]
    for r in range(pcfg.nproc):
        got = K.sw_wide(tuple(torch.from_numpy(a[r]) for a in data), pcfg,
                        first, nsteps, frame_offsets(pcfg, r, m))
        for name, a, b in zip(J.State._fields, want, got):
            a, b = crop(a[r], pcfg, m), crop(b.numpy(), pcfg, m)
            assert np.all(np.isfinite(b)), (r, name)
            bound = 5e-6 + 1e-6 * np.abs(a).max()
            err = np.abs(a - b).max()
            assert err <= bound, f"rank {r} {name}: {err:.3e} > {bound:.3e}"


# ---------------------------------------------------------------------------
# the kernel's tiling, emulated
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide_lib(tmp_path_factory):
    return host_libs(tmp_path_factory)["sw_wide"]


def tiled(lib, fields, cfg, first, nsteps, off):
    """What ``csrc/sw_wide.cu`` computes, block by block over the crop (as
    the source lays them out): gather each block's ``EXT`` columns and its
    rows grown by its margins by periodic addressing of the frame, run the
    steps on the window alone, keep the output rows and columns.  Cells
    outside the crop stay NaN: the kernel does not write them."""
    ny, nx = fields[0].shape
    outs = [torch.full_like(f, float("nan")) for f in fields]
    for oy, h, ox, w, my, mx in wide_blocks(lib, cfg, (ny, nx), nsteps)[0]:
        gy = torch.arange(oy - my, oy + h + my) % ny
        gx = torch.arange(ox - mx, ox - mx + K.EXT) % nx
        win = tuple(f[gy][:, gx] for f in fields)
        giy, gix = gy[:, None] + off[0], gx[None, :] + off[1]
        first_ = first
        for _ in range(nsteps):
            win = K._wide_step_window(cfg, first_, giy, gix, win, torch.roll)
            first_ = False
        for o, wf in zip(outs, win):
            o[oy:oy + h, ox:ox + w] = wf[my:my + h, mx:mx + w]
    return outs


@pytest.mark.parametrize("first,nsteps", STEP_CASES)
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("grid,rank", [((1, 1), 0), ((2, 4), 0), ((2, 4), 6)],
                         ids=["1x1", "2x4-r0", "2x4-r6"])
@pytest.mark.parametrize("nx,ny", [(64, 32), (1200, 40)], ids=["64x32", "1200x40"])
def test_tiles_with_margins_reproduce_whole_frame(wide_lib, nx, ny, grid, rank, periodic,
                                                  first, nsteps):
    """On the crop: at 64 x 32 these frames are one strip; at 1200 x 40
    two (2 x 4 ranks) or five (1 x 1), with a ragged last one."""
    _, cfg = configs(grid, periodic, nx=nx, ny=ny)
    m = P._margin_rows(nsteps)
    fields = tuple(torch.from_numpy(a[rank]) for a in frames(cfg, m, seed=1))
    off = frame_offsets(cfg, rank, m)
    want = K.sw_wide_plain(fields, cfg, first, nsteps, off)
    got = tiled(wide_lib, fields, cfg, first, nsteps, off)
    for name, a, b in zip(P.State._fields, want, got):
        assert torch.equal(crop(a, cfg, m), crop(b, cfg, m)), name
        assert int(torch.isnan(b).sum()) == b.numel() - cfg.ny_local * cfg.nx_local


def test_crop_region_is_the_local_array_inside_the_margins():
    _, cfg = configs((2, 4), False)
    for nsteps in (1, 2):
        m = P._margin_rows(nsteps)
        shape = (cfg.ny_local + 2 * (m - 1), cfg.nx_local + 2 * (m - 1))
        assert K.crop_region(cfg, shape) == (m - 1, m - 1, cfg.ny_local, cfg.nx_local)
    with pytest.raises(ValueError, match="grown by the same margin"):
        K.crop_region(cfg, (cfg.ny_local + 2, cfg.nx_local + 4))


def nan_spread(field):
    """The farthest (rows, cols) a NaN planted in one frame cell of
    ``field`` reaches in one wide step's outputs (periodic distance in the
    frame), over plantings near the walls, in the corners and in the
    interior, on a walled corner rank and an interior periodic rank."""
    spread = [0, 0]
    for grid, rank, periodic in [((2, 4), 0, False), ((2, 4), 7, False),
                                 ((2, 4), 5, True), ((1, 1), 0, False)]:
        _, cfg = configs(grid, periodic)
        m = P._margin_rows(1)
        base = [torch.from_numpy(a[rank])
                for a in frames(cfg, m, seed=2, zero_beyond_walls=False)]
        ny, nx = base[0].shape
        off = frame_offsets(cfg, rank, m)
        e = m - 1
        points = [(ny // 2, nx // 2), (e, e), (e + 1, e + 1), (ny - e - 1, nx - e - 1),
                  (ny - e - 2, nx - e - 2), (e, nx // 2), (ny // 2, e + 1)]
        for y, x in points:
            fields = [f.clone() for f in base]
            fields[field][y, x] = float("nan")
            for out in K.sw_wide_plain(fields, cfg, False, 1, off):
                ys, xs = torch.nonzero(torch.isnan(out), as_tuple=True)
                for a, b in zip(ys.tolist(), xs.tolist()):
                    spread[0] = max(spread[0], min((a - y) % ny, (y - a) % ny))
                    spread[1] = max(spread[1], min((b - x) % nx, (x - b) % nx))
    return tuple(spread)


@pytest.mark.parametrize("field", range(6), ids=P.State._fields)
def test_one_step_dependency_radius_within_margins(field):
    spread = nan_spread(field)
    assert spread[0] <= K.STEP_RADIUS[0] and spread[1] <= K.STEP_RADIUS[1], spread


def test_margins_are_the_measured_radius():
    spreads = [nan_spread(f) for f in range(6)]
    assert (max(s[0] for s in spreads), max(s[1] for s in spreads)) == K.STEP_RADIUS


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,nsteps", STEP_CASES)
def test_wrapper_on_cpu_is_the_plain_version(first, nsteps):
    _, cfg = configs((2, 4), False)
    m = P._margin_rows(nsteps)
    fields = tuple(torch.from_numpy(a[3]) for a in frames(cfg, m))
    off = frame_offsets(cfg, 3, m)
    before = K.counter.launches
    got = K.sw_wide(fields, cfg, first, nsteps, off)
    want = K.sw_wide_plain(fields, cfg, first, nsteps, off)
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
    assert K.counter.launches == before  # no kernel ran


@pytest.mark.parametrize("nsteps", [0, 3])
def test_wrapper_rejects_step_counts(nsteps):
    _, cfg = configs((1, 1), False)
    fields = tuple(torch.zeros(cfg.ny_local, cfg.nx_local) for _ in range(6))
    with pytest.raises(ValueError, match="1 or 2"):
        K.sw_wide(fields, cfg, False, nsteps, (0, 0))


@pytest.mark.parametrize("mode", ["wide", "wide2"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
def test_wide_mode_equals_fast_step_on_one_rank(periodic, mode):
    """On one rank the wide modes and ``model_step_fast`` evaluate the same
    operations in the same order: the same bits over 12 steps."""
    _, cfg = configs((1, 1), periodic)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    outs = []
    for fast in (True, mode):
        first, multi = P.make_stepper(cfg, comm, fast=fast)
        outs.append(multi(first(P.initial_state(cfg, device="cpu")), 11))
    for name, a, b in zip(P.State._fields, *outs):
        assert torch.equal(a, b), name


def test_wide_mode_refuses_a_small_interior():
    _, cfg = configs((1, 1), False, nx=48, ny=12)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    first, _ = P.make_stepper(cfg, comm, fast="wide2")
    with pytest.raises(ValueError, match="local interior"):
        first(P.initial_state(cfg, device="cpu"))
