"""The port's CUDA kernels and CUDA-graph runs, on a card.

Every test here needs a CUDA device and ``nvcc``; each decides inside the
test and skips without them.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)
``python3 chip_smoke.py`` holds each kernel against its plain version at
the full width of its path.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.entry import entry  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_phase as KP  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_steps as K  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_wide as KW  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402

STEP_CASES = [(True, 1), (False, 1), (False, 2), (False, 3)]


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


def perturbed_state(ny, nx, seed=0):
    cfg = P.Config(nx=nx, ny=ny)
    base = [f.numpy() for f in P.initial_state(cfg, device="cpu")]
    rng = np.random.default_rng(seed)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    return tuple(
        torch.from_numpy((b + s * rng.standard_normal(b.shape)).astype(np.float32)).cuda()
        for b, s in zip(base, scales)
    )


@pytest.mark.gpu
@pytest.mark.parametrize("first,nsteps", STEP_CASES)
@pytest.mark.parametrize("ny,nx", [(24, 40), (270, 40), (8, 8), (33, 65)])
def test_kernel_matches_plain(ny, nx, first, nsteps):
    """Bit for bit: the kernel keeps the plain version's operand order and
    is built without FMA contraction; band 5e-6 + 1e-6*max|a| as a floor."""
    need_cuda()
    cfg = P.Config(nx=nx, ny=ny)
    fields = perturbed_state(ny, nx)
    before = K.counter.launches
    got = K.sw_steps(fields, cfg, first, nsteps)
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    torch.cuda.synchronize()
    assert K.counter.launches == before + 1
    for a, b in zip(want, got):
        assert (a - b).abs().max().item() <= 5e-6 + 1e-6 * a.abs().max().item()


@pytest.mark.gpu
def test_kernel_wrapper_checks():
    need_cuda()
    cfg = P.Config(nx=8, ny=8)
    good = tuple(P.initial_state(cfg, device="cuda"))
    with pytest.raises(ValueError, match="f32"):
        K.sw_steps(tuple(f.double() for f in good), cfg, False, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.sw_steps(tuple(f.t() for f in good), cfg, False, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.sw_steps(tuple(f[:, :5] for f in good), cfg, False, 1)


@pytest.mark.gpu
def test_pinned_run_counts_replayed_launches():
    need_cuda()
    cfg = P.Config(nx=48, ny=24)
    info = {}
    before = K.counter.launches
    _, n, pinned = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="auto",
                                 pinned=True, return_state=True, info=info)
    assert n == 7 and info["pinned"] and info["runs"] == 4
    assert K.counter.launches - before == (1 + 3) * 4  # Euler + 3 pairs per run
    assert K.counter.captured == 0
    _, _, eager = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="auto",
                                return_state=True, device="cuda")
    for a, b in zip(eager, pinned):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_entry_runs_on_the_card():
    need_cuda()
    fn, (state,) = entry()
    assert state.h.is_cuda
    before = K.counter.launches
    out = fn(state)
    assert K.counter.launches == before + 1
    assert all(bool(torch.isfinite(f).all()) for f in out)


# ---------------------------------------------------------------------------
# the split-phase and wide-halo kernels
# ---------------------------------------------------------------------------

# (nx, ny, grid, rank): one rank, corner and interior ranks of (2,4), and a
# local array that no tile divides
RANK_CASES = [(48, 24, (1, 1), 0), (64, 32, (2, 4), 0), (64, 32, (2, 4), 6),
              (100, 62, (2, 2), 3)]


def rank_state(nx, ny, grid, rank, periodic, seed=0):
    cfg = replace(P.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                  periodic_x=periodic)
    base = [f.numpy() for f in P.initial_state(cfg, rank=rank, device="cpu")]
    rng = np.random.default_rng(seed + rank)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    fields = tuple(
        torch.from_numpy((b + s * rng.standard_normal(b.shape)).astype(np.float32)).cuda()
        for b, s in zip(base, scales))
    py, px = divmod(rank, cfg.nproc_x)
    return cfg, fields, (py * (cfg.ny_local - 2), px * (cfg.nx_local - 2))


def assert_band(want, got):
    for a, b in zip(want, got):
        assert bool(torch.isfinite(b).all())
        assert (a - b).abs().max().item() <= 5e-6 + 1e-6 * a.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("nx,ny,grid,rank", RANK_CASES)
def test_phase_kernels_match_plain(nx, ny, grid, rank, periodic):
    """Every cell, the halo ring included; band 5e-6 + 1e-6*max|a|."""
    need_cuda()
    cfg, fields, off = rank_state(nx, ny, grid, rank, periodic)
    before = KP.counter.launches
    for first in (True, False):
        got = KP.sw_phase1(fields, cfg, first, off)
        assert_band(KP.sw_phase1_plain(fields, cfg, first, off), got)
    got = KP.sw_phase2(fields[1], fields[2], cfg, off)
    assert_band(KP.sw_phase2_plain(fields[1], fields[2], cfg, off), got)
    torch.cuda.synchronize()
    assert KP.counter.launches == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("first,nsteps", [(True, 1), (False, 1), (False, 2)])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("nx,ny,grid,rank", RANK_CASES)
def test_wide_kernel_matches_plain_on_crop(nx, ny, grid, rank, periodic, first,
                                           nsteps):
    """On the crop region of a frame built by ``_wide_exchange`` on one
    rank (zeros beyond the walls, so the garbage holds inf and NaN)."""
    need_cuda()
    cfg, fields, _ = rank_state(nx, ny, (1, 1), 0, periodic)
    m = P._margin_rows(nsteps)
    _, comm = P.make_mesh_and_comm(cfg, device="cuda")
    wf, _ = P._wide_exchange(fields, cfg, comm, m, P.create_token())
    off = (-(m - 1), -(m - 1))
    before = KW.counter.launches
    got = KW.sw_wide(wf, cfg, first, nsteps, off)
    want = KW.sw_wide_plain(wf, cfg, first, nsteps, off)
    torch.cuda.synchronize()
    assert KW.counter.launches == before + 1
    sl = (slice(m - 1, m - 1 + cfg.ny_local), slice(m - 1, m - 1 + cfg.nx_local))
    assert_band([a[sl] for a in want], [b[sl] for b in got])


@pytest.mark.gpu
def test_walled_pinned_wide2_run_counts_replayed_launches():
    need_cuda()
    cfg = P.Config(nx=48, ny=24, periodic_x=False)
    info = {}
    before = KW.counter.launches
    _, n, pinned = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="auto",
                                 pinned=True, return_state=True, info=info)
    assert n == 7 and info["runs"] == 4
    assert KW.counter.launches - before == (1 + 3) * 4  # Euler + 3 pairs per run
    _, _, eager = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="auto",
                                return_state=True, device="cuda")
    for a, b in zip(eager, pinned):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pallas_halo", "wide2"])
def test_kernel_modes_match_fast_step_on_the_card(mode):
    need_cuda()
    cfg = P.Config(nx=64, ny=32, periodic_x=False)
    _, comm = P.make_mesh_and_comm(cfg, device="cuda")
    s0 = P.initial_state(cfg, device="cuda")
    outs = []
    for fast in (True, mode):
        first, multi = P.make_stepper(cfg, comm, fast=fast)
        outs.append(multi(first(s0), 11))
    assert_band(*outs)
