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

from mpi4jax_tpu_torch.attention import flash_attention  # noqa: E402
from mpi4jax_tpu_torch.entry import entry  # noqa: E402
from mpi4jax_tpu_torch.kernels import flash_attention as FA  # noqa: E402
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


# domains whose local arrays put the kernel's strips side by side: one
# 256-column strip over both seams (230 + 2 columns at nsteps 1), the two
# seam strips alone (250 + 2), seam and interior strips with a ragged one
# (700 + 2), and several chunks of rows (300 + 2 rows)
STRIP_CASES = [(70, 230), (130, 250), (40, 700), (300, 1100)]


def same_bits(a, b):
    """Bit for bit, the signs of zeros included (``torch.equal`` takes -0
    for 0)."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("first,nsteps", STEP_CASES + [(True, 2), (True, 3)])
@pytest.mark.parametrize("ny,nx", STRIP_CASES)
def test_kernel_bit_for_bit_across_strips(ny, nx, first, nsteps):
    """Every output cell equals the plain version's bit for bit on frames
    whose seam strips, interior strips and chunks meet."""
    need_cuda()
    cfg = P.Config(nx=nx, ny=ny)
    fields = perturbed_state(ny, nx, seed=3)
    geo = K.geometry((cfg.ny_local, cfg.nx_local), nsteps)
    got = K.sw_steps(fields, cfg, first, nsteps)
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    torch.cuda.synchronize()
    assert geo["strips"] * geo["chunks"] > 1
    for name, a, b in zip(P.State._fields, want, got):
        assert same_bits(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("first,nsteps", STEP_CASES)
def test_kernel_bit_for_bit_on_a_region_at_rest(first, nsteps):
    """A flat, motionless middle, as the far field of the full-width
    initial state: zero numerators, which the division routine sends down
    its slow path, and dh's -0."""
    need_cuda()
    ny, nx = 130, 700
    cfg = P.Config(nx=nx, ny=ny)
    fields = perturbed_state(ny, nx, seed=4)
    rest = (slice(ny // 4, 3 * ny // 4), slice(nx // 4, 3 * nx // 4))
    for k, f in enumerate(fields):
        f[rest] = 100.0 if k == 0 else 0.0
    got = K.sw_steps(fields, cfg, first, nsteps)
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    torch.cuda.synchronize()
    assert bool((torch.signbit(want[3]) & (want[3] == 0)).any())
    for name, a, b in zip(P.State._fields, want, got):
        assert same_bits(a, b), name


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
def test_pinned_on_one_cuda_rank_stays_one_graph():
    """Where the CPU and several ranks run the pin eagerly, one CUDA rank
    still captures the whole run as one graph: each timed run is one
    replay, and no eager reason is named."""
    need_cuda()
    cfg = P.Config(nx=48, ny=24)
    info = {}
    P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="wide2", pinned=True,
                  info=info)
    assert info["pinned"] and info["replays"] == 1 and "eager_reason" not in info
    assert info["launches"] == {"sw_wide": 4}


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


def assert_phases_bit_for_bit(cfg, fields, off):
    """Euler and AB-2 phase 1 and phase 2 equal their plain versions bit
    for bit on every cell, the halo ring included, one launch each."""
    before = KP.counter.launches
    for first in (True, False):
        got = KP.sw_phase1(fields, cfg, first, off)
        for a, b in zip(KP.sw_phase1_plain(fields, cfg, first, off), got):
            assert same_bits(a, b)
    got = KP.sw_phase2(fields[1], fields[2], cfg, off)
    for a, b in zip(KP.sw_phase2_plain(fields[1], fields[2], cfg, off), got):
        assert same_bits(a, b)
    torch.cuda.synchronize()
    assert KP.counter.launches == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("nx,ny,grid,rank", RANK_CASES)
def test_phase_kernels_match_plain(nx, ny, grid, rank, periodic):
    """Every cell, the halo ring included, bit for bit."""
    need_cuda()
    assert_phases_bit_for_bit(*rank_state(nx, ny, grid, rank, periodic))


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("nx,ny,grid,rank", [(10, 8, (1, 1), 0), (3600, 16, (1, 1), 0),
                                             (4, 4, (2, 2), 1), (1200, 300, (2, 2), 3)])
def test_phase_kernels_bit_for_bit_on_tiny_and_ragged_frames(nx, ny, grid, rank, periodic):
    """The frames ``pallas_halo`` takes on many ranks: a 10 x 12 local
    array, one of 18 x 3602 rows (fifteen strips, one chunk of rows) and a
    4 x 4 rank; and a 152 x 602 rank (three strips, the last ragged, and a
    ragged last chunk)."""
    need_cuda()
    assert_phases_bit_for_bit(*rank_state(nx, ny, grid, rank, periodic))


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


def wide_frame(nx, ny, grid, rank, periodic, nsteps, seed=0):
    """A rank's widened frame on the card, cut from one seeded global array
    that extends m - 1 cells beyond the border, zero beyond the walls (as
    ``_wide_exchange`` leaves it), its config and offsets."""
    cfg = replace(P.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                  periodic_x=periodic)
    e = P._margin_rows(nsteps) - 1
    gy, gx = cfg.ny + 2 + 2 * e, cfg.nx + 2 + 2 * e
    rng = np.random.default_rng(seed)
    glob = [s * rng.standard_normal((gy, gx)) for s in (0.5, 0.1, 0.1, 1e-4, 1e-5, 1e-5)]
    glob[0] += 100.0
    beyond = np.zeros((gy, gx), bool)
    beyond[:e] = beyond[gy - e:] = True
    if not periodic:
        beyond[:, :e] = beyond[:, gx - e:] = True
    py, px = divmod(rank, cfg.nproc_x)
    oy, ox = py * (cfg.ny_local - 2), px * (cfg.nx_local - 2)
    ny_w, nx_w = cfg.ny_local + 2 * e, cfg.nx_local + 2 * e
    fields = []
    for g in glob:
        g[beyond] = 0.0
        fields.append(torch.from_numpy(g[oy:oy + ny_w, ox:ox + nx_w].astype(np.float32)).cuda())
    return cfg, tuple(fields), (oy - e, ox - e)


@pytest.mark.gpu
@pytest.mark.parametrize("first,nsteps", [(True, 1), (False, 1), (False, 2), (True, 2)])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walled"])
@pytest.mark.parametrize("nx,ny,grid,rank", [(600, 100, (1, 1), 0), (1200, 300, (2, 2), 3),
                                             (1200, 300, (2, 2), 0), (64, 32, (2, 4), 6)])
def test_wide_kernel_bit_for_bit_on_the_crop(nx, ny, grid, rank, periodic, first, nsteps):
    """The crop-only grid: on the crop every cell equals the plain
    version's bit for bit, for one rank and for corner and interior ranks
    of a grid (their offsets), with several strips and chunks."""
    need_cuda()
    cfg, wf, off = wide_frame(nx, ny, grid, rank, periodic, nsteps)
    got = KW.sw_wide(wf, cfg, first, nsteps, off)
    want = KW.sw_wide_plain(wf, cfg, first, nsteps, off)
    torch.cuda.synchronize()
    cy, cx, rows, cols = KW.crop_region(cfg, wf[0].shape)
    sl = (slice(cy, cy + rows), slice(cx, cx + cols))
    for name, a, b in zip(P.State._fields, want, got):
        assert same_bits(a[sl], b[sl]), name


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


# ---------------------------------------------------------------------------
# the flash-attention forward kernels
# ---------------------------------------------------------------------------

# (b, tq, tk, h, d): the shapes of tests/test_kernels.py (rectangular,
# ragged 257 x 1100), and the full head dim with tiles that neither
# length divides
FLASH_SHAPES = [(1, 16, 16, 1, 32), (2, 16, 24, 4, 32), (2, 8, 8, 3, 64),
                (1, 257, 1100, 1, 32), (2, 130, 70, 2, 128)]


def flash_inputs(b, tq, tk, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32))
               .to("cuda", dtype) for t in (tq, tk, tk))
    mask = torch.from_numpy(rng.random((tq, tk)) < 0.8).cuda()
    return q, k, v, mask


def assert_partials_band(want, got, o_rel):
    """Bands of tests/test_kernels.py against max|ref| per field: m 1e-6,
    l 1e-5, o ``o_rel`` (1e-5; 1e-4 causal; 4 * 2^-8 for bf16 o, its
    rounding unit)."""
    for (a, b), rel in zip(zip(want, got), (o_rel, 1e-6, 1e-5)):
        a, b = a.float(), b.float()
        assert a.shape == b.shape
        assert not bool(torch.isnan(b).any())
        fin = torch.isfinite(a)
        assert torch.equal(fin, torch.isfinite(b))
        top = a[fin].abs().max().item() if bool(fin.any()) else 0.0
        atol = 0.0 if rel > 1e-3 else rel
        assert (a[fin] - b[fin]).abs().max().item() <= atol + rel * top
        assert torch.equal(a[~fin], b[~fin])


FWD_COUNTERS = (FA.counter_tf32, FA.counter_causal_tf32, FA.counter_mma,
                FA.counter_causal_mma)


def fwd_launches():
    """Launches so far of (flash_fwd_tf32, flash_fwd_causal_tf32,
    flash_fwd_mma, flash_fwd_causal_mma)."""
    return np.array([c.launches for c in FWD_COUNTERS])


def assert_one_forward(before, dtype, causal):
    """One launch of the forward kernel of ``dtype``'s route (the
    tensor-core ``*_mma`` kernels for bf16, the 3xTF32 ``*_tf32`` ones for
    f32) and ``causal``, and none of the others."""
    want = [0, 0, 0, 0]
    want[2 * (dtype == torch.bfloat16) + int(causal)] = 1
    assert (fwd_launches() - before).tolist() == want


@pytest.fixture
def full_f32_products():
    """The plain versions multiply in full f32 (no TF32)."""
    need_cuda()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("b,tq,tk,h,d", FLASH_SHAPES)
def test_flash_kernel_matches_plain(full_f32_products, b, tq, tk, h, d, masked, dtype):
    q, k, v, mask = flash_inputs(b, tq, tk, h, d, dtype)
    mask = mask if masked else None
    scale = 1.0 / np.sqrt(d)
    before = fwd_launches()
    got = FA.flash_block_partials(q, k, v, mask, scale=scale)
    want = FA.block_partials_plain(q, k, v, mask, scale=scale)
    torch.cuda.synchronize()
    assert_one_forward(before, dtype, False)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    assert_partials_band(want, got, 1e-5 if dtype == torch.float32 else 4 * 2**-8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 32), (1, 1024, 1, 32), (1, 1100, 1, 32),
                                     (1, 100, 2, 64), (2, 200, 2, 128)])
def test_flash_causal_kernel_matches_plain(full_f32_products, b, t, h, d, dtype):
    q, k, v, _ = flash_inputs(b, t, t, h, d, dtype, seed=3)
    scale = 1.0 / np.sqrt(d)
    before = fwd_launches()
    got = FA.flash_block_partials(q, k, v, None, scale=scale, causal=True)
    want = FA.block_partials_plain(q, k, v, None, scale=scale, causal=True)
    torch.cuda.synchronize()
    assert_one_forward(before, dtype, True)
    assert_partials_band(want, got, 1e-4 if dtype == torch.float32 else 4 * 2**-8)


@pytest.mark.gpu
def test_flash_kernel_fully_masked_rows():
    """m = -inf, l = 0, o = 0 (never NaN) for rows with no attendable key,
    and rows of a partly masked block that have one agree with plain."""
    need_cuda()
    q, k, v, _ = flash_inputs(2, 100, 130, 2, 64, torch.float32, seed=1)
    mask = torch.zeros((100, 130), dtype=torch.bool, device="cuda")
    mask[::3, 5] = True  # a third of the rows see one key, the rest none
    o, m, l = FA.flash_block_partials(q, k, v, mask, scale=0.1)
    torch.cuda.synchronize()
    empty = torch.ones(100, dtype=torch.bool, device="cuda")
    empty[::3] = False
    assert bool(torch.isneginf(m[:, :, empty]).all())
    assert bool((l[:, :, empty] == 0).all()) and bool((o[:, empty] == 0).all())
    assert not bool(torch.isnan(o).any())
    assert_partials_band(FA.block_partials_plain(q, k, v, mask, scale=0.1),
                         (o, m, l), 1e-5)


@pytest.mark.gpu
def test_flash_kernel_mask_none_equals_all_true():
    need_cuda()
    q, k, v, _ = flash_inputs(1, 70, 90, 2, 32, torch.float32, seed=2)
    ones = torch.ones((70, 90), dtype=torch.bool, device="cuda")
    a = FA.flash_block_partials(q, k, v, None, scale=0.2)
    b = FA.flash_block_partials(q, k, v, ones, scale=0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_flash_bf16_kernel_fully_masked_rows(full_f32_products):
    """The tensor-core forward: rows with no attendable key give exactly
    (0, -inf, 0), never NaN, in a partly masked block whose other rows
    agree with plain; a wholly masked block gives it on every row."""
    q, k, v, _ = flash_inputs(2, 100, 130, 2, 64, torch.bfloat16, seed=1)
    mask = torch.zeros((100, 130), dtype=torch.bool, device="cuda")
    mask[::3, 5] = True  # a third of the rows see one key, the rest none
    before = fwd_launches()
    o, m, l = FA.flash_block_partials(q, k, v, mask, scale=0.1)
    torch.cuda.synchronize()
    assert_one_forward(before, torch.bfloat16, False)
    empty = torch.ones(100, dtype=torch.bool, device="cuda")
    empty[::3] = False
    assert bool(torch.isneginf(m[:, :, empty]).all())
    assert bool((l[:, :, empty] == 0).all()) and bool((o[:, empty] == 0).all())
    assert not bool(torch.isnan(o).any())
    assert_partials_band(FA.block_partials_plain(q, k, v, mask, scale=0.1),
                         (o, m, l), 4 * 2**-8)
    o, m, l = FA.flash_block_partials(q, k, v, torch.zeros_like(mask), scale=0.1)
    assert bool(torch.isneginf(m).all()) and bool((l == 0).all()) and bool((o == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("tk", [90, 128], ids=["bytes", "words"])
def test_flash_bf16_kernel_mask_none_equals_all_true(tk):
    """An all-True mask gives the unmasked bits, whether the mask tile is
    staged byte by byte (Tk not a multiple of 4) or by 4-byte copies."""
    need_cuda()
    q, k, v, _ = flash_inputs(1, 70, tk, 2, 32, torch.bfloat16, seed=2)
    ones = torch.ones((70, tk), dtype=torch.bool, device="cuda")
    a = FA.flash_block_partials(q, k, v, None, scale=0.2)
    b = FA.flash_block_partials(q, k, v, ones, scale=0.2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "mask", "causal"])
def test_flash_bf16_kernel_is_deterministic(mode):
    """Each block owns its query rows (no atomics): two calls give the
    same bits."""
    need_cuda()
    q, k, v, mask = flash_inputs(2, 300, 300, 2, 128, torch.bfloat16, seed=9)
    mask = mask if mode == "mask" else None
    first = FA.flash_block_partials(q, k, v, mask, scale=0.1, causal=mode == "causal")
    second = FA.flash_block_partials(q, k, v, mask, scale=0.1, causal=mode == "causal")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_bf16_kernel_takes_stride4_views(causal):
    """q, k, v views whose strides are multiples of 4 but not of 8 (and
    whose data is 8- but not 16-byte aligned) pass the input check; the
    tensor-core forward copies 16 bytes at once, so it works on a
    contiguous copy and gives the partials of that copy."""
    need_cuda()
    rng = np.random.default_rng(11)
    wide = [torch.from_numpy(rng.standard_normal((2, 90, 2, 68), dtype=np.float32))
            .to("cuda", torch.bfloat16) for _ in range(3)]
    q, k, v = (x[..., 4:68] for x in wide)
    assert q.stride() == (12240, 136, 68, 1) and q.data_ptr() % 16 == 8
    before = fwd_launches()
    got = FA.flash_block_partials(q, k, v, None, scale=0.1, causal=causal)
    want = FA.flash_block_partials(*(x.contiguous() for x in (q, k, v)), None,
                                   scale=0.1, causal=causal)
    torch.cuda.synchronize()
    assert (fwd_launches() - before).tolist() == ([0, 0, 0, 2] if causal
                                                  else [0, 0, 2, 0])
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "mask", "causal"])
def test_flash_f32_kernel_is_deterministic(mode):
    """The 3xTF32 forward: each block owns its query rows (no atomics), so
    two calls give the same bits."""
    need_cuda()
    q, k, v, mask = flash_inputs(2, 300, 300, 2, 128, torch.float32, seed=14)
    mask = mask if mode == "mask" else None
    before = fwd_launches()
    first = FA.flash_block_partials(q, k, v, mask, scale=0.1, causal=mode == "causal")
    second = FA.flash_block_partials(q, k, v, mask, scale=0.1, causal=mode == "causal")
    torch.cuda.synchronize()
    assert (fwd_launches() - before).tolist() == ([0, 2, 0, 0] if mode == "causal"
                                                  else [2, 0, 0, 0])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_f32_kernel_takes_stride4_views(causal):
    """q, k, v views whose strides are multiples of 4 (not of 8): the
    3xTF32 forward copies f32 16 bytes at once, which these views allow, so
    it reads them in place and gives the partials of their contiguous
    copies, bit for bit."""
    need_cuda()
    rng = np.random.default_rng(15)
    wide = [torch.from_numpy(rng.standard_normal((2, 90, 2, 68), dtype=np.float32))
            .cuda() for _ in range(3)]
    q, k, v = (x[..., 4:68] for x in wide)
    assert q.stride() == (12240, 136, 68, 1) and q.data_ptr() % 16 == 0
    before = fwd_launches()
    got = FA.flash_block_partials(q, k, v, None, scale=0.1, causal=causal)
    want = FA.flash_block_partials(*(x.contiguous() for x in (q, k, v)), None,
                                   scale=0.1, causal=causal)
    torch.cuda.synchronize()
    assert (fwd_launches() - before).tolist() == ([0, 2, 0, 0] if causal
                                                  else [2, 0, 0, 0])
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_f32_kernel_masked_keys_not_a_multiple_of_8(full_f32_products):
    """D = 128, 70 queries against 90 keys under a mask: the key count
    (and so the mask's row) is a multiple of neither 8 nor 4, so the last
    key tile is ragged inside an 8-wide slice of the permuted P V product
    and the mask tile is staged byte by byte."""
    q, k, v, mask = flash_inputs(2, 70, 90, 2, 128, torch.float32, seed=16)
    scale = 1.0 / np.sqrt(128)
    before = fwd_launches()
    got = FA.flash_block_partials(q, k, v, mask, scale=scale)
    want = FA.block_partials_plain(q, k, v, mask, scale=scale)
    torch.cuda.synchronize()
    assert_one_forward(before, torch.float32, False)
    assert_partials_band(want, got, 1e-5)


@pytest.mark.gpu
def test_flash_kernel_refuses_grad_and_bad_inputs():
    """A gradient through the kernels now launches the two backward
    kernels once each (no refusal); bad inputs are still refused."""
    need_cuda()
    q, k, v, _ = flash_inputs(1, 16, 16, 2, 32, torch.float32)
    q.requires_grad_(True)
    before = (FA.counter_bwd_dq_tf32.launches, FA.counter_bwd_dkv_tf32.launches)
    flash_attention(q, k, v, causal=True).sum().backward()
    torch.cuda.synchronize()
    assert (FA.counter_bwd_dq_tf32.launches, FA.counter_bwd_dkv_tf32.launches) == \
        (before[0] + 1, before[1] + 1)
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():
        FA.flash_block_partials(q, k, v, None, scale=0.2)
    q = q.detach()
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_block_partials(q[..., :24], k[..., :24], v[..., :24], None, scale=0.2)
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_block_partials(q.half(), k.half(), v.half(), None, scale=0.2)


# ---------------------------------------------------------------------------
# the flash-attention backward kernels
# ---------------------------------------------------------------------------


def cotangents(q, seed=4):
    """Seeded cotangents of o (q's shape and dtype) and l (B, H, Tq) f32."""
    b, tq, h, _ = q.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_o = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    g_l = torch.randn((b, h, tq), device="cuda", generator=gen)
    return g_o, g_l


def assert_grads_band(want, got, dtype):
    """Per gradient against max|ref|: the band of tests/test_kernels.py:252
    (rtol 1e-3, atol 1e-4) read as 1e-3 max|ref| + 1e-4; 4 * 2^-8 of
    max|ref| for bf16 (its rounding unit, twice)."""
    for a, b in zip(want, got):
        assert b.dtype == a.dtype == dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(b).all())
        top = a.abs().max().item()
        lim = 4 * 2**-8 * top if dtype == torch.bfloat16 else 1e-3 * top + 1e-4
        assert (a - b).abs().max().item() <= lim


BWD_COUNTERS = (FA.counter_bwd_dq_tf32, FA.counter_bwd_dkv_tf32, FA.counter_bwd_dq_mma,
                FA.counter_bwd_dkv_mma)


def bwd_launches():
    """Launches so far of (flash_bwd_dq_tf32, flash_bwd_dkv_tf32,
    flash_bwd_dq_mma, flash_bwd_dkv_mma)."""
    return np.array([c.launches for c in BWD_COUNTERS])


def assert_one_backward(before, dtype):
    """One launch of each backward kernel of ``dtype``'s route (the bf16
    ``*_mma`` kernels for bf16, the 3xTF32 ``*_tf32`` ones for f32) and
    none of the other route's."""
    want = [0, 0, 1, 1] if dtype == torch.bfloat16 else [1, 1, 0, 0]
    assert (bwd_launches() - before).tolist() == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("b,tq,tk,h,d", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(full_f32_products, b, tq, tk, h, d, masked,
                                       dtype):
    q, k, v, mask = flash_inputs(b, tq, tk, h, d, dtype, seed=5)
    mask = mask if masked else None
    scale = 1.0 / np.sqrt(d)
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=scale)
    g_o, g_l = cotangents(q)
    before = bwd_launches()
    got = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=scale)
    want = FA.block_partials_bwd_plain(q, k, v, mask, m, g_o, g_l, scale=scale)
    torch.cuda.synchronize()
    assert_one_backward(before, dtype)
    assert_grads_band(want, got, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 32), (1, 1024, 1, 32), (1, 1100, 1, 32),
                                     (1, 100, 2, 64), (2, 200, 2, 128)])
def test_flash_bwd_causal_kernels_match_plain(full_f32_products, b, t, h, d, dtype):
    q, k, v, _ = flash_inputs(b, t, t, h, d, dtype, seed=6)
    scale = 1.0 / np.sqrt(d)
    _, m, _ = FA.block_partials_plain(q, k, v, None, scale=scale, causal=True)
    g_o, g_l = cotangents(q)
    before = bwd_launches()
    got = FA.block_partials_bwd(q, k, v, None, m, g_o, g_l, scale=scale, causal=True)
    want = FA.block_partials_bwd_plain(q, k, v, None, m, g_o, g_l, scale=scale,
                                       causal=True)
    torch.cuda.synchronize()
    assert_one_backward(before, dtype)
    assert_grads_band(want, got, dtype)


@pytest.mark.gpu
def test_flash_bwd_fully_masked_rows_and_strided_cotangent():
    """Rows that see no key get exactly zero dq (and contribute nothing to
    dk, dv), never NaN; a non-contiguous g_o gives what its contiguous
    copy gives."""
    need_cuda()
    q, k, v, _ = flash_inputs(2, 100, 130, 2, 64, torch.float32, seed=7)
    mask = torch.zeros((100, 130), dtype=torch.bool, device="cuda")
    mask[::3, 5] = True
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=0.1)
    g_o, g_l = cotangents(q)
    g_t = g_o.transpose(0, 1).contiguous().transpose(0, 1)  # other strides
    dq, dk, dv = FA.block_partials_bwd(q, k, v, mask, m, g_t, g_l, scale=0.1)
    torch.cuda.synchronize()
    empty = torch.ones(100, dtype=torch.bool, device="cuda")
    empty[::3] = False
    assert bool((dq[:, empty] == 0).all())
    assert not any(bool(torch.isnan(x).any()) for x in (dq, dk, dv))
    again = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=0.1)
    for a, b in zip(again, (dq, dk, dv)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_bwd_bf16_fully_masked_rows_and_strided_cotangent(full_f32_products):
    """The same through the tensor-core kernels: rows that see no key get
    exactly zero dq, keys no row sees exactly zero dk and dv, never NaN;
    the rest within the bf16 band; a non-contiguous g_o gives what its
    contiguous copy gives."""
    q, k, v, _ = flash_inputs(2, 100, 130, 2, 64, torch.bfloat16, seed=7)
    mask = torch.zeros((100, 130), dtype=torch.bool, device="cuda")
    mask[::3, 5] = True
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=0.1)
    g_o, g_l = cotangents(q)
    g_t = g_o.transpose(0, 1).contiguous().transpose(0, 1)  # other strides
    before = bwd_launches()
    got = FA.block_partials_bwd(q, k, v, mask, m, g_t, g_l, scale=0.1)
    torch.cuda.synchronize()
    assert_one_backward(before, torch.bfloat16)
    dq, dk, dv = got
    empty = torch.ones(100, dtype=torch.bool, device="cuda")
    empty[::3] = False
    unseen = torch.ones(130, dtype=torch.bool, device="cuda")
    unseen[5] = False
    assert bool((dq[:, empty] == 0).all())
    assert bool((dk[:, unseen] == 0).all()) and bool((dv[:, unseen] == 0).all())
    assert not any(bool(torch.isnan(x).any()) for x in got)
    assert_grads_band(FA.block_partials_bwd_plain(q, k, v, mask, m, g_o, g_l, scale=0.1),
                      got, torch.bfloat16)
    again = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=0.1)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "mask", "causal"])
def test_flash_bwd_bf16_is_deterministic(mode):
    """Each block owns its output rows (no atomics): two calls give the
    same bits."""
    need_cuda()
    q, k, v, mask = flash_inputs(2, 300, 300, 2, 128, torch.bfloat16, seed=9)
    mask = mask if mode == "mask" else None
    causal = mode == "causal"
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=0.1, causal=causal)
    g_o, g_l = cotangents(q)
    first = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=0.1, causal=causal)
    second = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=0.1, causal=causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_bwd_bf16_takes_views_the_forward_takes():
    """q, k, v views whose strides are multiples of 4 but not of 8 (and
    whose data is 8- but not 16-byte aligned) pass the forward's check;
    the tensor-core backward reads 16 bytes at once, so it works on a
    contiguous copy and gives the gradients of that copy."""
    need_cuda()
    rng = np.random.default_rng(10)
    wide = [torch.from_numpy(rng.standard_normal((2, 90, 2, 68), dtype=np.float32))
            .to("cuda", torch.bfloat16) for _ in range(3)]
    q, k, v = (x[..., 4:68] for x in wide)
    assert q.stride() == (12240, 136, 68, 1) and q.data_ptr() % 16 == 8
    o, m, l = FA.flash_block_partials(q, k, v, None, scale=0.1)
    g_o, g_l = cotangents(q)
    before = bwd_launches()
    got = FA.block_partials_bwd(q, k, v, None, m, g_o, g_l, scale=0.1)
    want = FA.block_partials_bwd(*(x.contiguous() for x in (q, k, v)), None, m, g_o,
                                 g_l, scale=0.1)
    torch.cuda.synchronize()
    assert (bwd_launches() - before).tolist() == [0, 0, 2, 2]
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "mask", "causal"])
def test_flash_bwd_f32_is_deterministic(mode):
    """The 3xTF32 kernels: each block owns its output rows (no atomics),
    so two calls give the same bits."""
    need_cuda()
    q, k, v, mask = flash_inputs(2, 300, 300, 2, 128, torch.float32, seed=11)
    mask = mask if mode == "mask" else None
    causal = mode == "causal"
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=0.1, causal=causal)
    g_o, g_l = cotangents(q)
    before = bwd_launches()
    first = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=0.1, causal=causal)
    second = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=0.1, causal=causal)
    torch.cuda.synchronize()
    assert (bwd_launches() - before).tolist() == [2, 2, 0, 0]
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_bwd_f32_takes_views_the_forward_takes():
    """q, k, v views whose strides are multiples of 4 (not of 8) and a g_o
    of other strides: the 3xTF32 kernels read f32 16 bytes at once, which
    these views allow, and give the gradients of the contiguous copies."""
    need_cuda()
    rng = np.random.default_rng(12)
    wide = [torch.from_numpy(rng.standard_normal((2, 90, 2, 68), dtype=np.float32))
            .cuda() for _ in range(3)]
    q, k, v = (x[..., 4:68] for x in wide)
    assert q.stride() == (12240, 136, 68, 1) and q.data_ptr() % 16 == 0
    _, m, _ = FA.flash_block_partials(q, k, v, None, scale=0.1)
    g_o, g_l = cotangents(q)
    g_t = g_o.transpose(0, 1).contiguous().transpose(0, 1)  # other strides
    before = bwd_launches()
    got = FA.block_partials_bwd(q, k, v, None, m, g_t, g_l, scale=0.1)
    want = FA.block_partials_bwd(*(x.contiguous() for x in (q, k, v)), None, m, g_o,
                                 g_l, scale=0.1)
    torch.cuda.synchronize()
    assert (bwd_launches() - before).tolist() == [2, 2, 0, 0]
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_bwd_f32_masked_keys_not_a_multiple_of_8(full_f32_products):
    """D = 128, 70 queries against 90 keys under a mask: the key count
    (and so the mask's row) is a multiple of neither 8 nor 4, so the last
    key tile is ragged inside an 8-wide slice of the permuted products and
    the mask tile is staged byte by byte."""
    q, k, v, mask = flash_inputs(2, 70, 90, 2, 128, torch.float32, seed=13)
    scale = 1.0 / np.sqrt(128)
    _, m, _ = FA.block_partials_plain(q, k, v, mask, scale=scale)
    g_o, g_l = cotangents(q)
    before = bwd_launches()
    got = FA.block_partials_bwd(q, k, v, mask, m, g_o, g_l, scale=scale)
    want = FA.block_partials_bwd_plain(q, k, v, mask, m, g_o, g_l, scale=scale)
    torch.cuda.synchronize()
    assert_one_backward(before, torch.float32)
    assert_grads_band(want, got, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_gradients_on_the_card(full_f32_products, causal):
    """Autograd through ``flash_attention`` against ``reference_attention``
    (rtol 2e-3, atol 2e-4, tests/test_long_context.py:128), with one
    launch of each backward kernel."""
    from mpi4jax_tpu_torch.attention import reference_attention

    q, k, v, _ = flash_inputs(2, 96, 96, 2, 64, torch.float32, seed=8)
    grads = []
    for fn in (flash_attention, reference_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (fn(*leaves, causal=causal) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["bf16", "fp8"])
def test_codec_on_the_card_matches_the_cpu(codec):
    """The fp8 bytes, scales and decode and both roundtrips on CUDA tensors
    equal the CPU's bit for bit (the scale divides by a 0-dim tensor)."""
    need_cuda()
    from mpi4jax_tpu_torch.ops import _compress as Z

    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.standard_normal((37, 300))
                          * 10.0 ** rng.integers(-20, 20, (37, 1))).astype(np.float32))
    got = Z.roundtrip(x.cuda(), codec).cpu()
    assert torch.equal(got.view(torch.int32), Z.roundtrip(x, codec).view(torch.int32))
    (q, s), (qc, sc) = Z.encode_fp8(x.cuda()), Z.encode_fp8(x)
    assert torch.equal(q.cpu().view(torch.uint8), qc.view(torch.uint8))
    assert torch.equal(s.cpu(), sc)


@pytest.mark.gpu
def test_fused_results_stay_on_the_card():
    """A world of one on the card: the packed allreduce and bcast results
    are CUDA tensors equal to their inputs."""
    need_cuda()
    import mpi4jax_tpu_torch as tpx

    mesh = tpx.make_world_mesh(device="cuda")
    comm = tpx.Comm(mesh.axes[0], mesh=mesh)
    xs = [torch.arange(5.0, device="cuda"), torch.ones(2, 3, device="cuda")]
    tpx.set_fusion_mode("force")
    try:
        out = tpx.run(lambda: [tpx.allreduce(x)[0] for x in xs]
                      + [tpx.bcast(x, 0)[0] for x in xs], comm=comm)
    finally:
        tpx.set_fusion_mode(None)
    for got, want in zip(out, xs + xs):
        assert got.is_cuda and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the dispatch layer: pins as CUDA graphs, megastep graphs
# ---------------------------------------------------------------------------


def _one_rank_comm():
    from mpi4jax_tpu_torch import Comm, make_world_mesh

    return Comm("x", mesh=make_world_mesh((1,), ("x",), device="cuda"))


def _generic_step(v):
    from mpi4jax_tpu_torch import SUM, allreduce

    s, _ = allreduce(v, op=SUM)
    return s * 0.25 + v * 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("unroll", [1, 3, 8])
def test_graph_megastep_equals_eager_calls(unroll):
    """``compile(unroll=N)`` on one CUDA rank is one CUDA graph whose call
    equals N eager calls bit for bit."""
    need_cuda()
    import mpi4jax_tpu_torch as tpx

    comm = _one_rank_comm()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 256))
                         .astype(np.float32)).cuda()
    want = x
    eager = tpx.spmd(_generic_step, comm=comm)
    for _ in range(unroll):
        want = eager(want)
    pinned = tpx.compile(_generic_step, x, comm=comm, unroll=unroll)
    before = tpx.aot.stats()["aot"]["replays"]
    got = pinned(x)
    torch.cuda.synchronize()
    assert pinned.graph and pinned.unroll == unroll
    assert tpx.aot.stats()["aot"]["replays"] == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_failed_capture_raises():
    """A body that synchronises with the host cannot be captured: compile
    raises, and nothing falls back to an eager run."""
    need_cuda()
    import mpi4jax_tpu_torch as tpx

    def synchronising(v):
        return v * v.sum().item()

    x = torch.ones(4, 4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA graph"):
        tpx.compile(synchronising, x, comm=_one_rank_comm())
    torch.cuda.synchronize()
    # the card is usable after the failed capture
    assert tpx.compile(_generic_step, x, comm=_one_rank_comm())(x).sum().item() == 12.0


@pytest.mark.gpu
def test_results_survive_the_next_call_unless_donated():
    """A call returns copies: the next replay does not overwrite them.
    With the carry donated, ``s = program(s)`` copies nothing and each call
    returns the graph's own buffers."""
    need_cuda()
    import mpi4jax_tpu_torch as tpx

    comm = _one_rank_comm()
    x = torch.arange(16.0, device="cuda").reshape(4, 4)
    kept = tpx.compile(_generic_step, x, comm=comm)
    a = kept(x)
    a_copy = a.clone()
    b = kept(a)
    torch.cuda.synchronize()
    assert torch.equal(a, a_copy) and not torch.equal(a, b)
    assert kept.bytes_copied == 2 * x.numel() * 4

    donated = tpx.compile(_generic_step, x, comm=comm, donate_argnums=0)
    s = donated(x.clone())
    first = s.clone()
    s2 = donated(s)
    torch.cuda.synchronize()
    assert s2.data_ptr() == s.data_ptr() and donated.bytes_copied == 0
    assert torch.equal(s2, tpx.spmd(_generic_step, comm=comm)(first))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,per_step", [("pallas2", 1), ("wide2", 1),
                                           ("pallas_halo", 2)])
def test_solve_fused_unroll_on_the_card(mode, per_step):
    """``solve_fused(unroll=4)`` over 12 steps (two megasteps and a tail of
    3): graphs, one kernel call a step (two for the split-phase path), the
    final state bit for bit with ``pinned=True``'s."""
    need_cuda()
    cfg = P.Config(nx=48, ny=24, periodic_x=mode != "wide2")
    name = {"pallas2": "sw_steps", "wide2": "sw_wide", "pallas_halo": "sw_phase"}[mode]
    info = {}
    _, n, got = P.solve_fused(cfg, 12 * cfg.dt, num_multisteps=1, fast=mode,
                              unroll=4, return_state=True, info=info)
    _, _, want = P.solve_fused(cfg, 12 * cfg.dt, num_multisteps=1, fast=mode,
                               pinned=True, return_state=True)
    assert n == 12 and info["unroll"] == 4 and info["pinned"]
    assert info["replays"] == 3 and info["launches"][name] == per_step * 12
    for a, b in zip(want, got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_unroll_one_launches_as_the_call_without_the_layer():
    """``spmd(unroll=1)`` and ``compile(unroll=1)`` launch what a direct
    call launches, with the same bits."""
    need_cuda()
    import mpi4jax_tpu_torch as tpx

    cfg = P.Config(nx=48, ny=24)
    _, comm = P.make_mesh_and_comm(cfg, device="cuda")
    s = P.initial_state(cfg, device="cuda")

    def step(state):
        return P.model_step_fused(state, cfg, comm, False)

    runs = []
    for fn in (step, tpx.spmd(step, comm=comm), tpx.spmd(step, comm=comm, unroll=1),
               tpx.compile(step, s, comm=comm, unroll=1)):
        before = K.counter.launches
        out = fn(s)
        torch.cuda.synchronize()
        runs.append((K.counter.launches - before, out))
    assert [n for n, _ in runs] == [1, 1, 1, 1]
    for _, out in runs[1:]:
        for a, b in zip(runs[0][1], out):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_meta_routes_launch_nothing_on_the_card():
    """The verifier's abstract runs (``analysis/``) of the card's programs
    on CUDA tensors: 0 error findings, and no kernel's launch counter
    moves (each kernel takes its ``meta`` shape rule)."""
    need_cuda()
    from mpi4jax_tpu_torch import analyze
    from mpi4jax_tpu_torch.attention import ring_attention
    from mpi4jax_tpu_torch.kernels import _build
    from mpi4jax_tpu_torch.parallel.comm import Comm
    from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid

    card = torch.device("cuda", 0)
    before = _build.launch_totals()
    cfg = P.Config(nx=256, ny=128, nproc_y=2, nproc_x=2)
    grid = Comm(("py", "px"), mesh=ProcessGrid((2, 2), ("py", "px"), card))
    state = P.State(*[torch.zeros((cfg.ny_local, cfg.nx_local), device=card)] * 6)
    for mode in ("wide2", "pallas_halo"):
        step = P.select_steps(mode, cfg)[0]
        rep = analyze(lambda s, step=step: step(s, cfg, grid, False), state,
                      comm=grid, ranks="all")
        assert not rep.errors and rep.events
    ring = Comm("i", mesh=ProcessGrid((4,), ("i",), card))
    q = torch.rand((1, 64, 2, 64), device=card)
    rep = analyze(lambda a: ring_attention(a, a, a, comm=ring), q, comm=ring,
                  ranks="all")
    assert not rep.errors and rep.events
    assert _build.launch_totals() == before


@pytest.mark.gpu
def test_command_benchmark_on_the_card(capsys):
    """``python -m mpi4jax_tpu_torch.models.shallow_water --benchmark
    --scale 1 --t1-days 0.01`` on the card: 360x180, 51 steps through
    ``sw_steps`` (26 launches a run: the Euler call and 25 pairs; a
    warm-up and two timed runs), its final ``h`` bit for bit the same
    command's on the CPU (the kernel is built without FMA contraction)."""
    need_cuda()
    argv = ["--benchmark", "--scale", "1", "--t1-days", "0.01"]
    before = K.counter.launches
    got = P.run(argv)
    launches = K.counter.launches - before
    assert got["device"].startswith("cuda") and got["mode"] == "pallas2"
    assert got["n_steps"] == 51 and got["snapshots"] == []
    assert launches == 26 * 3 == got["launches"][0]["sw_steps"]
    assert np.isfinite(got["final_h"]).all()
    want = P.run([*argv, "--device", "cpu"])
    np.testing.assert_array_equal(got["final_h"], want["final_h"])
    assert "(51 steps, " in capsys.readouterr().out


@pytest.mark.gpu
def test_vmap_ops_on_the_card():
    """``chip_smoke.py`` phase 21 (a) and (b) on one gloo rank on the card:
    ``torch.func.vmap`` over the 13 ops and the tokenless ``allreduce``
    and ``sendrecv`` on CUDA tensors, each bit for bit with its lanes and
    with as many exchanges as one lane's call; ``jacfwd`` and ``jacrev``
    of a SUM-allreduce and of a ring, the card's bits the CPU's."""
    need_cuda()
    import chip_smoke
    from mpi4jax_tpu_torch.parallel import launch

    (res,) = launch.run(chip_smoke.vmap_rank, 1, backend="gloo", device="cuda:0",
                        timeout=120, args=("cuda:0", 1, 1))
    assert len(res["cases"]) == 38 and res["worst"] == 0.0
    assert all(c["calls"] == 0 for c in res["cases"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_vmapped_flash_partials_are_one_launch_on_the_card(dtype, causal):
    """``chip_smoke.py`` phase 22 (a) at a small width: ``torch.func.vmap``
    over the partials is one forward launch, its lanes bit for bit the
    unbatched launch of the folded batch; ``vmap(grad)`` one ``dq`` and one
    ``dk``/``dv`` launch."""
    need_cuda()
    from torch.func import grad, vmap

    from mpi4jax_tpu_torch.kernels import _build

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((3, 2, 128, 2, 64), device="cuda", generator=g).to(dtype)
               for _ in range(3))
    f = lambda q, k, v: FA.flash_block_partials(q, k, v, None, scale=0.125,  # noqa: E731
                                                causal=causal)
    before = _build.launch_totals()
    got = vmap(f)(q, k, v)
    torch.cuda.synchronize()
    moved = {n: c - before.get(n, 0) for n, c in _build.launch_totals().items()
             if c != before.get(n, 0)}
    assert sum(moved.values()) == 1, moved
    want = f(*(x.reshape(6, *x.shape[2:]) for x in (q, k, v)))
    for a, b in zip(got, want):
        assert torch.equal(a.reshape(b.shape).view(torch.uint8), b.view(torch.uint8))
    before = _build.launch_totals()
    vmap(grad(lambda q, k, v: (flash_attention(q, k, v, causal=causal).float() ** 2).sum(),
              argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    moved = {n: c - before.get(n, 0) for n, c in _build.launch_totals().items()
             if c != before.get(n, 0) and "bwd" in n}
    assert sorted(moved.values()) == [1, 1], moved


@pytest.mark.gpu
def test_batched_stencil_launches_are_each_lane_on_the_card():
    """Each stencil kernel on stacked ``(lanes, ny, nx)`` fields: one
    launch, each lane bit for bit its own one-lane launch (ragged strips
    and chunks, walled and periodic, both phases)."""
    need_cuda()
    cfg = P.Config(nx=598, ny=38)
    lanes = [perturbed_state(38, 598, seed) for seed in range(3)]
    stacked = tuple(torch.stack(f) for f in zip(*lanes))
    runs = {"sw_steps": (K.counter, lambda f: K.sw_steps(f, cfg, False, 2)),
            "sw_phase1": (KP.counter, lambda f: KP.sw_phase1(f, cfg, True, (0, 0))),
            "sw_phase2": (KP.counter, lambda f: KP.sw_phase2(f[1], f[2], cfg, (0, 0)))}
    for name, (counter, fn) in runs.items():
        before = counter.launches
        got = fn(stacked)
        torch.cuda.synchronize()
        assert counter.launches - before == 1, name
        for i, lane in enumerate(lanes):
            for a, b in zip(got, fn(lane)):
                assert torch.equal(a[i].view(torch.int32), b.view(torch.int32)), (name, i)
    wcfg = replace(P.Config(nx=64, ny=32, nproc_y=2, nproc_x=2), periodic_x=False)
    frames = [tuple(torch.randn((48, 64), device="cuda") for _ in range(6))
              for _ in range(2)]
    stacked = tuple(torch.stack(f) for f in zip(*frames))
    before = KW.counter.launches
    got = KW.sw_wide(stacked, wcfg, False, 2, (-15, -15))
    torch.cuda.synchronize()
    assert KW.counter.launches - before == 1
    cy, cx, rows, cols = KW.crop_region(wcfg, (48, 64))
    crop = (slice(cy, cy + rows), slice(cx, cx + cols))
    for i, lane in enumerate(frames):
        for a, b in zip(got, KW.sw_wide(lane, wcfg, False, 2, (-15, -15))):
            assert torch.equal(a[i][crop].contiguous().view(torch.int32),
                               b[crop].contiguous().view(torch.int32))
