"""The stencil kernels' CUDA sources run on the host, bit for bit.

``csrc/sw_steps.cu``, ``csrc/sw_wide.cu`` and ``csrc/sw_phase.cu`` (all on
the streamed rows of ``csrc/sw_stream.cuh``), built for the host as
``tests/torch_sw_host.py`` says (so that they round as ``nvcc -fmad=false``
builds them), are held against the plain versions bit for bit
(``same_bits``: the signs of zeros too, which ``torch.equal`` does not
see): every ``nsteps``, Euler and AB-2, on periodic frames whose one strip
spans both seams, frames of two, three and four strips with ragged last
strips and chunks, and frames narrower than the margins; on walled,
periodic and offset wide frames of one and several strips (the crop, and
no cell written outside it); and both split phases (Euler and AB-2 phase
1, phase 2) on the local arrays of single, corner, edge and interior
ranks, periodic and walled, ragged, tiny and at rest (every cell written,
the halo ring included).
The warps run in lockstep and, in the last tests, each alone from one
barrier to the next in ascending and descending order, where a ring row
refilled before every warp has read it gives a wrong result.  The
geometry functions the sources export agree with the blocks they report,
give the main path's computed over useful cells and residency under the
H100's shared-memory limits, and the kernels' division by a held
reciprocal (``Divisor``) is held against true division on 24 M
numerators.  A batched launch (2 and 3 lanes, one a ``blockIdx.z``) of
each source, both phases, walled and periodic, with ragged strips, is bit
for bit each lane's one-lane launch in lockstep and with the warps run
apart, and writes nothing outside its lanes.  Skips where no C++ compiler
is found.
"""

import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.kernels import sw_phase as KP  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_steps as K  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_wide as KW  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from test_torch_warp_emulation import HOST  # noqa: E402
from torch_sw_host import host_libs, phase_blocks, steps_blocks, wide_blocks  # noqa: E402

STEPS = [(True, 1), (False, 1), (False, 2), (False, 3), (True, 2), (True, 3)]
WIDE_STEPS = [(True, 1), (False, 1), (False, 2), (True, 2)]
SENTINEL = 12345.0


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return host_libs(tmp_path_factory)


def state(ny, nx, seed):
    """A periodic local state ``(ny, nx)``: the initial state with every
    field perturbed by seeded noise at its own scale.  With ``seed`` None
    the middle half of the array is at rest instead (a flat depth, every
    other field zero), as the far field of the full-width initial state
    is: there the divisions' numerators are zero, and dh comes out as
    -0."""
    cfg = P.Config(nx=nx - 2, ny=ny - 2)
    rng = np.random.default_rng(0 if seed is None else seed)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    fields = tuple(
        (b + s * torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32))).contiguous()
        for b, s in zip(P.initial_state(cfg, device="cpu"), scales))
    if seed is None:
        rest = (slice(ny // 4, 3 * ny // 4), slice(nx // 4, 3 * nx // 4))
        for k, f in enumerate(fields):
            f[rest] = 100.0 if k == 0 else 0.0
    return cfg, fields


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def lanes_of(fields):
    """``(lanes, elements between lanes)`` of a launch on ``fields``: one
    plane, or a ``(lanes, ny, nx)`` stack."""
    ny, nx = fields[0].shape[-2:]
    return (fields[0].shape[0] if fields[0].dim() == 3 else 1), ny * nx


def run_steps(lib, fields, cfg, first, nsteps, outs=None):
    if outs is None:
        outs = tuple(torch.full_like(f, SENTINEL) for f in fields)
    c = K.step_constants(cfg)
    ny, nx = fields[0].shape[-2:]
    err = lib.sw_steps_launch(*(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs),
                              ny, nx, int(first), nsteps, int(cfg.lateral_viscosity > 0),
                              c.dx, c.dy, c.g, c.dt, c.ab_a, c.ab_b, c.f0, c.beta, c.visc,
                              *lanes_of(fields), None)
    assert err == 0
    return outs


def assert_steps_match(lib, ny, nx, first, nsteps, seed=1):
    cfg, fields = state(ny, nx, seed)
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    got = run_steps(lib, fields, cfg, first, nsteps)
    for name, a, b in zip(P.State._fields, want, got):
        assert same_bits(a, b), name


# local shapes under 256-column strips and chunks of 8 rows a step: (12,
# 40) one strip over both seams, (9, 8) narrower than any margin, (30, 300)
# the two seam strips alone, (44, 600) and (20, 850) seam and interior
# strips with a ragged last one, and several chunks with a ragged last one
STEP_SHAPES = [(12, 40), (9, 8), (30, 300), (44, 600), (20, 850)]


@pytest.mark.parametrize("first,nsteps", STEPS)
@pytest.mark.parametrize("ny,nx", STEP_SHAPES)
def test_emulated_sw_steps_matches_plain(libs, ny, nx, first, nsteps):
    assert_steps_match(libs["sw_steps"], ny, nx, first, nsteps)


@pytest.mark.parametrize("first,nsteps", STEPS)
@pytest.mark.parametrize("ny,nx", [(40, 300), (30, 600)])
def test_emulated_sw_steps_matches_plain_on_exact_zeros(libs, ny, nx, first, nsteps):
    cfg, fields = state(ny, nx, None)
    out = K.sw_steps_plain(fields, cfg, first, nsteps)
    assert int((torch.signbit(out[3]) & (out[3] == 0)).sum()) > 0  # -0 in dh
    assert_steps_match(libs["sw_steps"], ny, nx, first, nsteps, seed=None)


def wide_case(grid, rank, periodic, nsteps, seed=0, nx=64, ny=32):
    """A rank's widened frame of a ``grid`` of ranks, cut from one seeded
    global array with zero depths beyond the walls (as ``_wide_exchange``
    leaves them), its config and its offsets."""
    cfg = P.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1], periodic_x=periodic)
    m = P._margin_rows(nsteps)
    e = m - 1
    gy, gx = cfg.ny + 2 + 2 * e, cfg.nx + 2 + 2 * e
    rng = np.random.default_rng(seed)
    glob = [s * rng.standard_normal((gy, gx)) for s in (0.5, 0.1, 0.1, 1e-4, 1e-5, 1e-5)]
    glob[0] += 100.0
    beyond = np.zeros((gy, gx), bool)
    beyond[:e] = beyond[gy - e:] = True
    if not periodic:
        beyond[:, :e] = beyond[:, gx - e:] = True
    for g in glob:
        g[beyond] = 0.0
    py, px = divmod(rank, cfg.nproc_x)
    oy, ox = py * (cfg.ny_local - 2) - e, px * (cfg.nx_local - 2) - e
    ny_w, nx_w = cfg.ny_local + 2 * e, cfg.nx_local + 2 * e
    fields = tuple(torch.from_numpy(g[oy + e:oy + e + ny_w, ox + e:ox + e + nx_w]
                                    .astype(np.float32)).contiguous() for g in glob)
    return cfg, fields, (oy, ox)


def run_wide(lib, fields, cfg, first, nsteps, off, outs=None):
    if outs is None:
        outs = tuple(torch.full_like(f, SENTINEL) for f in fields)
    c = K.step_constants(cfg)
    ny, nx = fields[0].shape[-2:]
    cy, cx, rows, cols = KW.crop_region(cfg, (ny, nx))
    err = lib.sw_wide_launch(*(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs),
                             ny, nx, off[0], off[1], cfg.ny + 2, cfg.nx + 2,
                             int(not cfg.periodic_x), cy, cx, rows, cols, int(first), nsteps,
                             int(cfg.lateral_viscosity > 0), c.dx, c.dy, c.g, c.dt, c.ab_a,
                             c.ab_b, c.f0, c.beta, c.visc, *lanes_of(fields), None)
    assert err == 0
    return outs


def assert_wide_match(lib, case, first, nsteps):
    grid, rank, periodic, nx, ny = case
    cfg, fields, off = wide_case(grid, rank, periodic, nsteps, nx=nx, ny=ny)
    want = KW.sw_wide_plain(fields, cfg, first, nsteps, off)
    got = run_wide(lib, fields, cfg, first, nsteps, off)
    cy, cx, rows, cols = KW.crop_region(cfg, fields[0].shape)
    crop = (slice(cy, cy + rows), slice(cx, cx + cols))
    for name, a, b in zip(P.State._fields, want, got):
        assert same_bits(a[crop].contiguous(), b[crop].contiguous()), name
        outside = torch.ones_like(b, dtype=torch.bool)
        outside[crop] = False
        assert bool((b[outside] == SENTINEL).all()), f"{name} written outside the crop"


# (grid, rank, periodic, nx, ny): one strip on the small frames, three
# strips and several chunks on the (1,1) 600 x 20 and the (2,2) rank 3 of
# 1200 x 40 (a 602-column crop at an offset)
WIDE_CASES = [((1, 1), 0, True, 64, 32), ((1, 1), 0, False, 64, 32),
              ((2, 4), 0, False, 64, 32), ((2, 4), 6, True, 64, 32),
              ((2, 4), 6, False, 64, 32), ((1, 1), 0, False, 600, 20),
              ((2, 2), 3, True, 1200, 40)]
WIDE_IDS = ["1x1-periodic", "1x1-walled", "2x4-r0-walled", "2x4-r6-periodic", "2x4-r6-walled",
            "1x1-walled-3strips", "2x2-r3-periodic-3strips"]


@pytest.mark.parametrize("first,nsteps", WIDE_STEPS)
@pytest.mark.parametrize("case", WIDE_CASES, ids=WIDE_IDS)
def test_emulated_sw_wide_matches_plain_on_the_crop(libs, case, first, nsteps):
    assert_wide_match(libs["sw_wide"], case, first, nsteps)


def phase_case(grid, rank, periodic, nx, ny, seed=0, dx=5e3):
    """Rank ``rank``'s local state of a ``grid`` of ranks over an ``nx`` x
    ``ny`` domain of spacing ``dx``, every field perturbed by seeded noise
    at its own scale (with ``seed`` None the middle half of the array at
    rest instead, as in ``state``), its config and its offsets."""
    cfg = P.Config(nx=nx, ny=ny, dx=dx, dy=dx, nproc_y=grid[0], nproc_x=grid[1],
                   periodic_x=periodic)
    rng = np.random.default_rng(rank if seed is None else seed + rank)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    fields = tuple(
        (b + s * torch.from_numpy(rng.standard_normal(b.shape).astype(np.float32))).contiguous()
        for b, s in zip(P.initial_state(cfg, rank=rank, device="cpu"), scales))
    if seed is None:
        ny_l, nx_l = fields[0].shape
        rest = (slice(ny_l // 4, 3 * ny_l // 4), slice(nx_l // 4, 3 * nx_l // 4))
        for k, f in enumerate(fields):
            f[rest] = 100.0 if k == 0 else 0.0
    py, px = divmod(rank, cfg.nproc_x)
    return cfg, fields, (py * (cfg.ny_local - 2), px * (cfg.nx_local - 2))


def run_phase(lib, phase, fields, cfg, off, outs=None):
    """Phase 1 (``"euler"``, ``"ab2"``) or 2 (``"visc"``) of ``lib`` into
    outputs filled with a sentinel (or ``outs``); returns what the plain
    version returns (six fields, or u and v)."""
    ints, floats = KP._frame_args(cfg, off)
    if phase == "visc":
        if outs is None:
            outs = (torch.full_like(fields[1], SENTINEL), torch.full_like(fields[2], SENTINEL))
        err = lib.sw_phase2_launch(fields[1].data_ptr(), fields[2].data_ptr(),
                                   *(o.data_ptr() for o in outs), *ints, *floats,
                                   *lanes_of(fields), None)
    else:
        if outs is None:
            outs = tuple(torch.full_like(f, SENTINEL) for f in fields)
        err = lib.sw_phase1_launch(*(f.data_ptr() for f in fields),
                                   *(o.data_ptr() for o in outs), *ints,
                                   int(phase == "euler"), *floats, *lanes_of(fields), None)
    assert err == 0
    return outs


def assert_phase_match(lib, case, phase):
    cfg, fields, off = phase_case(*case)
    if phase == "visc":
        want = KP.sw_phase2_plain(fields[1], fields[2], cfg, off)
        names = ("u", "v")
    else:
        want = KP.sw_phase1_plain(fields, cfg, phase == "euler", off)
        names = P.State._fields
    got = run_phase(lib, phase, fields, cfg, off)
    for name, a, b in zip(names, want, got):
        assert same_bits(a, b), name


PHASES = ["euler", "ab2", "visc"]
# (grid, rank, periodic, nx, ny, seed[, dx]): the single rank both ways;
# corner ranks 0 and 7, edge rank 2 and interior-column rank 5 of (2,4);
# rank 3 of (2,2) on 1200 x 40 (a 602 x 22 local array: three strips, the
# last ragged, and two chunks, the last ragged); the tiny frames
# pallas_halo takes: a 10 x 12 local array (one strip far wider than it),
# 18 x 3602 (fifteen strips, two chunks) and a 4 x 4 rank of (2,2); a
# single rank whose middle half is at rest (exact zeros); and a spacing of
# 2000 km, whose reciprocal the host does not certify (outside [2^-20,
# 2^20]): every division by dx and dy then takes the double division
PHASE_CASES = [((1, 1), 0, True, 64, 32, 0), ((1, 1), 0, False, 64, 32, 0),
               ((2, 4), 0, False, 64, 32, 0), ((2, 4), 7, False, 64, 32, 0),
               ((2, 4), 2, True, 64, 32, 0), ((2, 4), 5, False, 64, 32, 0),
               ((2, 2), 3, False, 1200, 40, 0), ((1, 1), 0, False, 10, 8, 0),
               ((1, 1), 0, True, 3600, 16, 0), ((2, 2), 1, False, 4, 4, 0),
               ((1, 1), 0, True, 300, 40, None), ((2, 2), 3, False, 64, 32, 0, 2e6)]
PHASE_IDS = ["1x1-periodic", "1x1-walled", "2x4-r0-walled", "2x4-r7-walled",
             "2x4-r2-periodic", "2x4-r5-walled", "2x2-r3-walled-ragged", "10x12",
             "18x3602", "2x2-r1-4x4", "1x1-at-rest", "2x2-r3-uncertified-dx"]


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("case", PHASE_CASES, ids=PHASE_IDS)
def test_emulated_sw_phase_matches_plain(libs, case, phase):
    assert_phase_match(libs["sw_phase"], case, phase)


def test_emulated_sw_phase_at_rest_gives_negative_zeros(libs):
    """The case at rest reaches the signs of zeros: its dh holds -0."""
    cfg, fields, off = phase_case(*PHASE_CASES[10])
    dh = run_phase(libs["sw_phase"], "ab2", fields, cfg, off)[3]
    assert int((torch.signbit(dh) & (dh == 0)).sum()) > 0


@pytest.fixture(params=[1, -1], ids=["ascending", "descending"])
def warps_apart(request, libs):
    for lib in libs.values():
        lib.host_emu_schedule(request.param)
    yield libs
    for lib in libs.values():
        lib.host_emu_schedule(0)


@pytest.mark.parametrize("first,nsteps", [(True, 1), (False, 2), (False, 3)])
@pytest.mark.parametrize("ny,nx", [(30, 300), (44, 600)])
def test_emulated_sw_steps_holds_with_warps_run_apart(warps_apart, ny, nx, first, nsteps):
    """Each warp alone from one barrier to the next: a ring row that one
    warp refills while another still has to read it shows here."""
    assert_steps_match(warps_apart["sw_steps"], ny, nx, first, nsteps)


@pytest.mark.parametrize("first,nsteps", [(True, 1), (False, 2)])
@pytest.mark.parametrize("case", [WIDE_CASES[4], WIDE_CASES[6]], ids=[WIDE_IDS[4], WIDE_IDS[6]])
def test_emulated_sw_wide_holds_with_warps_run_apart(warps_apart, case, first, nsteps):
    assert_wide_match(warps_apart["sw_wide"], case, first, nsteps)


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("case", [PHASE_CASES[3], PHASE_CASES[6], PHASE_CASES[7]],
                         ids=[PHASE_IDS[3], PHASE_IDS[6], PHASE_IDS[7]])
def test_emulated_sw_phase_holds_with_warps_run_apart(warps_apart, case, phase):
    assert_phase_match(warps_apart["sw_phase"], case, phase)


DIVISION_CHECK = r"""
#include <stdint.h>
#include "sw_stream.cuh"
// a / sws::divisor(b, reciprocal_is_exact(b)) against a / b, bit for bit:
// numerators near exact multiples of b (the hard rounding cases), random
// ones, powers of two, zeros of both signs, tiny, huge, inf and NaN;
// divisors with random significands, all-ones and near-all-ones ones, the
// model's 5000, and one outside the reciprocal's range.  Prints the cases,
// the mismatches, the divisors whose reciprocal is used, and whether it is
// for 5000 and for 2^21.
int main() {
  uint64_t s = 1;
  auto next = [&] { s = s * 6364136223846793005ULL + 1442695040888963407ULL; return s; };
  long n = 0, bad = 0;
  int fast = 0;
  const float special[] = {0.0f, -0.0f, 0x1p-140f, -0x1p-127f, 0x1p-101f, 0x1p101f, 3e38f,
                           __uint_as_float(0x7f800000u), __uint_as_float(0x7fc00000u)};
  for (int i = 0; i < 24; ++i) {
    float b = __uint_as_float((uint32_t)(next() >> 41) | ((uint32_t)(117 + next() % 20) << 23));
    if (i < 4) b = __uint_as_float(0x3fffffffu - i);
    if (i == 4) b = 5000.0f;
    if (i == 5) b = -5559.7463f;
    if (i == 6) b = 0x1p21f;
    const bool exact = sws::reciprocal_is_exact(b);
    const sws::Divisor d = sws::divisor(b, exact);
    fast += exact;
    for (int j = 0; j < 1000000; ++j) {
      const uint64_t u = next();
      float a = __uint_as_float((uint32_t)(u >> 41) | ((uint32_t)(1 + u % 253) << 23) |
                                ((uint32_t)(u >> 20) & 0x80000000u));
      if (j % 3 == 0) a = __uint_as_float(__float_as_uint(a / b * b) + (int)(u % 5) - 2);
      if (j % 7 == 0) a = __uint_as_float((uint32_t)(1 + u % 253) << 23);
      if (j < 9) a = special[j];
      const float want = a / b, got = a / d;
      ++n;
      if (__float_as_uint(want) != __float_as_uint(got) && !(want != want && got != got)) ++bad;
    }
  }
  printf("%ld %ld %d %d %d\n", n, bad, fast, (int)sws::reciprocal_is_exact(5000.0f),
         (int)sws::reciprocal_is_exact(0x1p21f));
  return 0;
}
"""


def test_division_by_a_held_reciprocal_is_the_true_division(libs, tmp_path):
    """``a / divisor(b)`` (the reciprocal rounded once, the quotient
    corrected by its exact residual, where the host's sweep over every
    significand shows it exact; the division routine elsewhere) gives the
    bits of ``a / b``; the model's dx and dy take the reciprocal."""
    cxx = shutil.which("g++") or shutil.which("c++")
    header = libs["sw_steps"]._name.rsplit("/", 1)[0]
    (tmp_path / "check.cc").write_text(DIVISION_CHECK)
    defines = [f"-D{k}={v}" for k, v in K.spec()[1].items()]
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-w", "-I", header, "-I",
                    str(HOST), *defines, "-o", str(tmp_path / "check"),
                    str(tmp_path / "check.cc")], check=True)
    n, bad, fast, model, outside = map(int, subprocess.run(
        [str(tmp_path / "check")], capture_output=True, text=True, check=True).stdout.split())
    assert (n, bad) == (24 * 1000000, 0)
    assert (model, outside) == (1, 0) and fast >= 1


TAIL_DIVISION_CHECK = r"""
#include <stdint.h>
#include "sw_stream.cuh"
// a / sws::TailDivisor{divisor(b, reciprocal_is_exact(b))} against a / b,
// bit for bit (any NaN for a NaN): for each divisor, a quarter of the
// numerators subnormal, a quarter tiny normals under 2^-100 (the held
// reciprocal's range ends there), the rest over the whole range, near
// exact multiples of b and special; divisors as in the held reciprocal's
// check, the model's 5000 and one outside the certified range (2^21).
// Prints the cases and the mismatches.
int main() {
  uint64_t s = 7;
  auto next = [&] { s = s * 6364136223846793005ULL + 1442695040888963407ULL; return s; };
  long n = 0, bad = 0;
  const float special[] = {0.0f, -0.0f, 0x1p-149f, -0x1p-149f, 0x1p-127f, 0x1p-101f,
                           0x1p101f, 3e38f, __uint_as_float(0x7f800000u),
                           __uint_as_float(0x7fc00000u)};
  for (int i = 0; i < 24; ++i) {
    float b = __uint_as_float((uint32_t)(next() >> 41) | ((uint32_t)(117 + next() % 20) << 23));
    if (i < 4) b = __uint_as_float(0x3fffffffu - i);
    if (i == 4) b = 5000.0f;
    if (i == 5) b = 0x1p21f;
    if (i == 6) b = -5000.0f;
    const sws::TailDivisor d{sws::divisor(b, sws::reciprocal_is_exact(b))};
    for (int j = 0; j < 1000000; ++j) {
      const uint64_t u = next();
      const uint32_t sign = (uint32_t)(u >> 20) & 0x80000000u, frac = (uint32_t)(u >> 41);
      float a;
      if (j % 4 == 0) {
        a = __uint_as_float(sign | (frac == 0 ? 1u : frac));
      } else if (j % 4 == 1) {
        a = __uint_as_float(sign | frac | ((uint32_t)(1 + u % 26) << 23));
      } else {
        a = __uint_as_float(sign | frac | ((uint32_t)(1 + u % 253) << 23));
        if (j % 3 == 0) a = __uint_as_float(__float_as_uint(a / b * b) + (int)(u % 5) - 2);
      }
      if (j < 10) a = special[j];
      const float want = a / b, got = a / d;
      ++n;
      if (__float_as_uint(want) != __float_as_uint(got) && !(want != want && got != got)) ++bad;
    }
  }
  printf("%ld %ld\n", n, bad);
  return 0;
}
"""


def test_tail_division_is_the_true_division(libs, tmp_path):
    """``a / TailDivisor`` (the phase kernels' divisions by dx and dy: the
    held reciprocal inside its certified range, a zero's quotient by a
    select, a double division rounded to float everywhere else) gives the
    bits of ``a / b`` on 24 M numerators, subnormal ones and subnormal
    quotients included, for certified divisors and one that is not."""
    cxx = shutil.which("g++") or shutil.which("c++")
    header = libs["sw_phase"]._name.rsplit("/", 1)[0]
    (tmp_path / "check.cc").write_text(TAIL_DIVISION_CHECK)
    defines = [f"-D{k}={v}" for k, v in KP.spec()[1].items()]
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-w", "-I", header, "-I",
                    str(HOST), *defines, "-o", str(tmp_path / "check"),
                    str(tmp_path / "check.cc")], check=True)
    n, bad = map(int, subprocess.run([str(tmp_path / "check")], capture_output=True,
                                     text=True, check=True).stdout.split())
    assert (n, bad) == (24 * 1000000, 0)


@pytest.mark.parametrize("nsteps", [1, 2, 3])
@pytest.mark.parametrize("ny,nx", [(44, 600), (1802, 3602), (902, 1802), (9, 8)])
def test_sw_steps_geometry_is_the_layout(libs, ny, nx, nsteps):
    """The geometry's counts are those of the blocks the source reports."""
    blocks, g = steps_blocks(libs["sw_steps"], ny, nx, nsteps)
    assert g["strips"] * g["chunks"] == len(blocks)
    assert g["rows_walked"] * g["strips"] == sum(h + 2 * my for _, h, _, _, my, _ in blocks)
    assert max(h for _, h, *_ in blocks) <= g["rows_per_block"]
    assert g["rows_per_block"] >= 4 * K.INTERIOR_RADIUS[0] * nsteps


@pytest.mark.parametrize("nsteps", [1, 2])
@pytest.mark.parametrize("case", [WIDE_CASES[1], WIDE_CASES[3], WIDE_CASES[6]],
                         ids=[WIDE_IDS[1], WIDE_IDS[3], WIDE_IDS[6]])
def test_sw_wide_geometry_is_the_crop_layout(libs, case, nsteps):
    """The blocks cover the crop once and nothing outside it."""
    grid, rank, periodic, nx, ny = case
    cfg, fields, _ = wide_case(grid, rank, periodic, nsteps, nx=nx, ny=ny)
    shape = fields[0].shape
    cy, cx, rows, cols = KW.crop_region(cfg, shape)
    blocks, g = wide_blocks(libs["sw_wide"], cfg, shape, nsteps)
    assert g["strips"] * g["chunks"] == len(blocks)
    covered = torch.zeros(shape, dtype=torch.int32)
    for oy, h, ox, w, my, mx in blocks:
        covered[oy:oy + h, ox:ox + w] += 1
        assert (my, mx) == (KW.STEP_RADIUS[0] * nsteps, KW.STEP_RADIUS[1] * nsteps)
    assert bool((covered[cy:cy + rows, cx:cx + cols] == 1).all())
    assert int(covered.sum()) == rows * cols


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("ny,nx", [(1802, 3602), (902, 1802), (22, 602), (18, 3602),
                                   (10, 12)])
def test_sw_phase_geometry_is_the_layout(libs, ny, nx, phase):
    """The blocks cover the local array once, each walked with one row
    and computed with one column of margin (the phases' radius); the
    geometry's counts are those of the blocks."""
    blocks, g = phase_blocks(libs["sw_phase"], ny, nx, phase)
    assert g["strips"] * g["chunks"] == len(blocks)
    assert g["rows_walked"] * g["strips"] == sum(h + 2 * my for _, h, _, _, my, _ in blocks)
    assert max(h for _, h, *_ in blocks) <= g["rows_per_block"]
    covered = torch.zeros((ny, nx), dtype=torch.int32)
    for oy, h, ox, w, my, mx in blocks:
        assert (my, mx) == KP.PHASE1_RADIUS == KP.PHASE2_RADIUS
        assert w + 2 * mx <= g["threads"]
        covered[oy:oy + h, ox:ox + w] += 1
    assert bool((covered == 1).all())


def test_main_path_pairs_compute_at_most_a_quarter_more_than_they_keep(libs):
    """At the main path's shapes (the 1802 x 3602 local array of 3600 x
    1800, and its 1832 x 3632 widened frame) a pair computes at most 1.25
    cells per cell it keeps, with 16 warps resident per SM under the H100's
    shared-memory limit (the card's own residency, registers included, is
    what chip_smoke.py prints)."""
    cfg = P.Config(nx=3600, ny=1800, periodic_x=False)
    _, g = steps_blocks(libs["sw_steps"], 1802, 3602, 2)
    steps = K.geometry_report(list(g.values()), 1802, 3602, 2)
    shape = (1832, 3632)
    _, g = wide_blocks(libs["sw_wide"], cfg, shape, 2)
    _, _, rows, cols = KW.crop_region(cfg, shape)
    wide = K.geometry_report(list(g.values()), rows, cols, 2)
    for g in (steps, wide):
        assert g["computed_per_useful"] <= 1.25, g
        assert g["warps_per_sm"] >= 16, g


# ---------------------------------------------------------------------------
# the batched launch: N lanes of one launch, one a blockIdx.z
# ---------------------------------------------------------------------------


def lane_inputs(kind, case, lanes):
    """``(cfg, offsets, fields)`` of ``lanes`` states, lane i from its own
    seed, stacked as ``(lanes, ny, nx)`` contiguous planes."""
    per_lane = []
    for i in range(lanes):
        if kind == "steps":
            cfg, fields = state(*case, seed=1 + i)
            off = None
        elif kind == "wide":
            grid, rank, periodic, nx, ny = case
            cfg, fields, off = wide_case(grid, rank, periodic, 2, seed=i, nx=nx, ny=ny)
        else:
            cfg, fields, off = phase_case(*case[:5], seed=i)
        per_lane.append(fields)
    return cfg, off, tuple(torch.stack(f).contiguous() for f in zip(*per_lane))


def run_lanes(lib, kind, step, fields, cfg, off, outs=None):
    """One launch of ``kind`` (``step`` its (first, nsteps) or phase) on
    ``fields``, planes or stacked lanes."""
    if kind == "steps":
        return run_steps(lib, fields, cfg, *step, outs=outs)
    if kind == "wide":
        return run_wide(lib, fields, cfg, *step, off, outs=outs)
    return run_phase(lib, step, fields, cfg, off, outs=outs)


# (kind, case, step): periodic fused steps on two seam strips and on four
# strips with a ragged last strip and chunk; the wide frame walled on a
# (2,4) edge rank and periodic with three strips at an offset; both phases
# on a ragged walled (2,2) rank of three strips and two chunks, and phase
# 1 on a periodic edge rank of (2,4)
BATCH_CASES = [("steps", (30, 300), (True, 1)), ("steps", (20, 850), (False, 3)),
               ("wide", WIDE_CASES[4], (False, 2)), ("wide", WIDE_CASES[6], (True, 1)),
               ("phase", PHASE_CASES[6], "ab2"), ("phase", PHASE_CASES[6], "visc"),
               ("phase", PHASE_CASES[4], "euler")]
BATCH_IDS = ["steps-2strips-euler", "steps-4strips-ragged-3steps", "wide-2x4-r6-walled",
             "wide-2x2-r3-periodic-3strips", "phase1-ab2-ragged", "phase2-ragged",
             "phase1-euler-2x4-r2-periodic"]


@pytest.mark.parametrize("schedule", [0, 1, -1], ids=["lockstep", "ascending", "descending"])
@pytest.mark.parametrize("lanes", [2, 3])
@pytest.mark.parametrize("case", BATCH_CASES, ids=BATCH_IDS)
def test_emulated_batched_launch_is_each_lane_bit_for_bit(libs, case, lanes, schedule):
    """``lanes`` states in one launch (``gridDim.z`` = lanes, every field
    offset by its lane's plane): each lane's output is bit for bit its own
    one-lane launch, with the warps in lockstep and each alone from
    barrier to barrier in both orders, and no cell outside the lanes is
    written (a guard plane on each side keeps its sentinel)."""
    kind, shape_case, step = case
    lib = libs["sw_" + kind]
    cfg, off, fields = lane_inputs(kind, shape_case, lanes)
    lib.host_emu_schedule(schedule)
    try:
        n_out = 2 if step == "visc" else 6
        guarded = [torch.full((lanes + 2, *fields[0].shape[1:]), SENTINEL)
                   for _ in range(n_out)]
        got = run_lanes(lib, kind, step, fields, cfg, off,
                        outs=tuple(g[1:-1] for g in guarded))
        for i in range(lanes):
            want = run_lanes(lib, kind, step, tuple(f[i].contiguous() for f in fields),
                             cfg, off)
            for name, a, b in zip(P.State._fields if n_out == 6 else ("u", "v"), want,
                                  got):
                assert same_bits(a, b[i].contiguous()), (i, name)
    finally:
        lib.host_emu_schedule(0)
    for g in guarded:
        assert bool((g[0] == SENTINEL).all()) and bool((g[-1] == SENTINEL).all())


def test_emulated_launch_with_no_lanes_is_refused(libs):
    """A lane count below 1 is an invalid launch, refused before anything
    runs (cudaErrorInvalidValue); a count of 1 is the plane alone, whose
    geometry the exports report as before (the geometry tests above)."""
    cfg, fields = state(30, 300, 1)
    c = K.step_constants(cfg)
    outs = tuple(torch.full_like(f, SENTINEL) for f in fields)
    err = libs["sw_steps"].sw_steps_launch(
        *(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs), 30, 300, 1, 1, 1,
        c.dx, c.dy, c.g, c.dt, c.ab_a, c.ab_b, c.f0, c.beta, c.visc, 0, 30 * 300, None)
    assert err != 0
    assert all(bool((o == SENTINEL).all()) for o in outs)
