"""Fused whole-step shallow-water kernel: ``nsteps`` model steps per call.

Replaces the TPU kernel ``examples/shallow_water.py:_sw_steps_kernel``
(launched by ``model_step_pallas``).  It computes ``nsteps`` in {1, 2, 3}
whole Sadourny/AB-2 steps (the first one Euler when asked) on the
single-rank periodic-x state: six f32 ``(ny_l, nx_l)`` fields in, six out.

Bound on an H100: bytes.  A call must read the six state fields once and
write them once, 12 fields x 4 bytes per cell (12 x 25.96 MB = 311.6 MB at
3600x1800); at 3.35 TB/s that is 0.093 ms per call, whatever ``nsteps``.
The arithmetic, about 107 f32 operations per cell and step, needs a third
of that time even for three steps.  The kernel (``csrc/sw_steps.cu`` on
the streamed rows of ``csrc/sw_stream.cuh``) gives each block a strip of
``EXT`` columns and a chunk of rows, which it walks a row at a time,
keeping every intermediate field in rings of a few rows of shared memory
and what a cell reads only at itself in registers.  A strip recomputes
margins of ``nsteps * INTERIOR_RADIUS`` cells, or, in the two strips that
hold the periodic seam columns, ``nsteps * STEP_RADIUS`` columns.  The
source lays out the blocks and reports them (``geometry``,
``query_geometry``).

This module holds three things:

- the plain PyTorch version of the step (``_phase1_window``,
  ``_phase2_window``, ``_step_window``, ported operand for operand from
  the JAX package), which ``sw_steps_plain`` applies to the whole array
  with ``torch.roll``; the phase windows, in both mask frames, also serve
  ``kernels/sw_phase.py`` and ``kernels/sw_wide.py``;
- the wrapper ``sw_steps``: a CPU tensor takes the plain version, a CUDA
  tensor launches the kernel or raises;
- the build of ``csrc/sw_steps.cu`` with ``nvcc`` at first use, into the
  package's ``_build/`` directory (``kernels/_build.py``), loaded with
  ``ctypes``, and the kernel's geometry as the source reports it.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "sw_steps.cu"
HEADERS = (_build.CSRC / "sw_stream.cuh",)

# per-step dependency radius of one whole step (rows, cols) near the
# periodic seam: the margins of the kernel's first and last strips, in
# columns, are nsteps times its second entry.  Cols: phase 1 reads 1
# column away, each periodic column fix 2 (col 0 holds col nx-2), the
# viscosity 1.  tests/test_torch_sw_kernel.py measures it by NaN injection
# (periodic distance).
STEP_RADIUS = (3, 6)
# ... and away from the seam columns, at the walls included (measured in
# array rows, which never wrap: tests/test_torch_sw_kernel.py): every
# chunk's row margin and every other strip's column margin, per step.
# Phase 1 reads 1 cell away, the viscosity 1 more.
INTERIOR_RADIUS = (2, 2)
EXT = 256  # threads of a block = the columns of its strip, margins included
# the geometry reaches the kernel as -D flags of its build
_DEFINES = {"SW_NT": EXT, "SW_RY": INTERIOR_RADIUS[0], "SW_RX": INTERIOR_RADIUS[1],
            "SW_EDGE_RX": STEP_RADIUS[1]}


def f32(x: float) -> float:
    """A Python float rounded to f32: what a JAX op sees of a weak-typed
    Python constant multiplied into an f32 array."""
    return float(np.float32(x))


def divisors(c: SimpleNamespace, device):
    """``(dx, dy)`` as 0-dim f32 tensors on ``device``, for the plain
    versions' divisions.  PyTorch's CUDA division by a Python number
    multiplies by its reciprocal, which rounds differently from the true
    division that the JAX package and the kernel compute; a tensor divisor
    keeps it a true division on every device."""
    return (torch.full((), c.dx, dtype=torch.float32, device=device),
            torch.full((), c.dy, dtype=torch.float32, device=device))


def step_constants(cfg) -> SimpleNamespace:
    """The Config constants of one step, each rounded to f32 once, from the
    same double-precision Python expressions the JAX package evaluates."""
    return SimpleNamespace(
        dx=f32(cfg.dx), dy=f32(cfg.dy), g=f32(cfg.gravity),
        dt=f32(cfg.dt), ab_a=f32(cfg.ab_a), ab_b=f32(cfg.ab_b),
        f0=f32(cfg.coriolis_f), beta=f32(cfg.coriolis_beta),
        visc=f32(cfg.lateral_viscosity),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version (examples/shallow_water.py:574-796)
# ---------------------------------------------------------------------------


def _rolls(roll, nr: int, nx: int):
    """The four stencil shifts as positive-shift rolls."""
    rm1x = lambda a: roll(a, nx - 1, 1)  # noqa: E731  a[j, i+1]
    rp1x = lambda a: roll(a, 1, 1)  # noqa: E731      a[j, i-1]
    rm1y = lambda a: roll(a, nr - 1, 0)  # noqa: E731  a[j+1, i]
    rp1y = lambda a: roll(a, 1, 0)  # noqa: E731       a[j-1, i]
    return rm1x, rp1x, rm1y, rp1y


def _window_masks(cfg, iy, ix, giy, gix, wide=False):
    """``(derived, u_wall, wall_v, interior)`` of ``examples/shallow_water.py:
    _window_masks``.  Wall masks test the domain-global indices
    ``giy``/``gix``.  In the default (rank-local) frame the update mask
    tests the rank-local ``iy``/``ix``, so the rank's own halo ring is left
    to the next exchange.  In the wide frame (``wide=True``, the widened
    arrays of the wide-halo path) every cell is computed as its owning rank
    computes it: the update mask tests domain-global interiority, and the
    kept masks use inequalities, so the beyond-wall rows of the frame are
    zeroed in every derived field."""
    nyl, nxl = cfg.ny_local, cfg.nx_local
    gy_n, gx_n = cfg.ny + 2, cfg.nx + 2

    u_wall = None  # kind-"u" no-flow wall column
    wall_v = giy == gy_n - 2  # kind-"v" no-flux row
    if wide:
        kept = (giy <= 0) | (giy >= gy_n - 1)
        interior = (giy >= 1) & (giy <= gy_n - 2)
        if not cfg.periodic_x:
            kept = kept | (gix <= 0) | (gix >= gx_n - 1)
            interior = interior & (gix >= 1) & (gix <= gx_n - 2)
            u_wall = gix == gx_n - 2
    else:
        kept = (giy == 0) | (giy == gy_n - 1)
        if not cfg.periodic_x:
            kept = kept | (gix == 0) | (gix == gx_n - 1)
            u_wall = gix == gx_n - 2
        interior = (iy > 0) & (iy < nyl - 1) & (ix > 0) & (ix < nxl - 1)

    def derived(expr, extra=None):
        mask = kept if extra is None else (kept | extra)
        return torch.where(mask, 0.0, expr)

    return derived, u_wall, wall_v, interior


def _phase1_window(cfg, first_step: bool, iy, ix, giy, gix, fields, roll,
                   wide=False):
    """Integration phase of one step (hc, fluxes, q, ke, tendencies, AB-2 or
    Euler update) on a ``(nr, nx)`` window, no exchanges.  Same operands in
    the same order as ``examples/shallow_water.py:_phase1_window``,
    including its roll-commutation rewrites of the KE stencil; ``wide``
    selects the masks' frame (``_window_masks``)."""
    h, u, v, dh, du, dv = fields
    nr, nx = h.shape
    gy_n, gx_n = cfg.ny + 2, cfg.nx + 2
    c = step_constants(cfg)
    (dx, dy), g, dt = divisors(c, h.device), c.g, c.dt
    rm1x, rp1x, rm1y, rp1y = _rolls(roll, nr, nx)

    derived, u_wall, wall_v, interior = _window_masks(cfg, iy, ix, giy, gix, wide)

    hc = torch.where(giy == 0, rm1y(h), torch.where(giy == gy_n - 1, rp1y(h), h))
    if not cfg.periodic_x:
        hc = torch.where(
            gix == 0, rm1x(hc), torch.where(gix == gx_n - 1, rp1x(hc), hc)
        )

    fe = derived(0.5 * (hc + rm1x(hc)) * u, u_wall)
    fn = derived(0.5 * (hc + rm1y(hc)) * v, wall_v)

    cor = c.f0 + (giy - 1).to(torch.float32) * c.dy * c.beta
    rel_vort = (rm1x(v) - v) / dx - (rm1y(u) - u) / dy
    depth_q = 0.25 * (hc + rm1x(hc) + rm1y(hc) + rm1y(rm1x(hc)))
    q = derived((cor + rel_vort) / depth_q)
    # rolls commute bit-exactly with elementwise math (see the JAX source)
    u_sq, v_sq = u * u, v * v
    ke = derived(0.5 * (0.5 * (u_sq + rp1x(u_sq)) + 0.5 * (v_sq + rp1y(v_sq))))

    dh_new = torch.where(
        interior, -(fe - rp1x(fe)) / dx - (fn - rp1y(fn)) / dy, 0.0
    )
    fn_e = 0.5 * (fn + rm1x(fn))  # east-face vorticity-flux average
    fe_n = 0.5 * (fe + rm1y(fe))  # north-face average
    du_new = torch.where(
        interior,
        -g * (rm1x(h) - h) / dx
        + 0.5 * (q * fn_e + rp1y(q) * rp1y(fn_e))
        - (rm1x(ke) - ke) / dx,
        0.0,
    )
    dv_new = torch.where(
        interior,
        -g * (rm1y(h) - h) / dy
        - 0.5 * (q * fe_n + rp1x(q) * rp1x(fe_n))
        - (rm1y(ke) - ke) / dy,
        0.0,
    )

    if first_step:
        h1 = h + dt * dh_new
        u1 = u + dt * du_new
        v1 = v + dt * dv_new
    else:
        h1 = h + dt * (c.ab_a * dh_new + c.ab_b * dh)
        u1 = u + dt * (c.ab_a * du_new + c.ab_b * du)
        v1 = v + dt * (c.ab_a * dv_new + c.ab_b * dv)

    return h1, u1, v1, dh_new, du_new, dv_new


def _phase2_window(cfg, iy, ix, giy, gix, u, v, roll, wide=False):
    """Viscosity phase of one step on a window: lateral friction on ``u``
    and ``v``, which enter with coherent halos."""
    nr, nx = u.shape
    c = step_constants(cfg)
    (dx, dy), dt = divisors(c, u.device), c.dt
    rm1x, rp1x, rm1y, rp1y = _rolls(roll, nr, nx)
    derived, u_wall, wall_v, interior = _window_masks(cfg, iy, ix, giy, gix, wide)

    visc = c.visc
    out = []
    for f in (u, v):
        gx = derived(visc * (rm1x(f) - f) / dx, u_wall)
        gy = derived(visc * (rm1y(f) - f) / dy, wall_v)
        out.append(
            f + torch.where(
                interior, dt * ((gx - rp1x(gx)) / dx + (gy - rp1y(gy)) / dy), 0.0
            )
        )
    return out[0], out[1]


def _step_window(cfg, first_step: bool, n_rows: int, iy, ix, fields, roll):
    """One whole model step on a window: ``_phase1_window``, the halo
    refreshes as periodic column fixes, ``_phase2_window``.  Valid for the
    single-rank periodic-x decomposition, where global and local indices
    coincide.  The window may be narrower than the domain (a kernel tile):
    the rolls shift within the window, the masks test the domain's
    columns."""
    nw = fields[0].shape[1]
    nx = cfg.nx_local

    def pc_fix(a):
        # periodic column refresh: col 0 <- col -2, col -1 <- col 1
        return torch.where(
            ix == 0, roll(a, 2, 1), torch.where(ix == nx - 1, roll(a, nw - 2, 1), a)
        )

    h1, u1, v1, dh_new, du_new, dv_new = _phase1_window(
        cfg, first_step, iy, ix, iy, ix, fields, roll
    )
    u1 = pc_fix(u1)
    v1 = torch.where(iy == n_rows - 2, 0.0, pc_fix(v1))

    if cfg.lateral_viscosity > 0:
        u1, v1 = _phase2_window(cfg, iy, ix, iy, ix, u1, v1, roll)

    h1 = pc_fix(h1)
    u1 = pc_fix(u1)
    v1 = pc_fix(v1)
    return h1, u1, v1, dh_new, du_new, dv_new


def _check_eligible(cfg, nsteps: int) -> None:
    if not (cfg.nproc == 1 and cfg.periodic_x):
        raise ValueError(
            "sw_steps: single-rank periodic-x only; use model_step_fast"
        )
    if not 1 <= nsteps <= 3:
        raise ValueError(f"fused step windows support 1..3 steps, got {nsteps}")


def sw_steps_plain(fields, cfg, first_step: bool, nsteps: int):
    """The plain version: ``nsteps`` applications of ``_step_window`` to
    the whole local array, with ``torch.roll``."""
    _check_eligible(cfg, nsteps)
    ny, nx = fields[0].shape
    dev = fields[0].device
    iy = torch.arange(ny, device=dev)[:, None]
    ix = torch.arange(nx, device=dev)[None, :]
    first = first_step
    for _ in range(nsteps):
        fields = _step_window(cfg, first, ny, iy, ix, fields, torch.roll)
        first = False
    return tuple(fields)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


counter = _build.counter_for("sw_steps")
_lib = None

_C = ctypes
_SIGNATURES = {
    "sw_steps_launch": ([_C.c_void_p] * 12 + [_C.c_int] * 5 + [_C.c_float] * 9
                        + [_C.c_void_p]),
    "sw_steps_geometry": [_C.c_int] * 3 + [_C.c_void_p] * 2,
}
# what the geometry functions of csrc/sw_steps.cu and sw_wide.cu report
GEOMETRY_KEYS = ("strips", "chunks", "rows_per_block", "blocks_per_sm", "threads",
                 "smem_bytes", "rows_walked")


def spec():
    """``(source, defines, headers)`` of this kernel's build."""
    return SOURCE, _DEFINES, HEADERS


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(spec(), _SIGNATURES)
    return _lib


def query_geometry(fn, *args, blocks=False):
    """Call a geometry export of a built library (``sw_steps_geometry`` or
    ``sw_wide_geometry``) with its leading ``args``: the seven ints of its
    report and, with ``blocks``, every block's ``(oy, h, ox, w, my, mx)``:
    output rows ``oy..oy+h`` and columns ``ox..ox+w``, walked with ``my``
    rows and computed with ``mx`` columns of margin on each side."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    _build.raise_on_error("stencil geometry", fn(*args, out, None))
    if not blocks:
        return list(out), None
    n = out[0] * out[1]
    spans = (ctypes.c_int * (6 * n))()
    _build.raise_on_error("stencil geometry", fn(*args, out, spans))
    return list(out), [tuple(spans[6 * b:6 * b + 6]) for b in range(n)]


def geometry_report(out, rows, cols, nsteps):
    """The geometry functions' ``out`` as a dict, with the cells the kernel
    computes per step over those it keeps (``computed_per_useful``) and the
    warps resident per SM."""
    g = dict(zip(GEOMETRY_KEYS, out))
    g["computed_per_useful"] = g["strips"] * g["threads"] * g["rows_walked"] / (rows * cols)
    g["warps_per_sm"] = g["blocks_per_sm"] * g["threads"] // 32
    g["nsteps"] = nsteps
    return g


def geometry(shape, nsteps: int):
    """The launch's blocks and residency on the current card, without
    launching: strips, chunks, rows per chunk, blocks resident per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the computed
    over useful cell ratio."""
    out, _ = query_geometry(_library().sw_steps_geometry, shape[0], shape[1], nsteps)
    return geometry_report(out, shape[0], shape[1], nsteps)


def sw_steps(fields, cfg, first_step: bool, nsteps: int):
    """``nsteps`` whole model steps on the local state ``fields`` (h, u, v,
    dh, du, dv).  On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel, on the current stream, or raises.
    ``meta`` tensors (the verifier's abstract run, ``analysis/``) take the
    shape rule: empty outputs of the kernel's shapes, nothing launched."""
    _check_eligible(cfg, nsteps)
    h = fields[0]
    if h.device.type == "cpu":
        return sw_steps_plain(fields, cfg, first_step, nsteps)
    if h.device.type == "meta":
        return _build.meta_fields("sw_steps", "sw_steps", fields,
                                  (cfg.ny_local, cfg.nx_local))
    if h.device.type != "cuda":
        raise RuntimeError(f"sw_steps: unsupported device {h.device}")
    shape = (cfg.ny_local, cfg.nx_local)
    _build.check_cuda_fields("sw_steps", fields, shape)
    if min(shape) < 3:
        raise ValueError(f"sw_steps: local shape {shape} below 3x3")
    outs = tuple(torch.empty_like(f) for f in fields)
    c = step_constants(cfg)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _library().sw_steps_launch(
        *(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs),
        shape[0], shape[1], int(first_step), nsteps,
        int(cfg.lateral_viscosity > 0),
        c.dx, c.dy, c.g, c.dt, c.ab_a, c.ab_b, c.f0, c.beta, c.visc,
        stream,
    )
    _build.raise_on_error("sw_steps", err)
    counter.count(torch.cuda.is_current_stream_capturing())
    return outs
