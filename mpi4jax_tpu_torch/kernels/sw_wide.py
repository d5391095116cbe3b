"""Wide-halo shallow-water kernel: whole steps on a rank's widened frame.

Replaces the TPU kernel ``examples/shallow_water.py:_sw_wide_kernel``
(launched by ``_wide_kernel_call``).  It computes ``nsteps`` in {1, 2}
whole steps (the first one Euler when asked) on the widened frame of the
communication-avoiding path: the local array grown by ``m - 1`` cells of
neighbour data on every side (``m = _margin_rows(nsteps)``, 8 or 16), six
f32 fields in, six out.  A step is ``_wide_step_window``: phase 1 in the
wide mask frame, the wall rows of ``u`` and ``v`` set to zero, phase 2 in
the wide frame; no exchange and no periodic fix.  The frame's
domain-global offsets (the rank's offsets minus ``m - 1``) come in as two
ints.  Only the crop region ``[m-1, m-1+ny_l) x [m-1, m-1+nx_l)`` is
meaningful after a call.  The plain version leaves recompute garbage
outside it (inf and NaN beyond the walls); the kernel computes and writes
the crop alone and leaves the other output cells unwritten.  The caller
overwrites every one of them before any read (``_wide_refresh``,
``_wide_crop`` in ``models/shallow_water.py``).

Bound on an H100: bytes.  Only the crop is meaningful, so an AB-2 call
must read h, u, v on the crop grown by ``nsteps x STEP_RADIUS``, the
tendencies on the crop grown by ``(nsteps - 1) x STEP_RADIUS``, and write
six fields on the crop: 312.3 MB for a pair on the 1802 x 3602 crop of
3600 x 1800, 0.0932 ms at 3.35 TB/s.  The kernel (``csrc/sw_wide.cu``)
runs the streamed rows of ``csrc/sw_stream.cuh``, as ``csrc/sw_steps.cu``
does, over the crop only: strips and chunks with margins of ``nsteps *
STEP_RADIUS`` cells, every intermediate in rings of a few rows of shared
memory.

This module holds the plain version (``_wide_step_window`` over the whole
frame with ``torch.roll``), the wrapper (a CPU tensor takes the plain
version, a CUDA tensor launches the kernel on the current stream or
raises) and the kernel's build.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sw_steps import (
    EXT,
    _phase1_window,
    _phase2_window,
    geometry_report,
    query_geometry,
    step_constants,
)

SOURCE = _build.CSRC / "sw_wide.cu"
HEADERS = (_build.CSRC / "sw_stream.cuh",)

# per-step dependency radius (rows, cols) of one wide step, the kernel's
# margins per step: phase 1 reads one cell away, the viscosity one more (no
# periodic column fix, which costs csrc/sw_steps.cu its wider column
# margins in its edge strips).  tests/test_torch_sw_wide.py measures it by
# NaN injection and checks that blocks cut with these margins reproduce
# the whole-frame plain version bit for bit on the crop.
STEP_RADIUS = (2, 2)
_DEFINES = {"SW_NT": EXT, "SW_RY": STEP_RADIUS[0], "SW_RX": STEP_RADIUS[1],
            "SW_EDGE_RX": STEP_RADIUS[1]}

counter = _build.counter_for("sw_wide")
_lib = None

_C = ctypes
_SIGNATURES = {
    "sw_wide_launch": ([_C.c_void_p] * 12 + [_C.c_int] * 14 + [_C.c_float] * 9
                       + [_C.c_int, _C.c_longlong, _C.c_void_p]),
    "sw_wide_geometry": [_C.c_int] * 7 + [_C.c_void_p] * 2,
}


def spec():
    """``(source, defines, headers)`` of this kernel's build."""
    return SOURCE, _DEFINES, HEADERS


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(spec(), _SIGNATURES)
    return _lib


def crop_region(cfg, shape):
    """``(cy, cx, ny_l, nx_l)``: the first row and column of the crop of a
    frame of ``shape`` (the local array grown by ``m - 1`` cells on every
    side) and its extent, the local array's."""
    nyl, nxl = cfg.ny_local, cfg.nx_local
    ey, ex = shape[0] - nyl, shape[1] - nxl
    if ey < 0 or ey != ex or ey % 2:
        raise ValueError(f"sw_wide: frame {tuple(shape)} is not the local array "
                         f"{(nyl, nxl)} grown by the same margin on every side")
    return ey // 2, ex // 2, nyl, nxl


def geometry(cfg, shape, nsteps: int):
    """The launch's blocks and residency on the current card for a frame of
    ``shape``, without launching (as ``sw_steps.geometry``; the ratio is
    over the crop)."""
    cy, cx, rows, cols = crop_region(cfg, shape)
    out, _ = query_geometry(_library().sw_wide_geometry, shape[0], shape[1], cy, cx, rows,
                            cols, nsteps)
    return geometry_report(out, rows, cols, nsteps)


def _wide_step_window(cfg, first_step: bool, giy, gix, fields, roll):
    """One whole step on the widened frame (``examples/shallow_water.py:
    _wide_step_window``): ``_phase1_window`` with the wide masks, the
    post-integration wall conditions as global-index selects, then
    ``_phase2_window`` with the wide masks."""
    gy_n, gx_n = cfg.ny + 2, cfg.nx + 2
    h1, u1, v1, dh_n, du_n, dv_n = _phase1_window(
        cfg, first_step, giy, gix, giy, gix, fields, roll, wide=True
    )
    if not cfg.periodic_x:
        u1 = torch.where(gix == gx_n - 2, 0.0, u1)
    v1 = torch.where(giy == gy_n - 2, 0.0, v1)
    if cfg.lateral_viscosity > 0:
        u1, v1 = _phase2_window(cfg, giy, gix, giy, gix, u1, v1, roll, wide=True)
    return h1, u1, v1, dh_n, du_n, dv_n


def _check_steps(nsteps: int) -> None:
    if nsteps not in (1, 2):
        raise ValueError(f"sw_wide: nsteps must be 1 or 2, got {nsteps}")


def sw_wide_plain(fields, cfg, first_step: bool, nsteps: int, offsets):
    """The plain version: ``nsteps`` applications of ``_wide_step_window``
    to the whole frame, whose element (0, 0) sits at the domain-global
    ``offsets``."""
    _check_steps(nsteps)
    ny, nx = fields[0].shape
    dev = fields[0].device
    giy = torch.arange(ny, device=dev)[:, None] + int(offsets[0])
    gix = torch.arange(nx, device=dev)[None, :] + int(offsets[1])
    fields = tuple(fields)
    first = first_step
    for _ in range(nsteps):
        fields = _wide_step_window(cfg, first, giy, gix, fields, torch.roll)
        first = False
    return tuple(fields)


def sw_wide(fields, cfg, first_step: bool, nsteps: int, offsets):
    """``nsteps`` whole steps on the widened frame ``fields`` (h, u, v, dh,
    du, dv), or on ``(lanes, *frame)`` stacks of that many frames.  On CPU
    tensors this is the plain version (lane by lane); on CUDA tensors it
    launches the kernel once, on the current stream, or raises; ``meta``
    tensors take the shape rule; under ``torch.func.vmap`` the lanes go to
    one launch (``sw_steps``)."""
    _check_steps(nsteps)
    return _build.stencil_call(
        lambda fs: _wide(fs, cfg, first_step, nsteps, offsets), fields)


def _wide(fields, cfg, first_step: bool, nsteps: int, offsets):
    h = fields[0]
    shape = tuple(h.shape[-2:])  # the frame of each lane
    if h.device.type == "cpu":
        if h.dim() == 3:
            return _build.per_lane(
                lambda fs: sw_wide_plain(fs, cfg, first_step, nsteps, offsets), fields)
        return sw_wide_plain(fields, cfg, first_step, nsteps, offsets)
    if h.device.type == "meta":
        return _build.meta_fields("sw_wide", "sw_wide", fields,
                                  tuple(h.shape))
    if h.device.type != "cuda":
        raise RuntimeError(f"sw_wide: unsupported device {h.device}")
    _build.check_cuda_fields("sw_wide", fields, tuple(h.shape))
    cy, cx, rows, cols = crop_region(cfg, shape)
    outs = tuple(torch.empty_like(f) for f in fields)
    c = step_constants(cfg)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _library().sw_wide_launch(
        *(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs),
        shape[0], shape[1], int(offsets[0]), int(offsets[1]),
        cfg.ny + 2, cfg.nx + 2, int(not cfg.periodic_x), cy, cx, rows, cols,
        int(first_step), nsteps, int(cfg.lateral_viscosity > 0),
        c.dx, c.dy, c.g, c.dt, c.ab_a, c.ab_b, c.f0, c.beta, c.visc,
        _build.lanes_of(fields), shape[0] * shape[1], stream,
    )
    _build.raise_on_error("sw_wide", err)
    counter.count(torch.cuda.is_current_stream_capturing())
    return outs
