"""Split-phase shallow-water kernels: the two compute phases of one step.

Replaces the TPU kernel ``examples/shallow_water.py:_sw_phase_kernel``,
which ``model_step_pallas_halo`` launches twice per step on any process
grid, with real halo exchanges between the launches:

- phase 1 (``_phase1_window``): hc, fluxes, q, ke, tendencies and the AB-2
  or Euler update; six f32 ``(ny_l, nx_l)`` fields in, six out;
- phase 2 (``_phase2_window``): lateral viscosity; ``u`` and ``v`` in and
  out.

Both work on one rank's local array in the default mask frame; the
rank's domain-global ``(row, col)`` offsets (``models.shallow_water.
_rank_offsets``) come in as two ints.

Bound on an H100: bytes.  The halo ring of the output is overwritten by
the next ``enforce_boundaries`` (h, u, v) or feeds only ring cells (the
tendencies), so AB-2 phase 1 must read h, u, v whole, the tendencies on
the interior and write six fields on the interior (311.2 MB on the
1802 x 3602 local arrays of 3600 x 1800, 0.0929 ms at 3.35 TB/s); phase 2
reads u, v whole and writes their interior (0.0310 ms).
The kernel (``csrc/sw_phase.cu``) runs the streamed rows of
``csrc/sw_stream.cuh`` in its local frame, one phase per launch: a block of
``EXT`` threads, one a column, walks a chunk of rows of a strip with
margins of the phases' radius, every intermediate in rings of a few rows
of shared memory or in registers.  The source lays out the blocks and
reports them (``geometry``).

This module holds the plain versions (the windows of ``kernels/sw_steps.py``
over the whole local array, with ``torch.roll``), the wrappers (a CPU
tensor takes the plain version, a CUDA tensor launches the kernel on the
current stream or raises) and the kernel's build.
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

SOURCE = _build.CSRC / "sw_phase.cu"
HEADERS = (_build.CSRC / "sw_stream.cuh",)

# each phase's dependency radius (rows, cols), the kernel's margins: an
# output cell reads inputs at most one cell away in either phase (hc's
# wall pads reach one cell further, but only into rows and columns whose
# fluxes the kept masks zero).  The NaN-injection tests in
# tests/test_torch_sw_phase.py measure both.
PHASE1_RADIUS = (1, 1)
PHASE2_RADIUS = (1, 1)
# one build serves both phases: its margins cover either radius, the same
# for every strip (no seam here)
_MARGIN = tuple(max(a, b) for a, b in zip(PHASE1_RADIUS, PHASE2_RADIUS))
_DEFINES = {"SW_NT": EXT, "SW_RY": _MARGIN[0], "SW_RX": _MARGIN[1],
            "SW_EDGE_RX": _MARGIN[1]}

counter = _build.counter_for("sw_phase")
_lib = None

_C = ctypes
_CONSTS = [_C.c_float] * 9
_LANES = [_C.c_int, _C.c_longlong]  # lanes of one launch, elements between them
_SIGNATURES = {
    "sw_phase1_launch": ([_C.c_void_p] * 12 + [_C.c_int] * 8 + _CONSTS + _LANES
                         + [_C.c_void_p]),
    "sw_phase2_launch": [_C.c_void_p] * 4 + [_C.c_int] * 7 + _CONSTS + _LANES + [_C.c_void_p],
    "sw_phase_geometry": [_C.c_int] * 3 + [_C.c_void_p] * 2,
}


def spec():
    """``(source, defines, headers)`` of this kernel's build."""
    return SOURCE, _DEFINES, HEADERS


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(spec(), _SIGNATURES)
    return _lib


def geometry(shape, phase: int):
    """Phase ``phase``'s blocks and residency on the current card for a
    local array of ``shape``, without launching (as ``sw_steps.geometry``;
    the ratio is over the whole array, which is the output)."""
    out, _ = query_geometry(_library().sw_phase_geometry, shape[0], shape[1], phase)
    return geometry_report(out, shape[0], shape[1], 1)


def _indices(shape, offsets, device):
    """Local and domain-global row/col indices of a rank's local array."""
    iy = torch.arange(shape[0], device=device)[:, None]
    ix = torch.arange(shape[1], device=device)[None, :]
    return iy, ix, iy + int(offsets[0]), ix + int(offsets[1])


def sw_phase1_plain(fields, cfg, first_step: bool, offsets):
    """Phase 1 over the whole local array (h, u, v, dh, du, dv)."""
    iy, ix, giy, gix = _indices(fields[0].shape, offsets, fields[0].device)
    return _phase1_window(cfg, first_step, iy, ix, giy, gix, tuple(fields),
                          torch.roll)


def sw_phase2_plain(u, v, cfg, offsets):
    """Phase 2 over the whole local array: returns the new ``(u, v)``."""
    iy, ix, giy, gix = _indices(u.shape, offsets, u.device)
    return _phase2_window(cfg, iy, ix, giy, gix, u, v, torch.roll)


def _frame_args(cfg, offsets):
    c = step_constants(cfg)
    ints = (cfg.ny_local, cfg.nx_local, int(offsets[0]), int(offsets[1]),
            cfg.ny + 2, cfg.nx + 2, int(not cfg.periodic_x))
    floats = (c.dx, c.dy, c.g, c.dt, c.ab_a, c.ab_b, c.f0, c.beta, c.visc)
    return ints, floats


def _launch_device(fields):
    h = fields[0]
    if h.device.type != "cuda":
        raise RuntimeError(f"sw_phase: unsupported device {h.device}")
    return torch.cuda.current_stream(h.device).cuda_stream


def _launch_shape(fields, cfg):
    """The shape a launch asks of every field: the local plane, or stacked
    lanes of it."""
    return (*fields[0].shape[:-2], cfg.ny_local, cfg.nx_local)


def sw_phase1(fields, cfg, first_step: bool, offsets):
    """Phase 1 of one step on the local state ``fields`` (h, u, v, dh, du,
    dv) of the rank at ``offsets``, each ``(ny_l, nx_l)`` or stacked
    ``(lanes, ny_l, nx_l)``.  On CPU tensors this is the plain version
    (lane by lane); on CUDA tensors it launches the kernel once, or
    raises; ``meta`` tensors take the shape rule; under
    ``torch.func.vmap`` the lanes go to one launch (``sw_steps``)."""
    return _build.stencil_call(lambda fs: _phase1(fs, cfg, first_step, offsets), fields)


def _phase1(fields, cfg, first_step: bool, offsets):
    shape = _launch_shape(fields, cfg)
    if fields[0].device.type == "cpu":
        if fields[0].dim() == 3:
            return _build.per_lane(
                lambda fs: sw_phase1_plain(fs, cfg, first_step, offsets), fields)
        return sw_phase1_plain(fields, cfg, first_step, offsets)
    if fields[0].device.type == "meta":
        return _build.meta_fields("sw_phase", "sw_phase1", fields, shape)
    stream = _launch_device(fields)
    _build.check_cuda_fields("sw_phase", fields, shape)
    outs = tuple(torch.empty_like(f) for f in fields)
    ints, floats = _frame_args(cfg, offsets)
    err = _library().sw_phase1_launch(
        *(f.data_ptr() for f in fields), *(o.data_ptr() for o in outs),
        *ints, int(first_step), *floats, _build.lanes_of(fields),
        cfg.ny_local * cfg.nx_local, stream,
    )
    _build.raise_on_error("sw_phase1", err)
    counter.count(torch.cuda.is_current_stream_capturing())
    return outs


def sw_phase2(u, v, cfg, offsets):
    """Phase 2 of one step on ``u`` and ``v`` of the rank at ``offsets``
    (planes, or stacked lanes); returns the new ``(u, v)``.  CPU tensors
    take the plain version; CUDA tensors launch the kernel once, or raise;
    ``meta`` tensors take the shape rule; under ``torch.func.vmap`` the
    lanes go to one launch."""
    return _build.stencil_call(lambda fs: _phase2(*fs, cfg, offsets), (u, v))


def _phase2(u, v, cfg, offsets):
    shape = _launch_shape((u, v), cfg)
    if u.device.type == "cpu":
        if u.dim() == 3:
            return _build.per_lane(lambda fs: sw_phase2_plain(*fs, cfg, offsets), (u, v))
        return sw_phase2_plain(u, v, cfg, offsets)
    if u.device.type == "meta":
        return _build.meta_fields("sw_phase", "sw_phase2", (u, v), shape)
    stream = _launch_device((u, v))
    _build.check_cuda_fields("sw_phase", (u, v), shape)
    ou, ov = torch.empty_like(u), torch.empty_like(v)
    ints, floats = _frame_args(cfg, offsets)
    err = _library().sw_phase2_launch(
        u.data_ptr(), v.data_ptr(), ou.data_ptr(), ov.data_ptr(),
        *ints, *floats, _build.lanes_of((u, v)), cfg.ny_local * cfg.nx_local, stream,
    )
    _build.raise_on_error("sw_phase2", err)
    counter.count(torch.cuda.is_current_stream_capturing())
    return ou, ov
