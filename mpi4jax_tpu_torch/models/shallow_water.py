"""Shallow-water solver — the flagship workload, in PyTorch.

Port of ``examples/shallow_water.py``: a nonlinear shallow-water model on
an Arakawa C-grid (energy-conserving Sadourny scheme, Adams-Bashforth 2).
The JAX version traces one SPMD program over a device mesh and keeps the
state as stacked blocks ``(nproc, ny_l, nx_l)``; the port runs one process
per rank, and a ``State`` here is rank ``r``'s block, what the JAX package
calls ``global[r]``.  A grid of several ranks runs in a world of as many
processes (``parallel/launch.py``), the halos travel through ``sendrecv``.

The ``fast=`` modes are the JAX package's public contract:

- ``False`` — ``model_step``, the reference-structured step (the oracle);
- ``True`` — ``model_step_fast``, the exchange-light full-field step;
- ``"pallas"`` / ``"pallas2"`` / ``"pallas3"`` — the fused whole-step
  kernel (``kernels/sw_steps.py``) advancing 1, 2 or 3 steps per call;
  single-rank periodic-x only;
- ``"pallas_halo"`` — ``model_step_fused_halo``: the split-phase kernels
  (``kernels/sw_phase.py``) with real halo exchanges between them; any grid;
- ``"wide"`` / ``"wide2"`` — the communication-avoiding wide-halo kernel
  (``kernels/sw_wide.py``) on a widened frame carried across calls, one or
  two steps per call; any grid whose local interior is at least the
  exchange depth (8 or 16 cells);
- ``"auto"`` — ``"pallas2"`` on a single-rank periodic-x config, else
  ``"wide2"`` where the local interior fits its exchange depth, else
  ``"pallas_halo"``.

Every entry point takes ``device=None``, meaning the GPU; without CUDA it
raises unless given ``device="cpu"``.

The JAX example's command line (``main``, ``run``):

    python -m mpi4jax_tpu_torch.models.shallow_water                # 1-day demo
    python -m mpi4jax_tpu_torch.models.shallow_water --benchmark    # 10x domain, 0.1 day
    python -m mpi4jax_tpu_torch.models.shallow_water --save-animation
    python -m mpi4jax_tpu_torch.models.shallow_water --n-devices 4  # 4 gloo ranks

``--n-devices N`` starts N processes, one a rank, all on ``--device``
(so on one card they share it); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
import weakref
from dataclasses import asdict, dataclass, replace
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels import sw_phase as _kp
from ..kernels import sw_steps as _k
from ..kernels import sw_wide as _kw
from ..kernels.sw_steps import (  # noqa: F401  (the physics windows live beside the kernel)
    _phase1_window,
    _phase2_window,
    _step_window,
    _window_masks,
    divisors,
    step_constants,
)
from ..ops import _staging
from ..ops.gather import gather
from ..ops.sendrecv import sendrecv
from ..ops.token import create_token
from ..parallel.comm import Comm
from ..parallel.mesh import make_world_mesh, resolve_device
from ..parallel.rankspec import shift

DAY_IN_SECONDS = 86_400


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    """Model configuration (``examples/shallow_water.py:Config``)."""

    # interior grid points (without the 1-cell overlap border)
    nx: int = 360
    ny: int = 180
    # grid spacing [m]
    dx: float = 5e3
    dy: float = 5e3
    # physics
    gravity: float = 9.81
    depth: float = 100.0
    coriolis_f: float = 2e-4
    coriolis_beta: float = 2e-11
    periodic_x: bool = True
    # Adams-Bashforth coefficients
    ab_a: float = 1.5 + 0.1
    ab_b: float = -(0.5 + 0.1)
    # process grid
    nproc_y: int = 1
    nproc_x: int = 1

    @property
    def lateral_viscosity(self) -> float:
        return 1e-3 * self.coriolis_f * self.dx**2

    @property
    def dt(self) -> float:
        # CFL-limited gravity-wave time step
        return 0.125 * min(self.dx, self.dy) / math.sqrt(self.gravity * self.depth)

    @property
    def nproc(self) -> int:
        return self.nproc_y * self.nproc_x

    @property
    def ny_local(self) -> int:
        assert self.ny % self.nproc_y == 0, "nproc_y must divide ny"
        return self.ny // self.nproc_y + 2  # +2 halo cells

    @property
    def nx_local(self) -> int:
        assert self.nx % self.nproc_x == 0, "nproc_x must divide nx"
        return self.nx // self.nproc_x + 2

    @property
    def length_x(self) -> float:
        return self.nx * self.dx

    @property
    def length_y(self) -> float:
        return self.ny * self.dy


class State(NamedTuple):
    """Rank-local model state: every field is ``(ny_l, nx_l)`` f32."""

    h: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    dh: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor


def make_mesh_and_comm(cfg: Config, device=None):
    """Process grid ``(py, px)`` and the communicator over both axes."""
    mesh = make_world_mesh((cfg.nproc_y, cfg.nproc_x), ("py", "px"), device=device)
    return mesh, Comm(("py", "px"), mesh=mesh)


# ---------------------------------------------------------------------------
# initial conditions (host-side, decomposition-independent)
# ---------------------------------------------------------------------------


def _global_initial_fields(cfg: Config):
    """Global ``(h0, u0, v0)`` including the 1-cell border, in float64."""
    x = (np.arange(cfg.nx + 2) - 1.0) * cfg.dx
    y = (np.arange(cfg.ny + 2) - 1.0) * cfg.dy
    yy, xx = np.meshgrid(y, x, indexing="ij")

    u0 = 10 * np.exp(-((yy - 0.5 * cfg.length_y) ** 2) / (0.02 * cfg.length_x) ** 2)
    v0 = np.zeros_like(u0)
    # approximate geostrophic balance: h_y = -(f/g) u
    f = cfg.coriolis_f + yy * cfg.coriolis_beta
    h_geo = np.cumsum(-cfg.dy * u0 * f / cfg.gravity, axis=0)
    h0 = (
        cfg.depth
        + h_geo
        - h_geo.mean()
        + 0.2
        * np.sin(xx / cfg.length_x * 10 * np.pi)
        * np.cos(yy / cfg.length_y * 8 * np.pi)
    )
    return h0, u0, v0


def initial_state(cfg: Config, *, rank: int = 0, device=None) -> State:
    """Rank ``rank``'s block of the geostrophically balanced jet plus
    perturbation (``examples/shallow_water.py:initial_state``): computed
    globally on the host in float64, cut, then rounded to f32."""
    device = resolve_device(device)
    if not 0 <= rank < cfg.nproc:
        raise ValueError(f"rank {rank} out of range for {cfg.nproc} ranks")
    py, px = divmod(rank, cfg.nproc_x)
    step_y, step_x = cfg.ny_local - 2, cfg.nx_local - 2
    sel = np.s_[py * step_y: py * step_y + cfg.ny_local,
                px * step_x: px * step_x + cfg.nx_local]

    def cut(arr):
        return torch.from_numpy(np.ascontiguousarray(arr[sel], np.float32)).to(device)

    h0, u0, v0 = _global_initial_fields(cfg)
    shape = (cfg.ny_local, cfg.nx_local)
    zeros = [torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)]
    return State(cut(h0), cut(u0), cut(v0), *zeros)


def reassemble(stacked: np.ndarray, cfg: Config) -> np.ndarray:
    """Stacked local blocks ``(nproc, ny_l, nx_l)`` → global interior
    ``(ny, nx)``."""
    interior = np.asarray(stacked)[:, 1:-1, 1:-1]
    ny_i, nx_i = interior.shape[1:]
    grid = interior.reshape(cfg.nproc_y, cfg.nproc_x, ny_i, nx_i)
    return grid.transpose(0, 2, 1, 3).reshape(cfg.nproc_y * ny_i, cfg.nproc_x * nx_i)


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

_ALL = slice(None)

# the row and column comms of each grid comm, built at its first exchange:
# the JAX package traces a step once, so its sub-comms (and their uids,
# which key the telemetry counters) are built once too
_ROW_COL = weakref.WeakKeyDictionary()


def row_col(comm: Comm):
    """``(comm.sub("px"), comm.sub("py"))``, the same two comms at every
    call on ``comm``."""
    subs = _ROW_COL.get(comm)
    if subs is None:
        subs = _ROW_COL[comm] = (comm.sub("px"), comm.sub("py"))
    return subs


def enforce_boundaries(arr, kind: str, cfg: Config, comm: Comm, token):
    """Exchange the 1-cell halo with the four neighbours and apply the
    physical boundary conditions (``examples/shallow_water.py:
    enforce_boundaries``).  Each direction is one ``sendrecv`` with a
    ``shift`` routing on the row (px) or column (py) sub-communicator; a
    non-wrapping direction on a size-1 axis has no neighbour and is
    skipped.  Returns a new tensor and the token."""
    assert kind in ("h", "u", "v")
    commx, commy = row_col(comm)
    wrap_x = cfg.periodic_x
    arr = arr.clone()

    # (what to send, where received data lands, sub-comm, routing)
    exchanges = (
        # west-to-east halo fill: rank r sends col 1 to r-1, writes col -1
        ((_ALL, 1), (_ALL, -1), commx, shift(-1, wrap=wrap_x)),
        # south-to-north: rank r sends row -2 to r+1, writes row 0
        ((-2, _ALL), (0, _ALL), commy, shift(+1, wrap=False)),
        # east-to-west: rank r sends col -2 to r+1, writes col 0
        ((_ALL, -2), (_ALL, 0), commx, shift(+1, wrap=wrap_x)),
        # north-to-south: rank r sends row 1 to r-1, writes row -1
        ((1, _ALL), (-1, _ALL), commy, shift(-1, wrap=False)),
    )
    for send_sel, recv_sel, c, route in exchanges:
        if c.Get_size() == 1 and not route.wrap:
            continue  # no neighbor anywhere along this direction
        received, token = sendrecv(
            arr[send_sel], arr[recv_sel], dest=route, comm=c, token=token
        )
        arr[recv_sel] = received

    # physical (non-periodic) walls: no normal flow through the boundary
    if not cfg.periodic_x and kind == "u" and comm.axis_index("px") == cfg.nproc_x - 1:
        arr[:, -2] = 0.0
    if kind == "v" and comm.axis_index("py") == cfg.nproc_y - 1:
        arr[-2, :] = 0.0

    return arr, token


# ---------------------------------------------------------------------------
# model physics
# ---------------------------------------------------------------------------


def local_coriolis(cfg: Config, comm: Comm, device):
    """Coriolis parameter on this rank's rows, ``(ny_l, 1)``:
    y = (py * (ny_local-2) + j - 1) * dy."""
    c = step_constants(cfg)
    py = comm.axis_index("py")
    j = torch.arange(cfg.ny_local, device=device)
    y = (py * (cfg.ny_local - 2) + j - 1.0) * c.dy
    return (c.f0 + y * c.beta)[:, None]


def _zeros_set(like, inner, value):
    out = torch.zeros_like(like)
    out[inner] = value
    return out


def model_step(state: State, cfg: Config, comm: Comm, first_step: bool) -> State:
    """One step in the reference's structure (``examples/shallow_water.py:
    model_step``): every derived field is built on the interior and
    halo-exchanged.  The parity oracle for the other modes."""
    token = create_token()
    h, u, v, dh, du, dv = state
    inner = (slice(1, -1), slice(1, -1))
    c = step_constants(cfg)
    (dx, dy), g, dt = divisors(c, h.device), c.g, c.dt

    # cell-centered height with refreshed halo
    hc = F.pad(h[inner][None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    hc, token = enforce_boundaries(hc, "h", cfg, comm, token)

    # volume fluxes through east and north cell faces
    fe = _zeros_set(u, inner, 0.5 * (hc[1:-1, 1:-1] + hc[1:-1, 2:]) * u[inner])
    fn = _zeros_set(v, inner, 0.5 * (hc[1:-1, 1:-1] + hc[2:, 1:-1]) * v[inner])
    fe, token = enforce_boundaries(fe, "u", cfg, comm, token)
    fn, token = enforce_boundaries(fn, "v", cfg, comm, token)

    # continuity: dh/dt = -div(flux)
    dh_new = dh.clone()
    dh_new[inner] = (
        -(fe[1:-1, 1:-1] - fe[1:-1, :-2]) / dx - (fn[1:-1, 1:-1] - fn[:-2, 1:-1]) / dy
    )

    # potential vorticity q = (f + rel. vorticity) / interpolated depth
    coriolis = local_coriolis(cfg, comm, h.device)
    rel_vort = (v[1:-1, 2:] - v[1:-1, 1:-1]) / dx - (u[2:, 1:-1] - u[1:-1, 1:-1]) / dy
    depth_q = 0.25 * (hc[1:-1, 1:-1] + hc[1:-1, 2:] + hc[2:, 1:-1] + hc[2:, 2:])
    q = _zeros_set(h, inner, (coriolis[1:-1] + rel_vort) / depth_q)
    q, token = enforce_boundaries(q, "h", cfg, comm, token)

    # momentum tendencies: pressure gradient + vorticity flux
    du_new = du.clone()
    du_new[inner] = (
        -g * (h[1:-1, 2:] - h[1:-1, 1:-1]) / dx
        + 0.5
        * (
            q[1:-1, 1:-1] * 0.5 * (fn[1:-1, 1:-1] + fn[1:-1, 2:])
            + q[:-2, 1:-1] * 0.5 * (fn[:-2, 1:-1] + fn[:-2, 2:])
        )
    )
    dv_new = dv.clone()
    dv_new[inner] = (
        -g * (h[2:, 1:-1] - h[1:-1, 1:-1]) / dy
        - 0.5
        * (
            q[1:-1, 1:-1] * 0.5 * (fe[1:-1, 1:-1] + fe[2:, 1:-1])
            + q[1:-1, :-2] * 0.5 * (fe[1:-1, :-2] + fe[2:, :-2])
        )
    )

    # kinetic-energy gradient (C-grid average)
    ke = _zeros_set(
        h, inner,
        0.5
        * (
            0.5 * (u[1:-1, 1:-1] ** 2 + u[1:-1, :-2] ** 2)
            + 0.5 * (v[1:-1, 1:-1] ** 2 + v[:-2, 1:-1] ** 2)
        ),
    )
    ke, token = enforce_boundaries(ke, "h", cfg, comm, token)
    du_new[inner] = du_new[inner] + -(ke[1:-1, 2:] - ke[1:-1, 1:-1]) / dx
    dv_new[inner] = dv_new[inner] + -(ke[2:, 1:-1] - ke[1:-1, 1:-1]) / dy

    # time integration: forward Euler on the first step, AB-2 after
    h, u, v = h.clone(), u.clone(), v.clone()
    if first_step:
        h[inner] = h[inner] + dt * dh_new[inner]
        u[inner] = u[inner] + dt * du_new[inner]
        v[inner] = v[inner] + dt * dv_new[inner]
    else:
        h[inner] = h[inner] + dt * (c.ab_a * dh_new[inner] + c.ab_b * dh[inner])
        u[inner] = u[inner] + dt * (c.ab_a * du_new[inner] + c.ab_b * du[inner])
        v[inner] = v[inner] + dt * (c.ab_a * dv_new[inner] + c.ab_b * dv[inner])

    h, token = enforce_boundaries(h, "h", cfg, comm, token)
    u, token = enforce_boundaries(u, "u", cfg, comm, token)
    v, token = enforce_boundaries(v, "v", cfg, comm, token)

    # lateral friction on u and v
    if cfg.lateral_viscosity > 0:
        visc = c.visc
        for name, field in (("u", u), ("v", v)):
            gx = _zeros_set(field, inner,
                            visc * (field[1:-1, 2:] - field[1:-1, 1:-1]) / dx)
            gy = _zeros_set(field, inner,
                            visc * (field[2:, 1:-1] - field[1:-1, 1:-1]) / dy)
            gx, token = enforce_boundaries(gx, "u", cfg, comm, token)
            gy, token = enforce_boundaries(gy, "v", cfg, comm, token)
            field = field.clone()
            field[inner] = field[inner] + dt * (
                (gx[1:-1, 1:-1] - gx[1:-1, :-2]) / dx
                + (gy[1:-1, 1:-1] - gy[:-2, 1:-1]) / dy
            )
            if name == "u":
                u = field
            else:
                v = field

    return State(h, u, v, dh_new, du_new, dv_new)


def model_step_fast(state: State, cfg: Config, comm: Comm,
                    first_step: bool) -> State:
    """One step, numerically equivalent to ``model_step`` but computed
    full-field with rolls (``examples/shallow_water.py:model_step_fast``):
    with coherent halos on the inputs, the derived fields need no exchange,
    so only ``h``, ``u`` and ``v`` are exchanged, and the wall semantics
    become index masks."""
    token = create_token()
    h, u, v, dh, du, dv = state
    c = step_constants(cfg)
    (dx, dy), g, dt = divisors(c, h.device), c.g, c.dt
    ny, nx = cfg.ny_local, cfg.nx_local
    dev = h.device

    rm1x = lambda a: torch.roll(a, -1, 1)  # noqa: E731  a[j, i+1]
    rp1x = lambda a: torch.roll(a, 1, 1)  # noqa: E731   a[j, i-1]
    rm1y = lambda a: torch.roll(a, -1, 0)  # noqa: E731  a[j+1, i]
    rp1y = lambda a: torch.roll(a, 1, 0)  # noqa: E731   a[j-1, i]

    iy = torch.arange(ny, device=dev)[:, None]
    ix = torch.arange(nx, device=dev)[None, :]
    on_south = comm.axis_index("py") == 0
    on_north = comm.axis_index("py") == cfg.nproc_y - 1
    # y-halo rows that enforce_boundaries would not fill: 0 in every
    # derived field, exactly as in the reference
    kept_y_halo = (on_south & (iy == 0)) | (on_north & (iy == ny - 1))
    interior = (iy > 0) & (iy < ny - 1) & (ix > 0) & (ix < nx - 1)
    u_wall = None  # kind-"u" no-flow wall column
    if not cfg.periodic_x:
        on_west = comm.axis_index("px") == 0
        on_east = comm.axis_index("px") == cfg.nproc_x - 1
        kept_y_halo = kept_y_halo | (on_west & (ix == 0)) | (on_east & (ix == nx - 1))
        u_wall = on_east & (ix == nx - 2)
    wall_v = on_north & (iy == ny - 2)

    def derived(expr, extra_zero=None):
        zero = kept_y_halo if extra_zero is None else (kept_y_halo | extra_zero)
        return torch.where(zero, 0.0, expr)

    # cell-centered height: edge replication at wall ranks
    hc = torch.where(
        on_south & (iy == 0),
        rm1y(h),
        torch.where(on_north & (iy == ny - 1), rp1y(h), h),
    )
    if not cfg.periodic_x:
        hc = torch.where(
            on_west & (ix == 0),
            rm1x(hc),
            torch.where(on_east & (ix == nx - 1), rp1x(hc), hc),
        )

    fe = derived(0.5 * (hc + rm1x(hc)) * u, u_wall)
    fn = derived(0.5 * (hc + rm1y(hc)) * v, wall_v)

    coriolis = local_coriolis(cfg, comm, dev)
    rel_vort = (rm1x(v) - v) / dx - (rm1y(u) - u) / dy
    depth_q = 0.25 * (hc + rm1x(hc) + rm1y(hc) + rm1y(rm1x(hc)))
    q = derived((coriolis + rel_vort) / depth_q)

    u_sq, v_sq = u * u, v * v
    ke = derived(0.5 * (0.5 * (u_sq + rp1x(u_sq)) + 0.5 * (v_sq + rp1y(v_sq))))

    dh_new = torch.where(
        interior, -(fe - rp1x(fe)) / dx - (fn - rp1y(fn)) / dy, 0.0
    )
    fn_e = 0.5 * (fn + rm1x(fn))
    fe_n = 0.5 * (fe + rm1y(fe))
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
        h = h + dt * dh_new
        u = u + dt * du_new
        v = v + dt * dv_new
    else:
        h = h + dt * (c.ab_a * dh_new + c.ab_b * dh)
        u = u + dt * (c.ab_a * du_new + c.ab_b * du)
        v = v + dt * (c.ab_a * dv_new + c.ab_b * dv)

    h, token = enforce_boundaries(h, "h", cfg, comm, token)
    u, token = enforce_boundaries(u, "u", cfg, comm, token)
    v, token = enforce_boundaries(v, "v", cfg, comm, token)

    # lateral friction with locally computed ghosts
    if cfg.lateral_viscosity > 0:
        visc = c.visc
        for name in ("u", "v"):
            field = u if name == "u" else v
            gx = derived(visc * (rm1x(field) - field) / dx, u_wall)
            gy = derived(visc * (rm1y(field) - field) / dy, wall_v)
            field = field + torch.where(
                interior,
                dt * ((gx - rp1x(gx)) / dx + (gy - rp1y(gy)) / dy),
                0.0,
            )
            if name == "u":
                u = field
            else:
                v = field

        # restore the coherent-halo invariant for the next step (kind "h":
        # a pure halo refresh, the wall rows were applied above)
        u, token = enforce_boundaries(u, "h", cfg, comm, token)
        v, token = enforce_boundaries(v, "h", cfg, comm, token)

    return State(h, u, v, dh_new, du_new, dv_new)


# ---------------------------------------------------------------------------
# fused whole-step kernel (single-rank hot path)
# ---------------------------------------------------------------------------


def _margin_rows(nsteps: int) -> int:
    """The JAX package's margin depth for ``nsteps`` fused steps (8 rows per
    step, rounded up to a divisor of its 128-row block): the threshold
    ``"auto"`` compares a rank's local interior with before it picks the
    wide-halo pair kernel.  The CUDA kernel's own tile margins are
    ``nsteps * kernels.sw_steps.STEP_RADIUS``."""
    if not 1 <= nsteps <= 3:
        raise ValueError(f"fused step windows support 1..3 steps, got {nsteps}")
    m = 8 * nsteps
    while 128 % m:
        m += 8
    return m


def model_step_fused(state: State, cfg: Config, comm: Comm, first_step: bool,
                     nsteps: int = 1) -> State:
    """``nsteps`` applications of ``model_step_fast`` as one call of the
    fused kernel (counterpart of ``examples/shallow_water.py:
    model_step_pallas``).  On this single-rank periodic-x path every halo
    refresh is the periodic column fix, done inside the kernel, so there
    are no exchanges.  CPU tensors take the kernel's plain version."""
    return State(*_k.sw_steps(tuple(state), cfg, first_step, nsteps))


def model_step2_fused(state: State, cfg: Config, comm: Comm,
                      first_step: bool) -> State:
    """Two steps per kernel call (``model_step2_pallas``)."""
    return model_step_fused(state, cfg, comm, first_step, nsteps=2)


def model_step3_fused(state: State, cfg: Config, comm: Comm,
                      first_step: bool) -> State:
    """Three steps per kernel call (``model_step3_pallas``)."""
    return model_step_fused(state, cfg, comm, first_step, nsteps=3)


# ---------------------------------------------------------------------------
# split-phase step (any grid: kernel compute + real halo exchanges)
# ---------------------------------------------------------------------------


def _rank_offsets(cfg: Config, comm: Comm):
    """This rank's domain-global (row, col) offset: the two ints that let
    one kernel build serve every rank position (every wall mask tests
    ``local index + offset``)."""
    return (comm.axis_index("py") * (cfg.ny_local - 2),
            comm.axis_index("px") * (cfg.nx_local - 2))


def model_step_fused_halo(state: State, cfg: Config, comm: Comm,
                          first_step: bool) -> State:
    """One step on any grid (``examples/shallow_water.py:
    model_step_pallas_halo``): ``model_step_fast``'s exchange structure
    with its two compute regions as the split-phase kernels — phase 1,
    exchange h, u, v, phase 2, exchange u, v (kind "h", a pure halo
    refresh).  CPU tensors take the kernels' plain versions."""
    token = create_token()
    off = _rank_offsets(cfg, comm)
    h1, u1, v1, dh_new, du_new, dv_new = _kp.sw_phase1(
        tuple(state), cfg, first_step, off)

    h1, token = enforce_boundaries(h1, "h", cfg, comm, token)
    u1, token = enforce_boundaries(u1, "u", cfg, comm, token)
    v1, token = enforce_boundaries(v1, "v", cfg, comm, token)

    if cfg.lateral_viscosity > 0:
        u1, v1 = _kp.sw_phase2(u1, v1, cfg, off)
        u1, token = enforce_boundaries(u1, "h", cfg, comm, token)
        v1, token = enforce_boundaries(v1, "h", cfg, comm, token)

    return State(h1, u1, v1, dh_new, du_new, dv_new)


# ---------------------------------------------------------------------------
# wide-halo step (any grid: communication-avoiding fused kernel)
# ---------------------------------------------------------------------------


def _strip_exch(payload, route, c: Comm, token):
    """One batched halo strip along a direction: a single ``sendrecv`` with
    a zeros template (edge ranks of a non-wrapping direction keep zeros).
    A size-1 axis needs no message: the identity for a wrapping route,
    zeros for a non-wrapping one."""
    if c.Get_size() == 1:
        return payload if route.wrap else torch.zeros_like(payload)
    out, _ = sendrecv(payload, torch.zeros_like(payload), dest=route,
                      comm=c, token=token)
    return out


def _wide_exchange(fields, cfg: Config, comm: Comm, m: int, token):
    """Build the widened frame (``examples/shallow_water.py:
    _wide_exchange``): every side gains ``m - 1`` cells of neighbour data
    beyond the 1-cell halo, from ``m``-deep strips of all six fields, one
    ``sendrecv`` per direction: x strips first, then y strips of the
    x-widened arrays, which brings the corners.  The state fields keep
    their own halo ring and take only the ``m - 1`` cells beyond it; the
    tendencies take the whole strip, whose first cell is the owning rank's
    value at the seam."""
    nyl, nxl = cfg.ny_local, cfg.nx_local
    commx, commy = row_col(comm)
    wrap_x = cfg.periodic_x

    # x phase: (6, nyl, m) strips; high-side strips travel east
    lo = torch.stack([f[:, 1:m + 1] for f in fields])
    hi = torch.stack([f[:, nxl - 1 - m:nxl - 1] for f in fields])
    from_west = _strip_exch(hi, shift(+1, wrap=wrap_x), commx, token)
    from_east = _strip_exch(lo, shift(-1, wrap=wrap_x), commx, token)
    wx = []
    for k, f in enumerate(fields):
        w, e = from_west[k], from_east[k]
        if k < 3:  # state: local halo ring kept in place
            wx.append(torch.cat([w[:, :m - 1], f, e[:, 1:]], dim=1))
        else:  # tendency: the strip supplies the halo position
            wx.append(torch.cat([w, f[:, 1:-1], e], dim=1))

    # y phase: (6, m, nx_w) strips of the x-widened arrays
    lo = torch.stack([f[1:m + 1] for f in wx])
    hi = torch.stack([f[nyl - 1 - m:nyl - 1] for f in wx])
    from_south = _strip_exch(hi, shift(+1, wrap=False), commy, token)
    from_north = _strip_exch(lo, shift(-1, wrap=False), commy, token)
    out = []
    for k, f in enumerate(wx):
        s_, n_ = from_south[k], from_north[k]
        if k < 3:
            out.append(torch.cat([s_[:m - 1], f, n_[1:]], dim=0))
        else:
            out.append(torch.cat([s_, f[1:-1], n_], dim=0))
    return tuple(out), token


def _wide_kernel_call(wfields, cfg: Config, comm: Comm, first_step: bool,
                      nsteps: int, m: int):
    """``nsteps`` steps of the wide-halo kernel on the widened frame, whose
    global offsets are the rank's minus ``m - 1``."""
    oy, ox = _rank_offsets(cfg, comm)
    return _kw.sw_wide(tuple(wfields), cfg, first_step, nsteps,
                       (oy - (m - 1), ox - (m - 1)))


def _wide_crop(outs, cfg: Config, m: int) -> State:
    """Crop a widened frame back to the local layout: the state's halo ring
    lands coherent, and the tendency ring is set back to zero (in the frame
    it holds the neighbour's values at seams)."""
    nyl, nxl = cfg.ny_local, cfg.nx_local
    sl = (slice(m - 1, m - 1 + nyl), slice(m - 1, m - 1 + nxl))
    dev = outs[0].device
    liy = torch.arange(nyl, device=dev)[:, None]
    lix = torch.arange(nxl, device=dev)[None, :]
    ring = (liy == 0) | (liy == nyl - 1) | (lix == 0) | (lix == nxl - 1)
    h1, u1, v1 = (o[sl].contiguous() for o in outs[:3])
    dh_n, du_n, dv_n = (torch.where(ring, 0.0, o[sl]) for o in outs[3:])
    return State(h1, u1, v1, dh_n, du_n, dv_n)


def _wide_refresh(wf, cfg: Config, comm: Comm, m: int, token):
    """Refresh the margin bands of a carried widened frame between kernel
    calls (``examples/shallow_water.py:_wide_refresh``): after a call the
    crop region is valid and the ``m - 1``-deep margins are garbage.  x
    bands first, then y bands at the full widened width, sliced after the
    x update so their corners carry diagonal-neighbour data.  The bands
    are written into the carried tensors in place."""
    e = m - 1
    nyl, nxl = cfg.ny_local, cfg.nx_local
    commx, commy = row_col(comm)
    wrap_x = cfg.periodic_x

    # x bands (6, ny_w, e): west margin <- west neighbour's easternmost
    # interior, east margin <- east neighbour's westernmost
    from_west = _strip_exch(torch.stack([f[:, nxl - 2:nxl - 2 + e] for f in wf]),
                            shift(+1, wrap=wrap_x), commx, token)
    from_east = _strip_exch(torch.stack([f[:, e + 2:2 * e + 2] for f in wf]),
                            shift(-1, wrap=wrap_x), commx, token)
    for k, f in enumerate(wf):
        f[:, :e] = from_west[k]
        f[:, e + nxl:] = from_east[k]

    # y bands (6, e, nx_w), full width (corners now valid)
    from_south = _strip_exch(torch.stack([f[nyl - 2:nyl - 2 + e] for f in wf]),
                             shift(+1, wrap=False), commy, token)
    from_north = _strip_exch(torch.stack([f[e + 2:2 * e + 2] for f in wf]),
                             shift(-1, wrap=False), commy, token)
    for k, f in enumerate(wf):
        f[:e, :] = from_south[k]
        f[e + nyl:, :] = from_north[k]
    return wf


def _check_wide_interior(cfg: Config, m: int) -> None:
    if cfg.ny_local - 2 < m or cfg.nx_local - 2 < m:
        raise ValueError(
            "wide-halo path: local interior must be >= the exchange depth "
            f"({m}) in both dimensions; use model_step_fused_halo"
        )


def _wide_run(state: State, num_steps: int, cfg: Config, comm: Comm,
              chunk_size: int, m: int, euler_first: bool) -> State:
    """Advance ``num_steps`` steps on the carried widened frame
    (``examples/shallow_water.py:_wide_run``): build the frame once, run
    ``chunk_size``-step kernel calls with a margin-band refresh before each
    (except the first call after the build, whose margins are fresh), the
    remainder one step per call, and crop once at the end.
    ``euler_first`` makes the first step the forward-Euler one."""
    _check_wide_interior(cfg, m)
    if num_steps <= 0:
        return state
    token = create_token()
    wf, token = _wide_exchange(tuple(state), cfg, comm, m, token)
    rest = num_steps
    fresh = True  # margins still the just-exchanged ones
    if euler_first:
        wf = _wide_kernel_call(wf, cfg, comm, True, 1, m)
        rest -= 1
        fresh = False
    nchunks, rem = divmod(rest, chunk_size)
    for n in [chunk_size] * nchunks + [1] * rem:
        if not fresh:
            wf = _wide_refresh(wf, cfg, comm, m, token)
        fresh = False
        wf = _wide_kernel_call(wf, cfg, comm, False, n, m)
    return _wide_crop(wf, cfg, m)


def model_step_fused_wide(state: State, cfg: Config, comm: Comm,
                          first_step: bool, nsteps: int = 2) -> State:
    """``nsteps`` steps as one wide-halo kernel call between a frame build
    and a crop (``examples/shallow_water.py:model_step_pallas_wide``)."""
    m = _margin_rows(nsteps)
    _check_wide_interior(cfg, m)
    wf, _ = _wide_exchange(tuple(state), cfg, comm, m, create_token())
    return _wide_crop(_wide_kernel_call(wf, cfg, comm, first_step, nsteps, m),
                      cfg, m)


def model_step_wide(state: State, cfg: Config, comm: Comm,
                    first_step: bool) -> State:
    """One step through the wide-halo kernel."""
    return model_step_fused_wide(state, cfg, comm, first_step, nsteps=1)


def model_step2_wide(state: State, cfg: Config, comm: Comm,
                     first_step: bool) -> State:
    """Two steps per wide-halo kernel call and exchange round."""
    return model_step_fused_wide(state, cfg, comm, first_step, nsteps=2)


def select_step(fast, cfg: Config = None):
    """The single-step callable behind ``fast`` (see ``select_steps``)."""
    return select_steps(fast, cfg)[0]


def resolve_fast(fast, cfg: Config = None):
    """The mode ``fast`` names: ``"auto"`` resolved for ``cfg``, any other
    mode as it is."""
    if fast != "auto":
        return fast
    if cfg is None:
        raise ValueError(
            "select_step('auto') needs the Config to decide kernel "
            "eligibility — pass cfg"
        )
    if cfg.nproc == 1 and cfg.periodic_x:
        return "pallas2"
    if min(cfg.ny_local, cfg.nx_local) - 2 >= _margin_rows(2):
        return "wide2"
    return "pallas_halo"


def select_steps(fast, cfg: Config = None):
    """``(single_step, chunk_step_or_None, chunk_size)`` behind ``fast``
    (``examples/shallow_water.py:select_steps``).  ``chunk_step`` advances
    ``chunk_size`` steps per call; callers use ``single_step`` for the first
    (Euler) step and for remainders."""
    fast = resolve_fast(fast, cfg)
    if fast == "wide2":
        return model_step_wide, model_step2_wide, 2
    if fast == "wide":
        return model_step_wide, None, 1
    if fast == "pallas3":
        return model_step_fused, model_step3_fused, 3
    if fast == "pallas2":
        return model_step_fused, model_step2_fused, 2
    if fast == "pallas":
        return model_step_fused, None, 1
    if fast == "pallas_halo":
        return model_step_fused_halo, None, 1
    return (model_step_fast if fast else model_step), None, 1


def make_stepper(cfg: Config, comm: Comm, *, fast=True):
    """``(first_step, multistep)``: the first (Euler) step, and
    ``multistep(state, num_steps)`` advancing exactly ``num_steps`` AB-2
    steps (whole chunks through the chunk kernel, the remainder one step
    at a time)."""
    step, chunk, chunk_size = select_steps(fast, cfg)

    if step is model_step_wide:
        # the wide modes run on the carried widened frame
        m = _margin_rows(chunk_size)

        def first_step(state: State) -> State:
            return _wide_run(state, 1, cfg, comm, chunk_size, m, euler_first=True)

        def multistep(state: State, num_steps: int) -> State:
            return _wide_run(state, num_steps, cfg, comm, chunk_size, m,
                             euler_first=False)

        return first_step, multistep

    def first_step(state: State) -> State:
        return step(state, cfg, comm, first_step=True)

    def multistep(state: State, num_steps: int) -> State:
        return _run_steps(state, num_steps, cfg, comm, step, chunk, chunk_size)

    return first_step, multistep


def _run_steps(state: State, num_steps: int, cfg, comm, step, chunk,
               chunk_size: int) -> State:
    """Advance ``num_steps`` non-first steps, whole ``chunk_size`` runs
    through ``chunk`` when there is one."""
    if chunk is not None:
        nchunks, rem = divmod(num_steps, chunk_size)
        for _ in range(nchunks):
            state = chunk(state, cfg, comm, False)
        for _ in range(rem):
            state = step(state, cfg, comm, False)
        return state
    for _ in range(num_steps):
        state = step(state, cfg, comm, False)
    return state


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def _sync(state: State) -> None:
    """Wait for the device by fetching one element."""
    state.h[0, 0].item()


def solve(cfg: Config, t1: float, *, num_multisteps: int = 10, device=None,
          collect: bool = True, verbose: bool = False, fast=True):
    """Iterate the model to time ``t1`` [s].  Returns ``(snapshots,
    wall_time_s, n_steps)``.  ``snapshots`` holds this rank's ``h`` after
    the initial state, the first step and every multistep, then the
    root-gathered ``(nproc, ny_l, nx_l)`` final ``h`` (empty when
    ``collect=False``)."""
    _, comm = make_mesh_and_comm(cfg, device=device)
    first_step, multistep = make_stepper(cfg, comm, fast=fast)

    state = initial_state(cfg, rank=comm.Get_rank(), device=comm.device)
    snapshots = [state.h.cpu().numpy()] if collect else []

    state = first_step(state)
    if collect:
        snapshots.append(state.h.cpu().numpy())
    t = cfg.dt

    # warm-up call (excluded from timing, as in the JAX package's solve)
    _sync(multistep(state, num_multisteps))

    n_steps = 1
    start = time.perf_counter()
    while t < t1:
        state = multistep(state, num_multisteps)
        if collect:
            snapshots.append(state.h.cpu().numpy())
        t += cfg.dt * num_multisteps
        n_steps += num_multisteps
        if verbose:
            print(f"  t = {t / DAY_IN_SECONDS:.3f} days", end="\r")
    if not collect:
        _sync(state)
    wall = time.perf_counter() - start

    if collect:
        gathered, _ = gather(state.h, root=0, comm=comm)
        snapshots.append(gathered.cpu().numpy())

    return snapshots, wall, n_steps


def solve_fused(cfg: Config, t1: float, *, num_multisteps: int = 10,
                device=None, fast=True, return_state=False,
                pinned: bool = False, unroll: int = 0, info: dict = None):
    """Benchmark-mode solve: the first Euler step plus every remaining step
    as one run, timed after a warm-up, best of two.  Runs the same number
    of steps as ``solve(collect=False)``.  Returns ``(wall_time_s,
    n_steps)``, plus the final state when ``return_state`` is set.

    The wide modes run the carried frame (``_wide_run``) over the
    whole run: one frame build, a margin-band refresh per call, one crop.

    ``pinned=True`` pins the whole run (``aot.compile``), as the JAX
    package does on any mesh: on one CUDA rank one CUDA graph, captured
    after one eager run, whose replays are timed; a failed capture raises,
    there is no eager fallback.  On the CPU and on several ranks (whose
    exchanges are staged through the host, which a graph cannot capture)
    the pin is its body run eagerly at every call, the pin's meaning
    there: the same steps and bits as ``pinned=False``, with
    ``info["pinned"]`` False and ``info["eager_reason"]`` naming the world
    (``"device cpu"``, ``"4 ranks"``).

    ``unroll=N`` (> 0) runs the megastep mode of the JAX package: the
    Euler step through the whole-run program at total 0, then
    ``(n_steps - 1) // N`` calls of a megastep pin of N single steps
    (``compile(one_step, state, unroll=N)``) and one pin of the remaining
    steps; on one CUDA rank each is a CUDA graph, the two sharing one
    memory pool, elsewhere the same loop runs eagerly.  The body is one
    step: ``_run_steps(state, 1, ...)``, or the wide modes' ``_wide_run``
    of one step (a frame build, one kernel call and a crop).  It works
    on every grid and, when set, wins over ``pinned``.

    When ``info`` (a dict) is passed, ``info["runs"]`` counts the whole
    runs executed (warm-ups included), ``info["pinned"]`` says whether
    they replayed CUDA graphs, ``info["unroll"]`` is the megastep trip
    count that ran (0 without one), ``info["eager_reason"]``, present
    only when a pin ran eagerly, what made it (the world of a whole-run
    pin off one CUDA rank, else the knob, ``aot/pinning.py``), and of the
    timed (best) run
    ``info["exchange_s"]`` holds the seconds spent inside multi-rank ops
    (``ops/_staging.py:stats``), ``info["replays"]`` the graph replays,
    ``info["launches"]`` each kernel's launches (the kernels that
    launched) and ``info["bytes_copied"]`` the bytes the pins copied into
    and out of their graphs."""
    from ..aot import pinning
    from ..parallel.region import spmd

    _, comm = make_mesh_and_comm(cfg, device=device)
    n_iters = max(0, math.ceil((t1 - cfg.dt) / (cfg.dt * num_multisteps)))
    n_steps = 1 + n_iters * num_multisteps
    step, chunk, chunk_size = select_steps(fast, cfg)

    if step is model_step_wide:
        m = _margin_rows(chunk_size)

        @partial(spmd, comm=comm, static_argnums=(1,))
        def fused(state: State, total: int) -> State:
            return _wide_run(state, total + 1, cfg, comm, chunk_size, m,
                             euler_first=True)

        def one_step(state: State) -> State:
            return _wide_run(state, 1, cfg, comm, chunk_size, m,
                             euler_first=False)
    else:
        @partial(spmd, comm=comm, static_argnums=(1,))
        def fused(state: State, total: int) -> State:
            state = step(state, cfg, comm, first_step=True)
            return _run_steps(state, total, cfg, comm, step, chunk,
                              chunk_size)

        def one_step(state: State) -> State:
            return _run_steps(state, 1, cfg, comm, step, chunk, chunk_size)

    state = initial_state(cfg, rank=comm.Get_rank(), device=comm.device)
    runs, programs, eager_reason = 0, [], None
    mega = bool(unroll) and unroll > 0
    if mega:
        n_mega, tail = divmod(n_steps - 1, unroll)
        pool = (torch.cuda.graph_pool_handle()
                if comm.device.type == "cuda" and comm.Get_size() == 1 else None)
        pp = (pinning.compile(one_step, state, comm=comm, unroll=unroll, pool=pool)
              if n_mega else None)
        tail_pp = (pinning.compile(one_step, state, comm=comm, unroll=tail,
                                   pool=pool) if tail else None)
        programs = [p for p in (pp, tail_pp) if p is not None]

        def runner(s: State) -> State:
            s = fused(s, 0)
            for _ in range(n_mega):
                s = pp(s)
            if tail_pp is not None:
                s = tail_pp(s)
            return s
    elif pinned:
        runner = pinning.compile(fused, state, n_steps - 1)
        programs = [runner]
        runs += int(runner.graph)  # the eager run before the capture
        if comm.Get_size() > 1:
            eager_reason = f"{comm.Get_size()} ranks"
        elif comm.device.type != "cuda":
            eager_reason = f"device {comm.device.type}"
    else:
        def runner(s: State) -> State:
            return fused(s, n_steps - 1)

    graph = bool(programs) and all(p.graph for p in programs)
    _sync(runner(state))  # warm-up
    runs += 1
    wall, timed = float("inf"), {}
    for _ in range(2):
        before = _counts()
        start = time.perf_counter()
        out = runner(state)
        _sync(out)
        elapsed = time.perf_counter() - start
        if elapsed < wall:
            wall, timed = elapsed, _count_delta(before)
        runs += 1
    if info is not None:
        info["runs"] = runs
        info["pinned"] = graph
        # what made the whole-run pin eager (its world, or a knob on one
        # CUDA rank), or the knob that made a megastep pin eager
        reason = eager_reason or next((p.info["eager_reason"] for p in programs
                                       if p.info["eager_reason"]), None)
        if reason is not None:
            info["eager_reason"] = reason
        info["unroll"] = unroll if mega else 0
        info.update(timed)
    if return_state:
        return wall, n_steps, out
    return wall, n_steps


def _counts():
    from ..aot import pinning

    return (_staging.stats.seconds, pinning.stats(),
            {k: c.launches for k, c in _build.COUNTERS.items()})


def _count_delta(before) -> dict:
    """What ran since ``_counts()`` gave ``before``: exchange seconds,
    graph replays, each kernel's launches and the bytes pins copied."""
    seconds, pins, launches = before
    now_pins = _counts()[1]
    return {
        "exchange_s": _staging.stats.seconds - seconds,
        "replays": now_pins["replays"] - pins["replays"],
        "launches": {k: c.launches - launches.get(k, 0)
                     for k, c in _build.COUNTERS.items()
                     if c.launches != launches.get(k, 0)},
        "bytes_copied": now_pins["copied_bytes"] - pins["copied_bytes"],
    }


def pick_process_grid(n: int):
    """Same decomposition rule as the JAX package: nproc_y = min(n, 2), and
    even process counts only above 1."""
    nproc_y = min(n, 2)
    if n % nproc_y != 0:
        raise ValueError(
            f"Got invalid number of devices: {n}. Use 1 or an even count "
            "(the domain is decomposed over a (2, n//2) grid)."
        )
    return nproc_y, n // nproc_y


# ---------------------------------------------------------------------------
# the command line (examples/shallow_water.py:main)
# ---------------------------------------------------------------------------


def animation_frames(snapshots, cfg: Config) -> list:
    """Each stacked-block ``h`` snapshot as the global height anomaly."""
    return [reassemble(s, cfg) - cfg.depth for s in snapshots]


def save_animation(snapshots, cfg: Config, path: str = "shallow-water.gif"):
    """Write the stacked-block ``h`` snapshots as an animated GIF of the
    height anomaly, 20 frames a second; without matplotlib, say so and
    write nothing (``examples/shallow_water.py:save_animation``)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import animation
    except ImportError:
        print("matplotlib not available; skipping animation")
        return
    fig, ax = plt.subplots(figsize=(8, 4))
    frames = animation_frames(snapshots, cfg)
    vmax = np.abs(frames[-1]).max()
    im = ax.imshow(frames[0], origin="lower", cmap="RdBu_r", vmin=-vmax, vmax=vmax)
    fig.colorbar(im, label="height anomaly [m]")

    def update(i):
        im.set_data(frames[i])
        ax.set_title(f"step {i}")
        return (im,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames), interval=50)
    anim.save(path, writer=animation.PillowWriter(fps=20))
    plt.close(fig)
    print(f"wrote {path}")


def build_parser() -> argparse.ArgumentParser:
    """The JAX example's flags, with ``--n-devices`` counting ranks (one
    process each), and the port's ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.models.shallow_water",
        description=__doc__.splitlines()[0])
    p.add_argument("--benchmark", action="store_true",
                   help="benchmark config: 10x the demo's domain in each "
                        "direction, 0.1 days, no snapshots")
    p.add_argument("--t1-days", type=float, default=None,
                   help="simulated model days (default: 1.0; benchmark: 0.1)")
    p.add_argument("--scale", type=float, default=None,
                   help="linear domain scale factor (benchmark default: 10)")
    p.add_argument("--save-animation", action="store_true")
    p.add_argument("--n-devices", type=int, default=1,
                   help="ranks, one gloo process each, on a (min(N, 2), "
                        "N // min(N, 2)) grid (default: 1, in this process)")
    p.add_argument("--device", default=None,
                   help="cpu, or the CUDA device every rank computes on "
                        "(default: the GPU)")
    return p


def cli_rank(rank: int, fields: dict, t1: float, benchmark: bool, device,
             verbose: bool) -> dict:
    """One rank of the command: ``solve_fused(fast="auto")`` under
    ``benchmark``, else ``solve(fast="auto")`` with its snapshots; the
    wall, the step count and each kernel's launches in this rank."""
    cfg = Config(**fields)
    before = {k: c.launches for k, c in _build.COUNTERS.items()}
    if benchmark:
        wall, n_steps, final = solve_fused(cfg, t1, device=device, fast="auto",
                                           return_state=True)
        out = {"snapshots": [], "final_h": final.h.cpu().numpy()}
    else:
        snapshots, wall, n_steps = solve(cfg, t1, device=device,
                                         verbose=verbose, fast="auto")
        out = {"snapshots": snapshots, "final_h": None}
    out.update(wall=wall, n_steps=n_steps, launches={
        k: c.launches - before.get(k, 0) for k, c in _build.COUNTERS.items()
        if c.launches != before.get(k, 0)})
    return out


def stack_snapshots(per_rank: list) -> list:
    """Every rank's snapshot list as the JAX package's stacked blocks
    ``(nproc, ny_l, nx_l)``: the rank-local ones stacked over the ranks,
    the last (the root-gathered view) as it is."""
    snaps = [np.stack([r[i] for r in per_rank]) for i in range(len(per_rank[0]) - 1)]
    if per_rank[0]:
        snaps.append(np.asarray(per_rank[0][-1]))
    return snaps


def run(args, *, timeout: float = 3600.0) -> dict:
    """The command (``examples/shallow_water.py:main``) on parsed ``args``
    (or a list of its arguments): ``--n-devices N`` ranks, in this process
    for 1, else N gloo processes on ``--device`` through
    ``parallel/launch.py:run`` with ``timeout`` seconds.  Prints the JAX
    example's lines and returns what they say: the config, the grid, the
    mode ``fast="auto"`` picked, the step count, the wall (the slowest
    rank's), the snapshots as stacked blocks (the demo), the final stacked
    ``h`` (``--benchmark``) and each rank's kernel launches."""
    if not isinstance(args, argparse.Namespace):
        args = build_parser().parse_args(args)
    n = args.n_devices or 1
    nproc_y, nproc_x = pick_process_grid(n)
    device = resolve_device(args.device)

    scale = args.scale if args.scale is not None else (10.0 if args.benchmark else 1.0)
    cfg = Config(nproc_y=nproc_y, nproc_x=nproc_x)
    cfg = replace(cfg, nx=int(cfg.nx * scale), ny=int(cfg.ny * scale))
    t1 = (args.t1_days if args.t1_days is not None
          else (0.1 if args.benchmark else 1.0)) * DAY_IN_SECONDS

    print(f"shallow water: {cfg.ny}x{cfg.nx} interior on a "
          f"({nproc_y}, {nproc_x}) mesh of {n} {device.type.upper()} rank(s), "
          f"dt={cfg.dt:.1f}s")

    fields = asdict(cfg)
    if n == 1:
        per_rank = [cli_rank(0, fields, t1, args.benchmark, device, True)]
    else:
        # the ranks find cli_rank by its module's name, also when this file
        # runs as __main__
        from . import shallow_water as sw
        from ..parallel import launch

        per_rank = launch.run(sw.cli_rank, n, backend="gloo", device=args.device,
                              timeout=timeout,
                              args=(fields, t1, args.benchmark, args.device, False))
    wall = max(r["wall"] for r in per_rank)
    n_steps = per_rank[0]["n_steps"]
    snapshots = stack_snapshots([r["snapshots"] for r in per_rank])
    print(f"\nSolution took {wall:.2f}s "
          f"({n_steps} steps, {n_steps / wall:.1f} steps/s)")

    if args.save_animation and snapshots:
        save_animation(snapshots, cfg)
    return {
        "cfg": cfg, "grid": (nproc_y, nproc_x), "mode": resolve_fast("auto", cfg),
        "device": str(device), "n_steps": n_steps, "wall": wall,
        "walls": [r["wall"] for r in per_rank], "snapshots": snapshots,
        "final_h": (np.stack([r["final_h"] for r in per_rank])
                    if args.benchmark else None),
        "launches": [r["launches"] for r in per_rank],
    }


def main(argv=None) -> int:
    """``python -m mpi4jax_tpu_torch.models.shallow_water [flags]``."""
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
