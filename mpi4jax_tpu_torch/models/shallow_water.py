"""Shallow-water solver — the flagship workload, in PyTorch.

Port of ``examples/shallow_water.py``: a nonlinear shallow-water model on
an Arakawa C-grid (energy-conserving Sadourny scheme, Adams-Bashforth 2).
The JAX version traces one SPMD program over a device mesh and keeps the
state as stacked blocks ``(nproc, ny_l, nx_l)``; the port runs one process
per rank, and a ``State`` here is rank ``r``'s block, what the JAX package
calls ``global[r]``.  This slice runs the single-rank world.

The ``fast=`` modes are the JAX package's public contract:

- ``False`` — ``model_step``, the reference-structured step (the oracle);
- ``True`` — ``model_step_fast``, the exchange-light full-field step;
- ``"pallas"`` / ``"pallas2"`` / ``"pallas3"`` — the fused whole-step
  kernel (``kernels/sw_steps.py``) advancing 1, 2 or 3 steps per call;
  single-rank periodic-x only;
- ``"auto"`` — ``"pallas2"`` on a single-rank periodic-x config;
- ``"pallas_halo"``, ``"wide"``, ``"wide2"`` (and ``"auto"`` where it would
  pick them) raise ``NotImplementedError``: they come with the multi-rank
  kernels.

Every entry point takes ``device=None``, meaning the GPU; without CUDA it
raises unless given ``device="cpu"``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import sw_steps as _k
from ..kernels.sw_steps import (  # noqa: F401  (the physics windows live beside the kernel)
    _phase1_window,
    _phase2_window,
    _step_window,
    _window_masks,
    divisors,
    step_constants,
)
from ..ops.gather import gather
from ..ops.sendrecv import sendrecv
from ..ops.token import create_token
from ..parallel.comm import Comm
from ..parallel.mesh import make_world_mesh, resolve_device
from ..parallel.rankspec import shift

DAY_IN_SECONDS = 86_400

# the ROADMAP item that brings the multi-rank kernel modes
MULTI_RANK_KERNELS_ITEM = (
    "ROADMAP.md Queue 1, 'Multi-rank shallow-water modes' "
    "(_sw_wide_kernel and _sw_phase_kernel)"
)


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


def enforce_boundaries(arr, kind: str, cfg: Config, comm: Comm, token):
    """Exchange the 1-cell halo with the four neighbours and apply the
    physical boundary conditions (``examples/shallow_water.py:
    enforce_boundaries``).  Each direction is one ``sendrecv`` with a
    ``shift`` routing on the row (px) or column (py) sub-communicator; a
    non-wrapping direction on a size-1 axis has no neighbour and is
    skipped.  Returns a new tensor and the token."""
    assert kind in ("h", "u", "v")
    commx = comm.sub("px")
    commy = comm.sub("py")
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


def select_step(fast, cfg: Config = None):
    """The single-step callable behind ``fast`` (see ``select_steps``)."""
    return select_steps(fast, cfg)[0]


def select_steps(fast, cfg: Config = None):
    """``(single_step, chunk_step_or_None, chunk_size)`` behind ``fast``
    (``examples/shallow_water.py:select_steps``).  ``chunk_step`` advances
    ``chunk_size`` steps per call; callers use ``single_step`` for the first
    (Euler) step and for remainders."""
    if fast == "auto":
        if cfg is None:
            raise ValueError(
                "select_step('auto') needs the Config to decide kernel "
                "eligibility — pass cfg"
            )
        if cfg.nproc == 1 and cfg.periodic_x:
            fast = "pallas2"
        else:
            wanted = ("wide2" if min(cfg.ny_local, cfg.nx_local) - 2
                      >= _margin_rows(2) else "pallas_halo")
            raise NotImplementedError(
                f"fast='auto' picks {wanted!r} for this config, which is not "
                f"ported yet; see {MULTI_RANK_KERNELS_ITEM}"
            )
    if fast in ("wide", "wide2", "pallas_halo"):
        raise NotImplementedError(
            f"fast={fast!r} is not ported yet; see {MULTI_RANK_KERNELS_ITEM}"
        )
    if fast == "pallas3":
        return model_step_fused, model_step3_fused, 3
    if fast == "pallas2":
        return model_step_fused, model_step2_fused, 2
    if fast == "pallas":
        return model_step_fused, None, 1
    return (model_step_fast if fast else model_step), None, 1


def make_stepper(cfg: Config, comm: Comm, *, fast=True):
    """``(first_step, multistep)``: the first (Euler) step, and
    ``multistep(state, num_steps)`` advancing exactly ``num_steps`` AB-2
    steps (whole chunks through the chunk kernel, the remainder one step
    at a time)."""
    step, chunk, chunk_size = select_steps(fast, cfg)

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


class _GraphRun:
    """A whole run captured as one CUDA graph and replayed: the port's
    counterpart of the ``mpx.compile`` pin in the JAX package's
    ``solve_fused``.  Each replay adds the kernel launches it contains to
    the kernel's launch count."""

    def __init__(self, fn, state: State):
        self.static_in = State(*(f.clone() for f in state))
        before = _k.counter.captured
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.static_out = fn(self.static_in)
        finally:
            self.per_replay = _k.counter.captured - before
            _k.counter.captured = before

    def __call__(self) -> State:
        self.graph.replay()
        _k.counter.launches += self.per_replay
        return self.static_out


def solve_fused(cfg: Config, t1: float, *, num_multisteps: int = 10,
                device=None, fast=True, return_state=False,
                pinned: bool = False, info: dict = None):
    """Benchmark-mode solve: the first Euler step plus every remaining step
    as one run, timed after a warm-up, best of two.  Runs the same number
    of steps as ``solve(collect=False)``.  Returns ``(wall_time_s,
    n_steps)``, plus the final state when ``return_state`` is set.

    ``pinned=True`` captures the whole run as a CUDA graph (after one eager
    warm-up run) and times its replays.  It needs a CUDA device; a failed
    capture raises, there is no eager fallback.  When ``info`` (a dict) is
    passed, ``info["runs"]`` counts the whole runs executed (warm-ups
    included) and ``info["pinned"]`` says whether they were replays."""
    _, comm = make_mesh_and_comm(cfg, device=device)
    n_iters = max(0, math.ceil((t1 - cfg.dt) / (cfg.dt * num_multisteps)))
    n_steps = 1 + n_iters * num_multisteps
    step, chunk, chunk_size = select_steps(fast, cfg)

    def fused(state: State) -> State:
        state = step(state, cfg, comm, first_step=True)
        return _run_steps(state, n_steps - 1, cfg, comm, step, chunk, chunk_size)

    state = initial_state(cfg, rank=comm.Get_rank(), device=comm.device)
    runs = 0
    if pinned:
        if comm.device.type != "cuda":
            raise ValueError("pinned=True captures a CUDA graph; it needs a CUDA device")
        # one eager run on a side stream first (library load, allocator
        # warm-up), as CUDA-graph capture requires
        side = torch.cuda.Stream(comm.device)
        side.wait_stream(torch.cuda.current_stream(comm.device))
        with torch.cuda.stream(side):
            _sync(fused(state))
        torch.cuda.current_stream(comm.device).wait_stream(side)
        runs += 1
        runner = _GraphRun(fused, state)
    else:
        def runner():
            return fused(state)

    _sync(runner())  # warm-up
    runs += 1
    wall = float("inf")
    for _ in range(2):
        start = time.perf_counter()
        out = runner()
        _sync(out)
        wall = min(wall, time.perf_counter() - start)
        runs += 1
    if info is not None:
        info["runs"] = runs
        info["pinned"] = bool(pinned)
    if return_state:
        return wall, n_steps, out
    return wall, n_steps


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
