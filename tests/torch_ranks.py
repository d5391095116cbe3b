"""Rank programs of the port's multi-rank tests, and one run of each.

The programs run on every rank of a world that
``mpi4jax_tpu_torch.parallel.launch.run`` starts (gloo ranks on the CPU)
and return dicts of tensors, which ``run`` hands back as numpy arrays.
This module imports only torch, numpy and the port, since every rank
imports it afresh; the test modules compare the results with the JAX
package on the 8-device CPU mesh.

``shared_result`` computes a result once per test run: under
pytest-xdist a module's tests are spread over several workers, and each
would otherwise start its own ranks.  The first worker to ask computes
and stores the result in the run's shared temporary directory; the
others wait on a file lock and load it.
"""

from __future__ import annotations

import fcntl
import os
import pickle
from dataclasses import replace

import numpy as np
import torch

from mpi4jax_tpu_torch import (
    Comm,
    Op,
    allreduce,
    alltoall,
    convert,
    gather,
    make_world_mesh,
    sendrecv,
    set_fusion_mode,
    shift,
)
from mpi4jax_tpu_torch.attention import ring_attention, ulysses_attention
from mpi4jax_tpu_torch.models import long_context_attention as LCA
from mpi4jax_tpu_torch.models import long_context_training as LCT
from mpi4jax_tpu_torch.models import shallow_water as P
from mpi4jax_tpu_torch.ops import _staging

# every launch of the tests gets this limit: a hang fails one test instead
# of the whole run
RANK_TIMEOUT_S = 50.0
# ... and a world whose ranks compute for long, a budget of this much a
# rank: each rank is one process on a CPU thread, so under a loaded run
# (six xdist workers beside other worlds) its compute stretches with the
# ranks that share the cores.  The 8-rank shallow-water world
# (sw_program) took 20 s whole alone and 39-58 s under such a load, of
# which its eight process starts took 5-6 s: the rest is compute.
RANK_BUDGET_S = 20.0


def world_timeout(nprocs: int) -> float:
    """The launch limit of a world of ``nprocs`` ranks: ``RANK_TIMEOUT_S``,
    or ``RANK_BUDGET_S`` a rank where that is more."""
    return max(RANK_TIMEOUT_S, RANK_BUDGET_S * nprocs)


def shared_result(tmp_path_factory, name: str, compute):
    """``compute()``, once per test run (see the module docstring)."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as fh:
                return pickle.load(fh)
        result = compute()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(result, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return result


# ---------------------------------------------------------------------------
# the communicator
# ---------------------------------------------------------------------------

SHIFTS = [(1, True), (1, False), (-1, True), (-1, False)]


def comm_inputs(size: int) -> np.ndarray:
    """Every rank's send buffer, ``(size, 4, 6)`` f32 from a fixed seed."""
    rng = np.random.default_rng(7)
    return (10 * rng.standard_normal((size, 4, 6))).astype(np.float32)


def grid_of(size: int):
    """The 2-D grid of a world of ``size`` ranks, as the solver picks it."""
    return P.pick_process_grid(size)


def comm_program(rank: int, size: int):
    """sendrecv and gather on the 1-D world and on the 2-D grid of ``size``
    ranks and its sub-communicators."""
    x = torch.from_numpy(comm_inputs(size)[rank])
    tmpl = torch.full_like(x, -3.0)
    out = {}

    world = Comm("x", mesh=make_world_mesh((size,), ("x",), device="cpu"))
    for k, wrap in SHIFTS:
        out[f"world/{k}/{wrap}"] = sendrecv(x, tmpl, dest=shift(k, wrap=wrap),
                                            comm=world)[0]
    out["world/source"] = sendrecv(x, tmpl, source=shift(1), comm=world)[0]
    # a strided column view, which torch.distributed refuses as it is
    out["world/column"] = sendrecv(x[:, 1], tmpl[:, 0], dest=shift(1),
                                   comm=world)[0]
    buf = x.clone()
    received, _ = sendrecv(buf, tmpl, dest=shift(1), comm=world)
    buf.add_(1.0)  # the result must not alias the send buffer
    out["world/no_alias"] = received
    out["world/gather"] = gather(x, 0, comm=world)[0]

    mesh = make_world_mesh(grid_of(size), ("py", "px"), device="cpu")
    grid = Comm(("py", "px"), mesh=mesh)
    out["grid/facts"] = torch.tensor([
        grid.Get_size(), grid.Get_rank(),
        grid.sub("px").Get_size(), grid.sub("px").Get_rank(),
        grid.sub("py").Get_size(), grid.sub("py").Get_rank(),
        grid.axis_index("py"), grid.axis_index("px"),
    ])
    out["grid/gather"] = gather(x, 0, comm=grid)[0]
    for axis in ("px", "py"):
        sub = grid.sub(axis)
        out[f"{axis}/gather"] = gather(x, 0, comm=sub)[0]
        for k, wrap in SHIFTS:
            out[f"{axis}/{k}/{wrap}"] = sendrecv(
                x, tmpl, dest=shift(k, wrap=wrap), comm=sub)[0]
    out["stats"] = torch.tensor([_staging.stats.calls, _staging.stats.staged_bytes])
    return out


def raise_on(rank: int, bad: int):
    """Raises on rank ``bad``; the others wait at a collective."""
    if rank == bad:
        raise ValueError(f"deliberate failure on rank {rank}")
    torch.distributed.barrier()
    return {}


def grid_of_wrong_size(rank: int):
    """Asks for a (2, 4) grid in a world of another size."""
    make_world_mesh((2, 4), ("py", "px"), device="cpu")


def sleep_forever(rank: int):
    import time

    time.sleep(3600)


# ---------------------------------------------------------------------------
# the shallow-water paths
# ---------------------------------------------------------------------------

WIDE_SIZE = (64, 32)  # nx, ny of the wide modes (the JAX suite's)
HALO_SIZE = (48, 24)  # nx, ny of the split-phase mode
STEPS = 11  # steps after the first one: whole pairs and a remainder
RUN_LENGTHS = (1, 2, 5, 11)  # _wide_run's bookkeeping cases


def config(size, grid, periodic):
    nx, ny = size
    return replace(P.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                   periodic_x=periodic)


def mode_cases(grid):
    """``(size, mode)`` pairs each grid runs through ``make_stepper``."""
    cases = [(WIDE_SIZE, m) for m in ("wide", "wide2", "auto")]
    cases += [(HALO_SIZE, m) for m in ("pallas_halo", "auto", True)]
    if grid == (2, 4):
        cases.append((HALO_SIZE, False))
    return cases


def exchange_inputs(cfg, m):
    """Seeded random local arrays ``(nproc, ny_l, nx_l)`` and widened frames
    ``(nproc, ny_l + 2(m-1), nx_l + 2(m-1))``, six fields each."""
    rng = np.random.default_rng(11)
    local = rng.standard_normal((6, cfg.nproc, cfg.ny_local, cfg.nx_local))
    wide = rng.standard_normal((6, cfg.nproc, cfg.ny_local + 2 * (m - 1),
                                cfg.nx_local + 2 * (m - 1)))
    return local.astype(np.float32), wide.astype(np.float32)


def _run(cfg, comm, mode, num_steps):
    first, multi = P.make_stepper(cfg, comm, fast=mode)
    s = first(P.initial_state(cfg, rank=comm.Get_rank(), device="cpu"))
    return multi(s, num_steps) if num_steps else s


def sw_program(rank: int, grid):
    """Every multi-rank shallow-water path on ``grid``, both boundary
    modes; returns this rank's results by name."""
    out = {}
    for periodic in (True, False):
        tag = "periodic" if periodic else "walled"
        for size, mode in mode_cases(grid):
            cfg = config(size, grid, periodic)
            _, comm = P.make_mesh_and_comm(cfg, device="cpu")
            out[f"step/{tag}/{size[0]}/{mode}"] = tuple(_run(cfg, comm, mode, STEPS))

        cfg = config(WIDE_SIZE, grid, periodic)
        _, comm = P.make_mesh_and_comm(cfg, device="cpu")
        for n in RUN_LENGTHS:
            for mode in ("wide2", True):
                out[f"run/{tag}/{n}/{mode}"] = tuple(_run(cfg, comm, mode, n))

        m = P._margin_rows(2)
        local, wide = exchange_inputs(cfg, m)
        fields = tuple(torch.from_numpy(a[rank]) for a in local)
        frames = [torch.from_numpy(a[rank].copy()) for a in wide]
        tok = P.create_token()
        out[f"exchange/{tag}"] = P._wide_exchange(fields, cfg, comm, m, tok)[0]
        out[f"refresh/{tag}"] = tuple(P._wide_refresh(frames, cfg, comm, m, tok))
        out[f"crop/{tag}"] = tuple(P._wide_crop(
            [torch.from_numpy(a[rank]) for a in wide], cfg, m))
        for kind in ("h", "u", "v"):
            out[f"enforce/{tag}/{kind}"] = P.enforce_boundaries(
                fields[0], kind, cfg, comm, tok)[0]
        out[f"offsets/{tag}"] = torch.tensor(P._rank_offsets(cfg, comm))

    cfg = config(WIDE_SIZE, grid, True)
    info = {}
    _, n, state = P.solve_fused(cfg, 23 * cfg.dt, num_multisteps=5, fast="wide2",
                                return_state=True, device="cpu", info=info)
    out["solve_fused/wide2"] = tuple(state)
    out["solve_fused/n"] = torch.tensor(n)
    out["solve_fused/info"] = torch.tensor([info["runs"], info["exchange_s"]],
                                           dtype=torch.float64)
    for size, mode in ((HALO_SIZE, "pallas_halo"), (HALO_SIZE, True),
                       (WIDE_SIZE, "wide2")):
        cfg = config(size, grid, True)
        snaps, _, n = P.solve(cfg, 20 * cfg.dt, num_multisteps=5, device="cpu",
                              fast=mode)
        out[f"solve/{mode}/local"] = torch.from_numpy(snaps[-2])
        out[f"solve/{mode}/gathered"] = torch.from_numpy(snaps[-1])
    # pinned=True on several ranks: the pin is its body run eagerly
    info = {}
    _, n, state = P.solve_fused(cfg, 23 * cfg.dt, num_multisteps=5, fast="wide2",
                                return_state=True, device="cpu", pinned=True,
                                info=info)
    out["solve_fused/wide2/pinned"] = tuple(state)
    out["solve_fused/pinned_info"] = {k: info[k] for k in
                                      ("runs", "pinned", "eager_reason", "replays")}
    return out


# ---------------------------------------------------------------------------
# alltoall and long-context attention
# ---------------------------------------------------------------------------

# the JAX demo's widths (examples/long_context_attention.py:41)
ATTENTION = {"b": 2, "t_loc": 128, "h": 8, "d": 64}
ATTENTION_RUNS = (("ring", False), ("ring", True), ("ulysses", False),
                  ("ulysses", True))


def alltoall_inputs(size: int, comm_size: int) -> np.ndarray:
    """Every rank's alltoall input, ``(size, comm_size, 3, 5)`` f32."""
    rng = np.random.default_rng(5 + comm_size)
    return rng.standard_normal((size, comm_size, 3, 5), dtype=np.float32)


def _error(fn) -> str:
    """The message of the exception ``fn()`` raises ("" if none)."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def attention_program(rank: int, size: int):
    """alltoall on the 1-D world (and, on 4 ranks, on the row, column and
    column-major comms of a (2,2) grid), then the long-context demo's
    entry point over the world: ring and Ulysses, causal and not."""
    out = {}
    world = Comm("sp", mesh=make_world_mesh((size,), ("sp",), device="cpu"))
    x = torch.from_numpy(alltoall_inputs(size, size)[rank])
    out["alltoall/world"] = alltoall(x, comm=world)[0]
    if size == 4:
        mesh = make_world_mesh((2, 2), ("py", "px"), device="cpu")
        sub = torch.from_numpy(alltoall_inputs(size, 2)[rank])
        for axes in ("px", "py"):
            out[f"alltoall/{axes}"] = alltoall(sub, comm=Comm(axes, mesh=mesh))[0]
        # a comm whose rank order is not the process group's; its ranks
        # take the inputs of their comm rank
        colmajor = Comm(("px", "py"), mesh=mesh)
        xc = torch.from_numpy(alltoall_inputs(size, size)[colmajor.Get_rank()])
        out["alltoall/px,py"] = alltoall(xc, comm=colmajor)[0]
        out["alltoall/px,py/rank"] = colmajor.Get_rank()
    out["alltoall/error"] = _error(lambda: alltoall(x[:1], comm=world))

    for key, res in LCA.main("cpu", **ATTENTION, runs=ATTENTION_RUNS).items():
        out[f"{key}/out"] = res["out"]
        out[f"{key}/launches"] = sum(res["launches"].values())
        out[f"{key}/exchanges"] = res["exchange_calls"]

    q = torch.zeros((1, 4, size + 1, 32))
    out["ulysses/error"] = _error(lambda: ulysses_attention(q, q, q, comm=world))
    g = torch.from_numpy(np.random.default_rng((3, rank)).standard_normal(
        (1, 4, size, 32), dtype=np.float32)).requires_grad_(True)
    for scheme, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        g.grad = None
        fn(g, g, g, comm=world, causal=True).square().sum().backward()
        out[f"{scheme}/grad"] = g.grad
    g.grad = None
    ring_attention(g, g, g, comm=world, causal=True,
                   memory_efficient_grad=False).square().sum().backward()
    out["ring/plain_grad"] = g.grad
    return out


# ---------------------------------------------------------------------------
# gradients, allreduce and the dp x sp training step
# ---------------------------------------------------------------------------

# the JAX suite's long-context shapes (tests/test_long_context.py:29)
GRAD = {"b": 2, "t_loc": 16, "h": 8, "d": 32}
# (scheme, causal, dtype) of each gradient run
GRAD_RUNS = (("ring", True, "float32"), ("ring", False, "float32"),
             ("ring", True, "bfloat16"), ("ulysses", True, "float32"))
REDUCTIONS = ("SUM", "PROD", "MIN", "MAX")
# the training step of tests/test_examples.py:528
FUSION_MODES = ("off", "auto", "force")
TRAIN = {"b_loc": 1, "t_loc": 16, "d_model": 32, "d_ff": 64, "heads": 4,
         "lr": 0.05}


def grad_key(scheme, causal, dtype) -> str:
    return f"{scheme}/{'causal' if causal else 'full'}/{dtype}"


def grad_inputs(size: int) -> np.ndarray:
    """q, k and v of every rank, ``(3, size, B, T_loc, H, D)`` f32."""
    rng = np.random.default_rng(13)
    g = GRAD
    return rng.standard_normal((3, size, g["b"], g["t_loc"], g["h"], g["d"]),
                               dtype=np.float32)


def allreduce_inputs(size: int) -> np.ndarray:
    """Every rank's allreduce input, ``(size, 3, 4)``: small integers as
    f32, so sums and products in any order are exact."""
    rng = np.random.default_rng(21)
    return rng.integers(-3, 4, size=(size, 3, 4)).astype(np.float32)


def _grad_runs(rank, size, out):
    """Each run of ``GRAD_RUNS``: the gradient of the sum of ``out**2``
    over every rank with respect to this rank's q, k and v, and the
    exchanges of its forward and of its backward."""
    world = Comm("sp", mesh=make_world_mesh((size,), ("sp",), device="cpu"))
    shards = grad_inputs(size)[:, rank]
    for scheme, causal, dtype in GRAD_RUNS:
        q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
                   for x in shards)
        key = grad_key(scheme, causal, dtype)
        _staging.stats.reset()
        o = LCA.SCHEMES[scheme](q, k, v, comm=world, causal=causal)
        forward = _staging.stats.calls
        o.float().square().sum().backward()
        out[f"{key}/exchanges"] = torch.tensor([forward,
                                                _staging.stats.calls - forward])
        out[f"{key}/dtype"] = str(q.grad.dtype)
        out[f"{key}/grads"] = tuple(t.grad.float() for t in (q, k, v))


def _allreduce_runs(rank, size, out):
    """Every reduction of ``REDUCTIONS`` on the world and, on 4 ranks, on
    the row, column and column-major comms of a (2,2) grid; what the
    world's staged; and what older slices refused: a logical reduction, a
    callable and a gradient."""
    x = torch.from_numpy(allreduce_inputs(size)[rank])
    before = x.clone()
    comms = {"world": Comm("x", mesh=make_world_mesh((size,), ("x",),
                                                     device="cpu"))}
    if size == 4:
        mesh = make_world_mesh((2, 2), ("py", "px"), device="cpu")
        for axes in ("px", "py", ("px", "py")):
            comms[",".join((axes,) if isinstance(axes, str) else axes)] = Comm(
                axes, mesh=mesh)
    for name, comm in comms.items():
        for op in REDUCTIONS:
            _staging.stats.reset()
            out[f"allreduce/{name}/{op}"] = allreduce(x, getattr(Op, op),
                                                      comm=comm)[0]
            out[f"allreduce/{name}/{op}/stats"] = torch.tensor(
                [_staging.stats.calls, _staging.stats.staged_bytes])
    out["allreduce/input_kept"] = torch.equal(x, before)
    world = comms["world"]
    xg = x.clone().requires_grad_(True)
    (allreduce(xg, comm=world)[0] ** 2).sum().backward()
    out["allreduce/once_refused"] = [
        allreduce(x, Op.LAND, comm=world)[0],
        allreduce(x, torch.add, comm=world)[0],
        xg.grad,
    ]


def training_program(rank: int, size: int, params: dict, x: np.ndarray,
                     y: np.ndarray, grads: bool):
    """One step of the dp x sp training example on the world's grid from
    the JAX package's parameters and stacked tiles ``x`` (size, B, T, D),
    ``y`` (size, B, T), and its loss and gradients under each fusion mode;
    with ``grads``, also the attention gradient runs and the allreduce
    runs."""
    out = {}
    if grads:
        _grad_runs(rank, size, out)
        _allreduce_runs(rank, size, out)
    world, sp = LCT.make_grid("cpu")
    step = LCT.make_train_step(world, sp, TRAIN["heads"], lr=TRAIN["lr"])
    _staging.stats.reset()
    new, loss = step(convert.params_from_jax(params, device="cpu"),
                     torch.from_numpy(x[rank]), torch.from_numpy(y[rank]))
    out["train/params"] = new
    out["train/loss"] = loss
    out["train/exchanges"] = _staging.stats.calls
    out["train/grid"] = torch.tensor([world.axis_index("dp"),
                                      world.axis_index("sp")])
    grad_fn = LCT.make_grad_fn(world, sp, TRAIN["heads"])
    for mode in FUSION_MODES:
        set_fusion_mode(mode)
        try:
            _staging.stats.reset()
            loss, grads = grad_fn(convert.params_from_jax(params, device="cpu"),
                                  torch.from_numpy(x[rank]), torch.from_numpy(y[rank]))
            out[f"train/fusion/{mode}"] = {"loss": loss, "grads": grads,
                                           "exchanges": _staging.stats.calls}
        finally:
            set_fusion_mode(None)
    return out


class RunResults:
    """Results by name, each computed once per test run (``shared_result``)
    and kept for the module that asked."""

    def __init__(self, tmp_path_factory, prefix: str):
        self._factory = tmp_path_factory
        self._prefix = prefix
        self._cache = {}

    def get(self, name: str, compute):
        if name not in self._cache:
            self._cache[name] = shared_result(
                self._factory, f"{self._prefix}-{name}", compute)
        return self._cache[name]
