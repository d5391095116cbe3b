"""Rank programs of the parallel workloads' tests: the expert-parallel
MoE layer and the pipeline schedule compiler on four gloo ranks.

Every rank imports this module afresh, so it imports only torch, numpy
and the port.  The inputs are the JAX package's tests' (``tests/
test_moe.py``, ``tests/test_pipeline.py``), drawn from the same numpy
seeds; ``tests/test_torch_moe.py`` and ``tests/test_torch_pipeline.py``
hold the results against the JAX package.  Knobs are set in the rank
process's own ``os.environ``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpi4jax_tpu_torch import (
    Comm,
    make_world_mesh,
    p2p_wait,
    send_start,
    shift,
    spmd,
    telemetry,
)
from mpi4jax_tpu_torch.models import moe_training as MT
from mpi4jax_tpu_torch.models import pipeline_parallel as PP
from mpi4jax_tpu_torch.parallel import moe
from mpi4jax_tpu_torch.parallel.pipeline import pipeline, split_microbatches
from mpi4jax_tpu_torch.utils import config

# tests/test_moe.py
MOE_TOKENS, MOE_D, MOE_D_FF, MOE_SEED = 16, 8, 12, 3
# tests/test_pipeline.py
PIPE_DIM, PIPE_MICRO, UNROLL = 4, 16, 4


def world_comm(device="cpu") -> Comm:
    mesh = make_world_mesh(device=device)
    return Comm(mesh.axes[0], mesh=mesh)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def moe_inputs(size: int):
    """Every rank's tokens ``(size, TOKENS, D)`` and parameters, as
    ``tests/test_moe.py:_inputs`` draws them (numpy f32)."""
    rng = np.random.default_rng(MOE_SEED)
    x = rng.standard_normal((size, MOE_TOKENS, MOE_D)).astype(np.float32)
    params = [moe.init_moe_params(MOE_D, MOE_D_FF, size, rank=r, seed=MOE_SEED)
              for r in range(size)]
    return x, params


def _moe_fwd(comm, x, params, chunks):
    @spmd(comm=comm)
    def prog(xv):
        return moe.moe_layer(xv, params, comm=comm, chunks=chunks)[0]

    return prog(x)


def _moe_grad_w_in(comm, x, params, chunks):
    @spmd(comm=comm)
    def prog(xv):
        w_in = params.w_in.detach().requires_grad_(True)
        with torch.enable_grad():
            y, _ = moe.moe_layer(xv, params._replace(w_in=w_in), comm=comm,
                                 chunks=chunks)
            return torch.autograd.grad(torch.sum(y * y), w_in)[0]

    return prog(x)


def moe_program(rank: int, device="cpu") -> dict:
    """The layer for chunks 1, 2, 3 and the capacity, the knob's default
    and an explicit setting, a call outside any region, the gradient of
    ``w_in`` for chunks 1 and 2, and the training twin."""
    comm = world_comm(device)
    size = comm.Get_size()
    x_all, params_all = moe_inputs(size)
    dev = comm.device
    x = torch.from_numpy(x_all[rank]).to(dev)
    params = moe.MoEParams(*(torch.from_numpy(p).to(dev) for p in params_all[rank]))
    cap = moe.capacity_for(MOE_TOKENS, size)
    out = {"capacity": cap}
    for chunks in (1, 2, 3, cap):
        out[f"y/{chunks}"] = _moe_fwd(comm, x, params, chunks)
    os.environ.pop("MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", None)
    out["knob/default"] = config.moe_capacity_chunks()
    out["y/default"] = _moe_fwd(comm, x, params, None)
    os.environ["MPI4JAX_TPU_MOE_CAPACITY_CHUNKS"] = "3"
    try:
        out["knob/set"] = config.moe_capacity_chunks()
        out["y/knob3"] = _moe_fwd(comm, x, params, None)
    finally:
        del os.environ["MPI4JAX_TPU_MOE_CAPACITY_CHUNKS"]
    # outside a region the layer opens its own
    out["y/no_region"] = moe.moe_layer(x, params, comm=comm, chunks=2)[0]
    for chunks in (1, 2):
        out[f"grad_w_in/{chunks}"] = _moe_grad_w_in(comm, x, params, chunks)
    twin = MT.main(device)
    out["twin"] = {k: twin[k] for k in ("y_sync", "y_ovl", "losses", "capacity",
                                        "rows")}
    return out


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def pipe_problem(size: int, virtual: int = 1):
    """``tests/test_pipeline.py:_problem``'s model: ``x0`` (``(MICRO,
    DIM)``) and the ``size * virtual`` substage weights, numpy f32 from
    seed 7."""
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(PIPE_MICRO, PIPE_DIM)).astype(np.float32)
    ws_flat = (rng.normal(size=(size * virtual, PIPE_DIM, PIPE_DIM))
               * 0.5).astype(np.float32)
    return x0, ws_flat


def rank_weights(ws_flat, size: int, rank: int, virtual: int = 1):
    """Rank ``rank``'s substage weight (``virtual=1``) or chunk stack
    (chunk ``c`` is substage ``c * size + rank``)."""
    if virtual == 1:
        return ws_flat[rank]
    return ws_flat.reshape(virtual, size, PIPE_DIM, PIPE_DIM)[:, rank]


def substage(h, w):
    return torch.tanh(h @ w)


def softsign_substage(h, w):
    """A substage of IEEE operations only (a product, ``abs``, an add and
    a division): the frameworks round it alike, unlike ``tanh``."""
    z = h @ w
    return z / (1.0 + torch.abs(z))


def _local(rank, x0, dev):
    """This rank's microbatch view: stage 0's rows real, the others'
    zeros."""
    mbs = torch.from_numpy(split_microbatches(x0, PIPE_MICRO)).to(dev)
    return mbs if rank == 0 else torch.zeros_like(mbs)


def sequential_reference(x0, ws_flat, fn=substage, device="cpu"):
    """Every substage in order, per microbatch: ``(MICRO, 1, DIM)``."""
    outs = []
    ws = torch.from_numpy(ws_flat).to(device)
    for h in split_microbatches(torch.from_numpy(x0).to(device), PIPE_MICRO):
        for k in range(ws.shape[0]):
            h = fn(h, ws[k])
        outs.append(h)
    return torch.stack(outs)


def cuda_pipeline_program(rank: int, device) -> dict:
    """1f1b on this rank's device and the sequential reference there."""
    comm = world_comm(device)
    size, dev = comm.Get_size(), comm.device
    x0, ws_flat = pipe_problem(size)
    w = torch.from_numpy(rank_weights(ws_flat, size, rank)).to(dev)
    prog = pipeline(substage, PIPE_MICRO, schedule="1f1b", comm=comm)
    return {"y": prog(_local(rank, x0, dev), w),
            "ref": sequential_reference(x0, ws_flat, device=dev)}


def _straddling_send_is_mpx130(comm, dev) -> str:
    def straddling(v):
        send_start(v, shift(1), comm=comm)
        return v * 1.0

    try:
        spmd(straddling, comm=comm, unroll=UNROLL)(torch.ones(PIPE_DIM, device=dev))
    except RuntimeError as e:
        return str(e)
    return ""


def _paired_ring_inside_megastep(comm, dev):
    """A send/recv ring closed inside every iteration: ``unroll`` steps."""
    from mpi4jax_tpu_torch import recv_start

    def step(v):
        sh, tok = send_start(v, shift(1), comm=comm)
        rh, tok = recv_start(v, comm=comm, token=tok)
        got, tok = p2p_wait(rh, token=tok)
        p2p_wait(sh, token=tok)
        return got * 0.5 + v * 0.25

    x = torch.arange(PIPE_DIM, dtype=torch.float32, device=dev) * (comm.Get_rank() + 1)
    eager = x
    for _ in range(UNROLL):
        eager = spmd(step, comm=comm)(eager)
    return eager, spmd(step, comm=comm, unroll=UNROLL)(x)


def pipeline_program(rank: int, device="cpu") -> dict:
    """Every schedule's round on this rank (tanh and softsign substages),
    ``trace`` inside a region, the MPX130 check, the eager phases under
    ``counters`` (the snapshot and the rendered report) and under ``off``,
    and the ladder twin."""
    comm = world_comm(device)
    size, dev = comm.Get_size(), comm.device
    out = {}
    for fn_name, fn in (("tanh", substage), ("softsign", softsign_substage)):
        x0, ws_flat = pipe_problem(size)
        mbs = _local(rank, x0, dev)
        w = torch.from_numpy(rank_weights(ws_flat, size, rank)).to(dev)
        out[f"{fn_name}/ref"] = sequential_reference(x0, ws_flat, fn)
        for label, prog in (
            ("gpipe", pipeline(fn, PIPE_MICRO, schedule="gpipe", comm=comm)),
            ("1f1b", pipeline(fn, PIPE_MICRO, schedule="1f1b", comm=comm)),
            ("1f1b_no_megastep", pipeline(fn, PIPE_MICRO, schedule="1f1b",
                                          comm=comm, megastep=False)),
            ("auto", pipeline(fn, PIPE_MICRO, comm=comm)),
        ):
            out[f"{fn_name}/{label}"] = prog(mbs, w)
        x0, ws_flat = pipe_problem(size, virtual=2)
        out[f"{fn_name}/ref_v2"] = sequential_reference(x0, ws_flat, fn)
        mbs = _local(rank, x0, dev)
        wv = torch.from_numpy(np.ascontiguousarray(
            rank_weights(ws_flat, size, rank, virtual=2))).to(dev)
        out[f"{fn_name}/interleaved"] = pipeline(
            fn, PIPE_MICRO, schedule="interleaved", virtual=2, comm=comm)(mbs, wv)
        fns = [lambda h, p, fn=fn: fn(h, p[0]), lambda h, p, fn=fn: fn(h, p[1])]
        out[f"{fn_name}/interleaved_fns"] = pipeline(
            fns, PIPE_MICRO, schedule="interleaved", comm=comm)(mbs, wv)
        auto_fns = pipeline(fns, PIPE_MICRO, comm=comm)
        out[f"{fn_name}/auto_fns"] = auto_fns(mbs, wv)
        out["auto_fns_plan"] = vars(auto_fns.plan(size, PIPE_MICRO, PIPE_DIM * 4))

    # trace() inside an enclosing region composes
    x0, ws_flat = pipe_problem(size)
    mbs = _local(rank, x0, dev)
    w = torch.from_numpy(rank_weights(ws_flat, size, rank)).to(dev)
    prog = pipeline(substage, PIPE_MICRO, schedule="1f1b", comm=comm)

    @spmd(comm=comm)
    def round_fn(m, wt):
        got, _tok = prog.trace(m, wt)
        return got

    out["trace"] = round_fn(mbs, w)
    out["ring_eager"], out["ring_megastep"] = _paired_ring_inside_megastep(comm, dev)

    # telemetry: counters meters the eager phases, off adds nothing
    telemetry.reset()
    off = pipeline(substage, PIPE_MICRO, schedule="gpipe", comm=comm)(mbs, w)
    out["off/meters"] = sorted(telemetry.snapshot()["meters"])
    telemetry.set_telemetry_mode("counters")
    try:
        telemetry.reset()
        out["counters/y"] = prog(mbs, w)
        snap = telemetry.snapshot()
        out["counters/snapshot"] = {"meters": snap["meters"], "ops": snap["ops"]}
        with open(os.devnull, "w") as devnull:
            out["counters/report"] = telemetry.report(comm=comm, file=devnull)
    finally:
        telemetry.set_telemetry_mode(None)
        telemetry.reset()
    out["off/y"] = off
    out["comm_uid"] = comm.uid

    twin = PP.main(device)
    out["twin"] = {"outputs": twin["outputs"], "plans": twin["plans"],
                   "last": twin["last"]}
    # last, on a clone: the straddling send stays queued on its channel
    out["mpx130"] = _straddling_send_is_mpx130(comm.Clone(), dev)
    return out
