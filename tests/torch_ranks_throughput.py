"""Rank programs of the throughput layer's parity tests.

Each function runs on every rank of a ``mpi4jax_tpu_torch.parallel.launch``
world of gloo ranks on the CPU; like ``torch_ranks.py`` this module
imports no JAX, since every rank imports it afresh.  The test modules
(``test_torch_codec.py``, ``test_torch_fusion.py``, ``test_torch_async.py``,
``test_torch_data_parallel.py``) run the same calls through the JAX
package on the same seeded inputs and compare.  The knobs are set in the
rank processes' own environment, which ends with them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpi4jax_tpu_torch import (
    BAND,
    BOR,
    BXOR,
    LAND,
    LOR,
    LXOR,
    MAX,
    MIN,
    PROD,
    SUM,
    Comm,
    allreduce,
    allreduce_start,
    allreduce_wait,
    alltoall,
    alltoall_start,
    alltoall_wait,
    bcast,
    compress,
    convert,
    get_default_comm,
    make_world_mesh,
    overlap,
    p2p_wait,
    recv_start,
    reduce_scatter,
    reduce_scatter_start,
    reduce_scatter_wait,
    send_start,
    set_fusion_mode,
    shift,
    spmd,
)
from mpi4jax_tpu_torch.models import data_parallel_training as DP
from mpi4jax_tpu_torch.ops import _staging
from mpi4jax_tpu_torch.utils.tree import tree_map

CODECS = ("off", "bf16", "fp8")
FUSION_MODES = ("off", "auto", "force")
# the chunks of every async collective in these worlds: 3 pieces, the
# last one short
OVERLAP_CHUNKS = 3
OPS = {"SUM": SUM, "PROD": PROD, "MIN": MIN, "MAX": MAX, "LAND": LAND,
       "LOR": LOR, "LXOR": LXOR, "BAND": BAND, "BOR": BOR, "BXOR": BXOR}
# each reduction and the leaves it fuses: "f", "f2" small integers as f32,
# "g" gaussian f32, "i", "i2" int32, "b" bool
FUSED = {"SUM": ("f", "g", "i", "f2", "i2"), "PROD": ("f", "i", "f2"),
         "MIN": ("f", "g", "i", "i2"), "MAX": ("f", "g", "i", "i2"),
         "LAND": ("b", "i", "f"), "LOR": ("b", "i", "f"), "LXOR": ("b", "i", "f"),
         "BAND": ("i", "i2", "b"), "BOR": ("i", "i2", "b"), "BXOR": ("i", "i2", "b")}
BCAST_KINDS = ("f", "g", "i", "b")
# async cases: (key, input, reduction)
ASYNC_ALLREDUCE = (("g/SUM", "g", "SUM"), ("i/SUM", "i", "SUM"),
                   ("g/MIN", "g", "MIN"), ("g/MAX", "g", "MAX"),
                   ("f/PROD", "f", "PROD"), ("b/LAND", "b", "LAND"),
                   ("i/BXOR", "i", "BXOR"))
ASYNC_RS = (("blocks/SUM", "blocks", "SUM"), ("iblocks/MAX", "iblocks", "MAX"))
DP_RUNS = (("off", "auto"), ("bf16", "auto"), ("fp8", "auto"), ("off", "off"))
DP_SEED, DP_STEPS = 1, 5


def world(size: int) -> Comm:
    return Comm("x", mesh=make_world_mesh((size,), ("x",), device="cpu"))


def _rank_tree(tree, rank: int):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a[rank])), tree)


def ef_inputs(size: int):
    """Every rank's gradient tree and residual tree (leaves ``(size, ...)``
    f32): two layers, one leaf of 300 elements (a ragged fp8 chunk) and one
    of 561."""
    rng = np.random.default_rng(31)

    def tree(scale):
        return [{"b": scale * rng.standard_normal((size, 300), dtype=np.float32),
                 "w": scale * rng.standard_normal((size, 17, 33), dtype=np.float32)},
                {"b": scale * rng.standard_normal((size, 1), dtype=np.float32),
                 "w": scale * rng.standard_normal((size, 5), dtype=np.float32)}]

    return tree(1.0), tree(1e-3)


def fusion_inputs(size: int) -> dict:
    rng = np.random.default_rng(32)
    small = lambda *s: rng.integers(-3, 4, size=(size, *s)).astype(np.float32)  # noqa: E731
    return {"f": small(6, 5), "f2": small(3),
            "g": rng.standard_normal((size, 50), dtype=np.float32),
            "i": rng.integers(-50, 50, size=(size, 7)).astype(np.int32),
            "i2": rng.integers(0, 1000, size=(size, 2, 2)).astype(np.int32),
            "b": rng.random((size, 4)) > 0.3}


def async_inputs(size: int) -> dict:
    rng = np.random.default_rng(33)
    return {"g": rng.standard_normal((size, 1000), dtype=np.float32),
            "i": rng.integers(-99, 99, size=(size, 301)).astype(np.int32),
            "f": rng.integers(1, 3, size=(size, 37)).astype(np.float32),
            "b": rng.random((size, 9)) > 0.2,
            "blocks": rng.standard_normal((size, size, 13), dtype=np.float32),
            "iblocks": rng.integers(-9, 9, size=(size, size, 5)).astype(np.int32),
            "rows": rng.standard_normal((size, size, 11), dtype=np.float32)}


def _ef_runs(rank, comm, out):
    grads, residual = (_rank_tree(t, rank) for t in ef_inputs(comm.Get_size()))
    step = spmd(comm=comm)(lambda g, r: compress.ef_allreduce(g, r, op=SUM)[:2])
    for codec in CODECS:
        os.environ["MPI4JAX_TPU_COMPRESS"] = codec
        out[f"ef/{codec}"] = step(grads, residual)
        out[f"ef/{codec}/from_zero"] = step(grads, compress.ef_zeros_like(grads))
    del os.environ["MPI4JAX_TPU_COMPRESS"]


def fusion_body(x: dict, size: int) -> dict:
    """Every reduction of ``FUSED`` over its leaves, issued before any is
    used, then ``bcast`` from the first and the last rank."""
    out = {}
    for op, kinds in FUSED.items():
        for k in kinds:
            out[f"allreduce/{op}/{k}"] = allreduce(x[k], OPS[op])[0]
    for root in (0, size - 1):
        for k in BCAST_KINDS:
            out[f"bcast/{root}/{k}"] = bcast(x[k], root)[0]
    return out


def _fusion_runs(rank, comm, out):
    size = comm.Get_size()
    x = _rank_tree(fusion_inputs(size), rank)
    run = spmd(comm=comm)(lambda x: fusion_body(x, size))
    for mode in FUSION_MODES:
        set_fusion_mode(mode)
        try:
            _staging.stats.reset()
            out[f"fusion/{mode}"] = run(x)
            out[f"fusion/{mode}/calls"] = _staging.stats.calls
            # callables never fuse: each is its own gather
            _staging.stats.reset()
            out[f"fusion/{mode}/callables"] = spmd(comm=comm)(
                lambda: [allreduce(x[k], torch.add)[0] for k in ("f", "f2")])()
            out[f"fusion/{mode}/callables/calls"] = _staging.stats.calls
            # a gradient through a pair packed together under "force"
            a, b = (x[k].clone().requires_grad_(True) for k in ("f", "f2"))
            loss = spmd(comm=comm)(lambda: (allreduce(a)[0] ** 2).sum()
                                   + (allreduce(b)[0] ** 3).sum())()
            loss.backward()
            out[f"fusion/{mode}/grad"] = (a.grad, b.grad)
        finally:
            set_fusion_mode(None)


def _issue_async(x: dict) -> dict:
    """Every async case started, then waited in the reverse order."""
    started = []
    for key, k, op in ASYNC_ALLREDUCE:
        started.append((f"allreduce/{key}", allreduce_wait,
                        allreduce_start(x[k], OPS[op])[0]))
    for key, k, op in ASYNC_RS:
        started.append((f"reduce_scatter/{key}", reduce_scatter_wait,
                        reduce_scatter_start(x[k], OPS[op])[0]))
    started.append(("alltoall/rows", alltoall_wait, alltoall_start(x["rows"])[0]))
    started.append(("p2p/send", p2p_wait, send_start(x["g"], shift(1))[0]))
    started.append(("p2p/recv", p2p_wait, recv_start(torch.zeros_like(x["g"]))[0]))
    return {key: wait(h)[0] for key, wait, h in reversed(started)}


def _sync_async_cases(x: dict) -> dict:
    out = {f"allreduce/{key}": allreduce(x[k], OPS[op])[0]
           for key, k, op in ASYNC_ALLREDUCE}
    out.update({f"reduce_scatter/{key}": reduce_scatter(x[k], OPS[op])[0]
                for key, k, op in ASYNC_RS})
    out["alltoall/rows"] = alltoall(x["rows"])[0]
    return out


def _overlapped(x: dict) -> dict:
    with overlap():
        lazy = _sync_async_cases(x)
        # a use inside the scope waits for that one result there
        first = lazy["allreduce/g/SUM"] + 0
    out = {k: v + 0 if v.dtype != torch.bool else v | False for k, v in lazy.items()}
    out["first_use"] = first
    return out


def _mpx_code(fn):
    try:
        fn()
    except RuntimeError as e:
        return getattr(e, "mpx_code", repr(e))
    return None


def _async_runs(rank, comm, out):
    x = _rank_tree(async_inputs(comm.Get_size()), rank)
    region = spmd(comm=comm)
    out["async"] = region(_issue_async)(x)
    out["async/sync"] = region(_sync_async_cases)(x)
    out["async/overlap"] = region(_overlapped)(x)
    _staging.stats.reset()
    region(lambda: allreduce_wait(allreduce_start(x["g"])[0]))()
    out["async/chunk_calls"] = _staging.stats.calls

    def twice():
        h = allreduce_start(x["i"])[0]
        allreduce_wait(h)
        allreduce_wait(h)

    out["async/double_wait"] = _mpx_code(region(twice))
    out["async/never_waited"] = _mpx_code(region(lambda: allreduce_start(x["i"])))
    out["async/callable"] = region(lambda: allreduce_wait(
        allreduce_start(x["f"], torch.maximum)[0])[0])()
    g = x["f"].clone().requires_grad_(True)
    region(lambda: (allreduce_wait(allreduce_start(g)[0])[0] ** 2).sum())().backward()
    out["async/grad"] = g.grad


def throughput_program(rank: int, size: int) -> dict:
    """``ef_allreduce`` under each codec, fusion under each mode and the
    async pairs, on one world of ``size`` ranks; and the default comm, a
    bare ``spmd`` over the world."""
    os.environ["MPI4JAX_TPU_OVERLAP_CHUNKS"] = str(OVERLAP_CHUNKS)
    comm = world(size)
    x = torch.full((3,), float(rank))
    out = {"default": spmd(lambda: (allreduce(x)[0],
                                    get_default_comm().Get_size()))()}
    _ef_runs(rank, comm, out)
    _fusion_runs(rank, comm, out)
    _async_runs(rank, comm, out)
    return out


def dp_program(rank: int, size: int, params: list) -> dict:
    """``DP_STEPS`` steps of the data-parallel example from the JAX
    package's ``params`` (numpy), for each (codec, fusion) of
    ``DP_RUNS``: parameters, residual, losses and exchanges a step; then
    the example's ``main`` for 30 steps."""
    comm = world(size)
    x, y = (torch.from_numpy(a[rank]) for a in DP.train_data(DP_SEED, size))
    out = {}
    for codec, fusion in DP_RUNS:
        os.environ["MPI4JAX_TPU_COMPRESS"] = codec
        p = convert.mlp_params_from_jax(params, device="cpu")
        r = compress.ef_zeros_like(p)
        step = DP.make_train_step(comm, lr=DP.LR)
        losses, calls = [], []
        set_fusion_mode(fusion)
        try:
            for _ in range(DP_STEPS):
                _staging.stats.reset()
                p, r, loss = step(p, r, x, y)
                calls.append(_staging.stats.calls)
                losses.append(loss.item())
        finally:
            set_fusion_mode(None)
        out[f"{codec}/{fusion}"] = {"params": p, "residual": r, "losses": losses,
                                    "calls": calls}
    del os.environ["MPI4JAX_TPU_COMPRESS"]
    main = DP.main(steps=30, seed=0, device="cpu")
    out["main"] = {k: main[k] for k in ("losses", "params", "params0", "exchange",
                                        "compress", "fusion", "world")}
    return out
