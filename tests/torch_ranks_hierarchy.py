"""Rank programs of the collective algorithm layer's tests.

``hierarchy_program(rank, spec)`` runs on every rank of a gloo world under
the host topology ``spec`` (``MPI4JAX_TPU_TOPOLOGY``) and returns, per case,
this rank's result: the reductions, ``reduce_scatter``, ``bcast`` and
``alltoall`` under each forced lowering (``MPI4JAX_TPU_COLLECTIVE_ALGO``
``butterfly``, ``ring``, ``hier``) and under ``auto`` with every crossover
at 0; the exchanges each call made; the telemetry link columns; the
chunked ``allreduce_start``; and the plan memo's uid and group-order
check.  ``fallback_program(rank)`` runs the cases with no plan (a ``3,5``
spec, round-robin and single-host labels, unequal color groups) and the
host-label topology.
``run_cases``'s case list and ``inputs`` are shared with the JAX side of the tests, which
runs the same cases on the 8-device CPU mesh.  This module imports only
torch, numpy and the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ALGOS = ("butterfly", "ring", "hier", "auto")
OPS = ("SUM", "PROD", "MIN", "MAX", "LAND", "LOR", "LXOR", "BAND", "BOR",
       "BXOR")
# (dtype kind, op): every Op on int32, the arithmetic ones on f32, the
# logical, bitwise and MIN/MAX ones on bool
REDUCTIONS = ([("i", op) for op in OPS]
              + [("f", op) for op in ("SUM", "PROD", "MIN", "MAX")]
              + [("b", op) for op in ("MIN", "MAX", "LAND", "LOR", "LXOR",
                                      "BAND", "BOR", "BXOR")])
# associative, elementwise, not commutative: the first non-zero operand;
# and a commutative one whose f32 bits depend on the association
CALLABLES = ("first_nonzero", "hypot")


def first_nonzero(xp):
    return lambda a, b: xp.where(a != 0, a, b)


def hypot(xp):
    return lambda a, b: xp.sqrt(a * a + b * b)


def inputs(k: int, n: int = None) -> dict:
    """Every rank's inputs (leading axis the rank of a world of ``k``),
    from a fixed seed; the blocks of ``reduce_scatter`` and ``alltoall``
    are ``n`` (default ``k``: the comm size).  The payloads are 15
    elements, which no ring of 2, 4 or 8 divides: the padding lanes are
    exercised."""
    n = k if n is None else n
    rng = np.random.default_rng(24)
    f = rng.standard_normal((k, 5, 3)).astype(np.float32)
    f[rng.random((k, 5, 3)) < 0.25] = 0.0
    i = rng.integers(-3, 4, (k, 5, 3)).astype(np.int32)
    b = rng.random((k, 5, 3)) < 0.5
    fb = rng.standard_normal((k, n, 3, 2)).astype(np.float32)
    ib = rng.integers(-9, 10, (k, n, 3, 2)).astype(np.int32)
    return {"f": f, "i": i, "b": b, "fb": fb, "ib": ib,
            "bb": rng.random((k, n, 3, 2)) < 0.5}


def bcast_roots(n: int, r: int):
    """Roots 0, the first rank of the second host (``r`` ranks a host),
    and the last rank of a comm of ``n``."""
    return sorted({0, min(r, n - 1), n - 1})


def ranks_per_host(spec: str, k: int) -> int:
    return k // int(spec.split("x")[0]) if "x" in spec else 1


def _set(name: str, value) -> None:
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)


def _use_algo(algo: str) -> None:
    _set("MPI4JAX_TPU_COLLECTIVE_ALGO", algo)
    zero = "0" if algo == "auto" else None
    for name in ("MPI4JAX_TPU_RING_CROSSOVER_BYTES",
                 "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
                 "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES"):
        _set(name, zero)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_cases(rank: int, k: int, spec: str, comm, algos=ALGOS) -> dict:
    """Every case on ``comm``, keyed
    ``<algo>/<op family>/<case>``; ``calls/<key>`` is the exchanges it
    made."""
    import mpi4jax_tpu_torch as mpx
    from mpi4jax_tpu_torch.ops import _staging

    n = comm.Get_size()
    g = inputs(k, n)
    mine = {name: _t(v[rank]) for name, v in g.items()}
    out = {}

    def record(key, fn):
        before = _staging.stats.calls
        out[key] = fn().numpy()
        out["calls/" + key] = np.int64(_staging.stats.calls - before)

    for algo in algos:
        _use_algo(algo)
        for kind, op in REDUCTIONS:
            x = mine[kind]
            record(f"{algo}/allreduce/{kind}/{op}",
                   lambda: mpx.allreduce(x, getattr(mpx, op), comm=comm)[0])
        for name in CALLABLES:
            fn = globals()[name](torch)
            record(f"{algo}/allreduce/f/{name}",
                   lambda: mpx.allreduce(mine["f"], fn, comm=comm)[0])
            record(f"{algo}/allreduce/i/{name}",
                   lambda: mpx.allreduce(mine["i"], fn, comm=comm)[0]
                   if name == "first_nonzero" else torch.zeros(()))
        record(f"{algo}/reduce/f/SUM",
               lambda: mpx.reduce(mine["f"], mpx.SUM, n - 1, comm=comm)[0])
        record(f"{algo}/reduce/i/BXOR",
               lambda: mpx.reduce(mine["i"], mpx.BXOR, 0, comm=comm)[0])
        for kind, op in (("fb", "SUM"), ("fb", "MAX"), ("ib", "BXOR"),
                         ("ib", "PROD"), ("bb", "LOR")):
            record(f"{algo}/reduce_scatter/{kind}/{op}",
                   lambda: mpx.reduce_scatter(mine[kind], getattr(mpx, op),
                                              comm=comm)[0])
        record(f"{algo}/reduce_scatter/fb/first_nonzero",
               lambda: mpx.reduce_scatter(mine["fb"], first_nonzero(torch),
                                          comm=comm)[0])
        for root in bcast_roots(n, ranks_per_host(spec, k)):
            for kind in ("f", "i", "b"):
                record(f"{algo}/bcast/{root}/{kind}",
                       lambda: mpx.bcast(mine[kind], root, comm=comm)[0])
        for kind in ("fb", "ib", "bb"):
            record(f"{algo}/alltoall/{kind}",
                   lambda: mpx.alltoall(mine[kind], comm=comm)[0])
    _use_algo(None)
    return out


def hierarchy_program(rank: int, spec: str) -> dict:
    """The cases under ``spec`` on the whole comm and on a color split by
    parity, the telemetry link columns, the async split, and the plan memo
    check."""
    os.environ["MPI4JAX_TPU_TOPOLOGY"] = spec
    import torch.distributed as dist

    import mpi4jax_tpu_torch as mpx
    from mpi4jax_tpu_torch.ops import _hierarchy
    from mpi4jax_tpu_torch.parallel import comm as C
    from mpi4jax_tpu_torch.parallel import mesh as M
    from mpi4jax_tpu_torch.telemetry import core as T

    k = dist.get_world_size()
    comm = mpx.Comm("x", mesh=mpx.make_world_mesh((k,), ("x",)))
    out = run_cases(rank, k, spec, comm)
    split = comm.Split([r % 2 for r in range(k)])
    for key, val in run_cases(rank, k, spec, split,
                              algos=("ring", "hier")).items():
        out["split/" + key] = val
    out["plan"] = np.array(_plan_shape(_hierarchy.hier_plan(comm)))
    out["split_plan"] = np.array(_plan_shape(_hierarchy.hier_plan(split)))

    # the telemetry link columns of a few calls under each lowering
    x = _t(inputs(k)["f"][rank])
    xi = _t(inputs(k)["i"][rank])
    blocks = _t(inputs(k)["fb"][rank])
    T.set_telemetry_mode("counters")
    try:
        for algo in ("butterfly", "ring", "hier"):
            _use_algo(algo)
            mpx.allreduce(xi, mpx.PROD, comm=comm)
            mpx.allreduce(x, mpx.MAX, comm=split)
            mpx.bcast(x, 0, comm=split)
            mpx.reduce_scatter(blocks, mpx.MIN, comm=comm)
            mpx.alltoall(blocks, comm=comm)
        _use_algo("auto")
        os.environ["MPI4JAX_TPU_COMPRESS"] = "bf16"
        mpx.allreduce(x, mpx.PROD, comm=comm)
        os.environ["MPI4JAX_TPU_COMPRESS"] = "fp8"
        mpx.allreduce(x, mpx.PROD, comm=comm)
        mpx.reduce_scatter(blocks, mpx.MIN, comm=comm)
        os.environ.pop("MPI4JAX_TPU_COMPRESS")
        _use_algo(None)
        rows = T.snapshot()["ops"]
    finally:
        T.set_telemetry_mode(None)
        T.reset()
    for key, row in rows.items():
        op, _, algo, dtype = key.split("|")
        tag = "telemetry/" + f"{op}|{algo}|{dtype}"
        cols = np.array([row["calls"], row["bytes"], row["intra_bytes"],
                         row["inter_bytes"], row["wire_inter_bytes"]], np.int64)
        out[tag] = out[tag] + cols if tag in out else cols

    # the codec legs of the hierarchy (the JAX suite's inputs,
    # tests/test_compress.py)
    for key, val in codec_cases(rank, k, comm).items():
        out[key] = val

    # the chunked async allreduce against the synchronous one
    for algo in ("ring", "hier"):
        _use_algo(algo)
        os.environ["MPI4JAX_TPU_OVERLAP_CHUNKS"] = "3"
        for kind, op in (("f", "SUM"), ("i", "BXOR"), ("f", "MAX")):
            v = _t(inputs(k)[kind][rank])
            res = mpx.spmd(lambda v: mpx.allreduce_wait(mpx.allreduce_start(
                v, getattr(mpx, op))[0])[0], comm=comm)(v)
            out[f"async/{algo}/{kind}/{op}"] = res.numpy()
            out[f"sync/{algo}/{kind}/{op}"] = mpx.allreduce(
                v, getattr(mpx, op), comm=comm)[0].numpy()
        os.environ.pop("MPI4JAX_TPU_OVERLAP_CHUNKS")
    _use_algo(None)

    # autograd: whatever lowering the forward takes, the backward is the
    # op's own route's
    for algo in ("auto", "butterfly", "ring", "hier"):
        _use_algo(algo)
        for name, fn in (
                ("allreduce/SUM", lambda v: mpx.allreduce(v, mpx.SUM, comm=comm)[0]),
                ("allreduce/PROD", lambda v: mpx.allreduce(v, mpx.PROD, comm=comm)[0]),
                ("bcast", lambda v: mpx.bcast(v, 1, comm=comm)[0]),
                ("reduce_scatter", lambda v: mpx.reduce_scatter(
                    v.reshape(k, -1), mpx.SUM, comm=comm)[0])):
            v = (1.0 + 0.01 * _t(inputs(k)["f"][rank])).repeat(k, 1)
            v = v.reshape(-1).requires_grad_(True)
            (g,) = torch.autograd.grad((fn(v) ** 2).sum(), v)
            out[f"grad/{algo}/{name}"] = g.numpy()
    _use_algo(None)

    # a plan found in the memo on one rank and built again on another
    # takes no uid and creates no group
    _use_algo("hier")
    groups_before = len(M._World.groups)
    if rank == 1:
        _hierarchy._plan_memo.clear()
    again = mpx.allreduce(xi, mpx.BXOR, comm=comm)[0]
    out["memo/again"] = again.numpy()
    out["memo/groups_added"] = np.int64(len(M._World.groups) - groups_before)
    out["memo/next_uid"] = np.int64(C.next_uid())
    _use_algo(None)
    return out


CODECS = ("bf16", "fp8")


def codec_inputs(k: int) -> dict:
    """The JAX suite's codec inputs: ``(k, 512)``, ``(k, k*64)`` and
    ``(k, k*32)`` standard normals from seeds 3, 1 and 2."""
    def rand(n, seed):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((k, n)).astype(np.float32)

    return {"ar": rand(512, 3), "rs": rand(k * 64, 1), "a2a": rand(k * 32, 2)}


def codec_cases(rank: int, k: int, comm) -> dict:
    """The hierarchy's codec legs, forced ``hier``: SUM and MAX
    allreduce, SUM reduce_scatter and the alltoall (crossover 1 B) under
    each codec, and exact."""
    import mpi4jax_tpu_torch as mpx

    g = {name: _t(v[rank]) for name, v in codec_inputs(k).items()}
    out = {}
    _use_algo("hier")
    os.environ["MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES"] = "1"
    try:
        for codec in ("off",) + CODECS:
            os.environ["MPI4JAX_TPU_COMPRESS"] = codec
            pre = f"codec/{codec}/"
            out[pre + "allreduce/SUM"] = mpx.allreduce(
                g["ar"], mpx.SUM, comm=comm)[0].numpy()
            out[pre + "allreduce/MAX"] = mpx.allreduce(
                g["ar"], mpx.MAX, comm=comm)[0].numpy()
            out[pre + "reduce_scatter/SUM"] = mpx.reduce_scatter(
                g["rs"].reshape(k, 64), mpx.SUM, comm=comm)[0].numpy()
            out[pre + "alltoall"] = mpx.alltoall(
                g["a2a"].reshape(k, 32), comm=comm)[0].numpy()
    finally:
        os.environ.pop("MPI4JAX_TPU_COMPRESS", None)
        _use_algo(None)
    return out


def _plan_shape(plan):
    return (0, 0) if plan is None else (plan.h, plan.r)


FALLBACKS = ("3,5", "round_robin", "one_host", "blocks")


def fallback_program(rank: int) -> dict:
    """The cases where no plan exists, forced to ``hier`` and beside the
    butterfly, in one world of 8: a ``3,5`` spec, then host labels faked
    per rank (``host_label``, published and met at a barrier): round-robin,
    one host, and two blocks of 4 (which has a plan); each also on unequal
    color groups (sizes 1, 3 and 4).  Every one must run, flat where no
    plan exists."""
    import torch.distributed as dist

    import mpi4jax_tpu_torch as mpx
    from mpi4jax_tpu_torch.ops import _hierarchy
    from mpi4jax_tpu_torch.parallel import topology

    k = dist.get_world_size()
    out = {}
    g = inputs(k)
    x, xi = _t(g["f"][rank]), _t(g["i"][rank])
    for mode in FALLBACKS:
        if mode == "3,5":
            os.environ["MPI4JAX_TPU_TOPOLOGY"] = "3,5"
        else:
            os.environ.pop("MPI4JAX_TPU_TOPOLOGY", None)
            label = {"round_robin": f"host{rank % 2}", "one_host": "host",
                     "blocks": f"host{rank // (k // 2)}"}[mode]
            topology.host_label = lambda: label
            topology.publish_host_label()
            dist.barrier()
        comm = mpx.Comm("x", mesh=mpx.make_world_mesh((k,), ("x",)))
        out[f"{mode}/plan"] = np.array(
            _plan_shape(_hierarchy.hier_plan(comm)))
        topo = topology.derive_world_topology(comm)
        out[f"{mode}/host_of_rank"] = np.array(
            () if topo is None else topo.host_of_rank, np.int64)
        unequal = comm.Split([0] + [1] * 3 + [2] * (k - 4))
        for algo in ("hier", "butterfly"):
            _use_algo(algo)
            pre = f"{mode}/{algo}/"
            out[pre + "allreduce/i/BXOR"] = mpx.allreduce(
                xi, mpx.BXOR, comm=comm)[0].numpy()
            out[pre + "allreduce/f/MAX"] = mpx.allreduce(
                x, mpx.MAX, comm=comm)[0].numpy()
            out[pre + "bcast/f"] = mpx.bcast(x, k - 1, comm=comm)[0].numpy()
            out[pre + "alltoall/fb"] = mpx.alltoall(_t(g["fb"][rank]),
                                                    comm=comm)[0].numpy()
            out[pre + "unequal/i/BXOR"] = mpx.allreduce(
                xi, mpx.BXOR, comm=unequal)[0].numpy()
            out[pre + "unequal/f/SUM"] = mpx.allreduce(
                x, mpx.SUM, comm=unequal)[0].numpy()
        _use_algo(None)
    return out
