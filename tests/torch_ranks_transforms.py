"""Rank programs of the ``torch.func`` tests and of the mesh-size cases.

The programs run on every rank of a world that
``mpi4jax_tpu_torch.parallel.launch.run`` starts (gloo ranks on the CPU)
and return dicts of tensors, numbers and error messages.  The case tables
(``vmap_cases``, ``DIFF_CASES``) name each case once, as a function that
takes the op namespace, the tokenless namespace and the array namespace:
the rank programs give it the port's (``mpi4jax_tpu_torch``, its
``experimental.notoken``, ``torch``), and ``tests/test_torch_transforms.py``
the JAX package's, so both sides run the same program.  This module
imports only torch, numpy and the port.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, jvp, vjp, vmap

import mpi4jax_tpu_torch as M
from mpi4jax_tpu_torch import telemetry
from mpi4jax_tpu_torch.experimental import notoken as N
from mpi4jax_tpu_torch.models import shallow_water as P
from mpi4jax_tpu_torch.ops import _staging

from torch_ranks_ops import REDUCTIONS, SCANS, error

LANES = 3  # the vmapped batch
IN_DIMS = (0, 1, 2)
OUT_DIM = 1
BLOCKS = {"f": "blocks", "i": "iblocks", "b": "bblocks"}


def _world(size: int, name: str = "x"):
    return M.Comm(name, mesh=M.make_world_mesh((size,), (name,), device="cpu"))


def lane_inputs(size: int) -> dict:
    """Every rank's ``LANES`` lanes, from a numpy seed, ``(size, LANES,
    *lane)``: ``f`` f32 (positive, so that PROD stays well scaled), ``i``
    int32, ``b`` bool, each lane ``(4, 5)``; ``blocks``/``iblocks``/
    ``bblocks`` lanes ``(size, 4)``, one block a rank; ``mats`` and
    ``bmats`` 2x2 matrices for the matrix-product callable."""
    rng = np.random.default_rng(97)
    shape = (size, LANES, 4, 5)
    return {
        "f": rng.uniform(0.5, 1.5, shape).astype(np.float32),
        "i": rng.integers(-60, 60, shape).astype(np.int32),
        "b": rng.random(shape) < 0.5,
        "blocks": rng.uniform(0.5, 1.5, (size, LANES, size, 4)).astype(np.float32),
        "iblocks": rng.integers(0, 128, (size, LANES, size, 4)).astype(np.int32),
        "bblocks": rng.random((size, LANES, size, 4)) < 0.5,
        "mats": rng.standard_normal((size, LANES, 2, 2)).astype(np.float32),
        "bmats": rng.standard_normal((size, LANES, size, 2, 2)).astype(np.float32),
    }


def physical(lanes: np.ndarray, d: int) -> np.ndarray:
    """One rank's ``(LANES, *lane)`` lanes laid out with the batch at
    ``d``."""
    return np.ascontiguousarray(np.moveaxis(lanes, 0, d))


def _red(M_, op):
    return getattr(M_, op)


def vmap_cases(size: int):
    """``(name, input kind, make)`` of every vmapped case: ``make(M, N,
    xp, comm)`` gives the lane function on ops namespace ``M``, tokenless
    namespace ``N`` and array namespace ``xp``."""
    cases = []
    for kind, op in REDUCTIONS:
        cases.append((f"allreduce/{kind}/{op}", kind, lambda M_, N_, xp, c, op=op:
                      lambda v: M_.allreduce(v, _red(M_, op), comm=c)[0]))
        cases.append((f"reduce_scatter/{kind}/{op}", BLOCKS[kind],
                      lambda M_, N_, xp, c, op=op:
                      lambda v: M_.reduce_scatter(v, _red(M_, op), comm=c)[0]))
    for kind, op in SCANS:
        cases.append((f"scan/{kind}/{op}", kind, lambda M_, N_, xp, c, op=op:
                      lambda v: M_.scan(v, _red(M_, op), comm=c)[0]))
    cases += [
        ("allreduce/matmul", "mats", lambda M_, N_, xp, c:
         lambda v: M_.allreduce(v, xp.matmul, comm=c)[0]),
        ("allreduce/sqrt_sum_sq", "f", lambda M_, N_, xp, c:
         lambda v: M_.allreduce(v, lambda a, b: xp.sqrt(a * a + b * b), comm=c)[0]),
        ("reduce_scatter/matmul", "bmats", lambda M_, N_, xp, c:
         lambda v: M_.reduce_scatter(v, xp.matmul, comm=c)[0]),
    ]
    for root in (0, size - 1):
        for kind in ("f", "i", "b"):
            cases.append((f"bcast/{root}/{kind}", kind, lambda M_, N_, xp, c, root=root:
                          lambda v: M_.bcast(v, root, comm=c)[0]))
        for kind, op in (("f", "SUM"), ("i", "MAX"), ("b", "LOR")):
            cases.append((f"reduce/{root}/{kind}/{op}", kind,
                          lambda M_, N_, xp, c, root=root, op=op:
                          lambda v: M_.reduce(v, _red(M_, op), root, comm=c)[0]))
        for kind in ("blocks", "iblocks"):
            cases.append((f"scatter/{root}/{kind}", kind, lambda M_, N_, xp, c, root=root:
                          lambda v: M_.scatter(v, root, comm=c)[0]))
        cases.append((f"gather/{root}/f", "f", lambda M_, N_, xp, c, root=root:
                      lambda v: M_.gather(v, root, comm=c)[0]))
    for kind in ("f", "i", "b"):
        cases += [
            (f"allgather/{kind}", kind, lambda M_, N_, xp, c:
             lambda v: M_.allgather(v, comm=c)[0]),
            (f"alltoall/{kind}", BLOCKS[kind], lambda M_, N_, xp, c:
             lambda v: M_.alltoall(v, comm=c)[0]),
            (f"sendrecv/ring/{kind}", kind, lambda M_, N_, xp, c:
             lambda v: M_.sendrecv(v, v, dest=M_.shift(1), comm=c)[0]),
        ]
    cases += [
        # an unbatched recv template beside a batched send buffer
        ("sendrecv/edge/f", "f", lambda M_, N_, xp, c:
         lambda v: M_.sendrecv(v, xp.zeros((4, 5), dtype=v.dtype),
                               dest=M_.shift(1, wrap=False), comm=c)[0]),
        ("send_recv/f", "f", lambda M_, N_, xp, c:
         lambda v: M_.recv(v, comm=c, token=M_.send(v, M_.shift(1), comm=c))[0]),
        ("barrier/f", "f", lambda M_, N_, xp, c:
         lambda v: (M_.barrier(comm=c), v * 2)[1]),
    ]
    cases += [(f"notoken/{name}", kind, make) for name, kind, make in NOTOKEN_CASES]
    return cases


def _notoken_send_recv(N_, c, v):
    N_.send(v, [(0, 1)], comm=c)
    return N_.recv(v, comm=c)


NOTOKEN_CASES = [
    ("allreduce", "f", lambda M_, N_, xp, c: lambda v: N_.allreduce(v, comm=c)),
    ("allreduce_i", "i", lambda M_, N_, xp, c: lambda v: N_.allreduce(v, comm=c)),
    ("allgather", "f", lambda M_, N_, xp, c: lambda v: N_.allgather(v, comm=c)),
    ("alltoall", "blocks", lambda M_, N_, xp, c: lambda v: N_.alltoall(v, comm=c)),
    ("bcast", "f", lambda M_, N_, xp, c: lambda v: N_.bcast(v, 0, comm=c)),
    ("gather", "f", lambda M_, N_, xp, c: lambda v: N_.gather(v, 0, comm=c)),
    ("reduce", "i", lambda M_, N_, xp, c: lambda v: N_.reduce(v, M_.SUM, 0, comm=c)),
    ("reduce_scatter", "blocks", lambda M_, N_, xp, c:
     lambda v: N_.reduce_scatter(v, comm=c)),
    ("scan", "f", lambda M_, N_, xp, c: lambda v: N_.scan(v, comm=c)),
    ("scatter", "blocks", lambda M_, N_, xp, c: lambda v: N_.scatter(v, 0, comm=c)),
    ("sendrecv", "f", lambda M_, N_, xp, c:
     lambda v: N_.sendrecv(v, v, dest=M_.shift(1), comm=c)),
    ("sendrecv_i", "i", lambda M_, N_, xp, c:
     lambda v: N_.sendrecv(v, v, dest=M_.shift(1), comm=c)),
    ("send_recv", "f", lambda M_, N_, xp, c: lambda v: _notoken_send_recv(N_, c, v)),
    ("barrier", "f", lambda M_, N_, xp, c: lambda v: (N_.barrier(comm=c), v + 1)[1]),
]


def lane_band(name: str, size: int):
    """The comparison of a vmapped case with its lane-by-lane run: bit for
    bit (``None``), but where the result's rounding depends on how the
    exchange or the callable is batched: an f32 SUM on one
    ``dist.all_reduce`` or ``dist.reduce`` (gloo splits the whole buffer
    into segments, so the order in which an element's ranks are added
    depends on the buffer's length; two ranks commute), and the
    matrix-product callable,
    which ``torch.func.vmap`` runs as one batched product.  Those take the
    band ``tests/test_torch_ops.py`` holds them to against the JAX
    package."""
    native_sum = name in ("allreduce/f/SUM", "notoken/allreduce") or (
        name.startswith("reduce/") and name.endswith("/f/SUM"))
    if native_sum and size > 2:
        return {"rtol": 1e-5}
    if name == "allreduce/matmul":
        return {"rtol": 1e-5, "atol": 1e-5}
    if name == "reduce_scatter/matmul":
        return {"rtol": 1e-4, "atol": 1e-4}
    return None


def vmap_program(rank: int, size: int, dims=IN_DIMS):
    """Every case of ``vmap_cases`` vmapped at each batch dim of ``dims``
    (``out_dims=OUT_DIM``), its lane-by-lane run on the same ranks, and
    the exchanges (``_staging.stats.calls``) of the vmapped call and of
    one lane's call."""
    world = _world(size)
    inp = lane_inputs(size)
    out = {}
    for d in dims:
        for name, kind, make in vmap_cases(size):
            f = make(M, N, torch, world)
            x = torch.from_numpy(physical(inp[kind][rank], d))
            _staging.stats.reset()
            out[f"{name}/d{d}"] = vmap(f, in_dims=d, out_dims=OUT_DIM)(x)
            calls = _staging.stats.calls
            _staging.stats.reset()
            out[f"{name}/d{d}/lanes"] = torch.stack(
                [f(x.select(d, b)) for b in range(LANES)], dim=OUT_DIM)
            out[f"{name}/d{d}/calls"] = (calls, _staging.stats.calls / LANES)
    M.flush()
    return out


# ---------------------------------------------------------------------------
# the twins of the JAX suite's vmap tests
# ---------------------------------------------------------------------------


def vmap_twins_program(rank: int, size: int):
    """tests/test_allreduce.py:118 and tests/test_reduce_scatter.py:216,
    whose ``jax.vmap`` runs outside the region over the world array (axis
    0 the rank): ``in_axes=1, out_axes=1`` and ``in_axes=2, out_axes=1``
    there are ``in_dims=0, out_dims=0`` and ``in_dims=1, out_dims=0`` on
    the rank's slice; and tests/test_mesh_sizes.py:81,100 (a batched halo
    rotation; gather and bcast), each rank's slice of the JAX tests'
    global arrays."""
    world = _world(size)
    out = {}
    xb = torch.arange(size * 2 * 3, dtype=torch.float32).reshape(size, 2, 3)[rank]
    out["allreduce_vmap"] = vmap(lambda v: M.allreduce(v, M.SUM, comm=world)[0],
                                 in_dims=0, out_dims=0)(xb)
    rb = torch.arange(size * size * 4, dtype=torch.float32).reshape(
        size, size, 4)[rank]
    out["reduce_scatter_vmap"] = vmap(
        lambda v: M.reduce_scatter(v, M.SUM, comm=world)[0],
        in_dims=1, out_dims=0)(rb)
    x = torch.arange(size * 3.0).reshape(size, 3, 1)[rank]
    out["sendrecv_vmap"] = vmap(
        lambda v: M.sendrecv(v, v, dest=M.shift(1), comm=world)[0])(x)
    x = torch.arange(size * 2.0).reshape(size, 2, 1)[rank]

    def one(v):
        g, tok = M.gather(v, 0, comm=world)
        b, _ = M.bcast(v, 3 % size, comm=world, token=tok)
        return g.sum(0), b

    out["gather_bcast_vmap"] = vmap(one)(x)
    # the argument checks read the lane: under vmap each raises what the
    # lane's own call raises, word for word
    lanes = torch.zeros(LANES, size + 1, 4)
    checks = {
        "alltoall_axis": lambda v: M.alltoall(v, comm=world),
        "scatter_axis": lambda v: M.scatter(v, 0, comm=world),
        "reduce_scatter_axis": lambda v: M.reduce_scatter(v, comm=world),
        "bcast_root": lambda v: M.bcast(v, size, comm=world),
        "sendrecv_dtype": lambda v: M.sendrecv(v, v.int(), dest=M.shift(1), comm=world),
    }
    out["checks"] = {name: (error(lambda f=f: vmap(f)(lanes)), error(lambda f=f: f(lanes[0])))
                     for name, f in checks.items()}
    return out


# ---------------------------------------------------------------------------
# autodiff through the transforms
# ---------------------------------------------------------------------------


def diff_inputs(size: int) -> dict:
    """Every rank's input, tangent and cotangent of the differentiated
    cases, from a numpy seed: ``v`` ``(size, 4)``, ``blocks`` ``(size,
    size, 2)``, ``mats`` ``(size, 2, 2)`` f32."""
    rng = np.random.default_rng(53)
    out = {}
    for name, shape in (("v", (4,)), ("blocks", (size, 2)), ("mats", (2, 2))):
        for part in ("x", "t"):
            out[f"{name}/{part}"] = rng.uniform(
                0.5, 1.5, (size, *shape)).astype(np.float32)
    return out


# ``(name, input, make)``: ``make(M, xp, comm, size)`` gives the
# function differentiated; every op that differentiates today
DIFF_CASES = [
    ("allreduce", "v", lambda M_, xp, c, n: lambda w: M_.allreduce(w, M_.SUM, comm=c)[0]),
    ("prod", "v", lambda M_, xp, c, n: lambda w: M_.allreduce(w, M_.PROD, comm=c)[0]),
    ("matmul", "mats", lambda M_, xp, c, n:
     lambda w: M_.allreduce(w, xp.matmul, comm=c)[0]),
    ("sendrecv", "v", lambda M_, xp, c, n:
     lambda w: M_.sendrecv(w, w, dest=M_.shift(1), comm=c)[0]),
    ("bcast", "v", lambda M_, xp, c, n: lambda w: M_.bcast(w, n - 1, comm=c)[0]),
    ("reduce_scatter", "blocks", lambda M_, xp, c, n:
     lambda w: M_.reduce_scatter(w, M_.SUM, comm=c)[0]),
    ("alltoall", "blocks", lambda M_, xp, c, n: lambda w: M_.alltoall(w, comm=c)[0]),
    ("allgather", "v", lambda M_, xp, c, n: lambda w: M_.allgather(w, comm=c)[0]),
    ("gather", "v", lambda M_, xp, c, n: lambda w: M_.gather(w, 0, comm=c)[0]),
    ("reduce", "v", lambda M_, xp, c, n: lambda w: M_.reduce(w, M_.SUM, 0, comm=c)[0]),
    ("scatter", "blocks", lambda M_, xp, c, n: lambda w: M_.scatter(w, 0, comm=c)[0]),
    ("scan", "v", lambda M_, xp, c, n: lambda w: M_.scan(w, M_.SUM, comm=c)[0]),
]
TRANSFORMS = ("jacfwd", "jacrev", "jvp", "vjp", "grad", "hessian")


def diff_program(rank: int, size: int):
    """Every transform of every case of ``DIFF_CASES`` on this rank, and
    the refused rules (MIN and MAX on a whole comm) under each."""
    world = _world(size)
    inp = diff_inputs(size)
    out = {}
    for name, kind, make in DIFF_CASES:
        f = make(M, torch, world, size)
        x = torch.from_numpy(inp[f"{kind}/x"][rank])
        t = torch.from_numpy(inp[f"{kind}/t"][rank])
        y = f(x)
        # the cotangent: rank 0's tangent, the same on every rank
        ct = torch.from_numpy(np.resize(inp[f"{kind}/t"][0], y.shape))

        def loss(w, f=f):
            return (f(w) ** 2).sum()

        out[f"{name}/jacfwd"] = jacfwd(f)(x)
        out[f"{name}/jacrev"] = jacrev(f)(x)
        out[f"{name}/jvp"] = jvp(f, (x,), (t,))[1]
        out[f"{name}/vjp"] = vjp(f, x)[1](ct)[0]
        out[f"{name}/grad"] = grad(loss)(x)
        out[f"{name}/hessian"] = hessian(loss)(x)
    x = torch.from_numpy(inp["v/x"][rank])
    for op in ("MIN", "MAX"):
        f = lambda w, op=op: M.allreduce(w, getattr(M, op), comm=world)[0]
        out[f"refused/{op}"] = [
            error(lambda: jacfwd(f)(x)), error(lambda: jacrev(f)(x)),
            error(lambda: jvp(f, (x,), (x,))), error(lambda: grad(lambda w: f(w).sum())(x)),
            error(lambda: M.allreduce(x.clone().requires_grad_(), getattr(M, op),
                                      comm=world))]
    M.flush()
    return out


# ---------------------------------------------------------------------------
# the other layers under vmap: telemetry, fusion, async pairs, overlap()
# ---------------------------------------------------------------------------


def _two_ops(c):
    def f(v):
        a, t = M.allreduce(v, M.SUM, comm=c)
        b, t = M.allreduce(v * 2, M.SUM, comm=c, token=t)
        d, t = M.bcast(v, 1 % c.Get_size(), comm=c, token=t)
        return a + b + d
    return f


def _async_pairs(c):
    def f(v):
        blocks = v.reshape(-1)[:2 * c.Get_size()].reshape(c.Get_size(), 2)
        h1, _ = M.allreduce_start(v, M.SUM, comm=c)
        h2, _ = M.alltoall_start(blocks, comm=c)
        h3, _ = M.reduce_scatter_start(blocks, M.SUM, comm=c)
        hs, _ = M.send_start(v, M.shift(1), comm=c)
        hr, _ = M.recv_start(v, comm=c)
        a = M.allreduce_wait(h1)[0]
        b = M.alltoall_wait(h2)[0]
        r = M.reduce_scatter_wait(h3)[0]
        M.p2p_wait(hs)
        got = M.p2p_wait(hr)[0]
        return a + got + b.sum() + r.sum()
    return f


def _overlapped(c):
    def f(v):
        blocks = v.reshape(-1)[:2 * c.Get_size()].reshape(c.Get_size(), 2)
        with M.overlap():
            a, _ = M.allreduce(v, M.SUM, comm=c)
            b, _ = M.alltoall(blocks, comm=c)
            r, _ = M.reduce_scatter(blocks, M.SUM, comm=c)
            return a + b.sum() + r.sum()
    return f


SERVICES = {"two_ops": _two_ops, "async": _async_pairs, "overlap": _overlapped}
# (label, telemetry mode, fusion mode) of each run of the services program
SERVICE_MODES = [("counters", "counters", None), ("events", "events", None),
                 ("fusion", None, "force"), ("plain", None, None)]


def service_inputs(size: int) -> np.ndarray:
    """Every rank's lanes ``(size, LANES, 4, 5)``: int-valued f32, so that
    every sum is exact whatever its order or packing."""
    rng = np.random.default_rng(61)
    return rng.integers(-8, 8, (size, LANES, 4, 5)).astype(np.float32)


def _op_counts() -> dict:
    return {key: row["calls"] for key, row in telemetry.snapshot()["ops"].items()
            if "calls" in row}


def services_program(rank: int, size: int):
    """Each program of ``SERVICES`` under each mode of ``SERVICE_MODES``,
    in a region: vmapped inside the region and with the region inside the
    vmap, and lane by lane; the exchanges and the telemetry op counts of
    each vmapped call and of one lane's call."""
    world = _world(size)
    x = torch.from_numpy(service_inputs(size)[rank])
    out = {}
    for label, tmode, fmode in SERVICE_MODES:
        telemetry.set_telemetry_mode(tmode or "off")
        M.set_fusion_mode(fmode)
        try:
            for name, build in SERVICES.items():
                f = build(world)
                key = f"{label}/{name}"
                telemetry.reset()
                _staging.stats.reset()
                out[f"{key}/inside"] = M.spmd(lambda v: vmap(f)(v), comm=world)(x)
                out[f"{key}/calls"] = _staging.stats.calls
                out[f"{key}/ops"] = _op_counts()
                telemetry.reset()
                _staging.stats.reset()
                out[f"{key}/outside"] = vmap(M.spmd(f, comm=world))(x)
                out[f"{key}/outside_calls"] = _staging.stats.calls
                out[f"{key}/outside_ops"] = _op_counts()
                telemetry.reset()
                _staging.stats.reset()
                out[f"{key}/lane0"] = M.spmd(f, comm=world)(x[0])
                out[f"{key}/lane_calls"] = _staging.stats.calls
                out[f"{key}/lane_ops"] = _op_counts()
                out[f"{key}/lanes"] = torch.stack(
                    [M.spmd(f, comm=world)(x[b]) for b in range(LANES)])
        finally:
            telemetry.set_telemetry_mode(None)
            M.set_fusion_mode(None)
    M.flush()
    return out


# ---------------------------------------------------------------------------
# a batch size that differs between ranks
# ---------------------------------------------------------------------------


def divergent_program(rank: int, size: int, batched: bool):
    """Rank 0 has 3 lanes (or, unbatched, 3 rows) and the others 2: the
    same mismatch as a rank-divergent shape."""
    world = _world(size)
    x = torch.ones(3 if rank == 0 else 2, 5)
    f = lambda v: M.allreduce(v, M.SUM, comm=world)[0]
    return {"out": vmap(f)(x) if batched else f(x)}


# ---------------------------------------------------------------------------
# tests/test_mesh_sizes.py
# ---------------------------------------------------------------------------


def sizes_program(rank: int, size: int):
    """tests/test_mesh_sizes.py:24 and :48 on a world of ``size``: the
    collectives and the ring, a self-send on one rank."""
    world = _world(size)
    x = torch.tensor([float(rank) + 1.0])
    a, tok = M.allreduce(x, M.SUM, comm=world)
    b, tok = M.allgather(x, comm=world, token=tok)
    c, tok = M.bcast(x, 0, comm=world, token=tok)
    d, tok = M.scan(x, M.SUM, comm=world, token=tok)
    e, tok = M.sendrecv(x, x, dest=M.shift(1), comm=world, token=tok)
    M.barrier(comm=world, token=tok)
    ring = M.sendrecv(x - 1.0, x - 1.0, dest=M.shift(1), comm=world)[0]
    return {"a": a, "b": b.sum(0), "c": c, "d": d, "e": e, "ring": ring}


def complex_inputs(size: int):
    """Every rank's complex64 and bool inputs, from a numpy seed."""
    rng = np.random.default_rng(17)
    z = (rng.standard_normal((size, 3)) + 1j * rng.standard_normal((size, 3)))
    return z.astype(np.complex64), rng.random((size, 3)) < 0.3


def complex_program(rank: int, size: int):
    """tests/test_mesh_sizes.py:63, widened: complex64 SUM, PROD, sendrecv
    and gather, and bool LOR and LAND."""
    world = _world(size)
    z, m = (torch.from_numpy(a[rank]) for a in complex_inputs(size))
    return {"sum": M.allreduce(z, M.SUM, comm=world)[0],
            "prod": M.allreduce(z, M.PROD, comm=world)[0],
            "ring": M.sendrecv(z, z, dest=M.shift(1), comm=world)[0],
            "gather": M.gather(z, 0, comm=world)[0],
            "lor": M.allreduce(m, M.LOR, comm=world)[0],
            "land": M.allreduce(m, M.LAND, comm=world)[0]}


def odd_inputs(n: int):
    """tests/test_mesh_sizes.py:171's inputs for ``n`` ranks."""
    vals = (1.0 + np.arange(n)[:, None] / 8.0).astype(np.float32)
    mats = np.random.default_rng(n).normal(size=(n, 2, 2)).astype(np.float32)
    return vals, mats


def odd_program(rank: int, n: int):
    """PROD and the non-commutative matrix product on ``n`` ranks."""
    world = _world(n)
    vals, mats = odd_inputs(n)
    p, tok = M.allreduce(torch.from_numpy(vals[rank]), M.PROD, comm=world)
    mm, _ = M.allreduce(torch.from_numpy(mats[rank]), torch.matmul, comm=world,
                        token=tok)
    return {"prod": p, "matmul": mm}


# ---------------------------------------------------------------------------
# the hybrid ensemble on a 3-axis mesh (tests/test_mesh_sizes.py:121)
# ---------------------------------------------------------------------------

# (nx, ny, fast, steps after the first): the JAX test's own case, and a
# size where "auto" picks wide2 on the (2, 2) sub-communicator
ENSEMBLE_CASES = {"fast": (16, 8, True, 1), "auto": (64, 32, "auto", 4)}


def ensemble_program(rank: int, case: str):
    """Two shallow-water members on the ``("py", "px")`` sub-communicator
    of a ``(dp, py, px) = (2, 2, 2)`` world, member 1 started 10 cm higher,
    stepped through ``make_stepper``; the ensemble mean allreduced over
    ``dp``."""
    nx, ny, fast, steps = ENSEMBLE_CASES[case]
    mesh = M.make_world_mesh((2, 2, 2), ("dp", "py", "px"), device="cpu")
    world = M.Comm(("dp", "py", "px"), mesh=mesh)
    sp, dpc = world.sub("py", "px"), world.sub("dp")
    cfg = P.Config(nproc_y=2, nproc_x=2, nx=nx, ny=ny)
    s = P.initial_state(cfg, rank=sp.Get_rank(), device="cpu")
    if dpc.Get_rank() == 1:
        s = s._replace(h=s.h + 0.1)
    first, multi = P.make_stepper(cfg, sp, fast=fast)
    s = first(s)
    if steps:
        s = multi(s, steps)
    total, _ = M.allreduce(s.h, M.SUM, comm=dpc)
    return {"state": tuple(s), "mean": total * 0.5, "mode": P.resolve_fast(fast, cfg),
            "coords": (dpc.Get_rank(), sp.Get_rank(), sp.Get_size(), dpc.Get_size())}


def member_program(rank: int, case: str):
    """The same member as ``ensemble_program``'s member 0, alone on a
    ``(2, 2)`` world."""
    nx, ny, fast, steps = ENSEMBLE_CASES[case]
    cfg = P.Config(nproc_y=2, nproc_x=2, nx=nx, ny=ny)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    first, multi = P.make_stepper(cfg, comm, fast=fast)
    s = first(P.initial_state(cfg, rank=rank, device="cpu"))
    if steps:
        s = multi(s, steps)
    return {"state": tuple(s)}
