"""Rank programs of the op-surface tests: every op, color splits, autodiff,
the tokenless API and the op-by-op ring backward.

The programs run on every rank of a world that
``mpi4jax_tpu_torch.parallel.launch.run`` starts (gloo ranks on the CPU)
and return dicts of tensors, numbers and error messages, which ``run``
hands back with the tensors as numpy arrays.  This module imports only
torch, numpy and the port; ``tests/test_torch_ops.py``,
``test_torch_split.py``, ``test_torch_autodiff.py`` and
``test_torch_ring_grad.py`` compare the results with the JAX package.
"""

from __future__ import annotations

import time

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
    Status,
    allgather,
    allreduce,
    alltoall,
    barrier,
    bcast,
    create_token,
    flush,
    gather,
    make_world_mesh,
    recv,
    reduce,
    reduce_scatter,
    scan,
    scatter,
    send,
    sendrecv,
    shift,
)
from mpi4jax_tpu_torch.attention import ring_attention
from mpi4jax_tpu_torch.experimental import notoken
from mpi4jax_tpu_torch.ops import _staging

OPS = {"SUM": SUM, "PROD": PROD, "MIN": MIN, "MAX": MAX, "LAND": LAND,
       "LOR": LOR, "LXOR": LXOR, "BAND": BAND, "BOR": BOR, "BXOR": BXOR}
# (dtype key, reduction) of every allreduce, reduce_scatter and scan case
REDUCTIONS = ([("f", op) for op in ("SUM", "PROD", "MIN", "MAX")]
              + [("i", op) for op in OPS]
              + [("b", op) for op in ("LAND", "LOR", "LXOR", "BAND", "BOR", "BXOR")])
SCANS = [("f", "SUM"), ("f", "PROD"), ("f", "MIN"), ("f", "MAX"), ("i", "SUM"),
         ("i", "BXOR"), ("b", "LXOR")]
N_MATVEC = 16  # tests/test_allreduce_matvec.py:17


def error(fn) -> str:
    """``"Type: message"`` of the exception ``fn()`` raises ("" if none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is the result
        return f"{type(e).__name__}: {e}"
    return ""


def sqrt_sum_sq(a, b):
    """The associative, commutative callable of tests/test_allreduce.py:104."""
    return torch.sqrt(a * a + b * b)


def op_inputs(size: int) -> dict:
    """Every rank's inputs, from a numpy seed: ``f`` f32 (positive, so that
    PROD stays well scaled), ``i`` int32, ``b`` bool, each ``(size, 3, 4)``;
    ``blocks``/``iblocks``/``bblocks`` ``(size, size, 3)`` addressed per
    rank; ``mats`` ``(size, 2, 2)`` and ``bmats`` ``(size, size, 2, 2)``
    for the matrix-product callable."""
    rng = np.random.default_rng(31)
    return {
        "f": rng.uniform(0.5, 1.5, (size, 3, 4)).astype(np.float32),
        "i": rng.integers(-60, 60, (size, 3, 4)).astype(np.int32),
        "b": rng.random((size, 3, 4)) < 0.5,
        "blocks": rng.uniform(0.5, 1.5, (size, size, 3)).astype(np.float32),
        "iblocks": rng.integers(0, 128, (size, size, 3)).astype(np.int32),
        "bblocks": rng.random((size, size, 3)) < 0.5,
        "mats": rng.standard_normal((size, 2, 2)).astype(np.float32),
        "bmats": rng.standard_normal((size, size, 2, 2)).astype(np.float32),
    }


def matvec_inputs(size: int):
    """The column-sharded matvec of tests/test_allreduce_matvec.py: A, x and
    the cotangent y, each rank's columns of A and slice of x."""
    rng = np.random.RandomState(42)
    a = rng.randn(N_MATVEC, N_MATVEC).astype(np.float32)
    x = rng.randn(N_MATVEC).astype(np.float32)
    y = np.random.RandomState(7).randn(N_MATVEC).astype(np.float32)
    cols = N_MATVEC // size
    a_sh = np.stack([a[:, r * cols:(r + 1) * cols] for r in range(size)])
    return a, x, y, a_sh, x.reshape(size, cols)


def _world(size, name="x"):
    return Comm(name, mesh=make_world_mesh((size,), (name,), device="cpu"))


def _collectives(rank, size, world, inp, out):
    """Every collective with every reduction and dtype on ``world``."""
    t = {k: torch.from_numpy(v[rank]) for k, v in inp.items()}
    for kind, op in REDUCTIONS:
        out[f"allreduce/{kind}/{op}"] = allreduce(t[kind], OPS[op], comm=world)[0]
        blocks = t[{"f": "blocks", "i": "iblocks", "b": "bblocks"}[kind]]
        out[f"reduce_scatter/{kind}/{op}"] = reduce_scatter(blocks, OPS[op],
                                                            comm=world)[0]
    for kind, op in SCANS:
        out[f"scan/{kind}/{op}"] = scan(t[kind], OPS[op], comm=world)[0]
    out["allreduce/matmul"] = allreduce(t["mats"], torch.matmul, comm=world)[0]
    out["allreduce/sqrt_sum_sq"] = allreduce(t["f"], sqrt_sum_sq, comm=world)[0]
    out["reduce_scatter/matmul"] = reduce_scatter(t["bmats"], torch.matmul,
                                                  comm=world)[0]
    for root in (0, size - 1):
        for kind in ("f", "i", "b"):
            out[f"bcast/{root}/{kind}"] = bcast(t[kind], root, comm=world)[0]
        out[f"reduce/{root}/f/SUM"] = reduce(t["f"], SUM, root, comm=world)[0]
        out[f"reduce/{root}/i/MAX"] = reduce(t["i"], MAX, root, comm=world)[0]
        out[f"reduce/{root}/b/LOR"] = reduce(t["b"], LOR, root, comm=world)[0]
        out[f"scatter/{root}/f"] = scatter(t["blocks"], root, comm=world)[0]
        out[f"scatter/{root}/i"] = scatter(t["iblocks"], root, comm=world)[0]
    for kind in ("f", "i", "b"):
        out[f"allgather/{kind}"] = allgather(t[kind], comm=world)[0]
    out["input_kept"] = all(torch.equal(t[k], torch.from_numpy(v[rank]))
                            for k, v in inp.items())


def _grid_ops(rank, size, inp, out):
    """The op matrix of tests/test_collectives.py:307 on a two-axis comm
    (``(2, size/2)``, row-major rank order)."""
    comm = Comm(("y", "x"), mesh=make_world_mesh((2, size // 2), ("y", "x"),
                                                 device="cpu"))
    x = torch.tensor([float(rank + 1)])
    rows = torch.arange(float(size * size)).reshape(size, size, 1)[rank]
    tok = create_token()
    out["grid/allreduce"], tok = allreduce(x, SUM, comm=comm, token=tok)
    out["grid/prod"], tok = allreduce(x, PROD, comm=comm, token=tok)
    out["grid/bcast"], tok = bcast(x, 3 % size, comm=comm, token=tok)
    out["grid/allgather"], tok = allgather(x, comm=comm, token=tok)
    out["grid/scan"], tok = scan(x, SUM, comm=comm, token=tok)
    out["grid/sendrecv"], tok = sendrecv(x, x, dest=shift(1), comm=comm, token=tok)
    out["grid/alltoall"], tok = alltoall(rows, comm=comm, token=tok)
    out["grid/scatter"], tok = scatter(rows, 2, comm=comm, token=tok)
    out["grid/gather"], tok = gather(x, 1, comm=comm, token=tok)
    out["grid/reduce"], tok = reduce(x, MAX, 0, comm=comm, token=tok)
    tok = barrier(comm=comm, token=tok)
    out["grid/rank"] = comm.Get_rank()


def _point_to_point(rank, size, world, out):
    """send/recv and sendrecv cases of tests/test_send_recv.py."""
    x = torch.tensor([float(rank)])
    t = send(x, shift(1), comm=world)
    out["p2p/pair"] = recv(x, source=shift(-1), comm=world, token=t)[0]
    send(x, shift(2), comm=world)
    out["p2p/inferred"] = recv(x, comm=world)[0]
    # FIFO per tag: two sends on tag 0, matched in order
    send(x, shift(1), comm=world)
    send(x * 10, shift(2), comm=world)
    out["p2p/fifo"] = (recv(x, comm=world)[0], recv(x, comm=world)[0])
    # tags are channels: the tag-7 recv skips the older tag-0 send
    send(x, shift(1), tag=0, comm=world)
    send(x * 100, shift(1), tag=7, comm=world)
    b = recv(x, tag=7, comm=world)[0]
    out["p2p/tags"] = (recv(x, tag=0, comm=world)[0], b)
    # a clone is a fresh namespace: the world's queue is empty
    clone = world.Clone()
    send(x, shift(1), comm=clone)
    out["p2p/clone_error"] = error(lambda: recv(x, comm=world))
    out["p2p/clone"] = recv(x, comm=clone)[0]
    out["p2p/clone_uid"] = (world.uid != clone.uid, world.Dup().uid != clone.uid)
    # a single message: everyone but rank 1 keeps the template
    send(x, [(0, 1)], comm=world)
    out["p2p/single"] = recv(x, comm=world)[0]
    # status of recv and sendrecv (tests/test_send_recv.py:298)
    four = torch.full((4,), float(rank))
    s_sr, s_rv = Status(), Status()
    y, tok = sendrecv(four, four, dest=shift(1), sendtag=5, recvtag=5,
                      comm=world, status=s_sr)
    tok = send(y, shift(1), tag=3, comm=world, token=tok)
    out["p2p/status_recv"] = recv(y, tag=3, comm=world, status=s_rv, token=tok)[0]
    for key, s in (("sr", s_sr), ("rv", s_rv)):
        out[f"status/{key}"] = (s.Get_source(), s.Get_tag(), s.Get_count(),
                                str(s.dtype), s.Get_error(), s.Get_elements(),
                                s.Get_elements(torch.uint8),
                                s.Get_elements(torch.float64))
    edge = Status()
    sendrecv(x, x, dest=shift(1, wrap=False), comm=world, status=edge)
    out["status/edge_source"] = edge.Get_source()
    # a source spec that disagrees with the queued send: the send stays
    send(x, shift(1), tag=4, comm=world)
    out["p2p/mismatch_error"] = error(lambda: recv(x, source=shift(0), tag=4,
                                                   comm=world))
    out["p2p/retry"] = recv(x, source=shift(-1), tag=4, comm=world)[0]
    # errors, with their codes
    out["p2p/no_send_error"] = error(lambda: recv(x, tag=55, comm=world))
    send(x, shift(1), tag=66, comm=world)
    out["p2p/flush_error"] = error(flush)
    out["p2p/drained"] = recv(x, tag=66, comm=world)[0]
    out["p2p/flush_after"] = error(flush)
    out["p2p/bare_int_error"] = error(lambda: send(x, 1, comm=world))
    out["p2p/dtype_error"] = error(lambda: sendrecv(x, x.int(), dest=shift(1),
                                                    comm=world))
    send(x, shift(1), tag=8, comm=world)
    out["p2p/template_error"] = error(lambda: recv(torch.zeros(2), tag=8,
                                                   comm=world))
    recv(x, tag=8, comm=world)
    # row for column: equal counts, the template's shape
    mat = torch.arange(6.0).reshape(2, 3) + 10 * rank
    out["p2p/row_for_column"] = sendrecv(mat[0], torch.zeros(3, 1), dest=shift(1),
                                         comm=world)[0]
    # a hot potato around the ring, by sendrecv and by send/recv: every
    # hop stamps it, and after size hops it is home
    potato, tok = x.clone(), create_token()
    for _ in range(size):
        potato, tok = sendrecv(potato + 1.0, potato, dest=shift(1), comm=world,
                               token=tok)
    out["p2p/potato"] = potato
    potato = x.clone()
    for _ in range(size):
        tok = send(potato + 1.0, shift(1), comm=world, token=tok)
        potato, tok = recv(potato, comm=world, token=tok)
    out["p2p/potato_send_recv"] = potato
    flush()


def _roots_and_barrier(rank, size, world, inp, out):
    """Root checks (MPX105), shape checks, and barrier ordering."""
    f = torch.from_numpy(inp["f"][rank])
    out["errors/root"] = [
        error(lambda: bcast(f, size, comm=world)),
        error(lambda: reduce(f, SUM, -1, comm=world)),
        error(lambda: scatter(torch.zeros(size, 2), size, comm=world)),
        error(lambda: gather(f, size, comm=world)),
    ]
    out["errors/shape"] = [
        error(lambda: scatter(torch.zeros(size + 1, 2), 0, comm=world)),
        error(lambda: reduce_scatter(torch.zeros(size + 1, 2), comm=world)),
        error(lambda: allreduce(f, "sum", comm=world)),
    ]
    # rank r arrives r * 30 ms late; nobody leaves before the last arrives
    time.sleep(0.03 * rank)
    arrived = time.time()
    barrier(comm=world)
    out["barrier/times"] = (arrived, time.time())


def _notoken(rank, size, world, out):
    """Every tokenless op (tests/test_notoken.py)."""
    x = torch.tensor([float(rank)])
    tiled = x.repeat(size, 1)
    out["notoken/ops"] = [
        notoken.allreduce(x, SUM, comm=world),
        notoken.allgather(x, comm=world).sum(0),
        notoken.bcast(x, 0, comm=world),
        notoken.gather(x, 0, comm=world).sum(0),
        notoken.reduce(x, SUM, 0, comm=world),
        notoken.scan(x, comm=world),
        notoken.sendrecv(x, x, dest=shift(1), comm=world),
        notoken.alltoall(tiled, comm=world).sum(0),
        notoken.scatter(tiled, 0, comm=world),
        notoken.reduce_scatter(tiled, comm=world),
    ]
    out["notoken/none"] = (notoken.barrier(comm=world),
                           notoken.send(x, [(0, 1)], comm=world))
    out["notoken/single"] = notoken.recv(x, comm=world)
    val = x
    for _ in range(size):
        val = notoken.sendrecv(val, val, dest=shift(1), comm=world)
    out["notoken/potato"] = val
    notoken.send(torch.full((2,), float(rank)), shift(1), tag=31, comm=world)
    out["notoken/deferred"] = notoken.recv(torch.zeros(2), tag=31, comm=world)
    flush()


def _small_split(rank, size, world, out):
    """A uniform (evens/odds) and an unequal (one rank, the rest) split."""
    x = torch.tensor([float(rank + 1)])
    splits = {"eo": world.Split([r % 2 for r in range(size)]),
              "unequal": world.Split([0] + [1] * (size - 1))}
    for name, c in splits.items():
        out[f"split/{name}/groups"] = c.groups
        out[f"split/{name}/sum"] = allreduce(x, SUM, comm=c)[0]
        out[f"split/{name}/prod"] = allreduce(x, PROD, comm=c)[0]
        out[f"split/{name}/scan"] = scan(x, SUM, comm=c)[0]
        out[f"split/{name}/bcast"] = bcast(x, 0, comm=c)[0]
        out[f"split/{name}/ring"] = sendrecv(x, x, dest=shift(1), comm=c)[0]
    out["split/eo/allgather"] = allgather(x, comm=splits["eo"])[0]


def ops_program(rank: int, size: int):
    """Every op on the world of ``size`` ranks (and its two-axis grid), the
    point-to-point cases, errors, barrier ordering and the tokenless API."""
    inp = op_inputs(size)
    world = _world(size)
    out = {}
    _collectives(rank, size, world, inp, out)
    if size >= 4:
        _grid_ops(rank, size, inp, out)
    _small_split(rank, size, world, out)
    _point_to_point(rank, size, world, out)
    _roots_and_barrier(rank, size, world, inp, out)
    _notoken(rank, size, world, out)
    _staging.stats.reset()
    allreduce(torch.from_numpy(inp["i"][rank]), BXOR, comm=world)
    out["stats/fold_allreduce"] = _staging.stats.calls
    return out


# ---------------------------------------------------------------------------
# autodiff
# ---------------------------------------------------------------------------


def _grad(fn, x):
    """The gradient of this rank's loss ``fn(x)`` with respect to ``x``."""
    x = x.clone().requires_grad_(True)
    fn(x).backward()
    return x.grad


def _jvp(fn, x, tangent):
    """The forward-mode derivative of ``fn`` at ``x`` along ``tangent``."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        return fwAD.unpack_dual(fn(fwAD.make_dual(x, tangent))).tangent


class _CustomAllreduce(torch.autograd.Function):
    """``allreduce(sum(sin(x) * y))`` with an allreduce in its backward too
    (tests/test_custom_vjp.py:18)."""

    @staticmethod
    def forward(ctx, x, y, comm):
        ctx.save_for_backward(x, y)
        ctx.comm = comm
        return allreduce((torch.sin(x) * y).sum(), SUM, comm=comm)[0]

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = allreduce(g, SUM, comm=ctx.comm)[0]
        return torch.cos(x) * g * y, torch.sin(x) * g, None


def netket_inputs(size: int, n_chains: int = 4):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    xs = (0.5 * rng.standard_normal((size, n_chains, 4))).astype(np.float32)
    return w, xs


def _log_pdf(w, x):
    return torch.sum(x @ w, dim=-1)


def _expected_fun(w, x):
    return torch.exp(torch.sum(x @ w, dim=-1)) - 2


class _Expect(torch.autograd.Function):
    """The NetKet-style expectation of tests/test_custom_vjp.py:54: a mean
    over every rank's chains whose backward differentiates a fresh
    function through another allreduce."""

    @staticmethod
    def forward(ctx, w, x, comm, size):
        l_x = _expected_fun(w, x)
        mean = allreduce(l_x.mean(), SUM, comm=comm)[0] / size
        ctx.save_for_backward(w, x, l_x - mean)
        ctx.comm, ctx.size = comm, size
        return mean

    @staticmethod
    def backward(ctx, dout):
        w, x, dl_x = ctx.saved_tensors
        with torch.enable_grad():
            wg = w.detach().requires_grad_(True)
            term = dl_x * _log_pdf(wg, x) + _expected_fun(wg, x)
            f = allreduce(term.mean(), SUM, comm=ctx.comm)[0] / ctx.size
            (gw,) = torch.autograd.grad(f, wg, dout)
        return gw, None, None, None


def _allreduce_grads(rank, size, world, out):
    """SUM-allreduce's rules (tests/test_allreduce.py:131-227), the matvec
    suite and the custom-backward cases."""
    x = torch.full((3,), float(rank))
    out["ad/allreduce/grad"] = _grad(
        lambda w: allreduce((w ** 2).sum(), SUM, comm=world)[0], torch.arange(4.0) + rank)
    out["ad/allreduce/jvp"] = _jvp(lambda a: allreduce(a, SUM, comm=world)[0],
                                   x, torch.ones(3))
    # linear_transpose x1, x2, x3 as first, second and third backward
    xg = x.clone().requires_grad_(True)
    y = allreduce(xg, SUM, comm=world)[0]
    v = torch.ones(3, requires_grad=True)
    (t1,) = torch.autograd.grad(y, xg, v, create_graph=True)
    u = x.clone().requires_grad_(True)
    (t2,) = torch.autograd.grad(t1, v, u, create_graph=True)
    (t3,) = torch.autograd.grad(t2, u, torch.ones(3))
    out["ad/allreduce/transposes"] = (t1.detach(), t2.detach(), t3)
    # the column-sharded matvec
    _, _, yv, a_sh, x_sh = matvec_inputs(size)
    a_loc, x_loc = torch.from_numpy(a_sh[rank]), torch.from_numpy(x_sh[rank])
    yt = torch.from_numpy(yv)

    def matvec(v):
        return allreduce(a_loc @ v, SUM, comm=world)[0]

    out["ad/matvec/forward"] = matvec(x_loc)
    xg = x_loc.clone().requires_grad_(True)
    mv = matvec(xg)
    c = torch.zeros_like(yt, requires_grad=True)
    (ct,) = torch.autograd.grad(mv, xg, c, create_graph=True)
    out["ad/matvec/transpose"] = torch.autograd.grad(mv, xg, yt, retain_graph=True)[0]
    (dbl,) = torch.autograd.grad(ct, c, x_loc)
    out["ad/matvec/double_transpose"] = dbl
    out["ad/matvec/jvp"] = _jvp(matvec, x_loc, torch.ones_like(x_loc))
    # custom backward through allreduce, in the forward and the backward
    xg = torch.ones(3, requires_grad=True)
    yg = (torch.ones(3) * 2).requires_grad_(True)
    val = _CustomAllreduce.apply(xg, yg, world)
    val.backward()
    out["ad/custom/val"], out["ad/custom/grads"] = val.detach(), (xg.grad, yg.grad)
    w, xs = netket_inputs(size)
    wg = torch.from_numpy(w).requires_grad_(True)
    o = _Expect.apply(wg, torch.from_numpy(xs[rank]), world, size)
    o.backward(torch.ones_like(o))
    out["ad/netket"] = (o.detach(), wg.grad)


def _other_grads(rank, size, world, inp, out):
    """Every other op's reverse and forward mode."""
    x = torch.full((1,), float(rank))
    ones = torch.ones(1)
    sq = lambda t: (t ** 2).sum()  # noqa: E731
    # sendrecv: the gradient, the tangent and the transpose
    out["ad/sendrecv/grad"] = _grad(
        lambda a: sq(sendrecv(a, a, dest=shift(1), comm=world)[0]), x)
    out["ad/sendrecv/jvp"] = _jvp(
        lambda a: sendrecv(a, a, dest=shift(1), comm=world)[0], x, ones)
    xg = x.clone().requires_grad_(True)
    y = sendrecv(xg, xg, dest=shift(1), comm=world)[0]
    out["ad/sendrecv/transpose"] = torch.autograd.grad(y, xg, x)[0]
    out["ad/sendrecv/edge_grad"] = _grad(
        lambda a: sq(sendrecv(a * 3, a, dest=shift(1, wrap=False), comm=world)[0]),
        x + 1)
    # the transpose of the transpose is the forward route again
    c = (x + 2).requires_grad_(True)
    (g1,) = torch.autograd.grad(sendrecv(xg, xg, dest=shift(1), comm=world)[0],
                                xg, c, create_graph=True)
    out["ad/sendrecv/double"] = torch.autograd.grad(g1, c, x + 5)[0]

    def pair(a):
        send(a, shift(1), tag=9, comm=world)
        return sq(recv(a, tag=9, comm=world)[0])

    out["ad/send_recv/grad"] = _grad(pair, torch.full((2,), float(rank)))
    out["ad/send_recv/jvp"] = _jvp(
        lambda a: (send(a, shift(1), tag=10, comm=world),
                   recv(a, tag=10, comm=world)[0])[1], x, x + 1)
    # bcast: cotangents summed onto root
    xb = torch.full((2,), float(rank + 1))
    out["ad/bcast/grad"] = _grad(lambda a: sq(bcast(a, 0, comm=world)[0]), xb)
    out["ad/bcast/jvp"] = _jvp(lambda a: bcast(a, 1, comm=world)[0], xb, xb * 10)
    # reduce_scatter: jvp, transpose (= allgather) and gradient
    blocks = torch.from_numpy(inp["blocks"][rank])
    out["ad/reduce_scatter/jvp"] = _jvp(
        lambda a: reduce_scatter(a, SUM, comm=world)[0], blocks, torch.ones_like(blocks))
    bg = blocks.clone().requires_grad_(True)
    rs = reduce_scatter(bg, SUM, comm=world)[0]
    out["ad/reduce_scatter/transpose"] = torch.autograd.grad(
        rs, bg, torch.full((3,), float(rank)))[0]
    out["ad/reduce_scatter/grad"] = _grad(lambda a: sq(reduce_scatter(a, comm=world)[0]),
                                          blocks)
    out["ad/reduce_scatter/matmul_grad"] = _grad(
        lambda a: sq(reduce_scatter(a, torch.matmul, comm=world)[0]),
        torch.from_numpy(inp["bmats"][rank]))
    # scan: both modes
    xs = torch.tensor([1.0 + rank / max(size - 1, 1)])
    out["ad/scan/grad"] = _grad(lambda a: sq(scan(a, SUM, comm=world)[0]), xs)
    out["ad/scan/jvp"] = _jvp(lambda a: sq(scan(a, SUM, comm=world)[0]), xs, ones)
    # the fold reductions and the rest, as the JAX package differentiates them
    f = torch.from_numpy(inp["f"][rank])
    out["ad/prod/grad"] = _grad(lambda a: sq(allreduce(a, PROD, comm=world)[0]), f)
    out["ad/prod/jvp"] = _jvp(lambda a: allreduce(a, PROD, comm=world)[0], f,
                              torch.ones_like(f))
    out["ad/matmul/grad"] = _grad(
        lambda a: sq(allreduce(a, torch.matmul, comm=world)[0]),
        torch.from_numpy(inp["mats"][rank]))
    out["ad/allgather/grad"] = _grad(
        lambda a: (allgather(a, comm=world)[0] ** 2 * (rank + 1)).sum(), f)
    out["ad/gather/jvp"] = _jvp(lambda a: gather(a, 0, comm=world)[0], f, f * 2)
    out["ad/reduce/grad"] = _grad(
        lambda a: (reduce(a, SUM, 0, comm=world)[0] ** 2 * (rank + 1)).sum(), f)
    out["ad/reduce_prod/grad"] = _grad(
        lambda a: sq(reduce(a, PROD, size - 1, comm=world)[0]), f)
    out["ad/scatter/grad"] = _grad(
        lambda a: (scatter(a, 0, comm=world)[0] ** 2 * (rank + 1)).sum(), blocks)
    out["ad/alltoall/jvp"] = _jvp(lambda a: alltoall(a, comm=world)[0], blocks,
                                  blocks * 3)
    out["ad/alltoall/grad"] = _grad(
        lambda a: (alltoall(a, comm=world)[0] ** 2 * (rank + 1)).sum(), blocks)
    fg = f.clone().requires_grad_(True)
    out["ad/min_max/errors"] = [error(lambda: allreduce(fg, MIN, comm=world)),
                                error(lambda: allreduce(fg, MAX, comm=world))]


def autodiff_program(rank: int, size: int):
    """Reverse and forward mode through every differentiable op."""
    inp = op_inputs(size)
    world = _world(size)
    out = {}
    _allreduce_grads(rank, size, world, out)
    _other_grads(rank, size, world, inp, out)
    flush()
    return out


# ---------------------------------------------------------------------------
# color splits (tests/test_split.py)
# ---------------------------------------------------------------------------

# the unequal 2-group partition and the uniform evens/odds of the JAX suite
COLORS_2 = [0, 1, 1, 0, 1, 0, 1, 1]
COLORS_EO = [r % 2 for r in range(8)]
INT_COLORS = [0, 10, 2, 10, 2, 0, 10, 2]
STR_COLORS = ["b", "a", "b", "a", "a", "b", "a", "b"]


def split_program(rank: int, size: int):
    """Every color-split case on a world of 8 ranks."""
    world = _world(size)
    x = torch.tensor([float(rank)])
    out = {}
    split = world.Split(COLORS_2)
    uniform = world.Split(COLORS_EO)
    out["groups"] = {
        "COLORS_2": split.groups, "EO": uniform.groups,
        "keyed": world.Split([0] * size, key=list(range(size))[::-1]).groups,
        "nested": split.Split([r % 2 for r in range(size)]).groups,
        "int": world.Split(INT_COLORS).groups,
        "int_nested": world.Split(INT_COLORS).Split(
            [10 if r % 2 else 2 for r in range(size)]).groups,
        "str": world.Split(STR_COLORS).groups,
    }
    out["kinds"] = type(split).__name__
    out["rank_size"] = (split.Get_rank(), uniform.Get_size(),
                        error(split.Get_size))
    # the reductions on unequal groups
    out["unequal/sum"] = allreduce(x, SUM, comm=split)[0]
    out["unequal/max"] = allreduce(x, MAX, comm=split)[0]
    out["unequal/bcast"], tok = bcast(x, 1, comm=split)
    out["unequal/reduce"], tok = reduce(x, SUM, 0, comm=split, token=tok)
    out["unequal/scan"] = scan(x, SUM, comm=split)[0]
    barrier(comm=split)
    # p2p on unequal groups: a ring per group
    y, t = sendrecv(x, x, dest=shift(1), comm=split)
    t = send(x, shift(-1), tag=3, comm=split, token=t)
    z, _ = recv(x, source=shift(1), tag=3, comm=split, token=t)
    out["unequal/ring"] = (y, z)
    out["unequal/dict_error"] = error(lambda: sendrecv(x, x, dest={0: 3}, comm=split))
    out["unequal/gather_error"] = [error(lambda: allgather(x, comm=split)),
                                   error(lambda: alltoall(x.repeat(2, 1), comm=split)),
                                   error(lambda: reduce_scatter(x.repeat(2, 1),
                                                                comm=split))]
    # uniform groups: every op
    out["uniform/sendrecv"] = sendrecv(x, x, dest=shift(1), comm=uniform)[0]
    s = Status()
    t = send(x, shift(1), tag=2, comm=uniform)
    out["uniform/recv"] = recv(x, tag=2, comm=uniform, status=s, token=t)[0]
    out["uniform/source"] = s.Get_source()
    out["uniform/allgather"] = allgather(x, comm=uniform)[0]
    out["uniform/gather"] = gather(x, 1, comm=uniform)[0]
    out["uniform/scan"] = scan(x, SUM, comm=uniform)[0]
    gs = size // 2
    rows = 10.0 * rank + torch.arange(gs, dtype=torch.float32)
    out["uniform/alltoall"] = alltoall(rows, comm=uniform)[0]
    out["uniform/scatter"] = scatter(rows, 2, comm=uniform)[0]
    out["uniform/reduce_scatter"] = reduce_scatter(rows.reshape(gs, 1),
                                                   comm=uniform)[0]
    mats = torch.from_numpy(np.random.default_rng(1).normal(
        size=(size, 2, 2)).astype(np.float32)[rank])
    out["uniform/matmul"] = allreduce(mats, torch.matmul, comm=uniform)[0]
    # the gradient through a group allreduce
    xg = torch.full((1,), float(rank + 1), requires_grad=True)
    (allreduce(xg, SUM, comm=split)[0] ** 2).sum().backward()
    out["unequal/grad"] = xg.grad
    xg = torch.full((1,), float(rank + 1), requires_grad=True)
    (allreduce(xg, PROD, comm=split)[0] ** 2).sum().backward()
    out["unequal/prod_grad"] = xg.grad
    # nested: allreduce within the refined groups
    nested = split.Split([r % 2 for r in range(size)])
    out["nested/sum"] = allreduce(x, SUM, comm=nested)[0]
    out["nested/errors"] = [error(lambda: split.Split("x")),
                            error(lambda: split.Split([0, 1])),
                            error(lambda: split.sub("x"))]
    out["validation"] = [error(lambda: world.Split([0, 1])),
                         error(lambda: world.Split([0] * size, key=[0])),
                         error(lambda: uniform.Split([0] * (size // 2)))]
    # Clone and bind keep the groups; Clone isolates matching
    clone = uniform.Clone()
    bound = split.bind(split.mesh)
    out["clone"] = (type(clone).__name__, clone.groups == uniform.groups,
                    clone.uid != uniform.uid, bound.groups == split.groups,
                    bound.uid == split.uid)
    send(x, shift(1), comm=clone)
    out["clone/isolated"] = error(lambda: recv(x, comm=uniform))
    out["clone/recv"] = recv(x, comm=clone)[0]
    out["bound/sum"] = allreduce(x, SUM, comm=bound)[0]
    # the grid form on a two-axis comm
    grid = Comm(("sy", "sx"), mesh=make_world_mesh((2, size // 2), ("sy", "sx"),
                                                   device="cpu"))
    rows_comm = grid.Split("sy")
    out["grid_split"] = (rows_comm.axes, type(rows_comm).__name__,
                         allreduce(x, SUM, comm=rows_comm)[0])
    flush()
    return out


# ---------------------------------------------------------------------------
# ring attention, op by op
# ---------------------------------------------------------------------------

# the JAX suite's gradient shapes (tests/test_long_context.py:29)
RING = {"b": 2, "t_loc": 16, "h": 4, "d": 32}


def ring_inputs(size: int) -> np.ndarray:
    """q, k and v of every rank, ``(3, size, B, T_loc, H, D)`` f32: three
    distinct draws, so that a swap of dK and dV shows."""
    rng = np.random.default_rng(17)
    r = RING
    return rng.standard_normal((3, size, r["b"], r["t_loc"], r["h"], r["d"]),
                               dtype=np.float32)


def ring_program(rank: int, size: int):
    """``ring_attention`` causal and not, op by op and memory-efficient:
    this rank's output, its q, k and v gradients of the sum over ranks of
    ``sum(out**2)``, and the exchanges of the forward and of the
    backward."""
    world = _world(size, "sp")
    shards = ring_inputs(size)[:, rank]
    out = {}
    for causal in (True, False):
        for me in (False, True):
            q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in shards)
            _staging.stats.reset()
            o = ring_attention(q, k, v, comm=world, causal=causal,
                               memory_efficient_grad=me)
            forward = _staging.stats.calls
            (o ** 2).sum().backward()
            key = f"{'causal' if causal else 'full'}/{'me' if me else 'plain'}"
            out[key] = (o.detach(), q.grad, k.grad, v.grad)
            out[f"{key}/exchanges"] = (forward, _staging.stats.calls - forward)
    q, k, v = (torch.from_numpy(a) for a in shards)
    out["jvp"] = _jvp(lambda a: ring_attention(a, k, v, comm=world, causal=True,
                                               memory_efficient_grad=False), q,
                      torch.ones_like(q))
    return out
