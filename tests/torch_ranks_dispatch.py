"""Rank programs of the dispatch layer's parity tests.

Each function runs on every rank of a ``mpi4jax_tpu_torch.parallel.launch``
world of gloo ranks on the CPU (or, with ``size`` 1, in the test process
itself); like ``torch_ranks.py`` this module imports no JAX, since every
rank imports it afresh.  ``tests/test_torch_megastep.py`` and
``tests/test_torch_aot.py`` run the same steps through the JAX package's
``mpx.compile``/``mpx.spmd`` on the same seeded inputs and compare.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi4jax_tpu_torch import (
    SUM,
    Comm,
    allreduce,
    allreduce_start,
    allreduce_wait,
    bcast,
    compile,
    create_token,
    get_default_comm,
    make_world_mesh,
    set_fusion_mode,
    spmd,
)
from mpi4jax_tpu_torch.models import shallow_water as P
from mpi4jax_tpu_torch.ops import _staging

UNROLL = 4
GAIN = 0.125
# the solver's megastep cases: 11 steps after the first, two megasteps of
# 4 and a tail of 3
SOLVE_STEPS, SOLVE_UNROLL = 12, 4
SOLVE_SIZE = (64, 32)  # nx, ny: a (2,2) rank's interior fits wide2's 16 cells


def world(size: int) -> Comm:
    return Comm("x", mesh=make_world_mesh((size,), ("x",), device="cpu"))


def inputs(size: int) -> dict:
    """Every rank's inputs, ``(size, ...)`` f32 from a fixed seed."""
    rng = np.random.default_rng(41)
    return {"x": rng.standard_normal((size, 6), dtype=np.float32),
            "a": rng.standard_normal((size, 4), dtype=np.float32),
            "b": rng.standard_normal((size, 4), dtype=np.float32),
            "v": rng.standard_normal((size, 4), dtype=np.float32),
            "w": rng.standard_normal((size, 2), dtype=np.float32)}


# -- the steps, each the port's twin of the JAX suite's (tests/test_megastep.py)


def step_plain(v):
    s, _ = allreduce(v, op=SUM)
    return s * 0.25 + v * 0.5


def step_token(v):
    tok = create_token()
    s, tok = allreduce(v, op=SUM, token=tok)
    b, tok = bcast(s, 0, token=tok)
    return b * 0.25 + v * 0.5


def step_fusion(pair):
    """Both allreduces issued, then used: one bucket an iteration under
    fusion."""
    a, b = pair
    k = get_default_comm().Get_size()
    ra = allreduce(a, op=SUM)[0]
    rb = allreduce(b, op=SUM)[0]
    return (ra * (1.0 / k), rb * (1.0 / k))


def step_async(v):
    k = get_default_comm().Get_size()
    h, _ = allreduce_start(v, op=SUM)
    w = torch.tanh(v)  # compute in the gap
    s, _ = allreduce_wait(h)
    return s * (1.0 / k) + w * 0.0


def step_statics(v, gain, w):
    s, _ = allreduce(v, op=SUM)
    return (s * gain, w + 1.0)


def _eager(fn, carry, n: int, comm):
    """``n`` calls of the single-step region, each output the next input."""
    single = spmd(fn, comm=comm)
    for _ in range(n):
        carry = single(carry)
    return carry


def megastep_runs(rank: int, size: int) -> dict:
    """Each step as ``compile(unroll=UNROLL)``, ``spmd(unroll=UNROLL)`` and
    ``UNROLL`` eager region calls; the statics case with its static gain;
    and ``unroll=1`` against a call without the layer, with the exchanges
    each made."""
    comm = world(size)
    x = {k: torch.from_numpy(np.ascontiguousarray(a[rank]))
         for k, a in inputs(size).items()}
    out = {}
    for name, fn in (("plain", step_plain), ("token", step_token),
                     ("async", step_async)):
        out[f"{name}/compile"] = compile(fn, x["x"], comm=comm, unroll=UNROLL)(x["x"])
        out[f"{name}/spmd"] = spmd(fn, comm=comm, unroll=UNROLL)(x["x"])
        out[f"{name}/eager"] = _eager(fn, x["x"], UNROLL, comm)

    set_fusion_mode("auto")
    try:
        pair = (x["a"], x["b"])
        out["fusion/compile"] = compile(step_fusion, pair, comm=comm, unroll=UNROLL)(pair)
        out["fusion/eager"] = _eager(step_fusion, pair, UNROLL, comm)
    finally:
        set_fusion_mode(None)

    mega = spmd(step_statics, comm=comm, static_argnums=(1,), unroll=UNROLL)
    out["statics/spmd"] = mega(x["v"], GAIN, x["w"])
    pinned = compile(step_statics, x["v"], GAIN, x["w"], comm=comm,
                     static_argnums=(1,), unroll=UNROLL)
    out["statics/compile"] = pinned(x["v"], x["w"])
    single = spmd(step_statics, comm=comm, static_argnums=(1,))
    cv, cw = x["v"], x["w"]
    for _ in range(UNROLL):
        cv, cw = single(cv, GAIN, cw)
    out["statics/eager"] = (cv, cw)

    # unroll=1: the same exchanges and bits as a call without the layer
    for name, fn in (("region", spmd(step_plain, comm=comm)),
                     ("spmd1", spmd(step_plain, comm=comm, unroll=1)),
                     ("compile1", compile(step_plain, x["x"], comm=comm, unroll=1))):
        calls = _staging.stats.calls
        out[f"unroll1/{name}"] = fn(x["x"])
        out[f"unroll1/{name}/exchanges"] = torch.tensor(_staging.stats.calls - calls)
    return out


def solve_runs(rank: int, grid) -> dict:
    """``solve_fused(fast="wide2", unroll=SOLVE_UNROLL)`` over
    ``SOLVE_STEPS`` steps on ``grid`` (periodic), beside the whole run."""
    cfg = P.Config(nx=SOLVE_SIZE[0], ny=SOLVE_SIZE[1], nproc_y=grid[0],
                   nproc_x=grid[1])
    out = {}
    info = {}
    _, n, state = P.solve_fused(cfg, SOLVE_STEPS * cfg.dt, num_multisteps=1,
                                fast="wide2", unroll=SOLVE_UNROLL, return_state=True,
                                device="cpu", info=info)
    out["solve/unroll"] = tuple(state)
    out["solve/n"] = torch.tensor(n)
    out["solve/info"] = torch.tensor([info["unroll"], info["runs"], int(info["pinned"])])
    _, _, whole = P.solve_fused(cfg, SOLVE_STEPS * cfg.dt, num_multisteps=1,
                                fast="wide2", return_state=True, device="cpu")
    out["solve/whole"] = tuple(whole)
    return out


def dispatch_program(rank: int, size: int) -> dict:
    """Every multi-rank case of the dispatch layer on a world of ``size``
    ranks (the (2,2) solve on four)."""
    out = megastep_runs(rank, size)
    if size == 4:
        out.update(solve_runs(rank, (2, 2)))
    return out
