"""Rank programs of the kernel entry points under ``torch.func``.

``tests/test_torch_kernel_transforms.py`` starts them through
``mpi4jax_tpu_torch.parallel.launch.run`` (gloo ranks on the CPU).  The
case tables name each attention run once, as a function of the attention
namespace (the port's ``mpi4jax_tpu_torch.attention`` here, the JAX
package's in the test), so both sides run the same program.  This module
imports only torch, numpy and the port.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacrev, jvp, vjp, vmap

import mpi4jax_tpu_torch as M
from mpi4jax_tpu_torch import attention as TA
from mpi4jax_tpu_torch.models import shallow_water as P

LANES = 2  # the vmapped batch
# rank-local attention shards (B, T_loc, H, D): small, so that jacrev's
# B*T*H*D cotangent lanes stay cheap; H divisible by 4 ranks for Ulysses
ATT = {"b": 1, "t_loc": 4, "h": 4, "d": 32}
# (name, scheme, causal, memory_efficient_grad)
ATT_RUNS = [("ring/me/full", "ring", False, True), ("ring/me/causal", "ring", True, True),
            ("ring/op/full", "ring", False, False), ("ring/op/causal", "ring", True, False),
            ("ulysses/full", "ulysses", False, None), ("ulysses/causal", "ulysses", True, None)]
# the (2, 2) ensemble: (mode, periodic); sw_wide, sw_phase
SW_RUNS = [("wide2", True), ("wide", False), ("pallas_halo", False), ("pallas_halo", True)]
SW_SIZE = (64, 32)
SW_STEPS = 3  # after the first step


def attention_fn(ns, comm, scheme, causal, me):
    """The run as ``f(q, k, v)`` in attention namespace ``ns``."""
    if scheme == "ring":
        return lambda q, k, v: ns.ring_attention(q, k, v, comm=comm, causal=causal,
                                                 memory_efficient_grad=me)
    return lambda q, k, v: ns.ulysses_attention(q, k, v, comm=comm, causal=causal)


def attention_inputs(size):
    """Every rank's lanes of q, k, v and of a cotangent and a tangent,
    ``(size, LANES, B, T_loc, H, D)`` f32 from a fixed seed."""
    rng = np.random.default_rng(2800 + size)
    shape = (size, LANES, ATT["b"], ATT["t_loc"], ATT["h"], ATT["d"])
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("q", "k", "v", "ct", "tan")}


def error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001  the message is compared
        return f"{type(e).__name__}: {e}"
    return ""


def attention_program(rank, size):
    """Every run of ``ATT_RUNS`` under ``vmap``, ``vmap(grad)``, ``vjp``,
    ``jacrev`` and ``jvp`` on this rank, and each lane's unbatched run."""
    comm = M.Comm("sp", mesh=M.make_world_mesh((size,), ("sp",), device="cpu"))
    x = {k: torch.from_numpy(a[rank]) for k, a in attention_inputs(size).items()}
    q, k, v = x["q"], x["k"], x["v"]
    out = {}
    for name, scheme, causal, me in ATT_RUNS:
        f = attention_fn(TA, comm, scheme, causal, me)

        def loss(q, k, v, f=f):
            return (f(q, k, v) ** 2).sum()

        out[f"{name}/vmap"] = vmap(f)(q, k, v)
        out[f"{name}/lanes"] = torch.stack([f(q[i], k[i], v[i]) for i in range(LANES)])
        out[f"{name}/vmap_grad"] = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
        out[f"{name}/grad_lanes"] = tuple(torch.stack(g) for g in zip(*(
            grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i]) for i in range(LANES))))
        primal, pull = vjp(f, q[0], k[0], v[0])
        out[f"{name}/vjp"] = (primal, *pull(x["ct"][0]))
        out[f"{name}/jacrev"] = jacrev(f)(q[0], k[0], v[0])
        out[f"{name}/jvp_error"] = error(
            lambda f=f: jvp(f, (q[0], k[0], v[0]), (x["tan"][0], k[0], v[0])))
        if not out[f"{name}/jvp_error"]:
            out[f"{name}/jvp"] = jvp(f, (q[0], k[0], v[0]), (x["tan"][0], k[0], v[0]))
    return out


def sw_config(grid, periodic):
    return P.Config(nx=SW_SIZE[0], ny=SW_SIZE[1], nproc_y=grid[0], nproc_x=grid[1],
                    periodic_x=periodic)


def ensemble(cfg, rank, device="cpu"):
    """Two members of this rank's block: the initial state, and the same
    10 cm higher, stacked on a leading dim."""
    s = P.initial_state(cfg, rank=rank, device=device)
    return P.State(*(torch.stack([f, f + 0.1 if i == 0 else f])
                     for i, f in enumerate(s)))


def vmapped_run(cfg, comm, mode, states, steps=SW_STEPS):
    """``make_stepper(fast=mode)``'s first step and ``steps`` more, under
    ``torch.func.vmap`` over the members, and each member alone."""
    first, multi = P.make_stepper(cfg, comm, fast=mode)

    def run(*fields):
        return tuple(multi(first(P.State(*fields)), steps))

    batched = vmap(run)(*states)
    alone = [run(*(f[i] for f in states)) for i in range(states[0].shape[0])]
    return batched, tuple(torch.stack(f) for f in zip(*alone))


def stepper_program(rank, grid):
    """Each run of ``SW_RUNS`` on ``grid``: the vmapped ensemble and its
    members alone."""
    out = {}
    for mode, periodic in SW_RUNS:
        cfg = sw_config(grid, periodic)
        _, comm = P.make_mesh_and_comm(cfg, device="cpu")
        out[f"{mode}/{periodic}"] = vmapped_run(cfg, comm, mode, ensemble(cfg, rank))
    return out
