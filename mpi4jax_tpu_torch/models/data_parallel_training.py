"""Data-parallel SGD with an error-feedback gradient allreduce.

The twin of ``examples/data_parallel_training.py``: a small MLP
(16 -> 64 -> 1, ReLU) regresses ``tanh(x @ w_true)``; each rank holds 64
rows of the batch and the same weights.  A step (``make_train_step``)
computes the rank's loss and gradients, sends the gradients through
``compress.ef_allreduce`` (SUM, the error-feedback residual in the train
state), allreduces the loss on its token, and updates every weight by
``lr * g / size``, so the weights stay in lock-step on every rank without
a broadcast.  The step is a region (``spmd``): under
``set_fusion_mode("auto")``, which ``main`` sets as the JAX example does,
the four gradient allreduces and the loss's are issued before any is
used and go out as one packed collective.  With
``MPI4JAX_TPU_COMPRESS=off`` (the default) the residual stays exactly
zero; under ``bf16`` or ``fp8`` it carries each step's rounding into the
next.  The port's codec changes the values, not the bytes the exchange
moves (no multi-host lowering yet).

``main`` runs on every rank of a world that ``parallel/launch.py:run``
started, or alone as a world of one:

    python -m mpi4jax_tpu_torch.models.data_parallel_training --ranks 4 --device cpu

The weights come from a CPU ``torch.Generator`` seeded with ``seed`` (the
JAX example's ``init_mlp`` draws others with ``jax.random``; carry those
across with ``convert.mlp_params_from_jax``); the data from a numpy seed,
one shard a rank.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import SUM, Comm, allgather, allreduce, compress, make_world_mesh
from ..ops import _staging
from ..ops._fusion import set_fusion_mode
from ..parallel.region import spmd
from ..utils.tree import tree_flatten, tree_leaves, tree_map

SIZES = (16, 64, 1)
PER_RANK = 64
LR = 1e-2


def init_mlp(sizes, *, generator: torch.Generator = None, device=None):
    """A list of ``{"w", "b"}`` layers with the JAX example's shapes and
    scales: ``w`` normal times ``sqrt(2 / fan_in)``, ``b`` zeros; drawn on
    ``generator`` (CPU) and moved to ``device``."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator) * (2.0 / fan_in) ** 0.5
        params.append({"w": w.to(device), "b": torch.zeros(fan_out, device=device)})
    return params


def mlp_apply(params, x):
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return x @ last["w"] + last["b"]


def local_loss(params, x, y):
    return torch.mean((mlp_apply(params, x) - y) ** 2)


def value_and_grad(params, x, y):
    """The loss of ``params`` on ``(x, y)`` and its gradient tree."""
    flat, unflatten = tree_flatten(params)
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in flat]
        loss = local_loss(unflatten(leaves), x, y)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(list(grads))


def make_train_step(comm: Comm, lr: float):
    """``step(params, residual, x, y) -> (params, residual, loss)``: one
    DP-SGD step over ``comm``, the loss averaged over the ranks."""
    size = comm.Get_size()

    @spmd(comm=comm)
    def train_step(params, residual, x, y):
        loss, grads = value_and_grad(params, x, y)
        # every allreduce is issued before any result is used: under
        # fusion they go out as one packed collective
        red, residual, token = compress.ef_allreduce(grads, residual, op=SUM,
                                                     comm=comm)
        loss = allreduce(loss, op=SUM, comm=comm, token=token)[0] / size
        with torch.no_grad():
            new = tree_map(lambda p, g: p - lr * (g / size), params, red)
        return new, residual, loss

    return train_step


def sgd_steps(params, x, y, steps: int, lr: float):
    """``steps`` plain SGD steps of ``local_loss`` on one device: on the
    concatenated batch, what DP over equal shards must equal."""
    for _ in range(steps):
        _, grads = value_and_grad(params, x, y)
        with torch.no_grad():
            params = tree_map(lambda p, g: p - lr * g, params, grads)
    return params


def train_data(seed: int, size: int):
    """Every rank's shard, ``x`` (size, 64, 16) and ``y = tanh(x @ w_true)``
    (size, 64, 1), f32 numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((size, PER_RANK, SIZES[0]), dtype=np.float32)
    w_true = rng.standard_normal((SIZES[0], 1), dtype=np.float32)
    return x, np.tanh(x @ w_true)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_lockstep(params, comm: Comm) -> None:
    """Raise unless every rank holds the same weights (rtol 1e-6, the JAX
    example's check)."""
    for leaf in tree_leaves(params):
        every = allgather(leaf, comm=comm)[0].cpu().numpy()
        np.testing.assert_allclose(every, np.broadcast_to(every[0], every.shape),
                                   rtol=1e-6)


def main(steps: int = 200, seed: int = 0, out: str = "", device=None,
         fusion: str = "auto"):
    """Train ``steps`` steps on this rank's shard under ``fusion``
    (``set_fusion_mode``, reset at the end) and the codec of
    ``MPI4JAX_TPU_COMPRESS``; check the lock-step; rank 0 writes the loss
    curve to ``out`` as JSON.  Returns ``losses`` (the global loss of each
    step), ``params`` and ``params0`` (the weights after and before),
    ``wall`` (seconds a step, synchronised), ``exchange`` (each step's
    calls, staged bytes and seconds of ``ops/_staging.stats``),
    ``compress``, ``fusion`` and ``world``."""
    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    dev, size, rank = mesh.device, comm.Get_size(), comm.Get_rank()
    x, y = (torch.from_numpy(a[rank]).to(dev) for a in train_data(seed, size))
    params0 = init_mlp(SIZES, generator=torch.Generator().manual_seed(seed),
                       device=dev)
    params, residual = params0, compress.ef_zeros_like(params0)
    train_step = make_train_step(comm, lr=LR)
    res = {"losses": [], "wall": [], "exchange": []}
    set_fusion_mode(fusion)
    try:
        for step in range(steps):
            _staging.stats.reset()
            _sync(dev)
            start = time.perf_counter()
            params, residual, loss = train_step(params, residual, x, y)
            _sync(dev)
            res["wall"].append(time.perf_counter() - start)
            res["exchange"].append({"calls": _staging.stats.calls,
                                    "staged_bytes": _staging.stats.staged_bytes,
                                    "seconds": _staging.stats.seconds})
            res["losses"].append(loss.item())
            if rank == 0 and (step % 50 == 0 or step == steps - 1):
                print(f"step {step:4d}  loss {res['losses'][-1]:.5f}")
    finally:
        set_fusion_mode(None)
    check_lockstep(params, comm)
    mode = compress.compress_mode()
    if out and rank == 0:
        with open(out, "w") as f:
            json.dump({"compress": mode, "steps": steps, "seed": seed,
                       "world": size, "losses": res["losses"]}, f, indent=2)
    if rank == 0:
        print(f"{steps} steps on {size} rank(s) in {sum(res['wall']):.2f}s "
              f"(compress={mode}, fusion={fusion}): weights in lock-step on "
              "all ranks")
    res.update(params=params, params0=params0, compress=mode, fusion=fusion,
               world=size)
    return res


def rank_main(rank: int, device, kwargs: dict, env: dict = None):
    """``main`` on one rank of a ``launch.run`` world; ``env`` sets this
    rank process's knobs (``MPI4JAX_TPU_COMPRESS``, ...) first."""
    os.environ.update(env or {})
    return main(device=device, **kwargs)


if __name__ == "__main__":
    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device every rank shares")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="write the per-step loss curve as JSON here")
    a = ap.parse_args()
    launch.run(rank_main, a.ranks, backend="gloo", device=a.device, timeout=600,
               args=(a.device, {"steps": a.steps, "seed": a.seed, "out": a.out}))
