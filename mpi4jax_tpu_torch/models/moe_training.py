"""Expert-parallel MoE training on the ``alltoall`` path.

The twin of ``examples/moe_training.py``: ``k`` ranks each own one
expert, a seeded top-1 gate routes tokens, and the layer's two exchanges
are alltoalls (``parallel/moe.py``): the capacity-bucketed dispatch, the
per-expert MLP, then the combine, issued with ``alltoall_start`` so that
each capacity chunk's combine overlaps the next chunk's expert compute.
Three stages, as in the JAX example:

1. **pin**: the overlapped layer (``chunks`` capacity chunks) equals the
   synchronous one (``chunks=1``) bit for bit;
2. **train**: ``steps`` SGD steps through the synchronous layer, the
   router's gradient averaged over the ranks with a SUM ``allreduce`` (it
   is replicated), each expert's kept local; the losses must decrease;
3. **counters**: the ``alltoall`` rows of the telemetry counters over one
   overlapped forward, split by link class: under a faked topology
   (``MPI4JAX_TPU_TOPOLOGY=2x2`` on 4 ranks) the exchanges land modeled
   bytes on both the ``intra_host`` and the ``inter_host`` class once the
   payload reaches ``MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES`` (the
   hierarchical alltoall, ``ops/_hierarchy.py``); on one host every byte
   is intra-host.

The inputs are the JAX example's (``build_inputs``: the same numpy seed,
the same weights), so the losses match its run on as many devices.  The
width is a parameter (``main(tokens=, d=, d_ff=)``).  ``main`` runs on
every rank of a world that ``parallel/launch.py:run`` started:

    python -m mpi4jax_tpu_torch.models.moe_training --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import SUM, Comm, allreduce, make_world_mesh, telemetry
from ..parallel import moe
from ..parallel.region import spmd
from ..utils import config

TOKENS = 32
D = 16
D_FF = 32
SEED = 7
STEPS = 4
LR = 0.05


def build_inputs(n: int, tokens: int = TOKENS, d: int = D, d_ff: int = D_FF,
                 seed: int = SEED):
    """Every rank's tokens ``x`` and targets ``tgt`` (``(n, tokens, d)``)
    and parameters (one :class:`moe.MoEParams` a rank), numpy f32, drawn
    as the JAX example draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, tokens, d)).astype(np.float32)
    tgt = rng.standard_normal((n, tokens, d)).astype(np.float32) * 0.1
    params = [moe.init_moe_params(d, d_ff, n, rank=r, seed=seed)
              for r in range(n)]
    return x, tgt, params


def forward(comm: Comm, x, params: moe.MoEParams, chunks: int):
    """The layer's output on this rank, ``chunks`` capacity chunks."""

    @spmd(comm=comm)
    def prog(xv):
        return moe.moe_layer(xv, params, comm=comm, chunks=chunks)[0]

    return prog(x)


def make_train_step(comm: Comm, lr: float):
    """One SGD step through the synchronous layer: ``(loss, params)``, the
    loss averaged over the ranks."""
    n = comm.Get_size()

    @spmd(comm=comm)
    def train_step(x, tgt, params):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            y, _ = moe.moe_layer(x, moe.MoEParams(*leaves), comm=comm, chunks=1)
            loss = torch.mean((y - tgt) ** 2)
            g_gate, g_in, g_out = torch.autograd.grad(loss, leaves)
        # the router is replicated: average its gradient; the expert's
        # weights are this rank's, their gradients stay local
        g_gate, tok = allreduce(g_gate, op=SUM, comm=comm)
        loss_g, _ = allreduce(loss.detach(), op=SUM, comm=comm, token=tok)
        with torch.no_grad():
            new = moe.MoEParams(params.w_gate - lr * g_gate * (1.0 / n),
                                params.w_in - lr * g_in,
                                params.w_out - lr * g_out)
        return loss_g * (1.0 / n), new

    return train_step


def alltoall_rows(snapshot: dict) -> list:
    """The ``alltoall`` rows (and its start and wait) of a telemetry
    snapshot."""
    return [row for _key, row in sorted(snapshot["ops"].items())
            if row["op"].startswith("alltoall")]


def main(device=None, *, tokens: int = TOKENS, d: int = D, d_ff: int = D_FF,
         steps: int = STEPS, lr: float = LR, seed: int = SEED,
         chunks: int = 2):
    """The three stages on this rank; raises where the pin fails or the
    losses do not decrease.  Returns ``y_sync``, ``y_ovl``, ``losses``,
    ``capacity``, ``experts``, ``rows`` (stage 3's counters) and
    ``params`` (this rank's weights after the steps)."""
    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    dev, n, rank = mesh.device, comm.Get_size(), comm.Get_rank()
    x_all, tgt_all, params_all = build_inputs(n, tokens, d, d_ff, seed)
    x = torch.from_numpy(x_all[rank]).to(dev)
    tgt = torch.from_numpy(tgt_all[rank]).to(dev)
    params = moe.MoEParams(*(torch.from_numpy(p).to(dev)
                             for p in params_all[rank]))
    cap = moe.capacity_for(tokens, n)

    # 1. the pin: the overlapped layer is the synchronous one, bit for bit
    y_sync = forward(comm, x, params, 1)
    y_ovl = forward(comm, x, params, chunks)
    if not torch.equal(y_sync, y_ovl):
        raise AssertionError(
            f"overlapped combine ({chunks} chunks) differs from the "
            f"synchronous layer by {(y_sync - y_ovl).abs().max().item():.3e}")

    # 2. train
    train_step = make_train_step(comm, lr)
    losses = []
    for _ in range(steps):
        loss, params = train_step(x, tgt, params)
        losses.append(float(loss))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the losses do not decrease: {losses}")

    # 3. the alltoall traffic under counters
    telemetry.set_telemetry_mode("counters")
    try:
        telemetry.reset()
        forward(comm, x, params, chunks)
        rows = alltoall_rows(telemetry.snapshot())
    finally:
        telemetry.set_telemetry_mode(None)
        telemetry.reset()

    if rank == 0:
        print(f"pin: overlapped combine ({chunks} capacity chunks) bit-identical "
              f"to the synchronous layer ({n} experts, capacity {cap})")
        print("train: losses " + " -> ".join(f"{v:.5f}" for v in losses))
        for row in rows:
            print(f"telemetry: {row['op']} algo={row['algo'] or '-'} "
                  f"calls={row['calls']} intra_host={row['intra_bytes']} B "
                  f"inter_host={row['inter_bytes']} B")
        spec = config.topology_spec() or "one host"
        print(f"telemetry: link classes ({spec}): intra_host="
              f"{sum(r['intra_bytes'] for r in rows)} B inter_host="
              f"{sum(r['inter_bytes'] for r in rows)} B over "
              f"{sum(r['calls'] for r in rows)} calls")
    return {"y_sync": y_sync, "y_ovl": y_ovl, "losses": losses,
            "capacity": cap, "experts": n, "rows": rows,
            "params": params._asdict()}


def rank_main(rank: int, device, kwargs: dict = None):
    """``main`` on one rank of a ``launch.run`` world."""
    return main(device, **(kwargs or {}))


if __name__ == "__main__":
    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device every rank shares")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--d", type=int, default=D)
    ap.add_argument("--d-ff", type=int, default=D_FF)
    a = ap.parse_args()
    launch.run(rank_main, a.ranks, backend="gloo", device=a.device, timeout=600,
               args=(a.device, {"steps": a.steps, "tokens": a.tokens, "d": a.d,
                                "d_ff": a.d_ff}))
