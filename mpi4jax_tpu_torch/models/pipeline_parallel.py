"""Pipeline parallelism: the naive ladder against the compiled schedules.

The twin of ``examples/pipeline_parallel.py``: one pipeline stage per
rank, a model of two ``tanh(h @ w)`` substages a rank (so the interleaved
schedule has real virtual stages), and five forms of the same forward
pass, each held bit for bit against a sequential single-process
reference:

- the naive ladder: the whole batch crawls stage to stage over matched
  ``send``/``recv`` pairs, ``S - 1`` serialized hops;
- ``pipeline(..., schedule="gpipe")``: the wavefront, ``M`` microbatches
  injected one a tick over a blocking ``sendrecv`` boundary;
- ``pipeline(..., schedule="1f1b")``: the boundary through
  ``send_start``/``recv_start``/``p2p_wait``, the steady window one
  megastep loop;
- ``pipeline(..., schedule="interleaved", virtual=2)``: rank ``r`` owns
  substages ``r`` and ``S + r``, the boundary is a ring;
- ``pipeline(...)`` with ``schedule="auto"`` (the port's fixed rule until
  the cost model is ported: ``1f1b`` here, ``parallel/pipeline.py``).

The reference applies every substage in order per microbatch, as the
schedules compute on microbatch slices; the ladder computes on the whole
batch, so its reference is the same fold over the whole batch (one
"microbatch"), products of its shapes.  The JAX example's ladder passes
``recv(source={s - 1: s})``, which reads "rank ``s - 1`` receives from
``s``" and which the JAX package itself refuses against the send's
``dest={s - 1: s}`` (a ``ValueError`` at the first hop); the twin passes
the receiver-centric ``{s: s - 1}``.  The JAX example's MPX135
``analyze`` call on the ladder waits for the analysis layer (ROADMAP
Queue 1 item 6).  Width, stages (the world) and microbatches are
parameters; ``main`` runs on every rank of a world that
``parallel/launch.py:run`` started:

    python -m mpi4jax_tpu_torch.models.pipeline_parallel --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import Comm, make_world_mesh, recv, send
from ..parallel.pipeline import pipeline, split_microbatches
from ..parallel.region import spmd

MICROBATCHES = 16
BATCH, DIM = 32, 8
SEED = 0


def substage(h, w):
    """One model substage: a linear layer and ``tanh``."""
    return torch.tanh(h @ w)


def stage_pair(h, w2):
    """One stage of the flat schedules: the rank's two substages in
    order (``w2`` is ``(2, DIM, DIM)``)."""
    return substage(substage(h, w2[0]), w2[1])


def build_inputs(stages: int, batch: int = BATCH, dim: int = DIM,
                 seed: int = SEED):
    """The batch ``x0`` (``(batch, dim)``) and the ``2 * stages`` substage
    weights (``(2 S, dim, dim)``), numpy f32, drawn as the JAX example
    draws them."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(batch, dim)).astype(np.float32)
    ws = (rng.normal(size=(2 * stages, dim, dim)) * 0.5).astype(np.float32)
    return x0, ws


def stage_weights(ws, stages: int, rank: int):
    """Rank ``rank``'s weights: its substage pair under the flat schedules
    (``ws[2 r : 2 r + 2]``), and its interleaved chunks (chunk ``c`` is
    substage ``c * S + r``)."""
    dim = ws.shape[-1]
    pair = ws.reshape(stages, 2, dim, dim)[rank]
    chunks = ws.reshape(2, stages, dim, dim)[:, rank]
    return pair, chunks


def reference(x0, ws, microbatches: int):
    """Every substage in order, applied per microbatch; ``(B, dim)``."""
    outs = []
    for h in split_microbatches(x0, microbatches):
        for k in range(ws.shape[0]):
            h = substage(h, ws[k])
        outs.append(h)
    return torch.cat(outs)


def make_ladder(comm: Comm):
    """The naive ladder over ``comm``: compute, ship the whole activation
    to the next stage, wait, repeat.  Rank 0's ``x`` is the real batch;
    the last rank's result is the model output."""
    stages = comm.Get_size()

    @spmd(comm=comm)
    def ladder(x, w2):
        rank = comm.Get_rank()
        h = stage_pair(x, w2)  # rank 0's is the real value
        tok = None
        for s in range(1, stages):
            tok = send(h, dest={s - 1: s}, tag=s, comm=comm, token=tok)
            # receiver-centric: rank s receives from s - 1
            got, tok = recv(h, source={s: s - 1}, tag=s, comm=comm, token=tok)
            if rank == s:
                h = stage_pair(got, w2)
        return h

    return ladder


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None, *, batch: int = BATCH, dim: int = DIM,
         microbatches: int = MICROBATCHES, seed: int = SEED, runs: int = 1):
    """The ladder and the four schedules on this rank; raises on the last
    rank where one differs from its reference.  Returns ``outputs`` (each
    form's last-rank output, ``(B, dim)``), ``plans`` (each schedule's
    resolved plan), ``ms`` (each form's wall a round, the best of ``runs``,
    synchronised) and ``reference``."""
    mesh = make_world_mesh(device=device)
    comm = Comm(mesh.axes[0], mesh=mesh)
    dev, stages, rank = mesh.device, comm.Get_size(), comm.Get_rank()
    if batch % microbatches:
        raise ValueError(f"batch {batch} does not split into {microbatches}")
    x0_np, ws_np = build_inputs(stages, batch, dim, seed)
    x0 = torch.from_numpy(x0_np).to(dev)
    ws = torch.from_numpy(ws_np).to(dev)
    w2, wi = (t.contiguous() for t in stage_weights(ws, stages, rank))
    last = rank == stages - 1

    def timed(fn, *args):
        best, out = None, None
        for _ in range(runs):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(dev)
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        return out, best

    outputs, plans, ms = {}, {}, {}
    x = x0 if rank == 0 else torch.zeros_like(x0)
    outputs["ladder"], ms["ladder"] = timed(make_ladder(comm), x, w2)
    mbs = split_microbatches(x, microbatches)
    for label, prog, params in (
        ("gpipe", pipeline(stage_pair, microbatches, schedule="gpipe",
                           comm=comm), w2),
        ("1f1b", pipeline(stage_pair, microbatches, schedule="1f1b",
                          comm=comm), w2),
        ("interleaved", pipeline(substage, microbatches,
                                 schedule="interleaved", virtual=2,
                                 comm=comm), wi),
        ("auto", pipeline(stage_pair, microbatches, comm=comm), w2),
    ):
        got, ms[label] = timed(prog, mbs, params)
        outputs[label] = got.reshape(batch, dim)
        plans[label] = prog.plan(stages, microbatches,
                                 (batch // microbatches) * dim * 4)
    ref = {"ladder": reference(x0, ws, 1), "pipe": reference(x0, ws, microbatches)}
    if last:
        for label, got in outputs.items():
            want = ref["ladder" if label == "ladder" else "pipe"]
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{label!r} diverged from the sequential reference by "
                    f"{(got - want).abs().max().item():.3e}")
        for label, plan in plans.items():
            print(f"{label:<12} -> {plan.schedule}: warmup {plan.warmup} / "
                  f"steady {plan.steady} / cooldown {plan.cooldown} tick(s), "
                  f"activation stash <= {plan.max_stash}")
        print(f"pipeline over {stages} stage(s): the ladder and every compiled "
              "schedule match the sequential reference bit for bit")
    return {"outputs": outputs, "plans": {k: vars(p) for k, p in plans.items()},
            "ms": ms, "reference": ref, "last": last}


def rank_main(rank: int, device, kwargs: dict = None):
    """``main`` on one rank of a ``launch.run`` world."""
    return main(device, **(kwargs or {}))


if __name__ == "__main__":
    from ..parallel import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device every rank shares")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--dim", type=int, default=DIM)
    ap.add_argument("--microbatches", type=int, default=MICROBATCHES)
    a = ap.parse_args()
    launch.run(rank_main, a.ranks, backend="gloo", device=a.device, timeout=600,
               args=(a.device, {"batch": a.batch, "dim": a.dim,
                                "microbatches": a.microbatches}))
