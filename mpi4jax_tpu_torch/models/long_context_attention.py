"""Long-context attention demo: ring and Ulysses attention over a 1-D world.

The twin of ``examples/long_context_attention.py``.  ``main`` runs on
every rank of a world that ``parallel/launch.py:run`` started (or alone,
as a world of one): it builds the 1-D world comm
(``make_world_mesh((n,), ("sp",))``), makes this rank's sequence shard
of q, k and v from a numpy seed (the same shard on every rank that asks
for it: ``demo_shard``), and runs causal ring and causal Ulysses
attention on it, recording for each run the output, the kernel launches
and what the exchanges cost.  Attention has no weights.

    python -m mpi4jax_tpu_torch.models.long_context_attention --ranks 4 --device cpu

runs the demo's widths (b=2, t_loc=128, h=8, d=64) on four gloo ranks on
the CPU; without ``--device`` the ranks share the GPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import Comm, make_world_mesh
from ..attention import ring_attention, ulysses_attention
from ..kernels import _build
from ..ops import _staging

SCHEMES = {"ring": ring_attention, "ulysses": ulysses_attention}
KERNELS = ("flash_fwd_tf32", "flash_fwd_causal_tf32")


def demo_shard(seed: int, rank: int, b: int, t_loc: int, h: int, d: int):
    """Rank ``rank``'s shards of q, k and v, ``(3, b, t_loc, h, d)`` f32,
    from its own seeded stream (any rank can make any shard)."""
    rng = np.random.default_rng((seed, rank))
    return rng.standard_normal((3, b, t_loc, h, d), dtype=np.float32)


def demo_data(seed: int, size: int, b: int, t_loc: int, h: int, d: int):
    """Every rank's shards: q, k and v as ``(size, b, t_loc, h, d)``."""
    shards = np.stack([demo_shard(seed, r, b, t_loc, h, d) for r in range(size)])
    return tuple(shards[:, i] for i in range(3))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, *, b: int = 2, t_loc: int = 128, h: int = None,
         d: int = 64, seed: int = 0,
         runs=(("ring", True), ("ulysses", True)), repeats: int = 1):
    """Run each ``(scheme, causal)`` of ``runs`` on this rank's shard
    ``repeats`` times and keep the last (the first pays for loading the
    kernels and for the first exchanges); rank 0 prints each.  Returns, by
    ``"scheme/causal"`` or ``"scheme/full"``: ``out`` (this rank's output
    shard), ``launches`` (each flash kernel's), ``wall`` (seconds,
    synchronised), ``exchange_s``, ``exchange_calls`` and
    ``staged_bytes`` (``ops/_staging.stats``).  ``h`` defaults to the JAX
    demo's ``n * max(1, 8 // n)`` (Ulysses needs ``h % n == 0``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_world_mesh((n,), ("sp",), device=device)
    comm = Comm("sp", mesh=mesh)
    dev = mesh.device
    if h is None:
        h = n * max(1, 8 // n)
    q, k, v = (torch.from_numpy(x).to(dev)
               for x in demo_shard(seed, comm.Get_rank(), b, t_loc, h, d))
    results = {}
    with torch.no_grad():
        for scheme, causal in runs:
            fn = SCHEMES[scheme]
            for _ in range(repeats):
                for name in KERNELS:
                    _build.counter_for(name).launches = 0
                _staging.stats.reset()
                _sync(dev)
                start = time.perf_counter()
                out = fn(q, k, v, comm=comm, causal=causal)
                _sync(dev)
                wall = time.perf_counter() - start
            key = f"{scheme}/{'causal' if causal else 'full'}"
            results[key] = {
                "out": out,
                "launches": {name: _build.counter_for(name).launches
                             for name in KERNELS},
                "wall": wall,
                "exchange_s": _staging.stats.seconds,
                "exchange_calls": _staging.stats.calls,
                "staged_bytes": _staging.stats.staged_bytes,
            }
            if comm.Get_rank() == 0:
                print(f"{key} over {n} ranks: global T = {n * t_loc}, local "
                      f"out {tuple(out.shape)}, {wall:.4f} s")
    return results


def rank_main(rank: int, device, kwargs: dict):
    """``main`` on one rank of a ``launch.run`` world."""
    return main(device, **kwargs)


if __name__ == "__main__":
    from ..parallel import launch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device every rank shares")
    args = parser.parse_args()
    launch.run(rank_main, args.ranks, backend="gloo", device=args.device,
               args=(args.device, {}))
