"""A pinned serving step: the cold start and the hot loop.

The twin of ``examples/aot_serving_step.py``: a tensor-parallel
decode-style step (a row-parallel product, the partial sums' SUM
``allreduce``, an activation), pinned once with ``compile`` and called in
a loop.  Both costs the pin and the persistent tier remove show:

- the cold start: with ``MPI4JAX_TPU_COMPILE_CACHE_DIR`` set, the first
  process writes the pin's record (and builds any kernel library the step
  needs); a later process reads it and builds nothing, so ``from_disk``
  is true and ``disk_cache.hits`` positive.  A CUDA graph cannot be
  stored, so the second process still captures its graph;
- the hot loop: on one CUDA rank a call replays one CUDA graph, so
  ``per_call_us`` is the serving loop's floor.

Run it twice with one directory and compare the JSON lines::

    export MPI4JAX_TPU_COMPILE_CACHE_DIR=/tmp/mpx-torch-cache
    python -m mpi4jax_tpu_torch.models.aot_serving_step   # writes
    python -m mpi4jax_tpu_torch.models.aot_serving_step   # reads (hits > 0)

``--steps``, ``--dim`` and ``--json`` are the example's; ``--device``
(the GPU by default, ``cpu`` without one) and ``--ranks`` (gloo ranks
started with ``parallel/launch.py``, one by default) are the port's.
Each rank holds its own shard: ``x`` (8, dim/size) and ``w`` (dim/size,
dim), the JAX example's ``global[r]``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import SUM, allreduce, cache_stats, compile, varying
from ..parallel.region import get_default_comm


def decode_step(x, w):
    """The per-rank decode step: a row-parallel linear.  Each rank holds a
    (dim/size, dim) weight shard and its slice of the activations; the
    product is a partial sum that one ``allreduce`` completes.
    Module-level so that a warming manifest can name it
    (``python -m mpi4jax_tpu_torch.aot warm``): the output's width comes
    from the shard's own shape."""
    partial = x @ w
    full, _ = allreduce(partial, op=SUM)
    return torch.tanh(varying(full))[:, : w.shape[0]]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(steps: int = 50, dim: int = 256) -> dict:
    """Pin ``decode_step`` on the default comm, time ``steps`` calls and
    return the example's JSON dict."""
    comm = get_default_comm()
    size = comm.Get_size()
    dim = max(size, dim // size * size)  # divisible by the world
    dev = comm.device
    x = torch.full((8, dim // size), 0.01, dtype=torch.float32, device=dev)
    w = torch.full((dim // size, dim), 0.01, dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    pinned = compile(decode_step, x, w, comm=comm)
    pin_wall = time.perf_counter() - t0

    out = pinned(x, w)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = pinned(x, w)
    _sync(dev)
    per_call = (time.perf_counter() - t0) / steps

    stats = cache_stats()
    return {
        "workload": f"tp-decode dim={dim} over {size} ranks",
        "pin_wall_s": round(pin_wall, 4),
        "steps": steps,
        "per_call_us": round(per_call * 1e6, 2),
        "from_disk": pinned.from_disk,
        "aot": stats["aot"],
        "disk_cache": {
            k: stats["disk_cache"][k]
            for k in ("enabled", "hits", "misses", "writes", "evictions",
                      "bytes", "entries")
        },
    }


def rank_main(rank: int, device, steps: int, dim: int) -> dict:
    """``main`` on one rank of a ``launch.run`` world."""
    from ..parallel.mesh import make_world_mesh, set_default_mesh

    set_default_mesh(make_world_mesh(device=device))
    return main(steps, dim)


def _print(result: dict, only_json: bool) -> None:
    if not only_json:
        src = ("its record read from the persistent tier" if result["from_disk"]
               else "nothing read from the persistent tier")
        print(f"pinned in {result['pin_wall_s']:.3f}s ({src}); "
              f"{result['steps']} calls at {result['per_call_us']:.1f} us/call")
        if not result["disk_cache"]["enabled"]:
            print("hint: set MPI4JAX_TPU_COMPILE_CACHE_DIR and run twice "
                  "to see the cold-start cache in action")
    print(json.dumps(result))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=50,
                   help="pinned hot-loop calls to time")
    p.add_argument("--dim", type=int, default=256,
                   help="model dimension (split over ranks)")
    p.add_argument("--json", action="store_true",
                   help="print ONLY the JSON result line")
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device every rank shares (default: "
                        "the GPU)")
    p.add_argument("--ranks", type=int, default=1,
                   help="gloo ranks to start (rank 0 prints)")
    a = p.parse_args()
    if a.ranks == 1:
        from ..parallel.mesh import make_world_mesh, set_default_mesh

        set_default_mesh(make_world_mesh(device=a.device))
        _print(main(a.steps, a.dim), a.json)
    else:
        from ..parallel import launch

        res = launch.run(rank_main, a.ranks, backend="gloo", device=a.device,
                         args=(a.device, a.steps, a.dim))
        _print(res[0], a.json)
