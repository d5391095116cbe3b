"""Start ranks: one process per rank, on one host.

``run(fn, nprocs)`` starts ``nprocs`` processes with the ``spawn`` start
method (CUDA cannot be forked), initialises ``torch.distributed`` in each
(``parallel/mesh.py:init_distributed``) at a ``file://`` rendezvous in a
fresh temporary directory (no TCP port to pick, so parallel launches never
race for one), calls ``fn(rank, *args)`` on every rank and returns the
per-rank results, tensors turned into numpy arrays.  When a rank raises,
or ``timeout`` passes, it kills every rank and raises with each rank's
traceback; every collective also times out after ``timeout`` seconds, so
a rank blocked on a lost peer errors instead of hanging.

``fn`` must be importable by name (a module-level function), since the
ranks are fresh interpreters.

    from mpi4jax_tpu_torch.parallel import launch
    per_rank = launch.run(my_program, 4, backend="gloo", device="cpu")
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as _mesh


class RankError(RuntimeError):
    """One or more ranks raised, or the run timed out; ``tracebacks`` maps
    each failed rank to its traceback text."""

    def __init__(self, message: str, tracebacks: dict):
        super().__init__(message)
        self.tracebacks = tracebacks


def to_numpy(obj):
    """``obj`` with every tensor replaced by a numpy array (on the host),
    through dicts, lists, tuples and named tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return tuple(to_numpy(v) for v in obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _rank_main(fn, rank, nprocs, backend, device, init_method, timeout,
               args, outdir, messages):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    # the ranks share the host's cores
    torch.set_num_threads(1)
    try:
        _mesh.init_distributed(backend, init_method=init_method,
                               world_size=nprocs, rank=rank, device=device,
                               timeout=timeout)
        result = to_numpy(fn(rank, *args))
        with open(os.path.join(outdir, f"result-{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
        dist.destroy_process_group()
        messages.put((rank, None))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        messages.put((rank, traceback.format_exc()))


def run(fn: Callable[..., Any], nprocs: int, *, backend: str = "gloo",
        device=None, timeout: float = 60.0, args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` new ranks, each with one
    PyTorch CPU thread, and return their results in rank order.
    ``backend``/``device`` as in ``init_distributed`` (checked for every
    rank before anything starts)."""
    if nprocs < 1:
        raise ValueError(f"run: nprocs must be at least 1, got {nprocs}")
    for r in range(nprocs):
        _mesh.device_for_rank(backend, device, r, nprocs)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mpx-ranks-") as tmp:
        messages = ctx.Queue()
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, r, nprocs, backend, device, init_method, timeout,
                      tuple(args), tmp, messages),
                daemon=True,
            )
            for r in range(nprocs)
        ]
        for p in procs:
            p.start()
        try:
            failed = _wait(procs, messages, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
        if failed:
            ranks = ", ".join(str(r) for r in sorted(failed))
            text = "\n".join(f"--- rank {r} ---\n{failed[r]}" for r in sorted(failed))
            raise RankError(f"rank(s) {ranks} failed:\n{text}", failed)
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _wait(procs, messages, deadline, grace: float = 2.0) -> dict:
    """Collect every rank's message; returns ``{rank: traceback}`` of the
    ranks that failed (empty when all finished).  After the first failure
    the others get ``grace`` seconds to report theirs."""
    done, failed = set(), {}
    n = len(procs)
    while len(done) < n:
        now = time.monotonic()
        if now >= deadline:
            for r in range(n):
                if r not in done:
                    failed.setdefault(r, "no result before the time limit (killed)\n")
            break
        try:
            rank, tb = messages.get(timeout=min(0.2, deadline - now))
        except queue.Empty:
            for r, p in enumerate(procs):
                if r not in done and p.exitcode not in (None, 0):
                    done.add(r)
                    failed[r] = f"exited with code {p.exitcode} before reporting\n"
                    deadline = min(deadline, time.monotonic() + grace)
            continue
        done.add(rank)
        if tb is not None:
            failed[rank] = tb
            deadline = min(deadline, time.monotonic() + grace)
    return failed
