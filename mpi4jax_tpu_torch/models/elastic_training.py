"""Elastic data-parallel training: survive rank loss and keep going.

The twin of ``examples/elastic_training.py``: a DP-SGD loop (a 16 -> 32
-> 1 ReLU MLP regressing ``tanh(x @ w)``, 32 rows a rank) under
``resilience/elastic.py:run`` with a ``ShardStore`` in-memory
checkpoint.  When a rank dies (or hangs) mid-run, the survivors agree on
the failed set, revoke the communication epoch, re-bootstrap a smaller
world, restore the last committed state from the surviving shard
replicas, and finish the step budget on ``k - f`` ranks.

The gradient exchange is ``compress.ef_allreduce`` with the
error-feedback residual committed as part of the state: each rank holds
its own row, so every step ``allgather``s the rows into the ``(k, ...)``
stack every rank commits (the JAX example commits the same stack); after
a restore at another world size, ``compress.ef_reshard`` moves the
surviving rows to their new ranks (``store.last_rank_map``).  With
``MPI4JAX_TPU_COMPRESS=off`` (the default) the residual stays zero.

The port runs one process per rank, so the drill is the multi-process
one (``--launch N``: one ``python -m
mpi4jax_tpu_torch.models.elastic_training`` process per rank, its output
in files of the run's directory, ``port_base`` for the agreement probed
free here and passed on):

    python -m mpi4jax_tpu_torch.models.elastic_training --launch 4 \\
        --device cpu --fail-step 5            # simulated loss of rank 3

    MPI4JAX_TPU_FAULT_SPEC='die:rank=3:op=allreduce:after=5' \\
        python -m mpi4jax_tpu_torch.models.elastic_training --launch 4 \\
        --device cpu --watchdog 1

(``hang`` in place of ``die`` drills the watchdog's path; the hung rank
is killed once the others have ended.)  ``--fail-step`` is the JAX
example's single-process simulation (a ``RankFailure`` of
``--fail-rank`` raised on every rank after that step, in epoch 0),
which here runs on the launched ranks.  Without ``--launch`` the script
runs a world of one rank, which has nothing to shrink.  A stalled gloo
call breaks on its process group's timeout (``--pg-timeout``, 3x the
watchdog's by default), and the agreement waits ``--agree-timeout``
(4x that by default) for the slowest survivor.

The planned boundaries:

- ``--grow`` (the launcher sets ``MPI4JAX_TPU_ELASTIC_GROW=1``): for each
  worker that dies, the launcher spawns a replacement (``--join``:
  ``elastic.join_and_run``) that knocks on rank 0's join listener, is
  admitted at a commit boundary, receives the committed state through the
  cold-join restore, and finishes the budget with the others: the
  4 -> 3 -> 4 loop.  ``--wait-for-join S`` makes the ranks of a shrunken
  world poll (a tiny MAX ``allreduce`` every 20 ms, at most S seconds)
  in the first step after the shrink until a replacement has knocked, so
  that the admission lands inside the budget whatever the replacement's
  start-up costs;
- ``--grid RxC`` runs on a ``("y", "x")`` grid.  With a ``preempt``
  clause and ``MPI4JAX_TPU_ELASTIC_FAIL_UNIT=row`` it is the graceful
  preemption drill: the preempted rank's whole row drains at a step
  boundary (one forced commit, one ``drain`` incident, no watchdog
  expiry) and the other rows finish the budget::

      MPI4JAX_TPU_ELASTIC_FAIL_UNIT=row \\
      MPI4JAX_TPU_FAULT_SPEC='preempt:rank=3:op=allreduce:after=5' \\
        python -m mpi4jax_tpu_torch.models.elastic_training --launch 4 \\
          --device cpu --grid 2x2 --expect-world 2

- ``launch(sigterm=(rank, step))`` sends a real SIGTERM to that rank
  after its step: the rank prints a hold line after the step and waits
  (at most 30 s) until its handler has posted the drain, and the
  launcher sends the signal when it reads that line (``sigterm=(rank,
  step, seconds)``: that many seconds later).  The other ranks
  wait after the same step (at most 30 s) until the leaver's drain notice
  has landed, outside any collective: were they to wait in the next
  step's first collective, the watchdog would time the launcher's
  reaction, and a launcher that stalled a second (a loaded host, a busy
  parent process) expired it on every peer.

The launcher exits 0 iff a strict majority (or ``--expect-world`` ranks)
completed the budget and every worker that exited 0 either completed or
drained; each worker writes ``<out>.p<rank>`` (a replacement
``<out>.pj<rank>``) with the JAX example's keys (``losses``,
``final_world``, ``drained``).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

DONE_TAG = "ELASTIC_DONE"
DECLARED_TAG = "ELASTIC_DECLARED_FAILED"
DRAINED_TAG = "ELASTIC_DRAINED"
HOLD_TAG = "ELASTIC_HOLD"
LR = 0.05


def _init_params(dim=16, hidden=32, seed=0):
    """The JAX example's parameters, drawn with the same numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.normal(0, dim ** -0.5, (dim, hidden)).astype(np.float32),
        "b1": np.zeros((hidden,), np.float32),
        "w2": rng.normal(0, hidden ** -0.5, (hidden, 1)).astype(np.float32),
        "b2": np.zeros((1,), np.float32),
    }


def _data_for(k, per_rank=32, dim=16, seed=1):
    """Synthetic regression data with a leading rank axis, derived from
    the CURRENT world size (the JAX example's arrays: after a shrink the
    survivors re-derive them at k-f)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, per_rank, dim)).astype(np.float32)
    w = rng.normal(size=(dim, 1)).astype(np.float32)
    y = np.tanh(x @ w).astype(np.float32)
    return x, y


def to_device(tree, device):
    """A nest of numpy arrays as tensors on ``device``."""
    import torch

    from ..utils.tree import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def to_numpy(tree):
    from ..utils.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _loss(params, x, y):
    import torch

    h = torch.relu(x @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return torch.mean((pred - y) ** 2)


def make_elastic_step(lr=LR, store=None, *, ef_state=True):
    """``(step_fn, losses)``: ``step_fn(state, step, comm)`` for
    ``elastic.run`` and the list each step appends ``{"step", "world",
    "loss", "epoch", "seconds"}`` to.  ``ef_state=False`` leaves the
    residual stack out of the committed state (the codec must be off: the
    residual then stays zero)."""
    import torch

    from .. import SUM, allgather, allreduce, compress
    from ..utils.tree import tree_flatten, tree_map

    data = {}
    losses = []

    def data_for(comm, dim):
        key = (comm.Get_size(), comm.Get_rank(), str(comm.device))
        if key not in data:
            x, y = _data_for(key[0], dim=dim)
            r = key[1]
            data[key] = (torch.from_numpy(x[r]).to(comm.device),
                         torch.from_numpy(y[r]).to(comm.device))
        return data[key]

    def residual_row(state, params, comm):
        k, r = comm.Get_size(), comm.Get_rank()
        res = state.get("ef_residual")
        if res is None:
            return compress.ef_zeros_like(params)
        old_k = int(tree_flatten(res)[0][0].shape[0])
        if old_k != k:
            # a restore across a boundary: the committed rows belong to the
            # OLD world; move the survivors' rows to their new ranks
            rmap = store.last_rank_map if store is not None else None
            if rmap is None:
                rmap = {i: i for i in range(min(old_k, k))}
            res = compress.ef_reshard(res, rmap, k)
        return tree_map(lambda v: v[r], res)

    def step_fn(state, step, comm):
        t0, wall = time.perf_counter(), time.time()
        k = comm.Get_size()
        params = state["params"]
        x, y = data_for(comm, int(params["w1"].shape[0]))
        res = residual_row(state, params, comm)
        flat, unflatten = tree_flatten(params)
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in flat]
            loss = _loss(unflatten(leaves), x, y)
            grads = unflatten(list(torch.autograd.grad(loss, leaves)))
        red, res, token = compress.ef_allreduce(grads, res, op=SUM, comm=comm)
        loss, _ = allreduce(loss.detach(), op=SUM, comm=comm, token=token)
        loss = loss / k
        new = tree_map(lambda p, g: p - lr * (g / k), params, red)
        out = {"params": new}
        if ef_state:
            out["ef_residual"] = tree_map(
                lambda v: allgather(v, comm=comm)[0], res)
        value = float(loss)
        losses.append({"step": int(step), "world": k, "loss": value,
                       "epoch": comm.epoch,
                       "seconds": time.perf_counter() - t0, "at": wall})
        print(f"step {int(step):3d}  world {k}  epoch {comm.epoch}  "
              f"loss {value:.6f}", flush=True)
        return out

    return step_fn, losses


def _simulated(step_fn, fail_at, fail_rank):
    """The JAX example's simulated loss: a ``RankFailure`` of
    ``fail_rank`` raised on every rank AFTER step ``fail_at``'s work, in
    epoch 0 (a real death surfaces inside the next collective; the
    recovery from here on is the same)."""
    from ..resilience.elastic import RankFailure

    def wrapped(state, step, comm):
        state = step_fn(state, step, comm)
        if step == fail_at and comm.epoch == 0:
            raise RankFailure({fail_rank},
                              f"simulated loss of rank {fail_rank}")
        return state

    return wrapped


def _restored_probe(step_fn, record):
    """Record the state the first step of each new epoch is handed (the
    restored state after a failure, the live state after a drain, the
    cold-restored state after a grow) and that step's index."""
    seen = {"epoch": 0}

    def wrapped(state, step, comm):
        if comm.epoch != seen["epoch"]:
            seen["epoch"] = comm.epoch
            record.append({"epoch": comm.epoch, "step": int(step),
                           "state": to_numpy(state)})
        return step_fn(state, step, comm)

    return wrapped


def _hold_for_sigterm(step_fn, hold_step, limit=30.0):
    """After step ``hold_step`` (epoch 0) print the hold line and wait,
    at most ``limit`` seconds, until the SIGTERM the launcher sends on
    reading it has posted the drain (``elastic.run``'s handler)."""
    from ..resilience import elastic

    def wrapped(state, step, comm):
        state = step_fn(state, step, comm)
        if int(step) == hold_step and comm.epoch == 0:
            print(f"{HOLD_TAG} step={int(step)}", flush=True)
            deadline = time.monotonic() + limit
            while not elastic._pending_drain and time.monotonic() < deadline:
                time.sleep(0.005)
        return state

    return wrapped


def _await_peer_drain(step_fn, hold_step, limit=30.0):
    """After step ``hold_step`` (epoch 0) wait, at most ``limit`` seconds,
    until a peer's drain notice has landed (``elastic.peek_peer_drain``):
    the peers of a rank held by :func:`_hold_for_sigterm`.  They wait here,
    between the step's collectives, instead of in the next step's first
    collective, where the watchdog would time the launcher's reaction to
    the hold line."""
    from ..resilience import elastic

    def wrapped(state, step, comm):
        state = step_fn(state, step, comm)
        if int(step) == hold_step and comm.epoch == 0:
            deadline = time.monotonic() + limit
            while (elastic.peek_peer_drain() is None
                   and time.monotonic() < deadline):
                time.sleep(0.005)
        return state

    return wrapped


def _wait_for_join(step_fn, world, limit):
    """In the first step at a world smaller than ``world``, poll (a MAX
    ``allreduce`` every 20 ms, at most ``limit`` seconds) until rank 0's
    join listener holds a replacement, so that it is admitted at the next
    commit boundary."""
    import torch

    from .. import MAX, allreduce
    from ..resilience import elastic

    done = [False]

    def wrapped(state, step, comm):
        if not done[0] and comm.Get_size() < world:
            done[0] = True
            deadline = time.monotonic() + limit
            while True:
                knocked = (elastic.pending_join_count()
                           if comm.Get_rank() == 0 else 0)
                flag, _ = allreduce(torch.tensor([knocked], device=comm.device),
                                    op=MAX, comm=comm)
                if int(flag[0]) or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        return step_fn(state, step, comm)

    return wrapped


def _parse_grid(spec):
    if not spec:
        return None
    r, _, c = spec.lower().partition("x")
    return int(r), int(c)


# ---------------------------------------------------------------------------
# a rank of the drill
# ---------------------------------------------------------------------------


def _bootstrap(args, **extra) -> dict:
    bs = {"rendezvous": args.rendezvous, "host": "localhost",
          "port_base": args.port_base,
          "agree_port_base": args.port_base + 100,
          "agree_timeout": args.agree_timeout, "timeout": args.pg_timeout}
    bs.update(extra)
    return bs


def _finish(args, store, losses, restored, state, name, wall, declared=None):
    """Write the rank's ``--out`` file and its record in the run's
    directory (``result-<name>.json``, ``state-<name>.npz``; ``name`` is
    ``p<rank>``, a replacement's ``j<rank>``); returns the final world
    (``None`` when it left)."""
    from .. import telemetry
    from ..resilience import elastic

    left = declared is not None or store.drained
    final_world = None if declared is not None else int(store.comm.Get_size())
    if args.out:
        # the JAX example's names: <out>.p<rank>, a replacement's <out>.pj<rank>
        suffix = name if name.startswith("p") else "p" + name
        with open(f"{args.out}.{suffix}", "w") as f:
            json.dump({"losses": losses, "final_world": final_world,
                       "drained": bool(store.drained)}, f, indent=2)
    if not args.workdir:
        return final_world
    me = store.bootstrap.get("process_id")
    extra = {"rank": me, "name": name, "declared_failed": declared is not None,
             "declared": declared, "drained": bool(store.drained),
             "final_world": final_world,
             "origin": elastic.origin_rank(int(me)) if me is not None else None,
             "epoch": elastic.current_epoch(),
             "epoch_history": elastic.epoch_history(),
             "losses": losses, "recoveries": store.recoveries,
             "drains": store.drains, "grows": store.grows,
             "joined": store.joined,
             "auto_commit_every": store.auto_commit_every,
             "last_commit_s": store.last_commit_s,
             "committed_step": store.committed_step,
             "meters": telemetry.snapshot()["meters"],
             "wall": wall, "spawned_at": args.spawned_at or None}
    rec = store._committed
    if rec is not None:
        extra["last_commit"] = {"k": rec["k"], "held": sorted(rec["shards"]),
                                "shard_bytes": rec["shard"],
                                "state_bytes": rec["nbytes"]}
    if declared is None:
        arrays = {f"final/{k}": v
                  for k, v in to_numpy(state["params"]).items()}
        for r in restored:
            params = r["state"]["params"].items()
            arrays.update({f"restored/{k}": v for k, v in params})
            arrays.update({f"epoch{r['epoch']}/{k}": v for k, v in params})
            extra["restored_step"] = r["step"]
        extra["restored_steps"] = {str(r["epoch"]): r["step"]
                                   for r in restored}
        np.savez(os.path.join(args.workdir, f"state-{name}.npz"), **arrays)
    with open(os.path.join(args.workdir, f"result-{name}.json"), "w") as f:
        json.dump(extra, f, indent=2, default=str)
    if not left:
        # every rank of the final world ends here after the same steps:
        # leave it together (a process group left to the interpreter's
        # exit can abort it while its threads still run)
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return final_world


def _declared(rf) -> bool:
    """Whether ``rf`` says this rank left the world: declared failed, or
    shrunk out with a failed rank of its grid row or column."""
    text = str(rf)
    return "declared failed" in text or "shrunk out with them" in text


def _wrapped_step(args, store, world):
    step_fn, losses = make_elastic_step(args.lr, store=store,
                                        ef_state=args.ef_state)
    if 0 <= args.fail_step < args.steps:
        fail_rank = args.fail_rank if args.fail_rank >= 0 else world - 1
        step_fn = _simulated(step_fn, args.fail_step, fail_rank)
    if args.hold_after >= 0:
        step_fn = _hold_for_sigterm(step_fn, args.hold_after)
    if args.await_drain_after >= 0:
        step_fn = _await_peer_drain(step_fn, args.await_drain_after)
    if args.wait_for_join > 0:
        step_fn = _wait_for_join(step_fn, world, args.wait_for_join)
    restored = []
    return _restored_probe(step_fn, restored), losses, restored


def _commit_every(args):
    return (args.commit_every if args.commit_every == "auto"
            else int(args.commit_every))


def run_worker(args) -> int:
    import torch

    from .. import Comm, make_world_mesh, resilience
    from ..parallel.mesh import init_distributed
    from ..resilience import elastic

    dev = init_distributed(
        "gloo", init_method=elastic.rendezvous_for(args.rendezvous, 0),
        world_size=args.num_processes, rank=args.process_id,
        device=args.device, timeout=args.pg_timeout)
    torch.set_num_threads(1)
    if args.watchdog > 0:
        resilience.set_watchdog_timeout(args.watchdog)
    grid = _parse_grid(args.grid)
    if grid is None:
        mesh = make_world_mesh(device=dev)
    else:
        mesh = make_world_mesh(grid, ("y", "x"), device=dev)
    comm = Comm(mesh.axes, mesh=mesh)
    store = elastic.ShardStore(comm, bootstrap=_bootstrap(
        args, process_id=args.process_id, num_processes=args.num_processes))
    step_fn, losses, restored = _wrapped_step(args, store, args.num_processes)
    state = {"params": to_device(_init_params(args.dim, args.hidden), dev)}
    t0 = time.perf_counter()
    declared = None
    try:
        state = elastic.run(step_fn, state, store, steps=args.steps,
                            commit_every=_commit_every(args))
    except elastic.RankFailure as rf:
        if not _declared(rf):
            raise
        declared = str(rf)
        print(f"{DECLARED_TAG} rank {args.process_id}: {rf}", flush=True)
    final_world = _finish(args, store, losses, restored, state,
                          f"p{args.process_id}", time.perf_counter() - t0,
                          declared)
    if declared is not None:
        return 3
    if store.drained:
        # shrunk out by a planned drain (the preempted rank, or a row-mate
        # on a Cartesian drain): a graceful exit, not a completion
        print(f"{DRAINED_TAG} world={final_world}", flush=True)
        return 0
    print(f"{DONE_TAG} steps={args.steps} world={final_world}", flush=True)
    return 0


def run_joiner(args) -> int:
    """A replacement worker: knock on the running (shrunken) world's rank
    0, get admitted at a commit boundary, receive the committed state
    through the cold-join restore, and help finish the budget."""
    import torch

    from .. import resilience
    from ..resilience import elastic

    torch.set_num_threads(1)
    if args.watchdog > 0:
        resilience.set_watchdog_timeout(args.watchdog)
    store = elastic.ShardStore(None, bootstrap=_bootstrap(
        args, device=args.device))
    step_fn, losses, restored = _wrapped_step(args, store, 0)
    t0 = time.perf_counter()
    state = elastic.join_and_run(step_fn, store, steps=args.steps,
                                 commit_every=_commit_every(args),
                                 join_timeout=args.drill_timeout)
    name = f"j{store.bootstrap['process_id']}"
    final_world = _finish(args, store, losses, restored, state, name,
                          time.perf_counter() - t0)
    if store.drained:
        print(f"{DRAINED_TAG} world={final_world}", flush=True)
        return 0
    print(f"{DONE_TAG} steps={args.steps} world={final_world}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def ephemeral_low(default: int = 32768) -> int:
    """The first port of the host's ephemeral range, from which outgoing
    connections (gloo's among them) take their local ports."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return default


# the lowest port a window starts at, and the slices the ports below the
# ephemeral range are cut into under pytest-xdist: one a worker
# (PYTEST_XDIST_WORKER), so that concurrent test workers draw from
# disjoint windows
PORT_FLOOR = 10000
PORT_SLICES = 8

# where this process's next window starts, as an offset into its range:
# consecutive calls get disjoint windows, so launches that one process
# runs side by side never share a port
_next_window = {"offset": None}
_next_window_lock = threading.Lock()


def port_range() -> tuple:
    """``(lo, hi)``: the ports this process draws its windows from, below
    the ephemeral range (``ephemeral_low``); under pytest-xdist the
    worker's slice of them, else all of them."""
    top = min(32000, ephemeral_low())
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker is None:
        return PORT_FLOOR, top
    slot = int(worker[2:]) if worker[2:].isdigit() else 0
    width = (top - PORT_FLOOR) // PORT_SLICES
    lo = PORT_FLOOR + (slot % PORT_SLICES) * width
    return lo, lo + width


def free_port_base(ranks: int, epochs: int = 4, tries: int = 50) -> int:
    """A port base whose elastic ports are free for ``epochs`` epochs of up
    to ``ranks`` ranks: the agreement's (the coordinator star's,
    ``agree_port``, and the gossip ports, ``port_base + 100 + 17 * epoch
    + rank``), the control listeners' (``control_port``) and the join
    listener's (``join_port``).  The window lies in ``port_range``, below
    the ephemeral range: an outgoing connection cannot take one of its
    ports between this check and the listeners' binds.  A process hands
    out consecutive windows from a random start and wraps at the range's
    end, so the windows of launches it runs side by side are disjoint (a
    random draw each call could put two of them on one port, and a
    survivor's agreement could then reach another launch's listener); a
    window with a port in use is skipped."""
    from ..resilience import elastic

    span = elastic.config.elastic_port_span()

    def window(base):
        ports = {elastic.agree_port(base, e, span) for e in range(epochs)}
        ports |= {elastic.join_port(base, e, span) for e in range(epochs)}
        ports |= {base + 100 + 17 * elastic.wrapped_epoch(e, span) + r
                  for e in range(epochs) for r in range(ranks)}
        ports |= {elastic.control_port(base, r, e, span)
                  for e in range(2) for r in range(min(ranks, span))}
        return ports

    extent = max(5 * span, max(window(0)) + 1)
    lo, hi = port_range()
    if hi - lo < extent:
        raise RuntimeError(f"free_port_base: the ports {lo}-{hi} hold no "
                           f"window of {extent}")
    with _next_window_lock:
        if _next_window["offset"] is None:
            _next_window["offset"] = random.randrange(hi - lo - extent + 1)
        for _ in range(tries):
            offset = _next_window["offset"]
            if lo + offset + extent > hi:
                offset = 0
            _next_window["offset"] = offset + extent
            base = lo + offset
            try:
                for p in window(base):
                    with socket.socket() as s:
                        s.bind(("localhost", p))
            except OSError:
                continue
            return base
    raise RuntimeError("free_port_base: no free port window found")


def _read(path) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def launch(n: int, *, steps: int = 12, device=None, fault_spec=None,
           fail_step: int = -1, fail_rank: int = -1, watchdog: float = 30.0,
           pg_timeout: float = None, agree_timeout: float = None,
           commit_every="1", dim: int = 16, hidden: int = 32,
           lr: float = LR, ef_state: bool = True, out: str = "",
           expect_world: int = 0, grid: str = "", grow: bool = False,
           sigterm=None,
           wait_for_join: float = 0.0, limit: float = 540.0,
           grace: float = 3.0, workdir: str = None, env=None) -> dict:
    """Start ``n`` ranks, wait for them and judge the drill; returns
    ``{"ok", "exit", "stdout", "stderr", "results", "completed",
    "drained", "joiners", "seconds", "dir"}`` (``results``: each launch
    rank's ``result-p<rank>.json``, ``None`` for a rank that wrote none;
    ``joiners``: each replacement's ``{"exit", "stdout", "stderr",
    "result", "spawned_at"}``).  ``grid`` is ``"RxC"``; ``grow`` spawns a
    replacement (``--join``) for each worker that exits non-zero;
    ``sigterm=(rank, step)`` sends that rank a SIGTERM after its step
    (``(rank, step, seconds)``: that many seconds after its hold line, a
    notice that comes late).  A
    rank still running once the expected completions are in is the
    drill's hung subject: it gets ``grace`` seconds, then is killed.
    ``fault_spec`` (``None``: the caller's ``MPI4JAX_TPU_FAULT_SPEC``) and
    ``env`` go to every process."""
    from ..parallel.mesh import resolve_device

    device = str(resolve_device(device))
    if pg_timeout is None:
        pg_timeout = 3.0 * watchdog if watchdog > 0 else 300.0
    if agree_timeout is None:
        agree_timeout = max(5.0, 4.0 * pg_timeout)
    workdir = workdir or tempfile.mkdtemp(prefix="mpx-elastic-")
    os.makedirs(workdir, exist_ok=True)
    port_base = free_port_base(n + (n if grow else 0))
    run_env = dict(os.environ)
    if fault_spec is not None:
        run_env["MPI4JAX_TPU_FAULT_SPEC"] = fault_spec
    if grow:
        run_env["MPI4JAX_TPU_ELASTIC_GROW"] = "1"
    run_env.update(env or {})
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run_env["PYTHONPATH"] = root + os.pathsep + run_env.get("PYTHONPATH", "")
    rendezvous = "file://" + os.path.join(workdir, "rendezvous")
    common = ["--rendezvous", rendezvous, "--port-base", str(port_base),
              "--device", device, "--steps", str(steps),
              "--commit-every", str(commit_every),
              "--watchdog", str(watchdog), "--pg-timeout", str(pg_timeout),
              "--agree-timeout", str(agree_timeout), "--dim", str(dim),
              "--hidden", str(hidden), "--lr", repr(lr), "--workdir", workdir,
              "--wait-for-join", str(wait_for_join),
              "--drill-timeout", str(limit),
              "--ef-state" if ef_state else "--no-ef-state"]
    if out:
        common += ["--out", out]
    procs, files, names = [], [], []

    def spawn(name, extra):
        fo = open(os.path.join(workdir, f"{name}.out"), "w")
        fe = open(os.path.join(workdir, f"{name}.err"), "w")
        files.append((fo, fe))
        names.append(name)
        cmd = ([sys.executable, "-m",
                "mpi4jax_tpu_torch.models.elastic_training"] + common + extra)
        procs.append(subprocess.Popen(cmd, env=run_env, stdout=fo,
                                      stderr=fe, cwd=root))

    t0 = time.perf_counter()
    for r in range(n):
        extra = ["--process-id", str(r), "--num-processes", str(n),
                 "--fail-step", str(fail_step), "--fail-rank", str(fail_rank)]
        if grid:
            extra += ["--grid", grid]
        if sigterm is not None:
            extra += ["--hold-after" if r == sigterm[0] else
                      "--await-drain-after", str(sigterm[1])]
        spawn(f"rank{r}", extra)
    spawned_at, signalled, held_at = [], sigterm is None, None
    sigterm_delay = (float(sigterm[2]) if sigterm is not None and len(sigterm) > 2
                     else 0.0)

    def completed(i):
        return (procs[i].poll() == 0 and f"{DONE_TAG} steps={steps}"
                in _read(os.path.join(workdir, f"{names[i]}.out")))

    target = expect_world if expect_world > 0 else n // 2 + 1
    deadline = time.monotonic() + limit
    try:
        while time.monotonic() < deadline:
            if not signalled:
                rank, step = sigterm[:2]
                if held_at is None and f"{HOLD_TAG} step={step}" in _read(
                        os.path.join(workdir, f"rank{rank}.out")):
                    held_at = time.monotonic()
                if (held_at is not None
                        and time.monotonic() >= held_at + sigterm_delay):
                    os.kill(procs[rank].pid, signal.SIGTERM)
                    signalled = True
            subjects = [p for p in procs[:n]
                        if p.poll() is not None and p.returncode != 0]
            while grow and len(subjects) > len(spawned_at):
                spawned_at.append(time.time())
                spawn(f"join{len(spawned_at) - 1}",
                      ["--join", "--spawned-at", repr(spawned_at[-1])])
            live = [p for p in procs if p.poll() is None]
            if not live:
                break
            if sum(completed(i) for i in range(len(procs))) >= target:
                # the expected completions are in: whoever still runs is
                # the drill's hung subject
                end = time.monotonic() + grace
                while (any(p.poll() is None for p in procs)
                       and time.monotonic() < end):
                    time.sleep(0.05)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in files:
            fo.close()
            fe.close()
    res = {"exit": [], "stdout": [], "stderr": [], "results": [],
           "joiners": [], "seconds": time.perf_counter() - t0,
           "dir": workdir}
    for i, name in enumerate(names):
        rec = {"exit": procs[i].returncode,
               "stdout": _read(os.path.join(workdir, f"{name}.out")),
               "stderr": _read(os.path.join(workdir, f"{name}.err"))}
        results = [f for f in os.listdir(workdir)
                   if f.startswith("result-") and f.endswith(".json")]
        if i < n:
            path = os.path.join(workdir, f"result-p{i}.json")
        else:
            # a replacement names its files by the rank it was admitted as
            path = next((os.path.join(workdir, f) for f in sorted(results)
                         if f.startswith("result-j")
                         and json.loads(_read(os.path.join(workdir, f)))
                         .get("spawned_at") == spawned_at[i - n]), "")
        rec["result"] = json.loads(_read(path)) if os.path.exists(path) else None
        if i < n:
            for key in ("exit", "stdout", "stderr"):
                res[key].append(rec[key])
            res["results"].append(rec["result"])
        else:
            res["joiners"].append(dict(rec, spawned_at=spawned_at[i - n]))
    exited0 = [names[i] for i in range(len(procs)) if procs[i].returncode == 0]
    done = [names[i] for i in range(len(procs)) if procs[i].returncode == 0
            and f"{DONE_TAG} steps={steps}" in _read(
                os.path.join(workdir, f"{names[i]}.out"))]
    drained = [names[i] for i in range(len(procs))
               if procs[i].returncode == 0 and DRAINED_TAG in _read(
                   os.path.join(workdir, f"{names[i]}.out"))]
    res["completed"] = [int(nm[4:]) if nm.startswith("rank") else nm
                        for nm in done]
    res["drained"] = [int(nm[4:]) if nm.startswith("rank") else nm
                      for nm in drained]
    ok = len(done) >= target
    # every worker that exited 0 is accounted for: a completion or a
    # graceful drain
    ok = ok and sorted(exited0) == sorted(set(done) | set(drained))
    if expect_world > 0:
        ok = ok and len(done) == expect_world
    res["ok"] = ok
    return res


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=12,
                   help="total training steps to complete (the budget)")
    p.add_argument("--commit-every", default="1",
                   help="commit the state every N steps, or 'auto'")
    p.add_argument("--fail-step", type=int, default=-1,
                   help="simulate the loss of --fail-rank after this step "
                        "(<0 disables)")
    p.add_argument("--fail-rank", type=int, default=-1,
                   help="the rank the simulation fails (-1 = last)")
    p.add_argument("--out", default="",
                   help="each rank writes its loss trace to <out>.p<rank>")
    p.add_argument("--launch", type=int, default=0, metavar="N",
                   help="launch an N-rank world and run the drill")
    p.add_argument("--grow", action="store_true",
                   help="--launch: spawn a replacement (join_and_run) for "
                        "each worker that dies: the shrink-then-grow drill")
    p.add_argument("--grid", default="",
                   help="run on a ('y', 'x') grid 'RxC' (default: 1-D)")
    p.add_argument("--wait-for-join", type=float, default=0.0,
                   help="after a shrink, poll up to this many seconds for a "
                        "replacement to knock before training on")
    p.add_argument("--expect-world", type=int, default=0,
                   help="--launch: the expected FINAL world size (default: "
                        "a strict majority completes)")
    p.add_argument("--device", default=None,
                   help="the device (default: the GPU; 'cpu' for the CPU)")
    p.add_argument("--watchdog", type=float, default=30.0,
                   help="watchdog timeout in seconds (0: off)")
    p.add_argument("--pg-timeout", type=float, default=None,
                   help="the process group's collective timeout (default: "
                        "3x the watchdog's)")
    p.add_argument("--agree-timeout", type=float, default=None,
                   help="the failure agreement's window (default: 4x the "
                        "process group's timeout)")
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=LR,
                   help="the SGD step (the JAX example's 0.05 diverges at "
                        "--dim 1024 --hidden 8192; 1e-3 does not)")
    p.add_argument("--ef-state", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="commit the error-feedback residual stack")
    p.add_argument("--drill-timeout", type=float, default=540.0,
                   help="--launch: seconds before the drill fails")
    p.add_argument("--workdir", default="", help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port-base", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", default="", help=argparse.SUPPRESS)
    p.add_argument("--join", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--spawned-at", type=float, default=0.0,
                   help=argparse.SUPPRESS)
    p.add_argument("--hold-after", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--await-drain-after", type=int, default=-1,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _timeouts(args) -> None:
    if args.pg_timeout is None:
        args.pg_timeout = 3.0 * args.watchdog if args.watchdog > 0 else 300.0
    if args.agree_timeout is None:
        args.agree_timeout = max(5.0, 4.0 * args.pg_timeout)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.launch > 0:
        res = launch(args.launch, steps=args.steps, device=args.device,
                     fail_step=args.fail_step, fail_rank=args.fail_rank,
                     watchdog=args.watchdog, pg_timeout=args.pg_timeout,
                     agree_timeout=args.agree_timeout,
                     commit_every=args.commit_every, dim=args.dim,
                     hidden=args.hidden, lr=args.lr, ef_state=args.ef_state,
                     out=args.out, expect_world=args.expect_world,
                     grid=args.grid, grow=args.grow,
                     wait_for_join=args.wait_for_join,
                     limit=args.drill_timeout)
        for r, (rc, out) in enumerate(zip(res["exit"], res["stdout"])):
            sys.stdout.write(f"--- worker r{r} (exit {rc}) ---\n{out}")
        for j, rec in enumerate(res["joiners"]):
            sys.stdout.write(f"--- worker j{j} (exit {rec['exit']}) ---\n"
                             f"{rec['stdout']}")
        print(f"drill: {len(res['completed'])} worker(s) completed the "
              f"{args.steps}-step budget ({res['completed']}), "
              f"{len(res['drained'])} drained gracefully ({res['drained']}) "
              f"in {res['seconds']:.1f}s", flush=True)
        print("DRILL_OK" if res["ok"] else "DRILL_FAILED", flush=True)
        return 0 if res["ok"] else 1
    if args.join:
        _timeouts(args)
        return run_joiner(args)
    if args.process_id >= 0:
        _timeouts(args)
        return run_worker(args)
    # a world of one rank: nothing to shrink, the loop runs clean
    workdir = tempfile.mkdtemp(prefix="mpx-elastic-")
    args.process_id, args.num_processes = 0, 1
    args.rendezvous = "file://" + os.path.join(workdir, "rendezvous")
    args.port_base = free_port_base(1)
    args.fail_step = -1
    args.pg_timeout = args.pg_timeout or 300.0
    args.agree_timeout = args.agree_timeout or 20.0
    print("single rank: nothing to shrink, running clean", flush=True)
    return run_worker(args)


if __name__ == "__main__":
    sys.exit(main())
