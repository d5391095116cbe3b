"""Rank programs of the elastic layer's tests.

Each function runs on every rank of a ``mpi4jax_tpu_torch.parallel.launch``
world of gloo ranks on the CPU (or, for the two peer-death checks, in
processes ``tests/test_torch_elastic_pure.py`` starts itself, and for the
auto-measuring grow, the joiner rank 0 starts: ``python
tests/torch_ranks_elastic.py join ...``).  Like ``torch_ranks.py`` this
module imports no JAX, since every rank imports it afresh.  A rank the
shrink or a drain leaves out destroys its process group and returns;
``launch.run`` then skips its closing barrier.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch import aot
from mpi4jax_tpu_torch.resilience import elastic

WORLD = 4
LOST = 3  # the rank every program here loses


def world_comm():
    mesh = tpx.make_world_mesh(device="cpu")
    return tpx.Comm(mesh.axes[0], mesh=mesh)


def bootstrap(rank: int, rdv: str, port_base: int, size: int = WORLD) -> dict:
    return {"rendezvous": rdv, "host": "localhost", "port_base": port_base,
            "agree_port_base": port_base + 100, "agree_timeout": 20.0,
            "process_id": rank, "num_processes": size, "timeout": 50.0}


def seeded_state() -> dict:
    """A state of three dtypes and a 0-d leaf, sizes not divisible by 4
    (the padding path): the same on every rank."""
    rng = np.random.default_rng(5)
    return {
        "w": torch.from_numpy(rng.standard_normal((37, 5)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(11).astype(np.float32)).to(
            torch.bfloat16),
        "n": torch.tensor(12345, dtype=torch.int64),
        "host": rng.standard_normal(3),
    }


def state_bytes(state) -> dict:
    """Every leaf's dtype, shape and raw bytes."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = (str(v.dtype), tuple(v.shape), str(v.device),
                      v.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
        else:
            out[k] = (str(v.dtype), v.shape, "numpy", v.tobytes())
    return out


def leave_world() -> None:
    """The declared-failed rank's exit from the world: its process group
    destroyed (``launch.run`` then skips its closing barrier)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def store_program(rank: int, placement: str, topology, unrecoverable,
                  rdv: str, port_base: int) -> dict:
    """Commit a seeded state with redundancy 1 under ``placement``,
    restore it on the whole world (an exchange: each rank holds 2 of the
    4 shards), check that losing ``unrecoverable`` raises, then shrink
    out rank 3 (revoke, re-bootstrap) and restore it on the survivors."""
    comm = world_comm()
    store = elastic.ShardStore(comm, redundancy=1, placement=placement,
                               topology=topology,
                               bootstrap=bootstrap(rank, rdv, port_base))
    state = seeded_state()
    store.commit(7, state)
    out = {"held": store.held_shards(), "table": store.placement_table()}
    step0, back = store.restore()
    out["step0"], out["same0"] = step0, state_bytes(back) == state_bytes(state)
    try:
        store.restore_plan(unrecoverable)
        out["unrecoverable_raised"] = False
    except elastic.RankFailure:
        out["unrecoverable_raised"] = True
    # the single-controller shrink refuses a world of several processes
    try:
        store.apply_shrink({LOST})
        out["apply_shrink"] = "ran"
    except RuntimeError as e:
        out["apply_shrink"] = str(e)
    if rank == LOST:
        leave_world()
        out["left"] = True
        return out
    elastic.revoke_epoch({LOST}, rank=rank, world=WORLD)
    out["rank_map"] = store.rebootstrap({LOST})
    step1, back1 = store.restore({LOST})
    out.update(step1=step1, same1=state_bytes(back1) == state_bytes(state),
               world=store.comm.Get_size(), rank=store.comm.Get_rank(),
               epoch=store.comm.epoch, current_epoch=elastic.current_epoch(),
               last_rank_map=store.last_rank_map)
    # the revoked world's comm refuses a collective; the new one works
    try:
        tpx.allreduce(torch.ones(2), comm=comm)
        out["old_comm"] = "ran"
    except RuntimeError as e:
        out["old_comm"] = getattr(e, "mpx_code", str(e))
    out["new_sum"] = float(tpx.allreduce(torch.ones(2), comm=store.comm)[0][0])
    return out


class Recording:
    """An ``ElasticStep`` that records the step of every call and its
    comm's epoch (the boundaries ``elastic.run`` dispatches), and sums the
    pin counters' moves over its calls (a revoke resets the counters
    between two calls: ``ops/_base.clear_caches``)."""

    def __init__(self, inner):
        self.inner = inner
        self.unroll = inner.unroll
        self.calls = []
        self.totals = {"pins": 0, "stale_raises": 0}

    def __call__(self, state, step, comm):
        self.calls.append((int(step), comm.epoch))
        before = aot.stats()["aot"]
        try:
            return self.inner(state, step, comm)
        finally:
            after = aot.stats()["aot"]
            for k in self.totals:
                self.totals[k] += after[k] - before[k]

    def repin(self):
        self.inner.repin()
        return self


FAIL_AT = 5  # the iteration (inside the megastep [4, 6)) that fails


def megastep_body(state, step, comm):
    """One iteration: ``w += mean over ranks of w / 8 + step``, a
    ``RankFailure`` of rank 3 at iteration ``FAIL_AT`` in epoch 0."""
    if int(step) == FAIL_AT and comm.epoch == 0:
        raise elastic.RankFailure({LOST}, "simulated loss inside a megastep")
    total, _ = tpx.allreduce(state["w"], comm=comm)
    return {"w": state["w"] + total / (8 * comm.Get_size()) + step.float()}


def compile_step_program(rank: int, unroll: int, steps: int, rdv: str,
                         port_base: int, tdir: str) -> dict:
    """``elastic.run`` of ``aot.compile_step(megastep_body, unroll=)``
    over a 4 -> 3 shrink, with the health plane on under the events tier
    (the knobs in this rank's own environment): the dispatched steps, the
    pin counters, the epochs, this rank's journal incidents and the
    bundle's epoch history."""
    os.environ.update({"MPI4JAX_TPU_TELEMETRY": "events",
                       "MPI4JAX_TPU_TELEMETRY_DIR": tdir,
                       "MPI4JAX_TPU_HEALTH": "on"})
    from mpi4jax_tpu_torch.telemetry import health, journal

    comm = world_comm()
    store = elastic.ShardStore(comm, bootstrap=bootstrap(rank, rdv, port_base))
    step_fn = Recording(aot.compile_step(megastep_body, unroll=unroll))
    aot.reset_stats()
    state = {"w": torch.arange(6, dtype=torch.float32)}
    out = {"rank": rank}
    try:
        state = elastic.run(step_fn, state, store, steps=steps)
    except elastic.RankFailure as rf:
        out["declared"] = str(rf)
        leave_world()
        return out
    events = journal.snapshot_events()
    path = health.dump_postmortem("elastic test")
    with open(path) as f:
        bundle = json.load(f)
    out.update(
        calls=step_fn.calls, stats=step_fn.totals,
        world=store.comm.Get_size(), epoch=elastic.current_epoch(),
        w=state["w"].numpy(), committed=store.committed_step,
        epoch_changes=[e["detail"] for e in events
                       if e.get("name") == "epoch_change"],
        rank_failed=[e["detail"] for e in events if e.get("name") == "health"
                     and "agreed failed" in e.get("detail", "")],
        bundle_epochs=bundle.get("epochs"),
        bundle_file=os.path.basename(path),
        recoveries=store.recoveries)
    return out


def auto_commit_program(rank: int, steps: int) -> dict:
    """``commit_every='auto'`` on ranks whose steps take different times
    (rank r sleeps (r + 1)^2 ms): the interval each would pick alone, and
    the one the loop locked in, with the steps each rank committed."""
    comm = world_comm()
    store = elastic.ShardStore(comm)
    committed = []
    real_commit = store.commit

    def commit(step, state):
        committed.append(step)
        real_commit(step, state)

    store.commit = commit

    def step_fn(state, step, c):
        time.sleep(1e-3 * (rank + 1) ** 2)
        return {"w": state["w"] + 1}

    elastic.run(step_fn, {"w": torch.zeros(1 << 18)}, store, steps=steps,
                commit_every="auto")
    return {"agreed": store.auto_commit_every, "committed": committed}


def clean_run_program(rank: int, params: dict, start_step: int, steps: int,
                      rdv: str, port_base: int, grid=None) -> dict:
    """The elastic example's loop on a clean world of this size (on a
    ``("y", "x")`` grid of shape ``grid``, if given), from ``params`` at
    ``start_step``: the losses and final parameters a restored, drained or
    grown run must reproduce bit for bit."""
    from mpi4jax_tpu_torch.models import elastic_training as ET

    if grid is None:
        comm = world_comm()
    else:
        mesh = tpx.make_world_mesh(tuple(grid), ("y", "x"), device="cpu")
        comm = tpx.Comm(mesh.axes, mesh=mesh)
    store = elastic.ShardStore(
        comm, bootstrap=bootstrap(rank, rdv, port_base, comm.Get_size()))
    step_fn, losses = ET.make_elastic_step(store=store)
    state = {"params": ET.to_device(params, "cpu")}
    state = elastic.run(step_fn, state, store, steps=steps,
                        start_step=start_step)
    return {"losses": [(r["step"], r["world"], r["loss"]) for r in losses],
            "params": ET.to_numpy(state["params"])}


# ---------------------------------------------------------------------------
# the planned boundaries
# ---------------------------------------------------------------------------


def _old_comm_refusal(comm) -> str:
    try:
        tpx.allreduce(torch.ones(2), comm=comm)
        return "ran"
    except RuntimeError as e:
        return getattr(e, "mpx_code", str(e))


def boundary_control_program(rank: int, rdv: str, port_base: int) -> dict:
    """An external loop (not ``elastic.run``) polling ``BoundaryControl``
    on three ranks: rank 2 asks to drain after step 3 and leaves at the
    next boundary; the others go on at world 2 to step 8.  The steps each
    rank ran, the drain records, the meters, what the old comm does
    (MPX127) and a ring ``sendrecv`` on the new one."""
    os.environ["MPI4JAX_TPU_TELEMETRY"] = "counters"
    from mpi4jax_tpu_torch import telemetry

    comm = world_comm()
    store = elastic.ShardStore(comm, bootstrap=bootstrap(rank, rdv, port_base, 3))
    state = {"w": torch.arange(4.0) + rank}
    state = {"w": tpx.allreduce(state["w"], comm=comm)[0]}
    store.commit(0, state)
    steps = []
    with elastic.BoundaryControl(store) as bc:
        step, out = 0, None
        while step < 8:
            c = store.comm
            total, _ = tpx.allreduce(state["w"], comm=c)
            state = {"w": state["w"] * 0.5 + total / (4 * c.Get_size())}
            steps.append((step, c.Get_size(), c.epoch))
            step += 1
            if rank == 2 and step == 3 and c.epoch == 0:
                elastic.request_drain()
            out = bc.poll(step, state, committed=False)
            if out is not None:
                kind, step, state = out
                if kind == "leave":
                    break
    res = {"steps": steps, "drained": store.drained, "drains": store.drains,
           "history": elastic.epoch_history(),
           "meters": telemetry.snapshot()["meters"],
           "old_drained": comm.drained, "old_comm": _old_comm_refusal(comm),
           "w": state["w"].numpy(), "committed": store.committed_step,
           "sigterm_restored": signal.getsignal(signal.SIGTERM) is signal.SIG_DFL}
    if store.drained:
        return res
    new = store.comm
    got, _ = tpx.sendrecv(torch.full((3,), float(new.Get_rank())),
                          torch.zeros(3), source=tpx.shift(-1),
                          dest=tpx.shift(1), comm=new)
    res.update(world=new.Get_size(), rank=new.Get_rank(), epoch=new.epoch,
               ring=got.numpy(), new_sum=float(tpx.allreduce(
                   torch.ones(1), comm=new)[0][0]))
    return res


JOIN_STEPS = 8


def _joiner_body(state, step, comm):
    total, _ = tpx.allreduce(state["w"], comm=comm)
    return {"w": state["w"] * 0.5 + total * (0.25 / comm.Get_size())
            + float(step)}


def joiner_step():
    """The auto-measuring grow's step: ``w = w / 2 + mean_ranks(w) / 4 +
    step``; at a world under 3 (the two-rank world's step 0) every rank
    first waits (``elastic_training``'s poll, at most 30 s) until rank 0's
    join listener holds the joiner."""
    from mpi4jax_tpu_torch.models import elastic_training as ET

    return ET._wait_for_join(_joiner_body, 3, 30.0)


def _committing(store):
    committed = []
    real = store.commit

    def commit(step, state):
        committed.append(int(step))
        real(step, state)

    store.commit = commit
    return committed


def auto_join_program(rank: int, rdv: str, port_base: int, out: str) -> dict:
    """A world of two ranks under ``commit_every='auto'`` that a third
    process joins while the world still measures (rank 0 starts it; every
    rank waits in step 0 until it has knocked): all three must lock the
    interval in at the same boundary.  Each rank's interval, commits,
    epochs and final state; the joiner writes its own to ``out``."""
    os.environ["MPI4JAX_TPU_ELASTIC_GROW"] = "1"
    if rank == 0:
        env = dict(os.environ)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(here), here, env.get("PYTHONPATH", "")])
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "join",
                          rdv, str(port_base), out], env=env,
                         stdout=subprocess.DEVNULL, stderr=open(out + ".err", "w"))
    comm = world_comm()
    store = elastic.ShardStore(comm, bootstrap=bootstrap(rank, rdv, port_base, 2))
    committed = _committing(store)
    state = elastic.run(joiner_step(), {"w": torch.arange(6.0)}, store,
                        steps=JOIN_STEPS, commit_every="auto")
    res = {"auto": store.auto_commit_every, "committed": committed,
           "grows": store.grows, "history": elastic.epoch_history(),
           "world": store.comm.Get_size(), "w": state["w"].numpy()}
    dist.barrier()
    dist.destroy_process_group()
    return res


def joiner_main(rdv: str, port_base: int, out: str) -> None:
    """The auto-measuring grow's joiner (a process of its own)."""
    torch.set_num_threads(1)
    store = elastic.ShardStore(None, bootstrap={
        "rendezvous": rdv, "host": "localhost", "port_base": port_base,
        "agree_port_base": port_base + 100, "agree_timeout": 20.0,
        "timeout": 50.0, "device": "cpu"})
    committed = _committing(store)
    state = elastic.join_and_run(joiner_step(), store, steps=JOIN_STEPS,
                                 commit_every=3, join_timeout=40.0)
    res = {"auto": store.auto_commit_every, "committed": committed,
           "joined": store.joined, "history": elastic.epoch_history(),
           "world": store.comm.Get_size(), "rank": store.comm.Get_rank(),
           "origin": elastic.origin_rank(store.comm.Get_rank()),
           "w": state["w"].tolist()}
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f, default=str)


# ---------------------------------------------------------------------------
# peer death and the process group's teardown (processes of their own)
# ---------------------------------------------------------------------------


def peer_program(rank: int, world: int, rdv: str, mode: str, out: str) -> None:
    """``mode`` ``die``: the last rank exits at once; ``hang``: it sleeps.
    The others run one allreduce (a 2 s process-group timeout), classify
    what it raised and time ``destroy_process_group``; rank 0 writes the
    record to ``out``."""
    tpx.init_distributed("gloo", init_method=rdv, world_size=world,
                         rank=rank, device="cpu", timeout=2.0)
    if rank == world - 1:
        if mode == "die":
            os._exit(0)
        time.sleep(60)
        os._exit(0)
    time.sleep(0.5)  # the last rank is gone (or asleep) by now
    t0 = time.perf_counter()
    try:
        dist.all_reduce(torch.ones(4))
        err = None
    except Exception as e:  # noqa: BLE001 - the error is the record
        err = e
    t1 = time.perf_counter()
    rf = elastic.classify_failure(err) if err is not None else None
    elastic._teardown_process_group()
    t2 = time.perf_counter()
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"error": None if err is None else
                       f"{type(err).__name__}: {err}",
                       "classified": rf is not None,
                       "suspects": sorted(rf.suspects) if rf else None,
                       "collective_s": t1 - t0, "destroy_s": t2 - t1,
                       "initialized_after": dist.is_initialized()}, f)
    os._exit(0)


if __name__ == "__main__":
    if sys.argv[1] == "join":
        joiner_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        peer_program(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                     sys.argv[4], sys.argv[5])
