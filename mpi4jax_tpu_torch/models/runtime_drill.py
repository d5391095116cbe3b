"""Resilience drills: a fault injected into the split-phase shallow-water
solve on several ranks, each drill in a launch of its own.

Each rank is a process of its own (``python -m
mpi4jax_tpu_torch.models.runtime_drill --rank r ...``) whose standard
error goes to a file, so that a drill reads what every rank printed
before it died, and an abort kills only that drill's ranks.  A rank runs
one warm-up step of the split-phase solve (``fast="pallas_halo"``, the
path with the most ``sendrecv`` calls) with every service off, then turns
the drill's services on through the ``set_*`` overrides (so that a slow
start-up is not a hang and the fault counts start at the drill) and runs
``STEPS`` more steps and a ``barrier``, on ``WORLD`` ranks in a (2, 2)
grid.  The drills:

- ``delay``: rank 2 sleeps ``delay`` seconds in every ``sendrecv`` after
  its 9th (``delay:rank=2:op=sendrecv:after=9``), under the ``events``
  tier with the journals in the drill's directory: the merged journals'
  skew table charges rank 2 with the late arrivals;
- ``watchdog``: the same clause, ``hang`` seconds, with the watchdog at
  ``timeout``: the ranks that wait for rank 2 print the watchdog's
  diagnostic and abort;
- ``corrupt``: rank 0's ``sendrecv`` inputs turn to NaN after its 2nd,
  under numeric guards: the guard aborts rank 0 with its message;
- ``die``: rank 1 exits with code 13 in its 5th ``sendrecv``, with the
  watchdog at ``timeout`` so that the others end instead of hanging;
- ``hang``: rank 2 sleeps for good in its 10th ``sendrecv``
  (``hang:rank=2:op=sendrecv:after=9``), with the watchdog at
  ``timeout``: the others abort; the hung rank is killed once they have
  ended.

Two drills arm the health plane (``MPI4JAX_TPU_HEALTH=on`` in the ranks'
environment; ``telemetry/health.py``) under the ``events`` tier, so that
each rank's flight ring holds its begins, records and incidents, and the
ranks write postmortem bundles into the drill's directory:

- ``health_hang``: the ``hang`` drill with the watchdog in its Python
  registry (``watchdog.force_python_fallback(True)``), whose expiry writes
  the bundle of each waiting rank (the C++ monitor aborts in C++ and
  writes none); its handler dumps and aborts one ``timeout`` later, so
  that the first death cannot close a connection another rank waits on
  before that rank's own expiry; the hung rank writes its bundle as it
  hangs.  Four
  bundles, and ``python -m mpi4jax_tpu_torch.telemetry postmortem`` names
  rank 2 from the fault incident at the tail of its ring;
- ``health_die``: the ``die`` drill: rank 1 writes its bundle (reason
  ``fatal_fault: die injected ...``) before it exits; the others, under
  the C++ watchdog, write none.

``run_drill(name, ...)`` starts the ranks, waits at most ``limit``
seconds (then kills what is left; a hung rank as soon as the others have
ended) and returns every rank's exit code, standard output and standard
error, with the seconds it took.  The
checks of what came out are the caller's (``chip_smoke.py`` phase 11, the
port's tests).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

DRILLS = ("delay", "watchdog", "corrupt", "die", "hang", "health_hang",
          "health_die")
# the rank that sleeps for good in the hang drills
HUNG_RANK = {"hang": 2, "health_hang": 2}
# the drills whose ranks run with MPI4JAX_TPU_HEALTH=on
HEALTH_DRILLS = ("health_hang", "health_die")
WORLD = 4  # the drill specs name ranks 0-2 of a (2, 2) grid
STEPS = 1  # drilled steps after the warm-up


def drill_spec(name: str, delay: float = 0.5, hang: float = 3.0):
    """``(fault spec, watchdog timeout or None, numeric guards,
    telemetry mode)`` of drill ``name``; ``timeout`` is filled in by the
    caller."""
    if name == "delay":
        return f"delay:rank=2:op=sendrecv:after=9:secs={delay:g}", False, False, "events"
    if name == "watchdog":
        return f"delay:rank=2:op=sendrecv:after=9:secs={hang:g}", True, False, "off"
    if name == "corrupt":
        return "corrupt:nan:rank=0:op=sendrecv:after=2", False, True, "off"
    if name in ("die", "health_die"):
        return ("die:rank=1:op=sendrecv:after=4", True, False,
                "events" if name == "health_die" else "off")
    if name in ("hang", "health_hang"):
        return ("hang:rank=2:op=sendrecv:after=9", True, False,
                "events" if name == "health_hang" else "off")
    raise ValueError(f"unknown drill {name!r}; one of {DRILLS}")


def rank_main(args) -> int:
    import torch

    from .. import resilience, telemetry
    from ..ops import barrier
    from ..parallel.mesh import init_distributed
    from . import shallow_water as P

    dev = init_distributed("gloo", init_method=args.rendezvous,
                           world_size=WORLD, rank=args.rank,
                           device=args.device, timeout=args.limit)
    torch.set_num_threads(1)
    cfg = P.Config(nx=args.nx, ny=args.ny, nproc_y=2, nproc_x=WORLD // 2)
    _, comm = P.make_mesh_and_comm(cfg, device=dev)
    s = P.initial_state(cfg, rank=comm.Get_rank(), device=dev)
    s = P.model_step_fused_halo(s, cfg, comm, True)
    barrier(comm=comm)

    spec, watchdog, numerics, mode = drill_spec(args.drill, args.delay, args.hang)
    if args.drill == "health_hang":
        from ..resilience import watchdog as _wd

        _wd.force_python_fallback(True)
        # the dump-and-die waits one timeout after the expiry (whose bundle
        # is written before the handler runs), so that every waiting rank
        # expires and writes its bundle before the first death closes the
        # connections the others wait on
        def die_late(entries, expired):
            time.sleep(args.timeout)
            _wd._default_on_timeout(entries, expired)

        _wd.set_on_timeout(die_late)
    resilience.set_fault_spec(spec)
    if watchdog:
        resilience.set_watchdog_timeout(args.timeout)
    resilience.set_check_numerics(numerics)
    telemetry.set_telemetry_mode(mode)
    for _ in range(STEPS):
        s = P.model_step_fused_halo(s, cfg, comm, False)
    barrier(comm=comm)
    finite = all(bool(torch.isfinite(f).all()) for f in s)
    print(f"DRILL_DONE rank {args.rank} finite={finite}", flush=True)
    return 0


def run_drill(name: str, *, device=None, nx: int = 48, ny: int = 24,
              timeout: float = 1.0, delay: float = 0.5, hang: float = 3.0,
              limit: float = 60.0, workdir: str = None) -> dict:
    """Run drill ``name`` on ``WORLD`` ranks (a (2, 2) grid of an ``nx``
    x ``ny`` domain on ``device``; ``None`` means the GPU, and without
    CUDA this raises unless given ``device="cpu"``); returns ``{"exit":
    [...], "stdout": [...], "stderr": [...], "seconds": s, "dir":
    workdir}``, the journals of the ``delay`` and health drills and the
    health drills' postmortem bundles in ``workdir``."""
    from ..parallel.mesh import resolve_device

    if name not in DRILLS:
        raise ValueError(f"unknown drill {name!r}; one of {DRILLS}")
    device = str(resolve_device(device))
    workdir = workdir or tempfile.mkdtemp(prefix=f"mpx-drill-{name}-")
    os.makedirs(workdir, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPI4JAX_TPU_")}
    env["MPI4JAX_TPU_TELEMETRY_DIR"] = workdir
    if name in HEALTH_DRILLS:
        env["MPI4JAX_TPU_HEALTH"] = "on"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    rendezvous = "file://" + os.path.join(workdir, "rendezvous")
    procs, files = [], []
    t0 = time.perf_counter()
    for r in range(WORLD):
        out = open(os.path.join(workdir, f"rank{r}.out"), "w")
        err = open(os.path.join(workdir, f"rank{r}.err"), "w")
        files.append((out, err))
        cmd = [sys.executable, "-m", "mpi4jax_tpu_torch.models.runtime_drill",
               "--drill", name, "--rank", str(r), "--rendezvous", rendezvous,
               "--device", device, "--nx", str(nx), "--ny", str(ny),
               "--timeout", str(timeout),
               "--delay", str(delay), "--hang", str(hang), "--limit", str(limit)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=err,
                                      cwd=root))
    deadline = time.monotonic() + limit
    hung = HUNG_RANK.get(name)
    try:
        # a hung rank never returns: it is killed (below) as soon as the
        # others have ended
        for r, p in enumerate(procs):
            if r == hung:
                continue
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    res = {"exit": [p.returncode for p in procs], "stdout": [], "stderr": [],
           "seconds": time.perf_counter() - t0, "dir": workdir}
    for r in range(WORLD):
        for key, ext in (("stdout", "out"), ("stderr", "err")):
            with open(os.path.join(workdir, f"rank{r}.{ext}")) as f:
                res[key].append(f.read())
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--drill", choices=DRILLS, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--rendezvous", required=True)
    parser.add_argument("--device", default=None,
                        help="the device (default: the GPU; 'cpu' for the CPU)")
    parser.add_argument("--nx", type=int, default=48)
    parser.add_argument("--ny", type=int, default=24)
    parser.add_argument("--timeout", type=float, default=1.0)
    parser.add_argument("--delay", type=float, default=0.5)
    parser.add_argument("--hang", type=float, default=3.0)
    parser.add_argument("--limit", type=float, default=60.0)
    return rank_main(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
