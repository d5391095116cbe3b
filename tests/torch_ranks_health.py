"""Rank programs of the health plane's parity tests.

Each function runs on every rank of a ``mpi4jax_tpu_torch.parallel.launch``
world of gloo ranks on the CPU.  Like ``torch_ranks.py`` this module
imports no JAX, since every rank imports it afresh;
``tests/test_torch_health.py`` holds the results against the JAX
package's ``telemetry/health.py`` on the same seeded inputs.  The health
knobs are set in the rank processes' own ``os.environ``.
"""

from __future__ import annotations

import os

import numpy as np

import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch import telemetry
from mpi4jax_tpu_torch.telemetry import health, journal

# the detector key every rank feeds (an op key of telemetry/core.py)
KEY = "sendrecv|0|native|float32"
SLOW_RANK, SLOW_FACTOR = 2, 5.0
SAMPLES = 5
BOUNDARIES = 2


def scripted_latencies(rank: int, size: int) -> list:
    """Rank ``rank``'s latencies in seconds, from a fixed seed: 0.1-0.2 ms,
    rank ``SLOW_RANK``'s five times as long."""
    rng = np.random.default_rng(11)
    lat = rng.uniform(1e-4, 2e-4, size=(size, SAMPLES))
    lat[SLOW_RANK] *= SLOW_FACTOR
    return [float(v) for v in lat[rank]]


def detector_program(rank: int, size: int, tdir: str) -> dict:
    """Each rank feeds its scripted latencies and ticks ``on_boundary``
    with the world comm, ``BOUNDARIES`` times, under ``events`` with the
    health plane on and the Prometheus file written into ``tdir``."""
    os.environ["MPI4JAX_TPU_HEALTH"] = "on"
    os.environ["MPI4JAX_TPU_HEALTH_PROM"] = "1"
    os.environ["MPI4JAX_TPU_TELEMETRY_DIR"] = tdir
    telemetry.set_telemetry_mode("events")
    comm = tpx.Comm("x", mesh=tpx.make_world_mesh((size,), ("x",), device="cpu"))
    findings = []
    for step in range(BOUNDARIES):
        for v in scripted_latencies(rank, size):
            health.feed_latency(KEY, v)
        findings.append(health.on_boundary(step, comm=comm))
    journal.flush()
    incidents = [(r["name"], r["rank"], r.get("detail", ""))
                 for r in journal.snapshot_events() if r.get("type") == "instant"]
    prom = os.path.join(tdir, f"{health.PROM_FILE_PREFIX}{rank}.prom")
    with open(prom) as f:
        prom_text = f.read()
    return {"findings": findings, "incidents": incidents,
            "exchanges": health._detector.exchanges,
            "boundaries": health._detector.boundaries,
            "strikes": dict(health._detector.strikes),
            "meters": telemetry.snapshot()["meters"],
            "prom": prom_text}


def default_mesh_program(rank: int, size: int) -> dict:
    """``get_default_mesh`` built once per world and replaceable."""
    from mpi4jax_tpu_torch.parallel import mesh

    first = tpx.get_default_mesh()
    again = tpx.get_default_mesh()
    comm = tpx.get_default_comm()
    custom = tpx.make_world_mesh((size,), ("x",), device="cpu")
    tpx.set_default_mesh(custom)
    replaced = tpx.get_default_mesh()
    tpx.set_default_mesh(None)
    rebuilt = tpx.get_default_mesh()
    return {"same": first is again, "shape": first.shape, "axes": first.axes,
            "rank": first.rank, "device": str(first.device),
            "comm_on_default": comm.mesh is first,
            "replaced": replaced is custom,
            "rebuilt_new": rebuilt is not first and rebuilt.shape == first.shape,
            "world_key": mesh._world_key()}
