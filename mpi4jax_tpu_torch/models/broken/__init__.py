"""Intentionally broken programs, the twins of ``examples/broken/``.

Each module holds one seeded hazard that the collective verifier
(``analysis/``) must catch, and runs both of its front-ends, as the JAX
package's script does:

- ``analyze(fn, *args, comm=..., ranks='all')`` on a *virtual* grid of N
  ranks (``ProcessGrid`` with ``rank=0``, no ``torch.distributed``);
- the ambient mode on the same virtual grid: ``set_analyze_mode('error')``
  and ``run(fn, *args, comm=comm)``, which raises ``AnalysisError``
  before anything runs (and under ``python -m mpi4jax_tpu_torch.analysis``
  hands its report to the command's sink);
- with ``--launch N``, the ambient mode on N gloo ranks started by
  ``parallel/launch.py`` under a time limit: every rank must raise
  ``AnalysisError`` with the expected code before any exchange, and a
  rank that hangs fails the drill.

A twin's module defines ``CODES`` (the codes of which one must fire),
``build(comm, device)`` (the per-rank function) and ``example(comm,
device)`` (one rank's arguments, on ``device``: ``meta`` templates for
the virtual grid); ``drill`` drives the three front-ends.
"""

from __future__ import annotations

import argparse
import importlib
import sys

RANKS = 4
TWINS = ("rank_divergent_deadlock", "pipeline_interleave_deadlock",
         "moe_divergent_capacity", "overlap_donation_race",
         "ef_divergent_gate")


def virtual_comm(n: int, device=None):
    """A 1-D comm over a virtual grid of ``n`` ranks named ``"x"``, this
    process its rank 0 (``device=None`` names the card; the abstract runs
    never touch it)."""
    import torch

    from ...parallel.comm import Comm
    from ...parallel.mesh import ProcessGrid

    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    return Comm("x", mesh=ProcessGrid((n,), ("x",), dev, rank=0))


def _codes(findings) -> set:
    return {f.code for f in findings}


def ambient_rank(rank: int, module: str):
    """One gloo rank of the ambient front-end: the program under
    ``MPI4JAX_TPU_ANALYZE=error`` on the world's comm.  Returns the codes
    of the ``AnalysisError`` it raised and the exchanges made before it;
    a run that completes raises."""
    from ... import analysis, run
    from ...ops import _staging
    from ...parallel.comm import Comm
    from ...parallel.mesh import make_world_mesh

    twin = importlib.import_module(f"{__name__}.{module}")
    comm = Comm("x", mesh=make_world_mesh(axes=("x",)))
    args = twin.example(comm, comm.device)
    analysis.set_analyze_mode("error")
    before = _staging.stats.calls
    try:
        run(twin.build(comm, comm.device), *args, comm=comm)
    except analysis.AnalysisError as e:
        return sorted(_codes(e.findings)), _staging.stats.calls - before
    finally:
        analysis.set_analyze_mode(None)
    raise AssertionError(f"rank {rank}: the ambient mode let {module} run")


def drill(module: str, argv=None) -> dict:
    """The three front-ends over one twin (the virtual grid of ``RANKS``
    ranks); returns the codes each found (``launch``: one entry per gloo
    rank)."""
    from ... import analysis, run
    from ...ops._base import clear_caches
    from ...parallel import launch

    ap = argparse.ArgumentParser(prog=f"python -m {__name__}.{module}")
    ap.add_argument("--launch", type=int, default=0,
                    help="also run the ambient mode on this many gloo ranks")
    ap.add_argument("--device", default=None,
                    help="the gloo ranks' device (default: the GPU)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="the gloo ranks' time limit in seconds")
    args = ap.parse_args(argv)
    twin = importlib.import_module(f"{__name__}.{module}")
    comm = virtual_comm(RANKS, args.device)
    example = twin.example(comm, "meta")
    out = {}

    report = analysis.analyze(twin.build(comm, "meta"), *example, comm=comm,
                              ranks="all")
    print(report.render(), file=sys.stderr)
    out["analyze"] = sorted(_codes(report.findings))
    if not twin.CODES & _codes(report.findings):
        raise AssertionError(f"{module}: analyze(ranks='all') found "
                             f"{out['analyze']}, expected one of {sorted(twin.CODES)}")

    analysis.set_analyze_mode("error")
    try:
        run(twin.build(comm, "meta"), *example, comm=comm)
    except analysis.AnalysisError as e:
        out["ambient"] = sorted(_codes(e.findings))
    else:
        raise AssertionError(f"{module}: the ambient mode let the program run")
    finally:
        analysis.set_analyze_mode(None)
        clear_caches()
    if not twin.CODES & set(out["ambient"]):
        raise AssertionError(f"{module}: the ambient mode found "
                             f"{out['ambient']}, expected {sorted(twin.CODES)}")

    if args.launch:
        got = launch.run(ambient_rank, args.launch, device=args.device,
                         timeout=args.timeout, args=(module,))
        out["launch"] = [list(codes) for codes, _ in got]
        for r, (codes, calls) in enumerate(got):
            if not twin.CODES & set(codes) or calls:
                raise AssertionError(
                    f"{module}: gloo rank {r} raised {codes} after {calls} "
                    f"exchange(s); expected {sorted(twin.CODES)} before any")
    print(f"{module}: {out}", file=sys.stderr)
    return out
