"""``autotune()``: measure the performance knobs on the actual ranks.

PyTorch counterpart of ``mpi4jax_tpu/autotune/runner.py``.  Runs the
sweeps of ``autotune/sweeps.py`` under a wall-clock budget, feeds the
rows through the fitters (``autotune/fit.py``) and emits one
``mpx-tuning/1`` file (``autotune/schema.py``) that the config layer
serves between the defaults and the environment (``MPI4JAX_TPU_TUNING``,
``load_tuning``):

- the ``ici`` alpha and beta by least squares over the ``sendrecv`` ring
  ladder; ``dcn`` scaled from them by the JAX package's inter-host ratios
  (``costmodel.DCN_ALPHA_RATIO``, ``DCN_BANDWIDTH_RATIO``), since the
  port's ranks share one host;
- gamma (the device's fold), the compute rate (the device's copy) and the
  dispatch per step, measured;
- the ring crossover from the butterfly-against-ring sweep of a PROD
  allreduce (phase 2; the alpha-beta closed form where the ring never
  wins; no sweep below ``RING_MIN_GROUP`` ranks, where ``auto`` never
  takes the ring and the crossover is unused); the DCN crossover from the closed form over the scaled ``dcn``
  class;
- per requested topology spec (``topologies=``, faked with
  ``MPI4JAX_TPU_TOPOLOGY``), the flat-against-hier crossover (phase 4)
  and the alltoall crossover (phase 4b), as the file's ``topologies``
  overrides; the alltoall crossover is swept under the derived topology
  only on several real hosts;
- fusion bucket bytes and overlap chunk counts by sweeping candidates;
- the codec (phase 6b): the fastest modeled inter-host leg whose
  measured round-trip error fits ``MPI4JAX_TPU_COMPRESS_ERROR_BUDGET``;
- the commit pack throughput (``resilience.elastic.pack_leaves``).

On one host every hierarchy sweep runs under a faked topology: four
processes on one device, no inter-host link, so its crossovers say when
the port's two-level lowering beats its flat ring there, not what a
hierarchy gains across hosts; ``provenance`` records the faked specs
(``faked_topologies``).

Every rank of ``comm`` calls :func:`autotune` (each sweep is a
collective program); the budget decisions are agreed (the slowest rank's
clock), so every rank climbs the same ladders.  ``python -m
mpi4jax_tpu_torch.autotune`` is the command form (exit 0 every knob
fitted, 1 partial, 2 failure).
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from typing import List, Optional, Tuple

from . import fit
from .schema import SCHEMA, TuningFile

# candidate ladders, tiny first: each phase climbs while the budget lasts
P2P_SIZES_KB = (0.004, 4.0, 64.0, 1024.0)
# default first (4 MiB is the shipped default): pick_min breaks ties
# toward the earlier row
FUSION_BUCKET_CANDIDATES = (4 << 20, 1 << 20, 16 << 20, 1 << 18)
OVERLAP_CHUNK_CANDIDATES = (2, 1, 4)
OVERLAP_SIZES_MB = (0.25, 4.0)
PACK_PROBE_BYTES = 8 << 20

ALGO_SIZES_MB = (0.01, 0.1, 0.5, 1.0, 4.0, 16.0)

# what one host cannot measure, and why (the sweeps themselves all run)
SKIPPED_SWEEPS = {
    "dcn_links": "one host has no inter-host link: the dcn alpha and "
                 "bandwidth are the ici fit scaled by the JAX package's "
                 "ratios, and the DCN crossover is their closed form",
    "hierarchy_gain": "the hierarchy and alltoall sweeps run under a "
                      "faked MPI4JAX_TPU_TOPOLOGY: processes of one "
                      "host, not a hierarchy's gain across hosts",
    "codec_time": "the codec sweep's times are modeled (cost model); its "
                  "round-trip error is measured",
}


def _meter(name: str, n: int = 1) -> None:
    from ..telemetry.core import meter

    meter(name, n)


class _Budget:
    """Wall-clock budget; ``ok()`` is agreed over the comm (the slowest
    rank's clock), so that every rank takes the same rungs.  At least one
    rung of every phase runs."""

    def __init__(self, budget_s: float, comm):
        self.budget_s = float(budget_s)
        self.comm = comm
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def ok(self) -> bool:
        from .sweeps import slowest

        return slowest(self.comm, self.elapsed()) < self.budget_s


def provenance_block(device, n_ranks: int) -> dict:
    """What the measurement ran on: torch and CUDA versions, the device
    (the card's name), the rank count, the topology and a stamp of the
    whole flag surface."""
    import torch

    from ..utils import config

    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    stamp = hashlib.sha256(
        repr(config.env_fingerprint()).encode()).hexdigest()[:12]
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": dev.type,
        "device": name,
        "n_devices": n_ranks,
        "topology": config.topology_spec() or f"1x{n_ranks}",
        "config_stamp": stamp,
    }


def _pack_throughput_gb_s() -> Optional[float]:
    """``ShardStore`` pack throughput (GB/s) over a synthetic state: the
    commit-cost half of ``commit_every='auto'``."""
    import numpy as np

    from ..resilience.elastic import pack_leaves

    leaves = [np.ones(PACK_PROBE_BYTES // 8 // 4, np.float32)
              for _ in range(8)]
    pack_leaves(leaves)  # warm (allocator, first touch)
    best = float("inf")
    buf = None
    for _ in range(3):
        t0 = time.perf_counter()
        buf, _meta = pack_leaves(leaves)
        best = min(best, time.perf_counter() - t0)
    if best <= 0 or buf is None or not buf.nbytes:
        return None
    return buf.nbytes / best / 1e9


def _world_comm(device=None):
    from ..parallel.comm import Comm
    from ..parallel.mesh import make_world_mesh

    mesh = make_world_mesh(device=device)
    return Comm(mesh.axes[0], mesh=mesh)


def autotune(comm=None, budget_s: float = 60.0, save: Optional[str] = None,
             load: bool = True, topologies: Tuple[str, ...] = (),
             verbose: bool = False, device=None):
    """Tune every performance knob on the actual ranks (see the module
    docstring); returns an :class:`AutotuneResult` whose ``payload`` is a
    validated ``mpx-tuning/1`` dict.  ``save=`` also writes it (rank 0 of
    ``comm`` writes); ``load=True`` installs it as the tuning layer
    (``load_tuning``).  ``topologies``: ``MPI4JAX_TPU_TOPOLOGY`` specs to
    sweep the flat-against-hier crossovers for (per-topology overrides).
    ``comm=None`` is the world's comm on ``device`` (``None``: the
    card)."""
    if budget_s <= 0:
        raise ValueError(f"budget_s must be > 0, got {budget_s}")
    from . import sweeps
    from ..analysis import costmodel

    if comm is None:
        comm = _world_comm(device)
    budget = _Budget(budget_s, comm)
    n = comm.Get_size()
    rank = comm.Get_rank()
    _meter("autotune.runs")

    def note(msg):
        if verbose and rank == 0:
            print(f"autotune: {msg}", file=sys.stderr)

    tuned: dict = {}
    measured: dict = {}
    fit_sources: dict = {}
    topo_overrides: dict = {}
    fitted: List[str] = []
    unfitted: List[str] = []

    # -- phase 1: ici alpha/beta over the sendrecv ring -------------------
    pp_rows = []
    for kb in P2P_SIZES_KB:
        pp_rows += sweeps.bench_sendrecv_ring(comm, sizes_kb=[kb], iters=10)
        if not budget.ok():
            break
    alpha_us, gb_per_s = sweeps.fit_alpha_beta(
        [(r["size_kb"] * 1e3, r["hop_us"]) for r in pp_rows])
    note(f"ici fit: alpha {alpha_us:.3f} us, {gb_per_s:.3f} GB/s "
         f"({len(pp_rows)} point(s))")
    dcn_alpha = alpha_us * costmodel.DCN_ALPHA_RATIO
    dcn_bw = max(gb_per_s * costmodel.DCN_BANDWIDTH_RATIO, 0.001)
    links = {
        "ici": {"alpha_us": round(alpha_us, 4),
                "gb_per_s": round(gb_per_s, 4)},
        "dcn": {"alpha_us": round(dcn_alpha, 4),
                "gb_per_s": round(dcn_bw, 4)},
    }
    fitted.append("links")
    _meter("autotune.fits")

    # -- phase 1b: gamma, compute rate, dispatch --------------------------
    gamma = sweeps.fold_gb_per_s(comm)
    compute = sweeps.copy_gb_per_s(comm)
    dispatch = sweeps.dispatch_us(comm)
    note(f"gamma {gamma:.2f} GB/s, compute {compute:.2f} GB/s, dispatch "
         f"{dispatch:.2f} us")

    # -- phase 2: ring crossover (measured, closed-form fallback) ---------
    # below RING_MIN_GROUP ranks ``auto`` never takes the ring: no sweep
    from ..ops._algos import RING_MIN_GROUP

    algo_rows = []
    for mb in ALGO_SIZES_MB if n >= RING_MIN_GROUP else ():
        algo_rows += sweeps.bench_allreduce_algos(comm, sizes_mb=[mb],
                                                  iters=3)
        # two consecutive ring wins bound the interpolation from above
        if (len(algo_rows) >= 2
                and all(r["ring_speedup"] and r["ring_speedup"] > 1.0
                        for r in algo_rows[-2:])):
            break
        if not budget.ok():
            break
    ring_x = sweeps.measured_ring_crossover(algo_rows)
    ring_x_source = "sweep"
    if ring_x is None:
        ring_x = fit.analytic_crossover(alpha_us, gb_per_s, n)
        ring_x_source = "alpha-beta fit"
    if ring_x is not None:
        tuned["ring_crossover_bytes"] = int(ring_x)
        if ring_x_source == "sweep":
            measured["ring_crossover_bytes"] = int(ring_x)
        fit_sources["ring_crossover_bytes"] = ring_x_source
        fitted.append("ring_crossover_bytes")
        _meter("autotune.fits")
        note(f"ring crossover: {ring_x} B ({ring_x_source})")
    else:
        unfitted.append("ring_crossover_bytes")
        note("ring crossover: unfitted (group too small for the ring)")

    # -- phase 3: DCN crossover (closed form over the scaled dcn class) ---
    from ..parallel.topology import derive_world_topology

    topo = derive_world_topology(comm)
    hosts = topo.num_hosts if topo is not None else 1
    dcn_x = fit.analytic_crossover(dcn_alpha, dcn_bw, max(hosts, 4))
    if dcn_x is not None:
        tuned["dcn_crossover_bytes"] = int(dcn_x)
        fit_sources["dcn_crossover_bytes"] = "alpha-beta fit (scaled dcn)"
        fitted.append("dcn_crossover_bytes")
        _meter("autotune.fits")
        note(f"dcn crossover: {dcn_x} B (alpha-beta fit, h>={max(hosts, 4)})")
    else:
        unfitted.append("dcn_crossover_bytes")

    # -- phase 4: per-topology flat-vs-hier crossovers --------------------
    for spec in topologies:
        if not budget.ok():
            note(f"budget exhausted before topology {spec}")
            break
        hier_rows = sweeps.bench_hierarchy(
            comm, sizes_mb=tuple(ALGO_SIZES_MB[:4]), topologies=(spec,),
            iters=3)
        x = fit.measured_crossover(hier_rows, "size_mb", "flat_us",
                                   "hier_us")
        if x is not None:
            topo_overrides[spec] = {"ring_crossover_bytes": int(x)}
            fitted.append(f"topologies[{spec}]")
            _meter("autotune.fits")
            note(f"hier crossover @ {spec}: {x} B")

    # -- phase 4b: alltoall crossover (flat vs hier, per topology) --------
    # swept per requested topology, or under the derived one on several
    # real hosts; one host leaves the knob untuned
    a2a_specs = list(topologies) or ([None] if hosts > 1 else [])
    for spec in a2a_specs:
        if not budget.ok():
            note("budget exhausted before the alltoall crossover sweep")
            break
        a2a_rows = sweeps.bench_alltoall(
            comm, sizes_mb=tuple(ALGO_SIZES_MB[:4]), topologies=(spec,),
            iters=3)
        x = fit.measured_crossover(a2a_rows, "size_mb", "flat_us", "hier_us")
        if x is None:
            continue
        if spec is None:
            tuned["alltoall_crossover_bytes"] = int(x)
            measured["alltoall_crossover_bytes"] = int(x)
            fit_sources["alltoall_crossover_bytes"] = "sweep"
            fitted.append("alltoall_crossover_bytes")
        else:
            topo_overrides.setdefault(spec, {})[
                "alltoall_crossover_bytes"] = int(x)
            if "alltoall_crossover_bytes" not in tuned:
                # the first fitted topology seeds the flat knob too
                tuned["alltoall_crossover_bytes"] = int(x)
                measured["alltoall_crossover_bytes"] = int(x)
                fit_sources["alltoall_crossover_bytes"] = f"sweep @ {spec}"
                fitted.append("alltoall_crossover_bytes")
            fitted.append(f"alltoall[{spec}]")
        _meter("autotune.fits")
        note(f"alltoall crossover @ {spec or 'ambient'}: {x} B")
    if "alltoall_crossover_bytes" not in tuned:
        unfitted.append("alltoall_crossover_bytes")

    # -- phase 5: fusion bucket bytes -------------------------------------
    bucket_rows = []
    for cand in FUSION_BUCKET_CANDIDATES:
        if bucket_rows and not budget.ok():
            break
        with sweeps.env_patch(MPI4JAX_TPU_FUSION_BUCKET_BYTES=cand):
            rows = sweeps.bench_fusion(comm, counts=(16,), size_kb=64)
        bucket_rows.append({"bucket_bytes": cand,
                            "fused_us_per_op": rows[0]["fused_us_per_op"]})
    best_bucket = (fit.pick_min(bucket_rows, "bucket_bytes",
                                "fused_us_per_op")
                   if len(bucket_rows) >= 2 else None)
    if best_bucket is not None:
        tuned["fusion_bucket_bytes"] = int(best_bucket[0])
        measured["fusion_bucket_bytes"] = int(best_bucket[0])
        fit_sources["fusion_bucket_bytes"] = "sweep"
        fitted.append("fusion_bucket_bytes")
        _meter("autotune.fits")
        note(f"fusion bucket: {best_bucket[0]} B "
             f"({best_bucket[1]:.2f} us/op)")
    else:
        unfitted.append("fusion_bucket_bytes")

    # -- phase 6: overlap chunks per payload bucket -----------------------
    winners = []
    for mb in OVERLAP_SIZES_MB:
        if winners and not budget.ok():
            break
        per_payload = []
        for cand in OVERLAP_CHUNK_CANDIDATES:
            with sweeps.env_patch(MPI4JAX_TPU_OVERLAP_CHUNKS=cand):
                rows = sweeps.bench_overlap(comm, sizes_mb=(mb,))
            per_payload.append({"chunks": cand,
                                "overlap_us": rows[0]["overlap_us"]})
        best = fit.pick_min(per_payload, "chunks", "overlap_us")
        if best is not None:
            winners.append((int(mb * 1e6), int(best[0])))
    chunks = fit.chunk_buckets(winners)
    if chunks is not None:
        tuned["overlap_chunks"] = chunks
        fit_sources["overlap_chunks"] = "sweep"
        fitted.append("overlap_chunks")
        _meter("autotune.fits")
        note(f"overlap chunks: {chunks}")
    else:
        unfitted.append("overlap_chunks")

    # -- phase 6b: the codec against the error budget --------------------
    # the fastest modeled inter-host leg whose measured round-trip error
    # fits MPI4JAX_TPU_COMPRESS_ERROR_BUDGET; "off" always fits, so the
    # knob is always recorded; legs below the DCN crossover stay exact
    if budget.ok():
        from ..utils import config as _config

        err_budget = _config.compress_error_budget()
        comp_rows = sweeps.bench_compression(comm, sizes_mb=(1.0,), iters=3)
        best_codec, best_us = "off", None
        for row in comp_rows:
            if row["rel_err"] > err_budget:
                continue
            if best_us is None or row["modeled_dcn_us"] < best_us:
                best_codec, best_us = row["codec"], row["modeled_dcn_us"]
            measured[f"compress_rel_err_{row['codec']}"] = row["rel_err"]
        if best_codec == "off":
            tuned["compress"] = "off"
        else:
            bound = int(tuned.get("dcn_crossover_bytes",
                                  _config.dcn_crossover_bytes()))
            tuned["compress"] = [
                {"max_bytes": bound, "codec": "off"},
                {"max_bytes": None, "codec": best_codec},
            ]
        fit_sources["compress"] = "sweep vs error budget"
        fitted.append("compress")
        _meter("autotune.fits")
        note(f"compress codec: {best_codec} (error budget {err_budget:g})")
    else:
        unfitted.append("compress")

    # -- phase 7: commit pack throughput ----------------------------------
    pack = _pack_throughput_gb_s()
    if pack is not None:
        tuned["commit"] = {
            "pack_gb_per_s": round(pack, 4),
            "target_overhead": fit.DEFAULT_COMMIT_OVERHEAD,
        }
        fitted.append("commit")
        _meter("autotune.fits")
        note(f"commit pack throughput: {pack:.2f} GB/s")
    else:
        unfitted.append("commit")

    prov = provenance_block(comm.device, n)
    payload = {
        "schema": SCHEMA,
        "source": (f"mpi4jax_tpu_torch.autotune ({prov['device']}, {n} "
                   f"rank(s), budget {budget.budget_s:g}s)"),
        "links": links,
        "gamma_gb_per_s": round(gamma, 4),
        "compute_gb_per_s": round(compute, 4),
        "dispatch_us": round(dispatch, 4),
        "tuned": tuned,
        "measured": measured,
        "provenance": dict(
            prov, budget_s=budget.budget_s,
            elapsed_s=round(budget.elapsed(), 2),
            created=time.strftime("%Y-%m-%dT%H:%M:%S"),
            fit_sources=fit_sources, skipped=dict(SKIPPED_SWEEPS),
            faked_topologies=list(topologies)),
    }
    if topo_overrides:
        payload["topologies"] = topo_overrides
    tf = TuningFile(payload)  # validates: an unloadable emit is a bug here

    path = None
    if save:
        path = save
        if rank == 0:
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
            note(f"saved {path} (tuned@{tf.stamp})")
    if load:
        from ..utils import config

        tf = config.load_tuning(payload)
    return AutotuneResult(payload=payload, tuning=tf, path=path,
                          fitted=tuple(fitted), unfitted=tuple(unfitted),
                          elapsed_s=budget.elapsed())


def rank_autotune(rank, budget_s, save, device=None, topologies=()) -> dict:
    """One rank of ``python -m mpi4jax_tpu_torch.autotune`` (rank 0
    saves): the payload, its stamp, the knobs fitted and untuned and the
    seconds, as plain data."""
    res = autotune(budget_s=budget_s, save=save if rank == 0 else None,
                   load=False, topologies=tuple(topologies), verbose=True,
                   device=device)
    return {"payload": res.payload, "stamp": res.stamp,
            "fitted": list(res.fitted), "unfitted": list(res.unfitted),
            "elapsed_s": res.elapsed_s}


class AutotuneResult:
    """What one run produced: the validated payload, the (possibly
    installed) :class:`~.schema.TuningFile`, where it was saved, and the
    knobs fitted and left untuned (the command's exit code: 0 all, 1
    some untuned)."""

    __slots__ = ("payload", "tuning", "path", "fitted", "unfitted",
                 "elapsed_s")

    def __init__(self, payload, tuning, path, fitted, unfitted, elapsed_s):
        self.payload = payload
        self.tuning = tuning
        self.path = path
        self.fitted = fitted
        self.unfitted = unfitted
        self.elapsed_s = elapsed_s

    @property
    def stamp(self) -> str:
        return self.tuning.stamp

    def __repr__(self):
        return (f"AutotuneResult(tuned@{self.stamp}, "
                f"{len(self.fitted)} fitted, "
                f"{len(self.unfitted)} unfitted, "
                f"{self.elapsed_s:.1f}s)")
