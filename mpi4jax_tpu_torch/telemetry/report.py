"""Cross-rank telemetry report: snapshot gathering and the per-op table.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/report.py``.
``report(comm=...)`` gathers every process's snapshot through the port's
own collectives (a MAX ``allreduce`` sizes the buffer, one ``allgather``
moves the JSON-encoded uint8 payloads; no side channel), keeps one
snapshot per process, and renders one row per (op, comm, algorithm,
dtype) with calls, bytes, min/p50/p99 latency and the straggler columns:
the largest cross-rank arrival skew and the rank most often last to
arrive (``merge.skew_table`` over the gathered events), then the meters
summed over the processes and, where the serving engine ran
(``serving/engine.py``), its section: admissions, completions, failures,
tokens, prefills, decode megasteps and drain re-admissions; where the
pipeline's phases ran (``parallel/pipeline.py``), its section: the
steady rounds, the stage and bubble-wait microseconds and the measured
bubble fraction.  Every
rank must call it, outside any region, as every collective.
"""

from __future__ import annotations

import json
import sys
from typing import List

from . import core, merge
from .hist import Histogram

__all__ = ["snapshot", "report", "dump", "gather_snapshots", "render"]

snapshot = core.snapshot


def dump(path: str, include_events: bool = True) -> str:
    """Write this process's snapshot (events included by default) as JSON
    to ``path``; returns ``path``."""
    with open(path, "w") as f:
        json.dump(core.snapshot(include_events=include_events), f,
                  indent=2, sort_keys=True)
        f.write("\n")
    return path


def gather_snapshots(comm=None) -> List[dict]:
    """Every process's snapshot, gathered over ``comm`` (``None``: the
    world's comm) through ``allreduce`` and ``allgather``; one per
    process, in process order.  Events are included in the events tier."""
    import torch

    from ..ops import MAX, allgather, allreduce
    from ..parallel.region import resolve_comm

    comm = resolve_comm(comm)
    local = json.dumps(core.snapshot(include_events=core.events_on()),
                       sort_keys=True).encode()
    dev = comm.device
    n = torch.tensor([len(local)], dtype=torch.int64, device=dev)
    maxlen = int(allreduce(n, op=MAX, comm=comm)[0].item())
    payload = torch.zeros(maxlen, dtype=torch.uint8)
    payload[:len(local)] = torch.frombuffer(bytearray(local), dtype=torch.uint8)
    rows = allgather(payload.to(dev), comm=comm)[0].cpu()

    snaps = {}
    for row in rows:
        text = row.numpy().tobytes().rstrip(b"\x00").decode()
        snap = json.loads(text)
        snaps.setdefault(snap.get("process", 0), snap)
    return [snaps[p] for p in sorted(snaps)]


def _merge_counters(snaps: List[dict]) -> dict:
    """Op counters summed and latency histograms merged across process
    snapshots: ``{key: row}``."""
    out: dict = {}
    for snap in snaps:
        for key, row in snap.get("ops", {}).items():
            dst = out.setdefault(key, {
                **{k: row[k] for k in ("op", "comm_uid", "algo", "dtype")},
                "calls": 0, "bytes": 0, "intra_bytes": 0,
                "inter_bytes": 0, "hist": Histogram(),
            })
            dst["calls"] += row.get("calls", 0)
            dst["bytes"] += row.get("bytes", 0)
            dst["intra_bytes"] += row.get("intra_bytes", 0)
            dst["inter_bytes"] += row.get("inter_bytes", 0)
            if "latency" in row:
                dst["hist"] = dst["hist"].merge(
                    Histogram.from_dict(row["latency"]))
    return out


def _merged_events(snaps: List[dict]) -> list:
    events = []
    for snap in snaps:
        events.extend(snap.get("events", []))
    return events


def _fmt_us(seconds) -> str:
    if seconds is None:
        return "-"
    return f"{seconds * 1e6:,.1f}"


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):,.1f}M"
    if n >= 1 << 10:
        return f"{n / (1 << 10):,.1f}K"
    return str(n)


def render(snaps: List[dict]) -> str:
    """The per-op table of a set of process snapshots, the JAX package's
    columns, then the meters, dropped records, pins and the skew table."""
    ops = _merge_counters(snaps)
    events = _merged_events(snaps)
    skews = merge.skew_table(events) if events else {"per_op": {},
                                                    "per_rank": {}}

    header = (
        f"{'op':<16} {'comm':>4} {'algo':<10} {'dtype':<9} {'calls':>7} "
        f"{'bytes':>9} {'intra B':>9} {'inter B':>9} {'execs':>6} "
        f"{'min us':>9} {'p50 us':>9} "
        f"{'p99 us':>9} {'skew us':>9} {'straggler':>9}"
    )
    lines = [header, "-" * len(header)]
    # the table's straggler column charges the rank with the most last
    # arrivals overall; the skew chart below has the full story
    worst_rank = None
    if skews["per_rank"]:
        worst_rank = max(skews["per_rank"],
                         key=lambda r: skews["per_rank"][r]["last_arrivals"])
    for key in sorted(ops):
        row = ops[key]
        h = row["hist"]
        sk = skews["per_op"].get(row["op"])
        lines.append(
            f"{row['op']:<16} {row['comm_uid']:>4} {row['algo']:<10} "
            f"{row['dtype']:<9} {row['calls']:>7} "
            f"{_fmt_bytes(row['bytes']):>9} "
            f"{_fmt_bytes(row['intra_bytes']):>9} "
            f"{_fmt_bytes(row['inter_bytes']):>9} {h.count:>6} "
            f"{_fmt_us(h.min):>9} {_fmt_us(h.quantile(0.5)):>9} "
            f"{_fmt_us(h.quantile(0.99)):>9} "
            f"{_fmt_us(sk['max_skew']) if sk else '-':>9} "
            f"{('r' + str(worst_rank)) if sk else '-':>9}"
        )
    total_meters = {}
    for snap in snaps:
        for name, n in snap.get("meters", {}).items():
            total_meters[name] = total_meters.get(name, 0) + n
    if total_meters:
        lines.append("")
        lines.append("meters:")
        for name in sorted(total_meters):
            lines.append(f"  {name:<40} {total_meters[name]:>10}")
    # the serving engine's request-level story (serving/engine.py), which
    # its per-phase op rows (serving.prefill, serving.decode) do not carry,
    # summed across processes as every meter is
    srv = {name[len("serving."):]: n for name, n in total_meters.items()
           if name.startswith("serving.")}
    if srv:
        lines.append("")
        lines.append("serving:")
        for label, key in (("requests admitted", "requests_admitted"),
                           ("requests completed", "requests_completed"),
                           ("requests failed", "requests_failed"),
                           ("tokens generated", "tokens_generated"),
                           ("prefill dispatches", "prefills"),
                           ("decode megasteps", "megasteps"),
                           ("drain re-admissions", "readmissions")):
            if key in srv:
                lines.append(f"  {label:<22} {srv[key]:>10}")
    # the pipeline's measured bubble (parallel/pipeline.py): host-bracket
    # time of the steady phases ("stage") against the warmup and cooldown
    # ("bubble_wait"), summed across processes as every meter is
    pipe = {name[len("pipeline."):]: n for name, n in total_meters.items()
            if name.startswith("pipeline.")}
    if pipe:
        lines.append("")
        lines.append("pipeline:")
        for label, key in (("steady rounds", "rounds"),
                           ("stage time (us)", "stage_us"),
                           ("bubble wait (us)", "bubble_wait_us")):
            if key in pipe:
                lines.append(f"  {label:<22} {pipe[key]:>10}")
        stage_us = pipe.get("stage_us", 0)
        bubble_us = pipe.get("bubble_wait_us", 0)
        if stage_us + bubble_us > 0:
            frac = bubble_us / float(stage_us + bubble_us)
            lines.append(f"  {'bubble fraction':<22} {frac:>10.1%}")
    total_dropped = {}
    for snap in snaps:
        for src, n in snap.get("dropped", {}).items():
            total_dropped[src] = total_dropped.get(src, 0) + n
    if any(total_dropped.values()):
        lines.append("")
        lines.append("dropped: " + ", ".join(
            f"{n} {src} record(s)"
            for src, n in sorted(total_dropped.items()) if n))
    pins = [snap["compile_cache"]["aot"] for snap in snaps
            if "compile_cache" in snap]
    if pins:
        agg = {k: sum(p.get(k, 0) for p in pins)
               for k in ("pins", "calls", "stale_raises", "replays",
                         "eager_pins")}
        lines.append("")
        lines.append("compile cache:")
        lines.append(
            f"  aot: {agg['pins']} pin(s), {agg['calls']} pinned call(s), "
            f"{agg['stale_raises']} stale refusal(s), {agg['replays']} graph "
            f"replay(s), {agg['eager_pins']} pin(s) run eagerly")
    if events:
        lines.append("")
        lines.append(merge.render_skew(skews))
    return "\n".join(lines)


def report(comm=None, file=None) -> str:
    """Gather every process's snapshot over ``comm`` and print and return
    the per-op table (the straggler columns need the ``events`` tier;
    with ``counters`` they read ``-``)."""
    from . import journal

    journal.flush()
    text = render(gather_snapshots(comm))
    print(text, file=file if file is not None else sys.stdout)
    return text
