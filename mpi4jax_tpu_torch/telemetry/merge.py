"""Merge per-rank JSONL journals into one Chrome-trace-event timeline.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/merge.py`` (its merge
half): ``python -m mpi4jax_tpu_torch.telemetry merge <dir> --perfetto
out.json`` reads every ``*.jsonl`` the events tier wrote under ``<dir>``
(one file per process; records carry their rank), validates each line,
and renders:

- a **Chrome trace-event file** (the JSON format Perfetto and
  ``chrome://tracing`` open): rank = pid, one tid row per op name, one
  complete (``ph: "X"``) slice per op execution with call id / seq /
  bytes / dtype / algorithm in ``args``, and instant events for
  journalled incidents (fault injections, watchdog expiries);
- a **straggler attribution table**: executions of the same call are
  matched across ranks by ``(op, call_id, seq)``; per group, skew = max -
  min arrival (``t_begin``), and the rank arriving last is charged.

The records' schema is the JAX package's, so journals of either package
merge here and there, into the same trace (``TRACE_PRODUCER`` names that
format).  The ``postmortem`` subcommand reads the health plane's crash
bundles, which the port does not write yet (``telemetry/health.py`` is
not ported).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

__all__ = ["read_journal", "merge_dir", "chrome_trace", "skew_table",
           "render_skew", "main", "MalformedJournal"]

# the trace format's producer tag, shared with the JAX package's merge so
# that one run's timeline reads the same from either
TRACE_PRODUCER = "mpi4jax_tpu.telemetry"

_OP_REQUIRED = ("op", "call_id", "seq", "rank", "t_begin", "t_end",
                "latency")
_INSTANT_REQUIRED = ("name", "rank", "t")

# pid/tid sort: the "events" row (instants) sits above the op rows
_INSTANT_TID = 0


class MalformedJournal(ValueError):
    """A journal line that does not parse or lacks required fields
    (the CI lane fails the build on this)."""


def read_journal(path: str) -> List[dict]:
    """Parse one JSONL journal, validating every line."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise MalformedJournal(
                    f"{path}:{lineno}: not valid JSON: {e}"
                ) from e
            if not isinstance(rec, dict):
                raise MalformedJournal(
                    f"{path}:{lineno}: expected a JSON object, got "
                    f"{type(rec).__name__}"
                )
            kind = rec.get("type")
            required = {"op": _OP_REQUIRED, "instant": _INSTANT_REQUIRED}
            if kind not in required:
                raise MalformedJournal(
                    f"{path}:{lineno}: unknown record type {kind!r}"
                )
            missing = [k for k in required[kind] if k not in rec]
            if missing:
                raise MalformedJournal(
                    f"{path}:{lineno}: {kind} record missing field(s) "
                    f"{missing}"
                )
            records.append(rec)
    return records


def merge_dir(directory: str) -> List[dict]:
    """Read and concatenate every ``*.jsonl`` journal under ``directory``,
    deduplicated (re-running a report in the producing process can journal
    a record twice) and deterministically ordered."""
    paths = sorted(
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.endswith(".jsonl")
    )
    if not paths:
        raise FileNotFoundError(f"no *.jsonl journals under {directory}")
    records = []
    seen = set()
    for path in paths:
        for rec in read_journal(path):
            key = (rec.get("process"), rec.get("rank"), rec.get("type"),
                   rec.get("op"), rec.get("name"), rec.get("call_id"),
                   rec.get("seq"), rec.get("t_begin"), rec.get("t"))
            if key in seen:
                continue
            seen.add(key)
            records.append(rec)
    records.sort(key=lambda r: (r.get("t_begin", r.get("t", 0.0)),
                                r.get("rank", 0), r.get("seq", 0)))
    return records


def chrome_trace(records: List[dict]) -> dict:
    """Render merged records as a Chrome trace-event object
    (Perfetto / ``chrome://tracing``): rank = pid, op rows = tids."""
    op_names = sorted({r["op"] for r in records if r["type"] == "op"})
    tids = {op: i + 1 for i, op in enumerate(op_names)}  # 0 = instants
    ranks = sorted({int(r["rank"]) for r in records})
    base = min(
        (r.get("t_begin", r.get("t")) for r in records), default=0.0
    )

    events = []
    for rank in ranks:
        events.append({
            "ph": "M", "name": "process_name", "pid": rank,
            "args": {"name": f"rank {rank}"},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": rank,
            "args": {"sort_index": rank},
        })
        events.append({
            "ph": "M", "name": "thread_name", "pid": rank,
            "tid": _INSTANT_TID, "args": {"name": "events"},
        })
        for op, tid in tids.items():
            events.append({
                "ph": "M", "name": "thread_name", "pid": rank, "tid": tid,
                "args": {"name": op},
            })
    for r in records:
        if r["type"] == "op":
            events.append({
                "ph": "X",
                "name": r["op"],
                "cat": "collective",
                "pid": int(r["rank"]),
                "tid": tids[r["op"]],
                "ts": (r["t_begin"] - base) * 1e6,
                "dur": r["latency"] * 1e6,
                "args": {
                    k: r[k]
                    for k in ("call_id", "seq", "process", "bytes",
                              "dtype", "algo", "comm_uid", "axes")
                    if k in r
                },
            })
        else:
            events.append({
                "ph": "i",
                "s": "p",
                "name": r["name"],
                "cat": "incident",
                "pid": int(r["rank"]),
                "tid": _INSTANT_TID,
                "ts": (r["t"] - base) * 1e6,
                "args": {
                    k: r[k] for k in ("process", "detail") if k in r
                },
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": TRACE_PRODUCER,
            "ranks": ranks,
            "ops": op_names,
        },
    }


def skew_table(records: List[dict]) -> dict:
    """Cross-rank skew + straggler attribution from merged records.

    Returns ``{"per_op": {op: {max_skew, mean_skew, groups}},
    "per_rank": {rank: {last_arrivals, groups}}}`` — skews in seconds,
    computed over execution groups matched by ``(op, call_id, seq)``
    that span at least two ranks."""
    groups: Dict[tuple, List[dict]] = {}
    for r in records:
        if r["type"] == "op":
            groups.setdefault(
                (r["op"], r["call_id"], r["seq"]), []
            ).append(r)

    per_op: Dict[str, dict] = {}
    per_rank: Dict[int, dict] = {}
    for (op, _cid, _seq), members in groups.items():
        by_rank = {}
        for m in members:  # one record per rank per group; keep earliest
            rank = int(m["rank"])
            if rank not in by_rank or m["t_begin"] < by_rank[rank]:
                by_rank[rank] = m["t_begin"]
        if len(by_rank) < 2:
            continue
        arrivals = sorted(by_rank.items(), key=lambda kv: kv[1])
        skew = arrivals[-1][1] - arrivals[0][1]
        straggler = arrivals[-1][0]
        row = per_op.setdefault(
            op, {"max_skew": 0.0, "skew_sum": 0.0, "groups": 0}
        )
        row["max_skew"] = max(row["max_skew"], skew)
        row["skew_sum"] += skew
        row["groups"] += 1
        for rank in by_rank:
            rrow = per_rank.setdefault(
                rank, {"last_arrivals": 0, "groups": 0}
            )
            rrow["groups"] += 1
            if rank == straggler:
                rrow["last_arrivals"] += 1
    for row in per_op.values():
        row["mean_skew"] = row.pop("skew_sum") / row["groups"]
    return {"per_op": per_op, "per_rank": per_rank}


def _us(seconds: float) -> str:
    return f"{seconds * 1e6:,.1f}"


def render_skew(table: dict) -> str:
    """Human-readable straggler attribution (also what ``report()``
    embeds as its skew columns' standalone form)."""
    lines = []
    if not table["per_op"]:
        return ("no cross-rank execution groups found (need events from "
                ">= 2 ranks)")
    lines.append(f"{'op':<16} {'groups':>7} {'mean skew us':>13} "
                 f"{'max skew us':>12}")
    for op in sorted(table["per_op"]):
        row = table["per_op"][op]
        lines.append(
            f"{op:<16} {row['groups']:>7} {_us(row['mean_skew']):>13} "
            f"{_us(row['max_skew']):>12}"
        )
    lines.append("")
    lines.append(f"{'rank':<6} {'last arrivals':>14} {'of groups':>10}   "
                 "(a healthy job spreads these evenly)")
    for rank in sorted(
        table["per_rank"],
        key=lambda r: -table["per_rank"][r]["last_arrivals"],
    ):
        row = table["per_rank"][rank]
        lines.append(
            f"r{rank:<5} {row['last_arrivals']:>14} {row['groups']:>10}"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``merge <dir> [--perfetto OUT] [--no-skew]`` (exit 2 on a
    malformed journal or an empty directory)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.telemetry",
        description="merge per-rank telemetry journals",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="merge a journal dir into a Chrome trace")
    mp.add_argument("dir", help="MPI4JAX_TPU_TELEMETRY_DIR of the run")
    mp.add_argument("--perfetto", metavar="OUT",
                    help="write the merged Chrome-trace-event JSON here "
                         "(open in Perfetto / chrome://tracing)")
    mp.add_argument("--no-skew", action="store_true",
                    help="skip the straggler attribution table")
    args = parser.parse_args(argv)

    try:
        records = merge_dir(args.dir)
    except (MalformedJournal, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    ranks = {int(r["rank"]) for r in records}
    ops = {r["op"] for r in records if r["type"] == "op"}
    print(f"merged {len(records)} records from {len(ranks)} rank(s), "
          f"{len(ops)} op(s)")
    if args.perfetto:
        trace = chrome_trace(records)
        with open(args.perfetto, "w") as f:
            json.dump(trace, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.perfetto} "
              f"({len(trace['traceEvents'])} trace events)")
    if not args.no_skew:
        print()
        print(render_skew(skew_table(records)))
    return 0
