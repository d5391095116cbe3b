"""Merge per-rank JSONL journals into one Chrome-trace-event timeline.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/merge.py``.
``python -m mpi4jax_tpu_torch.telemetry merge <dir> --perfetto
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
format).  Where postmortem bundles lie beside the journals, the merge
warns of the records their bounded buffers dropped.

``python -m mpi4jax_tpu_torch.telemetry postmortem <dir>`` reads the
health plane's bundles (``postmortem-p*.json``, ``health.py``), aligns
their flight rings by call id and prints each rank's last completed and
last begun op, the frontier call and the suspected straggler
(``postmortem_report``, ``render_postmortem``).  Bundles of either
package read the same in either's command.  The port writes one bundle
per rank process, so a rank that wrote none (killed before its trigger,
or watched by the C++ watchdog, which writes no bundle) is absent from
the report; the JAX package's single process holds every rank's ring.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from . import health as _health

__all__ = ["read_journal", "merge_dir", "chrome_trace", "skew_table",
           "render_skew", "read_bundles", "postmortem_report",
           "render_postmortem", "main", "MalformedJournal"]

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


def read_bundles(directory: str) -> List[dict]:
    """Parse every per-rank postmortem bundle
    (``postmortem-p*.json``, written by ``health.dump_postmortem``)
    under ``directory``, sorted by process index."""
    paths = sorted(
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.startswith(_health.POSTMORTEM_FILE_PREFIX)
        and name.endswith(".json")
    )
    if not paths:
        raise FileNotFoundError(
            f"no {_health.POSTMORTEM_FILE_PREFIX}*.json bundles under "
            f"{directory} (set MPI4JAX_TPU_HEALTH=on and "
            f"MPI4JAX_TPU_TELEMETRY_DIR to produce them)"
        )
    bundles = []
    for path in paths:
        try:
            with open(path) as f:
                bundle = json.load(f)
        except ValueError as e:
            raise MalformedJournal(f"{path}: not valid JSON: {e}") from e
        if (not isinstance(bundle, dict)
                or bundle.get("schema") != _health.POSTMORTEM_SCHEMA):
            raise MalformedJournal(
                f"{path}: not a {_health.POSTMORTEM_SCHEMA} bundle"
            )
        bundles.append(bundle)
    return sorted(bundles, key=lambda b: b.get("process", 0))


def _bundle_dropped(directory: str) -> Dict[str, int]:
    """Best-effort dropped-record totals from any postmortem bundles in
    ``directory`` (the merge CLI's completeness warning — the JSONL
    journals themselves never drop, but the in-memory ring/journal the
    bundles snapshot do)."""
    totals: Dict[str, int] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return totals
    for name in names:
        if not (name.startswith(_health.POSTMORTEM_FILE_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                bundle = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(bundle, dict):
            continue
        for src, n in (bundle.get("dropped") or {}).items():
            if n:
                totals[src] = totals.get(src, 0) + int(n)
    return totals


def postmortem_report(bundles: List[dict]) -> dict:
    """Merge per-rank postmortem bundles into the "who was stuck where"
    answer.

    Flight-recorder rings are aligned across ranks by call id: per rank,
    the last *completed* op and the last *begun* op (a begin without a
    matching completion is an op still in flight when the bundle was
    written); across ranks, the **frontier call** is the call id with
    the latest arrival anywhere — ranks that never arrived at it are the
    stragglers everyone else was waiting for.  Attribution order:

    1. a journalled ``fault`` incident in a rank's ring (deterministic
       under fault injection — the injected rank journals before dying
       or hanging);
    2. ranks missing their arrival at the frontier call while peers
       arrived;
    3. the rank with the largest in-flight watchdog elapsed time.
    """
    processes: Dict[int, dict] = {}
    # call_id -> {"op", "began": {rank: t}, "ended": {rank: t}}
    calls: Dict[str, dict] = {}
    all_ranks = set()
    dropped: Dict[str, int] = {}
    times = []
    for b in bundles:
        proc = int(b.get("process", 0))
        for src, n in (b.get("dropped") or {}).items():
            if n:
                dropped[src] = dropped.get(src, 0) + int(n)
        pinfo = processes.setdefault(proc, {
            "reasons": list(b.get("reasons") or ()),
            "inflight": list(b.get("watchdog_inflight") or ()),
            "ranks": {},
        })
        for e in pinfo["inflight"]:
            if "rank" in e:
                all_ranks.add(int(e["rank"]))
        for rec in (b.get("flight") or {}).get("records", ()):
            if not isinstance(rec, dict) or "rank" not in rec:
                continue  # dispatch records carry no rank
            rank = int(rec["rank"])
            all_ranks.add(rank)
            rinfo = pinfo["ranks"].setdefault(rank, {
                "last_completed": None, "last_begin": None,
                "incidents": [],
            })
            if rec.get("type") == "op":
                times.append(rec["t_end"])
                cur = rinfo["last_completed"]
                if cur is None or rec["t_end"] > cur["t_end"]:
                    rinfo["last_completed"] = rec
                call = calls.setdefault(rec.get("call_id"),
                                        {"op": rec.get("op", "?"),
                                         "began": {}, "ended": {}})
                call["ended"][rank] = max(call["ended"].get(rank, 0.0),
                                          rec["t_end"])
                call["began"][rank] = max(call["began"].get(rank, 0.0),
                                          rec["t_begin"])
            elif rec.get("type") == "instant":
                times.append(rec["t"])
                rinfo["incidents"].append(rec)
            elif rec.get("kind") == "begin":
                times.append(rec["t"])
                cur = rinfo["last_begin"]
                if cur is None or rec["t"] > cur["t"]:
                    rinfo["last_begin"] = rec
                call = calls.setdefault(rec.get("call_id"),
                                        {"op": rec.get("op", "?"),
                                         "began": {}, "ended": {}})
                call["began"][rank] = max(call["began"].get(rank, 0.0),
                                          rec["t"])
    # the frontier: the call somebody arrived at last
    frontier = None
    if calls:
        fid = max(calls, key=lambda c: max(calls[c]["began"].values(),
                                           default=0.0))
        call = calls[fid]
        began = sorted(call["began"])
        frontier = {
            "call_id": fid,
            "op": call["op"],
            "t": max(call["began"].values(), default=0.0),
            "began": began,
            "ended": sorted(call["ended"]),
            "missing": sorted(all_ranks - set(began)),
        }
    suspects = []
    seen_ranks = set()

    def _suspect(rank, op, call_id, why):
        if rank in seen_ranks:
            return
        seen_ranks.add(rank)
        suspects.append({"rank": int(rank), "op": op,
                         "call_id": call_id, "why": why})

    for proc in sorted(processes):
        for rank in sorted(processes[proc]["ranks"]):
            for inc in processes[proc]["ranks"][rank]["incidents"]:
                if inc.get("name") == "fault":
                    _suspect(rank, None, None,
                             "fault incident journalled on this rank: "
                             + str(inc.get("detail", "")))
    if frontier and frontier["began"] and frontier["missing"]:
        for rank in frontier["missing"]:
            _suspect(
                rank, frontier["op"], frontier["call_id"],
                f"never arrived at {frontier['op']} call "
                f"{frontier['call_id']} "
                f"({len(frontier['began'])} peer rank(s) arrived)",
            )
    if not suspects:
        stuck = [
            (e.get("elapsed", 0.0), e)
            for proc in processes
            for e in processes[proc]["inflight"]
        ]
        if stuck:
            elapsed, e = max(stuck, key=lambda x: x[0])
            _suspect(e.get("rank", 0), e.get("opname"), e.get("call_id"),
                     f"largest in-flight time: {e.get('opname', '?')} "
                     f"call {e.get('call_id', '?')} stuck {elapsed:.1f}s")
    return {
        "processes": processes,
        "frontier": frontier,
        "suspects": suspects,
        "dropped": dropped,
        "base_t": min(times) if times else 0.0,
    }


def render_postmortem(report: dict) -> str:
    """Human-readable postmortem: per-rank frontier + attribution."""
    base = report["base_t"]

    def _rel(t):
        return f"+{t - base:.3f}s"

    lines = []
    nranks = sum(len(p["ranks"]) for p in report["processes"].values())
    lines.append(f"postmortem: {len(report['processes'])} bundle(s), "
                 f"{nranks} rank(s) with flight records")
    for proc in sorted(report["processes"]):
        pinfo = report["processes"][proc]
        lines.append("")
        lines.append(f"process {proc}:")
        if pinfo["reasons"]:
            lines.append("  reasons: " + "; ".join(pinfo["reasons"]))
        for rank in sorted(pinfo["ranks"]):
            rinfo = pinfo["ranks"][rank]
            lines.append(f"  rank {rank}:")
            done = rinfo["last_completed"]
            if done is not None:
                lines.append(
                    f"    last completed: {done.get('op', '?')} call "
                    f"{done.get('call_id', '?')} seq {done.get('seq', '?')}"
                    f" @ {_rel(done['t_end'])}")
            beg = rinfo["last_begin"]
            if beg is not None:
                lines.append(
                    f"    last begin:     {beg.get('op', '?')} call "
                    f"{beg.get('call_id', '?')} @ {_rel(beg['t'])}")
            for inc in rinfo["incidents"][-3:]:
                detail = inc.get("detail", "")
                lines.append(
                    f"    incident @ {_rel(inc['t'])}: {inc.get('name')}"
                    + (f" — {detail}" if detail else ""))
        for e in pinfo["inflight"]:
            lines.append(
                f"  in flight: {e.get('opname', '?')} call "
                f"{e.get('call_id', '?')} rank {e.get('rank', '?')} "
                f"(elapsed {e.get('elapsed', 0.0):.1f}s of "
                f"{e.get('timeout', 0.0):g}s budget)")
    frontier = report["frontier"]
    if frontier is not None:
        lines.append("")
        ranks_s = ",".join(str(r) for r in frontier["began"])
        line = (f"frontier: {frontier['op']} call {frontier['call_id']} "
                f"@ {_rel(frontier['t'])} — arrived: rank(s) {ranks_s}")
        if frontier["missing"]:
            line += ("; MISSING: rank(s) "
                     + ",".join(str(r) for r in frontier["missing"]))
        lines.append(line)
    if report["dropped"]:
        lines.append("")
        lines.append("dropped: " + ", ".join(
            f"{n} {src} record(s)"
            for src, n in sorted(report["dropped"].items())))
    lines.append("")
    if report["suspects"]:
        for s in report["suspects"]:
            lines.append(f"suspected straggler: rank {s['rank']} — "
                         f"{s['why']}")
    else:
        lines.append("no straggler attribution (no fault incidents, no "
                     "missing arrivals, no in-flight ops)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``merge <dir> [--perfetto OUT] [--no-skew]`` and
    ``postmortem <dir> [--out OUT]`` (exit 2 on a malformed journal or
    bundle, or when no bundles exist — the CI contract)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.telemetry",
        description="merge per-rank telemetry journals",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser(
        "merge", help="merge a journal dir into a Chrome trace"
    )
    mp.add_argument("dir", help="MPI4JAX_TPU_TELEMETRY_DIR of the run")
    mp.add_argument("--perfetto", metavar="OUT",
                    help="write the merged Chrome-trace-event JSON here "
                         "(open in Perfetto / chrome://tracing)")
    mp.add_argument("--no-skew", action="store_true",
                    help="skip the straggler attribution table")
    pp = sub.add_parser(
        "postmortem",
        help="merge per-rank postmortem bundles: last-known frontier "
             "per rank + straggler attribution",
    )
    pp.add_argument("dir", help="MPI4JAX_TPU_TELEMETRY_DIR of the run")
    pp.add_argument("--out", metavar="OUT",
                    help="also write the rendered report here")
    args = parser.parse_args(argv)

    if args.cmd == "postmortem":
        try:
            bundles = read_bundles(args.dir)
        except (MalformedJournal, FileNotFoundError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        text = render_postmortem(postmortem_report(bundles))
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
            print(f"wrote {args.out}", file=sys.stderr)
        return 0

    try:
        records = merge_dir(args.dir)
    except (MalformedJournal, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    ranks = {int(r["rank"]) for r in records}
    ops = {r["op"] for r in records if r["type"] == "op"}
    print(f"merged {len(records)} records from {len(ranks)} rank(s), "
          f"{len(ops)} op(s)")
    dropped = _bundle_dropped(args.dir)
    if dropped:
        print("warning: bounded in-memory buffers dropped records ("
              + ", ".join(f"{src}: {n}"
                          for src, n in sorted(dropped.items()))
              + ") — snapshots/reports from that run were incomplete "
              "(the JSONL timeline above is not; see the postmortem "
              "bundles)", file=sys.stderr)
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
