"""Analyze whole scripts: ``python -m mpi4jax_tpu_torch.analysis script.py ...``.

PyTorch counterpart of ``python -m mpi4jax_tpu.analysis``.  Runs each
script with the ambient verifier armed (``MPI4JAX_TPU_ANALYZE``
defaulting to ``warn``: the CLI aggregates findings itself instead of
aborting at the first one) and applies the CI exit-code contract:

- **0**: every script analyzed, no error-severity finding (advisories
  are listed but do not fail the run);
- **1**: at least one error-severity finding (including MPX-tagged
  raises, converted to findings);
- **2**: usage error, or a script failed outside the verifier (an
  untagged exception: import error, bad path, ...).

Options:

- ``--ranks N``: sets ``MPI4JAX_TPU_ANALYZE_RANKS=N``: the cross-rank
  schedule pass (per-rank abstract re-runs + deadlock/progress matching,
  MPX120-MPX125) runs for every region on a comm of at most N ranks;
- ``--json``: print the aggregated machine-readable payload (one
  ``Report.to_json()`` object per dirty region, plus per-script status)
  to stdout; the scripts' own stdout is redirected to stderr so the
  payload stays parseable;
- ``--strict-advisories``: exit 1 on advisory-severity findings too.

- ``--cost``: sets ``MPI4JAX_TPU_ANALYZE_COST=on``: every cross-rank pass
  extends into the critical-path timing simulation (``analysis/cost.py``):
  reports gain a ``cost`` breakdown and the MPX131-MPX135 advisories, and
  clean regions are reported too;
- ``--cost-model PATH``: sets ``MPI4JAX_TPU_COST_MODEL=PATH``, a
  ``mpx-cost-model/1`` or ``mpx-tuning/1`` file (``python -m
  mpi4jax_tpu_torch.autotune --save PATH`` writes one).
"""

import contextlib
import json
import os
import runpy
import sys
import traceback

USAGE = ("usage: python -m mpi4jax_tpu_torch.analysis [--ranks N] [--cost] "
         "[--cost-model PATH] [--json] [--strict-advisories] "
         "script.py [...]")


def _parse_args(argv):
    ranks = None
    as_json = False
    cost = False
    cost_model = None
    strict_advisories = False
    scripts = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--ranks":
            i += 1
            if i >= len(argv):
                return None
            ranks = argv[i]
        elif a.startswith("--ranks="):
            ranks = a.split("=", 1)[1]
        elif a == "--cost":
            cost = True
        elif a == "--cost-model":
            i += 1
            if i >= len(argv):
                return None
            cost_model = argv[i]
        elif a.startswith("--cost-model="):
            cost_model = a.split("=", 1)[1]
        elif a == "--json":
            as_json = True
        elif a == "--strict-advisories":
            strict_advisories = True
        elif a.startswith("-"):
            return None
        else:
            scripts.append(a)
        i += 1
    if not scripts:
        return None
    return ranks, as_json, cost, cost_model, strict_advisories, scripts


def main(argv) -> int:
    parsed = _parse_args(argv)
    if parsed is None:
        print(USAGE, file=sys.stderr)
        return 2
    ranks, as_json, cost, cost_model, strict_advisories, scripts = parsed
    if ranks is not None:
        os.environ["MPI4JAX_TPU_ANALYZE_RANKS"] = ranks
    if cost:
        os.environ["MPI4JAX_TPU_ANALYZE_COST"] = "on"
    if cost_model is not None:
        os.environ["MPI4JAX_TPU_COST_MODEL"] = cost_model
    os.environ.setdefault("MPI4JAX_TPU_ANALYZE", "warn")
    mode = os.environ["MPI4JAX_TPU_ANALYZE"]

    from .hook import set_report_sink
    from .report import AnalysisError, Report, finding_from_exception

    sink = []
    set_report_sink(sink)
    script_status = {}
    trace_failure = False
    saved_argv = sys.argv
    try:
        for path in scripts:
            print(f"[mpx_torch.analyze] running {path} with "
                  f"MPI4JAX_TPU_ANALYZE={mode}", file=sys.stderr)
            sys.argv = [path]
            before = len(sink)
            try:
                if as_json:
                    # scripts print freely; the JSON payload owns stdout
                    with contextlib.redirect_stdout(sys.stderr):
                        runpy.run_path(path, run_name="__main__")
                else:
                    runpy.run_path(path, run_name="__main__")
                script_status[path] = "ok"
            except AnalysisError as e:
                # ambient error-mode raises sink their report BEFORE
                # raising; an explicit `report.raise_if_findings()` in
                # the script does not — recover its findings here so the
                # exit-code contract sees them either way
                if len(sink) == before:
                    sink.append((path, Report(findings=e.findings)))
                script_status[path] = "findings"
            except SystemExit as e:
                # scripts commonly end with sys.exit(...): a zero exit is
                # a normal completion (any sunk findings still count); a
                # nonzero one is the script failing on its own terms —
                # either way the CLI's exit-code contract, not the
                # script's, decides the process exit
                code = e.code if isinstance(e.code, int) else (
                    0 if e.code is None else 1)
                if code == 0:
                    script_status[path] = "ok"
                else:
                    print(f"[mpx_torch.analyze] {path} exited with status "
                          f"{e.code}", file=sys.stderr)
                    script_status[path] = "trace-failure"
                    trace_failure = True
            except Exception as e:
                f = finding_from_exception(e)
                if f is not None:
                    # an MPX-tagged trace-time raise IS a finding
                    sink.append((path, Report(findings=(f,))))
                    script_status[path] = "findings"
                else:
                    traceback.print_exc()
                    script_status[path] = "trace-failure"
                    trace_failure = True
            finally:
                sys.argv = saved_argv
            if script_status[path] == "ok" and any(
                    rep.findings for _, rep in sink[before:]):
                # a clean --cost breakdown report is not a "finding"
                script_status[path] = "findings"
    finally:
        sys.argv = saved_argv
        set_report_sink(None)

    findings = [f for _, rep in sink for f in rep.findings]
    n_errors = sum(1 for f in findings if f.severity == "error")
    if as_json:
        payload = {
            "scripts": script_status,
            "errors": n_errors,
            "advisories": len(findings) - n_errors,
            "reports": [
                {"where": where, **rep.to_json()} for where, rep in sink
            ],
        }
        print(json.dumps(payload, indent=2))
    for where, rep in sink:
        label = "findings in" if rep.findings else "cost report for"
        print(f"[mpx_torch.analyze] {label} {where}:\n{rep.render()}",
              file=sys.stderr)
    if trace_failure:
        return 2
    if n_errors:
        print(f"[mpx_torch.analyze] {n_errors} error-severity finding(s) over "
              f"{len(scripts)} script(s)", file=sys.stderr)
        return 1
    n_advisories = len(findings) - n_errors
    if strict_advisories and n_advisories:
        print(f"[mpx_torch.analyze] --strict-advisories: {n_advisories} "
              f"advisory finding(s) over {len(scripts)} script(s)",
              file=sys.stderr)
        return 1
    print(f"[mpx_torch.analyze] {len(scripts)} script(s) analyzed, no errors "
          f"({n_advisories} advisory finding(s))", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
