"""The slice as a whole: ``solve_fused`` under the runtime services.

``tests/torch_ranks_runtime.py:solve_program`` runs the solver at the
sizes of ``tests/test_torch_multirank_sw.py`` under telemetry ``off``,
``counters`` and ``events``: on one rank (in this process) the megastep
path (``fast="wide2"``, ``unroll=4``) and the split-phase one
(``fast="pallas_halo"``), on four gloo ranks ((2,2), on the CPU) the
wide-halo run and the split-phase one.  The contract:

- every instrumented run's final state is bit for bit the ``off`` run's;
  the wide-halo runs are within the JAX package's ``solve_fused`` band
  (``1e-5 + 2e-6 * max|a|``, ``tests/test_examples.py:337``) of its own
  run on the same grid;
- ``sendrecv`` is counted once per call: the split-phase step makes 2
  exchanges per boundary refresh on one rank (the x directions, periodic)
  and 4 on (2,2), 5 refreshes a step (h, u, v, then u and v after the
  viscosity phase), so ``10`` and ``20`` a step;
- the events tier leaves no begin unpaired; the four ranks' journals
  merge into one record a ``sendrecv`` call and rank, and a skew table
  over four ranks;
- a megastep call writes one journal record (``op: "megastep"``, with
  ``unroll`` and ``label``), and the watchdog arms the whole loop with
  ``timeout * N``;
- with every service off, ``run_body`` calls the op's body and nothing of
  telemetry, resilience or the native hooks (spies on their entry
  points).
"""

import os
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_runtime as R  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import native  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from mpi4jax_tpu_torch.ops import _base  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.resilience import faultinject, numerics, watchdog  # noqa: E402
from mpi4jax_tpu_torch.resilience import runtime as rt  # noqa: E402
from mpi4jax_tpu_torch.telemetry import bracket, core, journal, merge  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [1, 4]
SENDRECV_A_STEP = {1: 10, 4: 20}
# the four-rank world's own limit, for the shared RANK_TIMEOUT_S (50 s).
# It runs 15.5 s alone; under the tier-1 command (6 xdist workers on 8
# cores beside other rank worlds, load average 25) it took 49.0 s: 11.0 s
# to start its ranks, 5.2 s of wide2 runs and 32.4 s of split-phase runs,
# whose 4680 blocking sendrecv calls a rank each wait ~7 ms for a peer to
# be scheduled (2.3 s of CPU against 10.7 s of wall a tier)
SOLVE_WORLD_TIMEOUT_S = 150.0


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "runtime-solve")


def _summarise(per_rank, tdir):
    """What the tests read of each rank's runs, with the merged journals
    of every events run."""
    out = {"ranks": per_rank, "merged": {}}
    for case in ("wide2", "halo"):
        d = os.path.join(tdir, f"{case}-events")
        if os.path.isdir(d):
            recs = merge.merge_dir(d)
            trace = merge.chrome_trace(recs)
            out["merged"][case] = {"records": recs, "skew": merge.skew_table(recs),
                                   "trace_events": len(trace["traceEvents"])}
    return out


def port_run(results, size, tmp_path_factory):
    def compute():
        # a fresh journal directory for each attempt: a rerun after a failed
        # one (RunResults keeps no failure) never merges the failed world's
        # journals with its own
        tdir = tempfile.mkdtemp(prefix=f"runtime-solve-{size}-",
                                dir=tmp_path_factory.getbasetemp().parent)
        if size == 1:
            per_rank = [launch.to_numpy(R.solve_program(0, 1, tdir))]
        else:
            per_rank = launch.run(R.solve_program, size, device="cpu",
                                  timeout=SOLVE_WORLD_TIMEOUT_S, args=(size, tdir))
        return _summarise(per_rank, tdir)

    return results.get(f"port-{size}", compute)


def jax_wide2(results, size):
    grid = (1, 1) if size == 1 else (2, size // 2)

    def compute():
        cfg = J.Config(nx=R.WIDE_SIZE[0], ny=R.WIDE_SIZE[1], nproc_y=grid[0],
                       nproc_x=grid[1])
        _, n, s = J.solve_fused(cfg, R.SOLVE_T1_STEPS * cfg.dt,
                                num_multisteps=R.SOLVE_MULTI, fast="wide2",
                                return_state=True, devices=jax.devices()[:size])
        return n, [np.asarray(f) for f in s]

    return results.get(f"jax-wide2-{size}", compute)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", ["wide2", "halo"])
@pytest.mark.parametrize("mode", ["counters", "events"])
def test_instrumented_solve_is_bit_for_bit_with_off(results, tmp_path_factory,
                                                    size, case, mode):
    for rank, r in enumerate(port_run(results, size, tmp_path_factory)["ranks"]):
        off, on = r[f"{case}/off"], r[f"{case}/{mode}"]
        assert on["n"] == off["n"] == 26 and on["runs"] == off["runs"] == 3
        for name, a, b in zip(P.State._fields, off["final"], on["final"]):
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), (
                f"rank {rank} {case} {mode}: {name} differs from off")


@pytest.mark.parametrize("size", SIZES)
def test_wide2_solve_within_the_jax_band(results, tmp_path_factory, size):
    n, want = jax_wide2(results, size)
    per_rank = port_run(results, size, tmp_path_factory)["ranks"]
    assert n == per_rank[0]["wide2/events"]["n"] == 26
    for k, name in enumerate(P.State._fields):
        got = np.stack([r["wide2/events"]["final"][k] for r in per_rank])
        bound = 1e-5 + 2e-6 * np.abs(want[k]).max()
        err = np.abs(want[k] - got).max()
        assert err <= bound, f"{size} ranks, {name}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("size", SIZES)
def test_sendrecv_counted_once_a_call(results, tmp_path_factory, size):
    """The split-phase run counts the exchanges the code makes, in both
    tiers, on every rank; the events tier journals one record each."""
    want = SENDRECV_A_STEP[size] * 26 * 3  # a step, steps a run, runs
    for r in port_run(results, size, tmp_path_factory)["ranks"]:
        for mode in ("counters", "events"):
            counts = r[f"halo/{mode}"]["counts"]
            assert set(counts) == {("sendrecv", "float32")}
            assert counts[("sendrecv", "float32")][0] == want
        recs = [e for e in r["halo/events"]["events"] if e.get("op") == "sendrecv"]
        assert len(recs) == want
        assert r["halo/off"]["counts"] == {}


@pytest.mark.parametrize("size", SIZES)
def test_events_journals_pair_every_begin_and_merge(results, tmp_path_factory, size):
    run = port_run(results, size, tmp_path_factory)
    for r in run["ranks"]:
        for case in ("wide2", "halo"):
            assert r[f"{case}/events"]["pending"] == 0
    merged = run["merged"]["halo"]
    per_rank = {}
    for rec in merged["records"]:
        if rec["type"] == "op" and rec["op"] == "sendrecv":
            per_rank[rec["rank"]] = per_rank.get(rec["rank"], 0) + 1
    assert per_rank == {k: SENDRECV_A_STEP[size] * 26 * 3 for k in range(size)}
    assert merged["trace_events"] > len(merged["records"])
    if size > 1:
        assert sorted(merged["skew"]["per_rank"]) == list(range(size))
        assert merged["skew"]["per_op"]["sendrecv"]["groups"] == SENDRECV_A_STEP[size] * 78


def test_megastep_journals_one_record_a_call(results, tmp_path_factory):
    """One rank, ``unroll=4`` over 25 steps after the Euler step: 6
    megastep calls and a tail of one step (no loop) a run, 3 runs."""
    r = port_run(results, 1, tmp_path_factory)["ranks"][0]
    mega = [e for e in r["wide2/events"]["events"] if e.get("op") == "megastep"]
    assert len(mega) == 6 * 3
    assert all(e["unroll"] == R.UNROLL and e["label"] == "one_step"
               and e["algo"] == "loop" for e in mega)
    assert not any(e.get("op") == "megastep" for e in r["wide2/counters"]["events"])


def test_megastep_watchdog_bracket_scales_the_deadline():
    got = R.megastep_watchdog_program(0.25)
    loops = [t for name, t in got["arms"] if name == "MPI_Megastep[one_step]"]
    assert len(loops) == 6 * got["runs"]
    assert loops == [pytest.approx(0.25 * R.UNROLL)] * len(loops)
    assert got["left"] == 0


def test_off_calls_no_service(monkeypatch):
    """With every knob off the dispatch point calls the body directly:
    nothing of telemetry, resilience or the native hooks runs."""
    called = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **k):
            called.append(f"{mod.__name__}.{name}")
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for mod, names in ((core, ("open_op", "close_op", "abort_op", "meter",
                               "count_eager_call")),
                       (bracket, ("bracket_for",)),
                       (journal, ("begin", "end", "instant", "incident")),
                       (rt, ("plan_for",)),
                       (faultinject, ("probe_host", "apply_corrupt")),
                       (numerics, ("guard_values",)),
                       (watchdog, ("arm", "disarm")),
                       (native, ("available", "op_begin", "op_end", "abort_if",
                                 "watchdog_arm", "watchdog_disarm", "host_line"))):
        for name in names:
            spy(mod, name)
    comm = tpx.Comm(("py", "px"), mesh=tpx.make_world_mesh((1, 1), ("py", "px"),
                                                           device="cpu"))
    x = torch.arange(6.0)
    tpx.allreduce(x, comm=comm)
    tpx.sendrecv(x, x, dest=tpx.shift(1), comm=comm)
    tpx.barrier(comm=comm)

    @tpx.spmd(comm=comm)
    def region(v):
        h, _ = tpx.allreduce_start(v)
        return tpx.allreduce_wait(h)[0]

    region(x)
    cfg = P.Config(nx=R.HALO_SIZE[0], ny=R.HALO_SIZE[1])
    P.solve_fused(cfg, 3 * cfg.dt, num_multisteps=1, device="cpu", fast="pallas_halo",
                  unroll=2)
    assert called == []
    assert _base.hooks() is None
    # and a knob turns them on
    core.set_telemetry_mode("counters")
    tpx.allreduce(x, comm=comm)
    assert "mpi4jax_tpu_torch.telemetry.core.open_op" in called
