"""The port's resilience layer (``mpi4jax_tpu_torch/resilience/``) against
the JAX package's.

- the fault-spec grammar: every spec of ``tests/test_resilience.py``'s
  parametrisations parses, canonicalises and round-trips to the JAX
  package's clauses, and every rejected clause is rejected with the JAX
  package's message;
- per-rank call counting: the probe's decisions (corrupt masks, delays,
  deaths, warnings) call for call equal the JAX package's ``probe_host``;
- ``corrupt``: the port's corrupted inputs equal the JAX package's
  ``Plan._apply_corrupt`` bit for bit (f32, bf16, f16; ints untouched);
- the retry envelope, its deadline and exhaustion messages, with a seeded
  RNG and an injected clock and sleep, equal the JAX package's;
- ``plan_for`` and ``cache_token`` for every knob, step for step;
- the watchdog's Python registry: FIFO under one call id, expiry with an
  injected clock, ``suspend_expiries``, the default diagnostic's words;
- in child processes: ``die`` exits 13, a watchdog-armed op that hangs
  aborts with the diagnostic, ``init_distributed`` retries a refused
  rendezvous and then connects.
"""

import os
import random
import re
import socket
import subprocess
import sys
import textwrap
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpi4jax_tpu.resilience import faultinject as jfi  # noqa: E402
from mpi4jax_tpu.resilience import retry as jretry  # noqa: E402
from mpi4jax_tpu.resilience import runtime as jrt  # noqa: E402

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.resilience import faultinject as fi  # noqa: E402
from mpi4jax_tpu_torch.resilience import retry  # noqa: E402
from mpi4jax_tpu_torch.resilience import runtime as rt  # noqa: E402
from mpi4jax_tpu_torch.resilience import watchdog as wd  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = os.path.join(os.path.dirname(__file__), "..")
KNOBS = ("MPI4JAX_TPU_WATCHDOG_TIMEOUT", "MPI4JAX_TPU_FAULT_SPEC",
         "MPI4JAX_TPU_CHECK_NUMERICS", "MPI4JAX_TPU_TOPOLOGY")

# tests/test_resilience.py: test_fault_spec_round_trips
ROUND_TRIPS = [
    "delay:rank=1:op=allreduce:after=3:secs=2",
    "die:rank=0:op=barrier:after=1",
    "hang:rank=3:op=allreduce:after=5",
    "hang",
    "preempt:rank=3:after=4:grace=2",
    "preempt:rank=3:op=allreduce:after=4",
    "preempt",
    "corrupt:nan:rank=2:op=allreduce",
    "corrupt:inf:op=bcast",
    "delay:secs=0.5",
    "die",
    "delay:rank=1:op=allreduce:after=3:secs=2;"
    "die:rank=0:op=barrier:after=1;hang:rank=3:op=allreduce;"
    "preempt:rank=2:after=1:grace=5;"
    "corrupt:nan:rank=2:op=allreduce",
    # test_die_host_shorthand_parses_to_the_canonical_long_form
    "die-host:1@3", "die-host:0", "delay:host=1:op=allreduce:secs=0.5",
    "delay:rank=1:op=AllReduce:after=3:secs=2", "corrupt", "", "  ; ;",
]
# test_fault_spec_rejects_bad_clauses, test_host_fault_rejects_bad_clauses
REJECTED = [
    "explode:rank=1", "delay:when=now", "delay:nan", "corrupt:frob",
    "delay:rank=one", "delay:secs=fast", "die:secs=2", "hang:secs=2",
    "hang:nan", "die:grace=2", "preempt:secs=2", "preempt:grace=0",
    "preempt:nan", "delay:rank=1:rank=2", "delay:after=-1", "delay:secs=-0.5",
    "delay::secs=1",
    "die-host:", "die-host:one", "die-host:1@x", "die-host:-1",
    "die-host:1@2:after=3", "die:host=-2", "die:rank=1:host=2",
]


@pytest.fixture(autouse=True)
def clean_both(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for r, f in ((rt, fi), (jrt, jfi)):
        r.reset_overrides()
        f.reset_fault_state()
    yield
    for r, f in ((rt, fi), (jrt, jfi)):
        r.reset_overrides()
        f.reset_fault_state()


def run_child(code: str, env_extra=None, timeout: float = 60.0):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPI4JAX_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                          capture_output=True, text=True, timeout=timeout)


# -- grammar


def _fields(clauses):
    return [(c.verb, c.mode, c.rank, c.host, c.op, c.after, c.secs, c.grace)
            for c in clauses]


@pytest.mark.parametrize("spec", ROUND_TRIPS)
def test_fault_spec_round_trips_match_jax(spec):
    ours, theirs = fi.parse_fault_spec(spec), jfi.parse_fault_spec(spec)
    assert _fields(ours) == _fields(theirs)
    canon = fi.canonical_spec(ours)
    assert canon == jfi.canonical_spec(theirs)
    assert fi.parse_fault_spec(canon) == ours
    assert fi.canonical_spec(fi.parse_fault_spec(canon)) == canon


@pytest.mark.parametrize("bad", REJECTED)
def test_fault_spec_rejections_match_jax(bad):
    with pytest.raises(ValueError, match="fault spec clause") as ours:
        fi.parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jfi.parse_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)


# -- the probe


def _probe_log(mod, monkeypatch, spec, calls, topology=None):
    """``[(mask, actions), ...]`` of ``probe_host`` over ``calls`` (each
    ``(mpi_name, rank)``), sleeps and exits recorded instead of done."""
    actions = []
    monkeypatch.setattr(mod.time, "sleep", lambda s: actions.append(("sleep", s)))
    monkeypatch.setattr(mod.os, "_exit", lambda c: actions.append(("exit", c)))
    monkeypatch.setattr(mod, "_hang_forever", lambda: actions.append(("hang",)))
    if topology is None:
        monkeypatch.delenv("MPI4JAX_TPU_TOPOLOGY", raising=False)
    else:
        monkeypatch.setenv("MPI4JAX_TPU_TOPOLOGY", topology)
    clauses = mod.parse_fault_spec(spec)
    log = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, rank in calls:
            op = name[len("MPI_"):].lower()
            indexed = tuple((b, c) for b, c in enumerate(clauses) if c.matches_op(op))
            del actions[:]
            mask = mod.probe_host(indexed, name, rank)
            log.append((mask, list(actions)))
    return log, [str(w.message) for w in caught if "TOPOLOGY" in str(w.message)]


PROBES = [
    ("corrupt:nan:after=2", [("MPI_Allreduce", 0)] * 4 + [("MPI_Allreduce", 1)], None),
    ("corrupt:nan:rank=1;corrupt:inf:rank=2",
     [("MPI_Bcast", 0), ("MPI_Bcast", 1), ("MPI_Bcast", 2)], None),
    ("delay:rank=0:after=1:secs=0.2", [("MPI_Allreduce", 0)] * 3, None),
    ("die:rank=3", [("MPI_Barrier", 2), ("MPI_Barrier", 3)], None),
    ("delay:rank=2:op=sendrecv:after=9:secs=0.5",
     [("MPI_Sendrecv", r) for _ in range(11) for r in range(4)]
     + [("MPI_Allreduce", 2)], None),
    ("die-host:1", [("MPI_Barrier", r) for r in range(8)] + [("MPI_Barrier", 11)],
     "2x4"),
    ("die-host:0@2", [("MPI_Allreduce", 2)] * 3, "4,4"),
    ("corrupt:nan:host=0", [("MPI_Allreduce", 0), ("MPI_Allreduce", 1)], None),
    ("hang:rank=1:after=1;corrupt:inf:op=allreduce",
     [("MPI_Allreduce", 1)] * 3, None),
]


@pytest.mark.parametrize("spec,calls,topology", PROBES, ids=[p[0] for p in PROBES])
def test_probe_decisions_per_call_match_jax(monkeypatch, spec, calls, topology):
    ours = _probe_log(fi, monkeypatch, spec, calls, topology)
    theirs = _probe_log(jfi, monkeypatch, spec, calls, topology)
    assert ours == theirs
    assert any(mask or acts for mask, acts in ours[0]) or "host=0" in spec


# -- corrupt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_corrupt_is_bit_for_bit_with_jax(dtype, mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    n = rng.integers(-9, 9, (4,)).astype(np.int32)
    spec = f"corrupt:{mode}:op=allreduce;corrupt:nan:op=bcast"
    clauses = tuple(enumerate(fi.parse_fault_spec(spec)))
    jclauses = tuple(enumerate(jfi.parse_fault_spec(spec)))
    ours = fi.apply_corrupt((torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(n)), clauses, 0b01)
    plan = jrt.Plan(jclauses, None, False)
    theirs = plan._apply_corrupt((jnp.asarray(x).astype(dtype), jnp.asarray(n)),
                                 jnp.uint32(0b01))
    bits = {"float32": torch.int32, "bfloat16": torch.int16, "float16": torch.int16}
    got = ours[0].view(bits[dtype]).numpy()
    want = np.asarray(theirs[0]).view({"float32": np.int32}.get(dtype, np.int16))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    # a mask that sets no bit leaves the inputs alone
    same = fi.apply_corrupt((torch.ones(2),), clauses, 0)
    assert torch.equal(same[0], torch.ones(2))


def test_corrupt_reaches_the_op_under_a_fault_spec():
    rt.set_fault_spec("corrupt:inf:op=sendrecv")
    comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))
    x = torch.arange(4.0)
    got, _ = tpx.sendrecv(x, x, dest=tpx.shift(1), comm=comm)
    assert torch.isinf(got).all() and torch.equal(x, torch.arange(4.0))
    i = torch.arange(4)
    assert torch.equal(tpx.sendrecv(i, i, dest=tpx.shift(1), comm=comm)[0], i)


# -- retry


class _Flaky:
    def __init__(self, refusals, exc=ConnectionError):
        self.left = refusals
        self.exc = exc
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.left > 0:
            self.left -= 1
            raise self.exc(f"refused ({self.calls})")
        return "connected"


RETRIES = [
    dict(refusals=4, what="rendezvous", deadline=300.0, base_delay=1.0,
         max_delay=4.0, jitter=False),
    dict(refusals=6, what="rendezvous", deadline=300.0, base_delay=0.5,
         max_delay=8.0, jitter=True),
    dict(refusals=10**6, what="coordinator connection (host:1234)", deadline=50.0,
         base_delay=10.0, max_delay=100.0, jitter=False),
    dict(refusals=10**6, what="agreement report", deadline=300.0, max_attempts=4,
         base_delay=1.0, jitter=False),
    dict(refusals=10**6, what="stampede", deadline=1.0, max_attempts=50,
         base_delay=0.01, max_delay=0.05, jitter=True),
]


def _retry_run(mod, kw):
    kw = dict(kw)
    fn = _Flaky(kw.pop("refusals"))
    now, sleeps = [0.0], []

    def sleep(s):
        sleeps.append(s)
        now[0] += s

    random.seed(11)
    try:
        out = mod.retry_with_backoff(fn, sleep=sleep, clock=lambda: now[0], **kw)
    except RuntimeError as e:
        out = (str(e), type(e.__cause__).__name__)
    return out, sleeps, fn.calls, now[0]


@pytest.mark.parametrize("kw", RETRIES, ids=[str(i) for i in range(len(RETRIES))])
def test_retry_envelope_deadline_and_messages_match_jax(kw):
    ours, theirs = _retry_run(retry, kw), _retry_run(jretry, kw)
    assert ours == theirs
    for n, s in enumerate(ours[1], start=1):
        assert 0.0 <= s <= retry.backoff_delay(
            n, base_delay=kw["base_delay"], max_delay=kw.get("max_delay", 30.0))


@pytest.mark.parametrize("attempt,kw", [(1, {}), (3, {}), (10, {}), (10_000, {}),
                                        (2, dict(base_delay=0.05, factor=3.0,
                                                 max_delay=1.0)),
                                        (10_000, dict(base_delay=0.0)),
                                        (7, dict(factor=1.0, base_delay=2.0))])
def test_backoff_delay_matches_jax(attempt, kw):
    assert retry.backoff_delay(attempt, **kw) == jretry.backoff_delay(attempt, **kw)


def test_retry_nonretryable_and_giveup_escape_immediately():
    fn = _Flaky(5, exc=ValueError)
    with pytest.raises(ValueError):
        retry.retry_with_backoff(fn, sleep=lambda s: None)
    assert fn.calls == 1
    fn = _Flaky(5, exc=RuntimeError)
    with pytest.raises(RuntimeError, match="refused"):
        retry.retry_with_backoff(fn, sleep=lambda s: None,
                                 giveup=lambda e: "refused" in str(e))
    assert fn.calls == 1


# -- plan and cache token


def _plan_view(plan):
    if plan is None:
        return None
    return ([(b, c.canonical()) for b, c in plan.clauses], plan.timeout, plan.numerics)


def _knob_steps(r, monkeypatch):
    seen = []

    def look():
        seen.append((tuple(_plan_view(r.plan_for(op))
                           for op in ("allreduce", "barrier", "sendrecv", "gather")),
                     r.cache_token()[:4]))

    look()
    r.set_fault_spec("die:op=barrier;corrupt:op=allreduce")
    look()
    r.set_watchdog_timeout(30)
    look()
    r.set_check_numerics(True)
    look()
    r.reset_overrides()
    look()
    monkeypatch.setenv("MPI4JAX_TPU_WATCHDOG_TIMEOUT", "120")
    monkeypatch.setenv("MPI4JAX_TPU_FAULT_SPEC", "  delay:rank=1:op=sendrecv  ")
    look()
    r.set_watchdog_timeout(0)
    look()
    monkeypatch.setenv("MPI4JAX_TPU_CHECK_NUMERICS", "1")
    look()
    r.reset_overrides()
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    look()
    return seen


def test_plan_and_cache_token_match_jax_for_every_knob(monkeypatch):
    ours = _knob_steps(rt, monkeypatch)
    theirs = _knob_steps(jrt, monkeypatch)
    assert ours == theirs
    assert ours[0][0] == (None,) * 4 and ours[-1] == ours[0]
    assert len({token for _, token in ours}) == 7


@pytest.mark.parametrize("bad", [-1, float("nan")])
def test_bad_watchdog_timeout_rejected_as_jax(bad):
    with pytest.raises(ValueError) as ours:
        rt.set_watchdog_timeout(bad)
    with pytest.raises(ValueError) as theirs:
        jrt.set_watchdog_timeout(bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name,raw", [
    ("MPI4JAX_TPU_WATCHDOG_TIMEOUT", "-1"), ("MPI4JAX_TPU_WATCHDOG_TIMEOUT", "soon"),
    ("MPI4JAX_TPU_WATCHDOG_TIMEOUT", "nan"), ("MPI4JAX_TPU_CHECK_NUMERICS", "maybe"),
])
def test_bad_environment_rejected_as_jax(monkeypatch, name, raw):
    monkeypatch.setenv(name, raw)
    read = {"MPI4JAX_TPU_WATCHDOG_TIMEOUT": "effective_watchdog_timeout",
            "MPI4JAX_TPU_CHECK_NUMERICS": "effective_check_numerics"}[name]
    with pytest.raises(ValueError) as ours:
        getattr(rt, read)()
    with pytest.raises(ValueError) as theirs:
        getattr(jrt, read)()
    assert str(ours.value) == str(theirs.value)


# -- the watchdog's Python registry


def test_watchdog_registry_fifo_and_snapshot():
    reg = wd._Registry(on_timeout=lambda entries, expired: None)
    reg.arm("MPI_Allreduce", "aabbccdd", 0, "('i',)", timeout=1.0)
    reg.arm("MPI_Allreduce", "aabbccdd", 0, "('i',)", timeout=1.0)
    snap = reg.snapshot()
    assert len(snap) == 2
    assert snap[0]["opname"] == "MPI_Allreduce" and snap[0]["call_id"] == "aabbccdd"
    assert snap[0]["rank"] == 0 and snap[0]["timeout"] == 1.0
    reg.disarm("aabbccdd", 0)
    assert len(reg.snapshot()) == 1
    reg.disarm("aabbccdd", 0)
    reg.disarm("aabbccdd", 0)  # spurious: a no-op
    assert reg.empty()


def test_watchdog_expiry_with_injected_clock_and_suspend():
    now = [100.0]
    reg = wd._Registry(on_timeout=lambda entries, expired: None, clock=lambda: now[0])
    reg.arm("MPI_Gather", "12345678", 1, "('i',)", timeout=0.5)
    now[0] += 0.4
    assert reg.check_expired() is None
    now[0] += 0.2
    with wd.suspend_expiries():
        assert reg.check_expired() is None
    expired = reg.check_expired()
    assert expired["opname"] == "MPI_Gather"
    assert expired["elapsed"] == pytest.approx(0.6)
    assert reg.drain_expired() == 1 and reg.empty()


def test_watchdog_default_diagnostic_words(monkeypatch):
    """The default handler's lines, word for word the JAX package's."""
    from mpi4jax_tpu.resilience import watchdog as jwd

    seen = {}
    for mod, pkg in ((wd, "mpi4jax_tpu_torch"), (jwd, "mpi4jax_tpu")):
        lines = []
        fake = types.SimpleNamespace(
            host_line=lambda rank, text, lines=lines: lines.append(("line", rank, text)),
            host_fatal=lambda rank, text, lines=lines: lines.append(("fatal", rank, text)))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, f"{pkg}.native", fake)
            m.setattr(sys.modules[pkg], "native", fake, raising=False)
            entries = [dict(opname="MPI_Allreduce", call_id="aabbccdd", rank=0,
                            axes="('i',)", elapsed=1.01, timeout=1.0),
                       dict(opname="MPI_Barrier", call_id="11223344", rank=0,
                            axes="('i',)", elapsed=0.5, timeout=1.0)]
            mod._default_on_timeout(entries, entries[0])
        seen[pkg] = lines
    assert seen["mpi4jax_tpu_torch"] == seen["mpi4jax_tpu"]
    assert "collective watchdog: MPI_Allreduce exceeded 1s" in seen["mpi4jax_tpu"][-1][2]


def test_python_registry_brackets_an_op_and_monitor_handler():
    fired = []
    wd.force_python_fallback(True)
    wd.set_on_timeout(lambda entries, expired: fired.append(expired))
    rt.set_watchdog_timeout(1.0)
    comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))
    tpx.allreduce(torch.ones(2), comm=comm)
    assert wd.registry_empty() and fired == []
    # an op that raises is disarmed too
    with pytest.raises(ValueError):
        tpx.sendrecv(torch.ones(2), torch.ones(2, dtype=torch.int32),
                     dest=tpx.shift(1), comm=comm)
    assert wd.registry_empty()


# -- child processes


def test_die_exits_with_code_13():
    proc = run_child("""
        import torch, mpi4jax_tpu_torch as tpx
        comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))
        tpx.allreduce(torch.ones(2), comm=comm)
        tpx.allreduce(torch.ones(2), comm=comm)
        print("SHOULD NOT REACH", flush=True)
    """, {"MPI4JAX_TPU_FAULT_SPEC": "die:rank=0:op=allreduce:after=1"})
    assert proc.returncode == 13, proc.stderr
    assert "r0 | FAULT | die injected in MPI_Allreduce" in proc.stderr
    assert "SHOULD NOT REACH" not in proc.stdout


def test_hung_op_dies_by_the_watchdog():
    proc = run_child("""
        import torch, mpi4jax_tpu_torch as tpx
        comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))
        tpx.barrier(comm=comm)
        print("SHOULD NOT REACH", flush=True)
    """, {"MPI4JAX_TPU_FAULT_SPEC": "hang:op=allreduce;delay:op=barrier:secs=0.6",
          "MPI4JAX_TPU_WATCHDOG_TIMEOUT": "0.3"})
    # the delay sleeps before the arm (as in the JAX package), so the
    # probe's sleep is not the op's time in flight: the barrier completes
    assert proc.returncode == 0 and "SHOULD NOT REACH" in proc.stdout
    proc = run_child("""
        import time, torch, mpi4jax_tpu_torch as tpx
        from mpi4jax_tpu_torch.ops import _base
        comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))
        _base.run_body("barrier", comm, lambda c, a, t: time.sleep(5), (), None)
        print("SHOULD NOT REACH", flush=True)
    """, {"MPI4JAX_TPU_WATCHDOG_TIMEOUT": "0.3"})
    assert proc.returncode != 0 and "SHOULD NOT REACH" not in proc.stdout
    assert re.search(r"r0 \| WATCHDOG \| in-flight: MPI_Barrier \(call [0-9a-f]{8}, "
                     r"axes=\('x',\), elapsed \d+\.\d+s\)", proc.stderr), proc.stderr
    assert re.search(r"FATAL: collective watchdog: MPI_Barrier exceeded 0\.3s",
                     proc.stderr), proc.stderr


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_retries_a_refused_rendezvous_then_connects():
    proc = run_child(f"""
        import socket, threading, time
        import torch.distributed as dist
        from mpi4jax_tpu_torch.parallel import mesh

        calls = []
        real = dist.init_process_group

        def counted(*a, **k):
            calls.append(time.monotonic())
            return real(*a, **k)

        dist.init_process_group = counted
        held = socket.socket()
        held.bind(("localhost", {_free_port()}))
        held.listen()
        port = held.getsockname()[1]
        threading.Timer(0.6, held.close).start()
        url = f"tcp://localhost:{{port}}"
        dev = mesh.init_distributed("gloo", init_method=url, world_size=1, rank=0,
                                    device="cpu", timeout=10, connect_deadline=20,
                                    connect_base_delay=0.1, connect_max_delay=0.2)
        print("CONNECTED", dist.get_world_size(), len(calls) > 1, dev, flush=True)
        try:
            mesh.init_distributed("gloo", init_method=url, world_size=1, rank=0,
                                  device="cpu", connect_deadline=20)
        except ValueError as e:
            print("SECOND", len(calls), str(e)[:60], flush=True)
        dist.destroy_process_group()

        held = socket.socket()
        held.bind(("localhost", 0))
        held.listen()
        try:
            mesh.init_distributed(
                "gloo", init_method=f"tcp://localhost:{{held.getsockname()[1]}}",
                world_size=1, rank=0, device="cpu", timeout=5,
                connect_deadline=0.6, connect_base_delay=0.1)
        except RuntimeError as e:
            print("GAVE UP", str(e).splitlines()[0][:200], flush=True)
    """)
    assert proc.returncode == 0, proc.stderr
    assert "CONNECTED 1 True cpu" in proc.stdout, proc.stdout
    second = re.search(r"SECOND (\d+) trying to initialize", proc.stdout)
    assert second, proc.stdout
    m = re.search(r"GAVE UP torch.distributed rendezvous \(tcp://localhost:\d+, rank 0 "
                  r"of 1\) failed after \d+ attempt\(s\) over", proc.stdout)
    assert m and "deadline 0.6s" in proc.stdout, proc.stdout


def test_init_distributed_waits_for_a_late_rank_and_keeps_the_short_timeout(tmp_path):
    # rank 1 reaches the rendezvous 2.5 s after rank 0 in a world whose
    # collectives time out after 1 s: the world is still made, and a
    # collective rank 1 never enters fails on rank 0 after about 1 s
    code = textwrap.dedent(f"""
        import os, sys, time
        import torch, torch.distributed as dist
        from mpi4jax_tpu_torch.parallel import mesh

        rank = int(sys.argv[1])
        if rank == 1:
            time.sleep(2.5)
        mesh.init_distributed("gloo", init_method="file://{tmp_path}/rdv",
                              world_size=2, rank=rank, device="cpu",
                              timeout=1.0, connect_deadline=30.0)
        x = torch.ones(1)
        dist.all_reduce(x)
        print("SUM", float(x), flush=True)
        if rank == 1:
            time.sleep(4.0)
        else:
            t0 = time.monotonic()
            try:
                dist.all_reduce(torch.ones(1))
                print("NO TIMEOUT", flush=True)
            except Exception:
                print("TIMED OUT", round(time.monotonic() - t0, 1), flush=True)
        os._exit(0)
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPI4JAX_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=40))
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("SUM 2.0" in out for out, _ in outs), outs
    m = re.search(r"TIMED OUT (\d+\.\d)", outs[0][0])
    assert m and 0.5 <= float(m.group(1)) < 3.0, outs[0]


# -- drills on four gloo ranks (mpi4jax_tpu_torch/models/runtime_drill.py)


def _drill(name, tmp_path):
    from mpi4jax_tpu_torch.models import runtime_drill

    return runtime_drill.run_drill(name, device="cpu", timeout=0.5, delay=0.3,
                                   hang=2.0, limit=45.0,
                                   workdir=str(tmp_path / name))


def test_drill_delay_names_rank_2_the_late_arrival(tmp_path):
    from mpi4jax_tpu_torch.telemetry import merge

    res = _drill("delay", tmp_path)
    assert res["exit"] == [0, 0, 0, 0], res["stderr"]
    assert all("DRILL_DONE" in out for out in res["stdout"])
    table = merge.skew_table(merge.merge_dir(res["dir"]))
    arrivals = {r: row["last_arrivals"] for r, row in table["per_rank"].items()}
    assert sorted(arrivals) == [0, 1, 2, 3]
    assert max(arrivals, key=arrivals.get) == 2, arrivals
    assert table["per_op"]["sendrecv"]["max_skew"] >= 0.25


def test_drill_watchdog_aborts_the_waiting_ranks(tmp_path):
    res = _drill("watchdog", tmp_path)
    for r in (0, 1, 3):
        err = res["stderr"][r]
        assert res["exit"][r] != 0, err
        assert re.search(rf"r{r} \| WATCHDOG \| in-flight: MPI_Sendrecv \(call "
                         r"[0-9a-f]{8}, axes=.*elapsed (\d+\.\d+)s\)", err), err
        assert re.search(rf"r{r} \| FATAL: collective watchdog: MPI_Sendrecv "
                         r"exceeded 0\.5s", err), err
    assert res["exit"][2] != 0 and "delay 2s injected in MPI_Sendrecv" in res["stderr"][2]


def test_drill_corrupt_aborts_under_numeric_guards(tmp_path):
    res = _drill("corrupt", tmp_path)
    assert res["exit"][0] not in (0, 13), res["stderr"][0]
    assert re.search(r"r0 \| FATAL: MPI_Sendrecv: non-finite input detected "
                     r"\(MPI4JAX_TPU_CHECK_NUMERICS, call [0-9a-f]{8}\)",
                     res["stderr"][0]), res["stderr"][0]
    assert all(code != 0 for code in res["exit"])


def test_drill_die_exits_13_and_ends_the_others(tmp_path):
    res = _drill("die", tmp_path)
    assert res["exit"][1] == 13, res["stderr"][1]
    assert "r1 | FAULT | die injected in MPI_Sendrecv" in res["stderr"][1]
    assert all(code not in (0, None) for code in res["exit"]), res["exit"]
    assert res["seconds"] < 40


def test_drill_defaults_to_the_gpu(monkeypatch, tmp_path):
    """``device=None`` is the GPU: without CUDA the drill raises before
    it starts a rank, as every entry point of the port does."""
    import torch

    from mpi4jax_tpu_torch.models import runtime_drill

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime_drill.run_drill("die", workdir=str(tmp_path / "die"))
    assert not (tmp_path / "die").exists()


def test_async_span_armed_from_start_to_wait():
    wd.force_python_fallback(True)
    wd.set_on_timeout(lambda entries, expired: None)
    rt.set_watchdog_timeout(1.0)
    comm = tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))

    @tpx.spmd(comm=comm)
    def f(v):
        h, _ = tpx.allreduce_start(v)
        armed = [e["opname"] for e in wd.inflight_snapshot()]
        return tpx.allreduce_wait(h)[0], armed

    out, armed = f(torch.ones(3))
    assert armed == ["MPI_Allreduce"] and wd.registry_empty()
    assert torch.equal(out, torch.ones(3))
