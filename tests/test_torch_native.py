"""The port's native host hooks (``mpi4jax_tpu_torch/csrc/host_hooks.cc``)
against the JAX package's.

The library builds here with ``g++`` (no CUDA), as the JAX package's
does.  The runtime-trace lines of the port's ops are held against the
regexes of ``tests/test_native.py`` (the reference's format), begin and
end of one call share its id, tracing off prints nothing, ``wallclock``
is monotonic, ``abort_if`` kills only when its predicate holds, and the
C++ watchdog arms, disarms, drains and, in a child process, expires with
the JAX package's dump wording (the regexes of
``tests/test_resilience.py::test_watchdog_aborts_hung_rank_after_injected_death``).
Deaths are asserted in child processes.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from test_native import DONE_RE, LINE_RE  # noqa: E402

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import native  # noqa: E402
from mpi4jax_tpu_torch.resilience import watchdog  # noqa: E402
from mpi4jax_tpu_torch.utils import set_runtime_tracing  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    native.build(verbose=False)
    assert native.available()


@pytest.fixture
def tracing():
    set_runtime_tracing(True)
    yield
    set_runtime_tracing(False)


def comm1():
    return tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))


def run_child(code: str, timeout: float = 60.0):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPI4JAX_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_library_builds_with_gxx():
    path = native.build(verbose=False)
    assert os.path.exists(path) and path.endswith(".so")
    # the port's own library, never the JAX package's
    assert "mpi4jax_tpu_torch" in path and "libmpx_torch_hooks" in path


def test_runtime_trace_format(capfd, tracing):
    out, _ = tpx.allreduce(torch.arange(4.0), op=tpx.SUM, comm=comm1())
    assert torch.equal(out, torch.arange(4.0))
    err = capfd.readouterr().err
    begin_lines = [ln for ln in err.splitlines()
                   if LINE_RE.match(ln) and "done" not in ln]
    done_lines = [ln for ln in err.splitlines() if DONE_RE.match(ln)]
    assert len(begin_lines) == 1 and len(done_lines) == 1, err
    assert DONE_RE.match(done_lines[0]).group(1) == "0"
    assert DONE_RE.match(done_lines[0]).group(3) == "MPI_Allreduce"


def test_runtime_trace_pairs_share_call_id(capfd, tracing):
    comm = comm1()
    a, tok = tpx.allreduce(torch.ones(3), op=tpx.SUM, comm=comm)
    tpx.sendrecv(a, a, dest=tpx.shift(1), comm=comm, token=tok)
    err = capfd.readouterr().err
    ids = {}
    for line in err.splitlines():
        m = LINE_RE.match(line)
        if m:
            ids.setdefault(m.group(3).split()[0], []).append(m.group(2))
    # begin and end of one call carry one id; two calls, two ids
    assert len(set(ids["MPI_Allreduce"])) == 1 and len(ids["MPI_Allreduce"]) == 2
    assert len(set(ids["MPI_Sendrecv"])) == 1 and len(ids["MPI_Sendrecv"]) == 2
    assert ids["MPI_Allreduce"][0] != ids["MPI_Sendrecv"][0]


def test_trace_off_is_silent(capfd):
    tpx.allreduce(torch.ones(3), op=tpx.SUM, comm=comm1())
    err = capfd.readouterr().err
    assert not any(LINE_RE.match(ln) for ln in err.splitlines())


def test_wallclock_monotonic_ordering():
    t1 = native.wallclock()
    t2 = native.wallclock()
    assert t2 >= t1 >= 0


def test_abort_if_false_is_noop():
    assert native.abort_if(False, 0, "nan detected") is False
    assert native.abort_if(torch.isnan(torch.ones(4)).any(), 0, "nan") is False


def test_abort_if_kills_process():
    proc = run_child("""
        import torch
        from mpi4jax_tpu_torch import native
        x = torch.full((4,), float("nan"))
        native.abort_if(torch.isnan(x).any(), 0, "nan detected in gradient")
        print("SHOULD NOT REACH", flush=True)
    """)
    assert proc.returncode != 0
    assert "r0 | FATAL: nan detected in gradient" in proc.stderr
    assert "SHOULD NOT REACH" not in proc.stdout


def test_native_watchdog_arms_disarms_and_drains():
    assert watchdog.native_active()
    watchdog.drain_registry()
    native.watchdog_arm("MPI_Allreduce", "aabbccdd", 0, "('x',)", 1.0)
    native.watchdog_arm("MPI_Allreduce", "aabbccdd", 0, "('x',)", 1.0)
    native.watchdog_arm("MPI_Barrier", "11223344", 0, "('x',)", 1.0)
    try:
        assert native.watchdog_inflight() == 3
        native.watchdog_disarm("aabbccdd", 0)  # FIFO under one id
        assert native.watchdog_inflight() == 2
        native.watchdog_disarm("99999999", 0)  # a spurious disarm: no-op
        assert native.watchdog_inflight() == 2
    finally:
        assert watchdog.drain_registry() == 2
    assert native.watchdog_inflight() == 0


WD_LINE = re.compile(r"r0 \| WATCHDOG \| in-flight: MPI_Allreduce \(call deadbeef, "
                     r"axes=.*elapsed (\d+\.\d+)s\)")


def test_native_watchdog_expires_with_the_dump_wording():
    proc = run_child("""
        import time
        from mpi4jax_tpu_torch import native
        native.watchdog_arm("MPI_Barrier", "11223344", 0, "('x',)", 1.0)
        native.watchdog_arm("MPI_Allreduce", "deadbeef", 0, "('x',)", 0.2)
        time.sleep(10)
        print("SHOULD NOT REACH", flush=True)
    """)
    assert proc.returncode != 0 and "SHOULD NOT REACH" not in proc.stdout
    m = WD_LINE.search(proc.stderr)
    assert m, proc.stderr
    assert 0.2 <= float(m.group(1)) <= 0.5  # printed to 2 decimals
    assert "r0 | WATCHDOG | in-flight: MPI_Barrier (call 11223344" in proc.stderr
    assert re.search(r"r0 \| FATAL: collective watchdog: MPI_Allreduce exceeded "
                     r"0\.2s \(call deadbeef, axes=\('x',\)\)", proc.stderr), proc.stderr


def test_native_cli_builds():
    from mpi4jax_tpu_torch.native import main

    assert main(["build"]) == 0
    assert main(["nonsense"]) == 1
