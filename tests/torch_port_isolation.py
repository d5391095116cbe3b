"""Isolation for the port's parity tests from state other test files leave.

The parity tests run the JAX package beside the port in one pytest
worker, after whatever files the worker ran before.  Process state left
behind there breaks the JAX side here:

- ``tests/test_analysis_pure.py`` can leave ``MPI4JAX_TPU_ANALYZE`` set to
  an invalid value, which every later JAX op of the package rejects
  (``leaked_env_guard`` puts it back before every test of the session;
  this fixture also clears the programmatic override);
- a test that fails while a collective is armed in a watchdog registry
  leaves the entry armed, and that registry's monitor aborts the process
  once the deadline passes.  Besides ``mpi4jax_tpu.resilience.watchdog``,
  every test file that loads the package under a private name
  (``_load_isolated``) has its own copy of the module, with its own
  registry and monitor thread.

``isolated_reference_state`` clears both before each test: it drains the
registry of every loaded copy of the JAX package's watchdog module, holds
each copy's ``suspend_expiries`` window open for the test (so its Python
monitor treats nothing as expired), and unsets
``MPI4JAX_TPU_WATCHDOG_TIMEOUT`` so that the test arms no collective.
The C++ monitor of ``csrc/host_hooks.cc`` is out of its reach: its
registry has no drain, and an entry an earlier test left there can still
abort the worker (ROADMAP Queue 3).

The port has a watchdog module of its own
(``mpi4jax_tpu_torch.resilience.watchdog``), which is not one of those
copies: holding its expiries off would let the port's watchdog tests pass
while testing nothing.  Instead, after each test the fixture puts the
port's runtime services back to their defaults (``reset_port_services``):
both its registries drained (the Python one and its own C++ library's),
its telemetry and resilience overrides, its counters, journal and fault
counts reset, the health plane's ring, detector and gauges reset and its
boundary hook unregistered, runtime tracing and debug logging off, and
the elastic layer's state cleared: the epoch and its history back to 0
(``_reset_epoch_for_tests``: the launch-rank map and the counter of
launch ranks issued, the drain registry, the draining and drained comms
and the parked joins too), no pending failure, no claimed SIGINT
handler, no preemption (SIGTERM) handler of the elastic layer, the
default grid and comm dropped (the claimed watchdog handler goes with
``set_on_timeout(None)``), and no serving bucket table declared.

Import it into a test module (``from torch_port_isolation import
isolated_reference_state  # noqa: F401``); it is autouse.  Where the JAX
package cannot be imported (the card's machine, which runs only the
``gpu`` tests) it resets the port's services alone.
"""

import contextlib
import signal
import sys

import pytest


def watchdog_copies():
    """Every loaded copy of the JAX package's watchdog module (not the
    port's)."""
    return [m for name, m in list(sys.modules.items())
            if name.endswith("resilience.watchdog")
            and not name.startswith("mpi4jax_tpu_torch.")
            and hasattr(m, "drain_registry") and hasattr(m, "suspend_expiries")]


def reset_port_services() -> None:
    """The port's runtime services back to their defaults (only where the
    port's modules are loaded)."""
    if "mpi4jax_tpu_torch.resilience.watchdog" not in sys.modules:
        return
    from mpi4jax_tpu_torch import resilience, serving, telemetry
    from mpi4jax_tpu_torch.parallel import mesh
    from mpi4jax_tpu_torch.resilience import elastic, watchdog
    from mpi4jax_tpu_torch.utils import debug

    watchdog.drain_registry()
    watchdog.set_on_timeout(None)
    watchdog.force_python_fallback(False)
    resilience.reset_overrides()
    resilience.reset_fault_state()
    telemetry.set_telemetry_mode(None)
    telemetry.reset()
    telemetry.health.unregister_boundary_hook()
    debug.set_runtime_tracing(False)
    debug.set_logging(False)
    elastic._uninstall_interrupt()
    if getattr(signal.getsignal(signal.SIGTERM), "mpx_preemption", False):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    elastic.take_pending_failure()
    elastic._reset_epoch_for_tests()
    mesh.forget_world()
    serving.clear_declared_buckets()
    # the pin, persistent-tier and compiler counters (the files a test
    # wrote stay in its own tmp_path)
    from mpi4jax_tpu_torch import aot

    aot.reset_stats()


@pytest.fixture(autouse=True)
def isolated_reference_state(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_ANALYZE", raising=False)
    monkeypatch.delenv("MPI4JAX_TPU_WATCHDOG_TIMEOUT", raising=False)
    try:
        from mpi4jax_tpu.analysis import hook
        from mpi4jax_tpu.resilience import watchdog  # noqa: F401 - loads the copy
    except ImportError:
        # no JAX (the card's machine, where only the gpu tests run): no
        # JAX-package state to isolate from
        hook = None
    if hook is not None:
        hook.set_analyze_mode(None)
    with contextlib.ExitStack() as stack:
        for copy in watchdog_copies():
            copy.drain_registry()
            stack.enter_context(copy.suspend_expiries())
        yield
    reset_port_services()
