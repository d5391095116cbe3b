"""Isolation for the port's parity tests from state other test files leave.

The parity tests run the JAX package beside the port in one pytest
worker, after whatever files the worker ran before.  Two kinds of process
state left behind there break the JAX side here:

- ``tests/test_analysis_pure.py`` can leave ``MPI4JAX_TPU_ANALYZE`` set to
  an invalid value, which every later JAX op of the package rejects
  (``leaked_env_guard`` puts it back before every test of the session;
  this fixture also clears the programmatic override);
- a test that fails while a collective is armed in the watchdog's registry
  leaves the entry armed, and the watchdog aborts the process once its
  deadline passes.

``isolated_reference_state`` clears both before each test.  Import it into
a test module (``from torch_port_isolation import isolated_reference_state
# noqa: F401``); it is autouse.
"""

import pytest


@pytest.fixture(autouse=True)
def isolated_reference_state(monkeypatch):
    from mpi4jax_tpu.analysis import hook
    from mpi4jax_tpu.resilience import watchdog

    monkeypatch.delenv("MPI4JAX_TPU_ANALYZE", raising=False)
    hook.set_analyze_mode(None)
    watchdog.drain_registry()
