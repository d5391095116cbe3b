"""Pytest plugin: put ``MPI4JAX_TPU_ANALYZE`` back before each test.

Two tests of ``tests/test_analysis_pure.py`` write the variable straight
into ``os.environ``: ``test_analyze_mode_parsing`` leaves it at ``loud``,
which the JAX package rejects, and ``test_mode_override_and_cache_token``
leaves it at ``warn``, which arms the trace-time verifier.  Their
fixture's ``monkeypatch.delenv`` records no undo for a variable that was
unset, so the value outlives the test.  Every later test in the same
pytest worker then runs under that mode: with ``loud`` each op raises
``ValueError``; with ``warn`` cache tokens, counters and retrace counts
differ from what the tests expect.  Which tests those are depends on how
xdist hands tests to workers.

The hook restores the value the variable had when the plugin was loaded
(collection ends before any test runs) before each test's setup, so a
test's own fixtures and ``monkeypatch.setenv`` still apply on top.  The
port's parity test modules load it with
``pytest_plugins = ["leaked_env_guard"]``; once loaded it holds for every
test of the session.
"""

import os

import pytest

_VAR = "MPI4JAX_TPU_ANALYZE"
_BASELINE = os.environ.get(_VAR)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    if os.environ.get(_VAR) == _BASELINE:
        return
    if _BASELINE is None:
        del os.environ[_VAR]
    else:
        os.environ[_VAR] = _BASELINE
