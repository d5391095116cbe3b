"""The fast call of a pinned program: the CUDA graph replay.

PyTorch counterpart of ``mpi4jax_tpu/aot/fastpath.py``.  There the fast
path is jaxlib's C++ dispatch of a compiled executable, which skips the
Python prologue of ``Compiled.__call__``.  The port's counterpart is the
graph replay: a pin on one CUDA rank (``aot/pinning.py:GraphRun``)
launches everything its body launched with one host call.  So
``cpp_call_for(run)`` hands the run back with whether it replays a graph,
and ``MPI4JAX_TPU_CPP_DISPATCH=false`` makes a pin on one CUDA rank run
its body eagerly (``program.info["eager_reason"]`` names the variable),
as the JAX switch sends a pin through the Python call.
"""

from __future__ import annotations

__all__ = ["cpp_call_for", "supported"]


def supported(run) -> bool:
    """Does this run replay a CUDA graph (the port's fast path)?"""
    from .pinning import GraphRun

    return isinstance(run, GraphRun)


def cpp_call_for(run):
    """``(call, used_fastpath)``: the run itself, and whether it replays a
    CUDA graph."""
    return run, supported(run)
