"""Profiler integration: the ops' ranges and the device's kernels in one trace.

PyTorch counterpart of ``mpi4jax_tpu/utils/profiling.py``.  There every
op runs inside ``jax.named_scope("mpi4jax_tpu.<op>")`` and
``profile_ops`` wraps ``jax.profiler.trace`` with a fence of the live
arrays.  Here ``profile_ops`` opens a ``torch.profiler`` capture with the
CPU activity and, where CUDA is available, the CUDA one (kernels, copies
and CUDA-graph launches as the device ran them), and while a capture is
open the dispatch point (``ops/_base.py:run_body``) runs each op inside
``torch.profiler.record_function("mpi4jax_tpu.<op>")``, the JAX package's
scope name.  Outside a capture an op call pays nothing for this: the
capture's opening and closing move the services' stamp
(``utils/config.py:bump_service_epoch``), which the dispatch point reads
once a call anyway, and a pin captured before stays valid.
"""

from __future__ import annotations

import contextlib
import gc
import os

import torch

__all__ = ["profile_ops", "ProfileSummary", "capture_open", "op_range"]

# open profile_ops captures in this process
_open = [0]


def capture_open() -> bool:
    """Whether a ``profile_ops`` capture is open (the dispatch point reads
    it when the services' stamp moves)."""
    return _open[0] > 0


def op_range(opname: str):
    """The trace range of one op call: ``mpi4jax_tpu.<op>``."""
    return torch.profiler.record_function(f"mpi4jax_tpu.{opname}")


class ProfileSummary:
    """What a ``profile_ops`` capture did: the trace directory, the Chrome
    trace file in it, the backend (``"cuda"`` or ``"cpu"``) and how many
    live tensors the exit fence covered (``None`` until the context
    exits)."""

    __slots__ = ("trace_dir", "trace_file", "backend", "fenced_arrays")

    def __init__(self, trace_dir: str, trace_file: str, backend: str):
        self.trace_dir = trace_dir
        self.trace_file = trace_file
        self.backend = backend
        self.fenced_arrays = None

    def __repr__(self):
        return (
            f"ProfileSummary(trace_dir={self.trace_dir!r}, "
            f"trace_file={self.trace_file!r}, backend={self.backend!r}, "
            f"fenced_arrays={self.fenced_arrays})"
        )


def _live_tensors(device_type: str) -> int:
    """The tensors alive in this process on ``device_type``, as the
    garbage collector finds them."""
    n = 0
    for obj in gc.get_objects():
        # type(), not isinstance: a module's deprecated alias answers an
        # isinstance probe with a warning
        if issubclass(type(obj), torch.Tensor) and obj.device.type == device_type:
            n += 1
    return n


@contextlib.contextmanager
def profile_ops(logdir: str, *, create_perfetto_link: bool = False):
    """Capture a profiler trace of the enclosed ops and of the device work
    they queue.

    Usage::

        with mpx.profile_ops("/tmp/trace") as prof:
            out = step(state)
        # prof.trace_file: the Chrome trace (Perfetto, chrome://tracing)

    Each op call inside shows as a ``mpi4jax_tpu.<op>`` range; a pinned
    program replayed as a CUDA graph runs no host code, so its ops show
    no ranges, only the kernels the graph launches.  On exit, in a
    ``finally`` (so also when the block raises), the device is fenced
    with ``torch.cuda.synchronize``, which lands every queued kernel
    inside the capture, then the trace is written to
    ``logdir/mpi4jax_tpu_torch-p<rank>.trace.json``.
    ``fenced_arrays`` counts the tensors alive on the capture's device
    when the fence ran (found by the garbage collector: the port's
    counterpart of ``jax.live_arrays``); the synchronisation waits for all
    the device's work whatever holds it, so the count says what the block
    kept alive, and 0 says it kept none of its outputs.  On the CPU the
    ops have finished when they return, and there is nothing to wait for.

    ``create_perfetto_link=True`` prints the trace file's path and how to
    open it in the Perfetto UI; nothing is served and nothing waits (the
    JAX package serves the trace on a local port and blocks until it is
    opened).
    """
    from torch.profiler import ProfilerActivity, profile

    from . import config
    from ..telemetry import journal

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    backend = "cuda" if cuda else "cpu"
    trace_file = os.path.join(
        logdir, f"mpi4jax_tpu_torch-p{journal.process_index()}.trace.json")
    summary = ProfileSummary(logdir, trace_file, backend)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _open[0] += 1
    config.bump_service_epoch()
    try:
        yield summary
    finally:
        try:
            # the fence: work queued inside the block lands in the capture,
            # also when the block raised
            summary.fenced_arrays = _live_tensors(backend)
            if cuda:
                torch.cuda.synchronize()
        finally:
            _open[0] -= 1
            config.bump_service_epoch()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace_file)
            if create_perfetto_link:
                print(f"profile_ops: wrote {trace_file}; open it at "
                      "https://ui.perfetto.dev (Open trace file)", flush=True)
