"""Numeric guards: fail fast on NaN/Inf flowing through the ops.

PyTorch counterpart of ``mpi4jax_tpu/resilience/numerics.py``.  A NaN
that enters an ``allreduce`` poisons every rank's copy of the result in
one hop; by the time a loss turns NaN the broken exchange is thousands of
steps back.  With ``MPI4JAX_TPU_CHECK_NUMERICS=1`` (or
``set_check_numerics(True)``) every op checks its floating inputs and
outputs and kills the job through ``native.abort_if`` with a message that
names the op and the call.

Off by default.  On, a guarded op costs one ``isfinite`` reduction per
floating tensor and one host read of the combined flag (on a CUDA tensor,
a synchronisation of the host with the device), so a pinned program runs
its body eagerly under it (``aot/pinning.py``): a CUDA graph cannot read
a flag back between two of its kernels.
"""

from __future__ import annotations

__all__ = ["guard_values"]


def guard_values(mpi_name: str, call_id: str, rank, values, stage: str):
    """One ``abort_if`` over the non-finite flag of ``values``'s floating
    tensors (``stage`` is ``"input"`` or ``"output"``, named in the
    message).  Returns the flag, ``None`` when nothing is checkable."""
    import torch

    from .. import native
    from ..telemetry.core import meter

    floats = [v for v in values
              if isinstance(v, torch.Tensor)
              and (v.is_floating_point() or v.is_complex())]
    if not floats:
        return None
    meter("numeric_guard.sites")
    bad = torch.stack([~torch.isfinite(v).all() for v in floats]).any()
    return native.abort_if(
        bool(bad.item()), rank,
        f"{mpi_name}: non-finite {stage} detected "
        f"(MPI4JAX_TPU_CHECK_NUMERICS, call {call_id})")
