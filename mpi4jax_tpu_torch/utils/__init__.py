"""Knobs, debug switches, the profiler capture, pytrees and the capability
probes: the parts of the JAX package's ``utils/`` the port reads.  Its
dtype table (``SUPPORTED_DTYPES``, ``check_dtype``), its argument-type
decorator (``enforce_types``), its JAX version check and its
``prefer_notoken`` knob have no counterpart
(``tests/test_torch_namespaces.py`` lists why)."""

import torch

from .config import parse_env_bool  # noqa: F401
from .debug import (  # noqa: F401
    get_logging,
    get_runtime_tracing,
    set_logging,
    set_runtime_tracing,
)
from .profiling import ProfileSummary, profile_ops  # noqa: F401


def has_cuda_support() -> bool:
    """True if PyTorch sees a CUDA device (``torch.cuda.is_available()``),
    the device the port's kernels and entry points run on."""
    return torch.cuda.is_available()


def has_tpu_support() -> bool:
    """Always False: the port is PyTorch on CUDA and has no TPU backend
    (the JAX package is the one that runs on TPUs)."""
    return False


def has_sycl_support() -> bool:
    """Always False, as in the JAX package: neither has a SYCL backend."""
    return False


def flush() -> None:
    """Wait for the ops in flight (``ops.send.flush``, the top-level
    ``flush``), as the JAX package's ``utils.flush`` does."""
    from ..ops.send import flush as _flush

    _flush()
