"""Knobs, debug switches and pytrees: the parts of the JAX package's
``utils/`` the port reads."""

from .debug import (  # noqa: F401
    get_logging,
    get_runtime_tracing,
    set_logging,
    set_runtime_tracing,
)
