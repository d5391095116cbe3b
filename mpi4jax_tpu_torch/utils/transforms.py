"""What the port's Functions need to know of ``torch.func``.

The exchanges (``ops/_base.py``) and the kernel entry points
(``kernels/flash_attention.py``, ``kernels/_build.py:StencilCall``) run
on storage: under a ``torch.func`` transform they go through Functions
whose ``vmap`` rule lays the batch dim out (``batch_at``) and calls again
one level down, until plain tensors arrive.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._C import _functorch


def transformed(*tensors) -> bool:
    """Whether a ``torch.func`` transform (``vmap``, ``grad``, ``jvp``,
    ...) wraps one of ``tensors``: they then have no storage of their own,
    and an exchange or a kernel must run on what they wrap."""
    return any(isinstance(t, torch.Tensor) and _functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def batch_at(size: int, dim: Optional[int], t: torch.Tensor,
             at: int = 0) -> torch.Tensor:
    """The physical ``t`` of a vmapped call with its batch dim (``dim``)
    at ``at``; an unbatched ``t`` expanded to ``size`` lanes."""
    if dim is None:
        return t.unsqueeze(at).expand(*t.shape[:at], size, *t.shape[at:])
    return t.movedim(dim, at)
