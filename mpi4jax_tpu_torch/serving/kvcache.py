"""The KV cache: a slot pool and its out-of-place updates.

PyTorch counterpart of ``mpi4jax_tpu/serving/kvcache.py``.  The KV
cache is the serving runtime's only long-lived device state: one tensor
pair per rank, shaped ``[slots + 1, max_len, local_heads, head_dim]``,
the head axis split over the tensor-parallel group (each rank holds
``heads / k`` heads) and the slot axis a fixed pool of sequence rows.
Admission binds a sequence to a free slot; eviction frees the integer.
The tensors never change shape, so the per-bucket programs survive any
admit and evict churn: slot ids enter a program as a small ``int32``
tensor, and every write is a scatter at ``[slot, position]``.

Row ``slots`` (the +1) is the SCRATCH row: padding lanes of a bucketed
batch point their writes there, so padded compute can never touch a
live sequence.  Several padding lanes write the same ``[scratch, 0]``
element, and on CUDA which of them lands is unspecified: the row's
content is garbage by design, and nothing reads it for a live lane.

The writes are out of place, as the JAX package's ``.at[...].set``:
they return a new tensor and leave the argument as it was.  A pin on
one CUDA rank runs its body on copies of its arguments, and everywhere
else on the arguments themselves (``aot/pinning.py``), so an in-place
write would change the caller's state on one path and not the other.

:class:`SlotAllocator` and :func:`kv_shape` are pure Python.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["SlotAllocator", "kv_shape", "scatter_prefill", "scatter_step"]


class SlotAllocator:
    """A deterministic free-list over ``capacity`` KV slots (lowest id
    first, so every rank of a lockstep host loop allocates alike)."""

    __slots__ = ("capacity", "_free", "_used")

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._free: List[int] = list(range(capacity))
        self._used: set = set()

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"KV slot pool exhausted ({self.capacity} slots in use); "
                "admission must check free() first"
            )
        slot = self._free.pop(0)
        self._used.add(slot)
        return slot

    def free_slot(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        # the free list stays sorted: the allocation order does not depend
        # on the eviction order
        self._free.append(slot)
        self._free.sort()

    def free(self) -> int:
        return len(self._free)

    def used(self) -> Tuple[int, ...]:
        return tuple(sorted(self._used))

    def reset(self) -> None:
        self._free = list(range(self.capacity))
        self._used.clear()

    @property
    def scratch(self) -> int:
        """The scratch row's slot id (the ``+1`` row padding lanes write
        to, outside the allocatable pool by construction)."""
        return self.capacity


def kv_shape(slots: int, max_len: int, local_heads: int,
             head_dim: int) -> Tuple[int, int, int, int]:
    """Per-rank KV tensor shape: ``slots + 1`` rows (pool + scratch)."""
    return (slots + 1, max_len, local_heads, head_dim)


# ---------------------------------------------------------------------------
# the writes (run inside the serving programs)
# ---------------------------------------------------------------------------


def scatter_step(kv, slots, lens, new):
    """One decode step's K (or V) rows written at ``[slot, len]`` per lane,
    into a new tensor: ``kv [S+1, L, H, d]``, ``slots``/``lens`` int32
    ``[B]``, ``new [B, H, d]``."""
    return kv.index_put((slots.long(), lens.long()), new)


def scatter_prefill(kv, slots, new):
    """A whole prompt's K (or V) rows, into a new tensor: ``new [B, P, H,
    d]`` lands at ``kv[slot, 0:P]`` per lane (positions past the live
    prompt hold values that the length array masks and the growing
    sequence overwrites)."""
    import torch

    pos = torch.arange(new.shape[1], device=kv.device)
    return kv.index_put((slots.long()[:, None], pos[None, :]), new)
