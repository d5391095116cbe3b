"""Bucketed batch shapes: the serving runtime's one-program-per-shape rule.

PyTorch counterpart of ``mpi4jax_tpu/serving/buckets.py``, pure Python
as there.  A serving loop cannot afford one program per request count:
on one CUDA rank each distinct batch shape is another captured CUDA
graph.  The bucket table rounds every live batch UP to a small declared
set of shapes (powers of two by default), so each ``(phase, bucket)``
pair maps to exactly ONE program for the life of the server, and
admission and eviction change which *lanes* are live, never which
*program* runs.

The padded bucket shape is also what every shape-derived knob is
consulted with (:func:`bucket_payload_bytes`): with the live payload,
two batches in one bucket could derive two chunk counts and split the
bucket across two programs.

:func:`declare_buckets` registers the active table process-wide.  In
the JAX package the MPX136 advisory (``analysis/checkers.py``) reads it
to flag traced programs whose batch dimension is not a bucket; that
checker belongs to the analysis layer the port has not reached yet
(ROADMAP Queue 1 item 6), and the registry is kept so that the engine
scopes its declaration around its loop as the JAX engine does.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

__all__ = ["BucketTable", "bucket_payload_bytes", "clear_declared_buckets",
           "declare_buckets", "declared_buckets", "powers_of_two"]


def powers_of_two(max_batch: int) -> Tuple[int, ...]:
    """The default bucket set: ``1, 2, 4, ... , max_batch`` (the cap is
    always included, so the table covers it when it is not a power of
    two)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


class BucketTable:
    """An ascending set of declared batch sizes and the pad-up rule."""

    __slots__ = ("buckets",)

    def __init__(self, buckets: Sequence[int]):
        bs = tuple(int(b) for b in buckets)
        if not bs:
            raise ValueError("bucket table must declare at least one bucket")
        if any(b < 1 for b in bs):
            raise ValueError(f"bucket sizes must be >= 1, got {bs}")
        if len(set(bs)) != len(bs) or tuple(sorted(bs)) != bs:
            raise ValueError(
                f"bucket sizes must be strictly ascending, got {bs}"
            )
        self.buckets = bs

    @classmethod
    def from_spec(cls, spec: str, max_batch: Optional[int] = None
                  ) -> "BucketTable":
        """Parse the ``MPI4JAX_TPU_SERVING_BUCKETS`` grammar: a
        comma-separated ascending list, or empty for powers of two up to
        ``max_batch``."""
        spec = (spec or "").strip()
        if not spec:
            if max_batch is None:
                raise ValueError(
                    "an empty bucket spec needs max_batch to derive the "
                    "default power-of-two table"
                )
            return cls(powers_of_two(max_batch))
        try:
            buckets = tuple(int(tok) for tok in spec.split(","))
        except ValueError:
            raise ValueError(
                f"MPI4JAX_TPU_SERVING_BUCKETS={spec!r} could not be "
                "parsed: expected comma-separated ascending batch sizes "
                "(e.g. '1,2,4,8')"
            ) from None
        return cls(buckets)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """The smallest declared bucket covering a live batch of ``n``."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch size {n} exceeds the largest declared bucket "
            f"{self.max_batch} (buckets: {self.buckets})"
        )

    def pad(self, n: int) -> int:
        """Lanes of padding a live batch of ``n`` rides with."""
        return self.bucket_for(n) - n

    def __contains__(self, n) -> bool:
        return n in self.buckets

    def __eq__(self, other) -> bool:
        return (isinstance(other, BucketTable)
                and other.buckets == self.buckets)

    def __hash__(self) -> int:
        return hash(self.buckets)

    def __repr__(self) -> str:
        return f"BucketTable{self.buckets}"


def bucket_payload_bytes(bucket: int, per_item_bytes: int) -> int:
    """The PADDED payload a bucketed program ships per collective: what
    shape-derived knobs must be consulted with, so that two requests in
    one bucket derive the same values (one program per bucket)."""
    if bucket < 1 or per_item_bytes < 0:
        raise ValueError(
            f"need bucket >= 1 and per_item_bytes >= 0, got "
            f"({bucket}, {per_item_bytes})"
        )
    return bucket * per_item_bytes


# ---------------------------------------------------------------------------
# the declared-bucket registry
# ---------------------------------------------------------------------------
#
# The serving engine declares its table for the length of its loop
# (engine.py:run) and puts the previous one back after it.  Nothing
# outside the serving runtime declares buckets.

_declared: Optional[BucketTable] = None


def declare_buckets(table) -> BucketTable:
    """Install ``table`` (a :class:`BucketTable` or an iterable of batch
    sizes) as the process's declared serving bucket set.  Returns the
    installed table."""
    global _declared
    if not isinstance(table, BucketTable):
        table = BucketTable(tuple(table) if isinstance(table, Iterable)
                            else (table,))
    _declared = table
    return table


def declared_buckets() -> Optional[BucketTable]:
    """The declared table, or ``None`` when no serving loop declared
    one."""
    return _declared


def clear_declared_buckets() -> None:
    global _declared
    _declared = None
