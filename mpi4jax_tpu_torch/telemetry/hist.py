"""Mergeable log2-bucketed latency histograms.

PyTorch port's copy of ``mpi4jax_tpu/telemetry/hist.py`` (pure Python,
kept apart so that the port imports nothing of the JAX package): fixed
buckets at powers of two of a second (bucket ``b`` covers
``[2^b, 2^(b+1))`` seconds), so histograms recorded on different ranks or
processes merge by bucket-wise addition with no rebinning, and a p50/p99
read off the merged histogram is as accurate as either input's
(half-bucket, about sqrt(2), relative error).  Its dict form is the JAX
package's, so either package's snapshots merge with the other's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["Histogram", "bucket_index", "bucket_value"]

# latencies outside [2^MIN_BUCKET, 2^(MAX_BUCKET+1)) seconds clamp to the
# edge buckets: ~6e-10 s is below any host-callback resolution, and 2^16 s
# (~18 h) is longer than any collective that has not already tripped the
# watchdog
MIN_BUCKET = -31
MAX_BUCKET = 16


def bucket_index(value: float) -> int:
    """The log2 bucket of ``value`` seconds: ``floor(log2(value))``,
    clamped to the fixed range (non-positive values clamp to the bottom
    bucket — a begin/end pair on one host clock cannot be negative, but a
    defensive clamp beats a crash inside a host callback)."""
    if value <= 0:
        return MIN_BUCKET
    return max(MIN_BUCKET, min(MAX_BUCKET, math.floor(math.log2(value))))


def bucket_value(index: int) -> float:
    """Representative value of a bucket: its geometric midpoint
    ``2^(b+0.5)`` — the point estimate minimizing worst-case relative
    error within ``[2^b, 2^(b+1))``."""
    return 2.0 ** (index + 0.5)


class Histogram:
    """Fixed-log2-bucket histogram with exact count/sum/min/max sidecars.

    The sidecars make ``min``/``mean``/``max`` exact while quantiles are
    bucket-resolution estimates (clamped into ``[min, max]`` so a
    single-sample histogram reports its sample, not a bucket midpoint).
    """

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, value: float) -> None:
        b = bucket_index(value)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-wise sum into a NEW histogram (inputs untouched)."""
        out = Histogram()
        for src in (self, other):
            for b, n in src.counts.items():
                out.counts[b] = out.counts.get(b, 0) + n
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (``0 <= q <= 1``) from the buckets:
        the geometric midpoint of the bucket where the cumulative count
        crosses ``q * count``, clamped into ``[min, max]``."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        est = None
        for b in sorted(self.counts):
            cum += self.counts[b]
            if cum >= target:
                est = bucket_value(b)
                break
        if est is None:  # q > 1 fed in; be defensive
            est = bucket_value(max(self.counts))
        return max(self.min, min(self.max, est))

    def to_dict(self) -> dict:
        """JSON-ready form (bucket keys become strings)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": {str(b): n for b, n in sorted(self.counts.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls()
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.min = d.get("min")
        h.max = d.get("max")
        h.counts = {int(b): int(n) for b, n in d.get("buckets", {}).items()}
        return h

    def __repr__(self):
        return (
            f"Histogram(count={self.count}, min={self.min}, "
            f"p50={self.quantile(0.5)}, max={self.max})"
        )
