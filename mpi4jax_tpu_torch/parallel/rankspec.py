"""Static rank-routing specifications for point-to-point ops.

PyTorch counterpart of ``mpi4jax_tpu/parallel/rankspec.py``.  A routing
spec describes the whole pattern at once (which rank sends to which), so
the same call reads the same on every process.  A spec is any of:

- ``shift(k)`` / ``shift(k, wrap=False)`` — ring / edge-stopping shift,
  the halo-exchange workhorse;
- a dict ``{src_rank: dst_rank}``;
- a list of ``(src, dst)`` pairs;
- a callable ``rank -> Optional[dst]``.

A bare int rank is refused (MPX103): every rank runs the same call, so
``dest=1`` would send every rank's data to rank 1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union


class shift:
    """Ring (or edge-stopping) shift pattern: rank ``r`` sends to ``r + k``.

    ``wrap=True`` (default) wraps modulo the comm size, giving a ring.
    ``wrap=False`` drops out-of-range endpoints: the halo-exchange pattern
    at domain boundaries.
    """

    def __init__(self, k: int, *, wrap: bool = True):
        self.k = int(k)
        self.wrap = bool(wrap)

    def __call__(self, r: int, size: int) -> Optional[int]:
        d = r + self.k
        if self.wrap:
            return d % size
        return d if 0 <= d < size else None

    def inverse(self) -> "shift":
        return shift(-self.k, wrap=self.wrap)

    def __repr__(self):
        return f"shift({self.k}{'' if self.wrap else ', wrap=False'})"


RankSpecLike = Union[
    shift,
    Dict[int, int],
    Sequence[Tuple[int, int]],
    Callable[[int], Optional[int]],
    None,
]


def normalize_dest(spec: RankSpecLike, size: int, *,
                   what: str) -> Tuple[Tuple[int, int], ...]:
    """Normalize a routing spec into a sorted tuple of (src, dst) pairs.

    Validates that the pairs form a partial permutation (no duplicate
    sources or destinations) and that every rank lies in ``[0, size)``.
    """
    if spec is None:
        raise ValueError(
            f"{what}: routing spec is required here (got None). Routing "
            "describes all ranks at once; use shift(k), a {src: dst} dict, "
            "or [(src, dst), ...] pairs."
        )
    if isinstance(spec, int):
        # imported here: ops._base imports the parallel package
        from ..analysis.schedule import is_rank_concrete
        from ..ops._base import mpx_error

        if is_rank_concrete(spec):
            # the rank of a per-rank abstract run (analysis/): structure
            # must stay rank-uniform there too
            raise mpx_error(
                TypeError, "MPX104",
                f"{what}: routing spec is the comm rank (concretized for "
                "per-rank analysis). Routing is structure — it must be "
                "rank-uniform static values describing the whole pattern "
                "(pairs/shift/dict), not a per-rank destination.",
            )

        raise mpx_error(
            TypeError, "MPX103",
            f"{what}: a bare int rank is ambiguous (every rank executes the "
            "same call, so 'dest=1' would mean all ranks send to rank 1 — "
            "not a valid permutation). Describe the full pattern: "
            "pairs=[(0, 1)] for a single message, shift(k) for rings, or a "
            "{src: dst} dict.",
        )
    pairs: List[Tuple[int, int]]
    if isinstance(spec, shift):
        pairs = []
        for r in range(size):
            d = spec(r, size)
            if d is not None:
                pairs.append((r, d))
    elif isinstance(spec, dict):
        pairs = [(int(s), int(d)) for s, d in spec.items()]
    elif callable(spec):
        pairs = []
        for r in range(size):
            d = spec(r)
            if d is not None:
                pairs.append((r, int(d)))
    else:
        pairs = [(int(s), int(d)) for (s, d) in spec]

    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    for v, role in ((srcs, "source"), (dsts, "destination")):
        if len(set(v)) != len(v):
            raise ValueError(
                f"{what}: duplicate {role} ranks in routing {pairs}; "
                "point-to-point routing must be a (partial) permutation"
            )
    for v in srcs + dsts:
        if not (0 <= v < size):
            raise ValueError(f"{what}: rank {v} out of range for comm size {size}")
    return tuple(sorted(pairs))


def normalize_source(spec: RankSpecLike, size: int, *,
                     what: str) -> Tuple[Tuple[int, int], ...]:
    """Like ``normalize_dest`` but receiver-centric: ``spec(r)`` is the
    source of rank ``r``.  Returns (src, dst) pairs."""
    if isinstance(spec, shift):
        # receiving from r+k  <=>  r+k sends to r
        return normalize_dest(spec.inverse(), size, what=what)
    if isinstance(spec, dict):
        return normalize_dest(
            {int(s): int(r) for r, s in spec.items()}, size, what=what)
    if spec is None or isinstance(spec, int):
        return normalize_dest(spec, size, what=what)  # raises with guidance
    if callable(spec):
        pairs = {}
        for r in range(size):
            s = spec(r)
            if s is not None:
                pairs[int(s)] = r
        return normalize_dest(pairs, size, what=what)
    # sequences are (src, dst) pairs, as for dest specs
    return normalize_dest(spec, size, what=what)


def invert_pairs(pairs: Sequence[Tuple[int, int]]) -> Tuple[Tuple[int, int], ...]:
    """The pairs with every message's direction reversed, sorted."""
    return tuple(sorted((d, s) for s, d in pairs))


def resolve_routing(source, dest, size: int, *,
                    what: str) -> Tuple[Tuple[int, int], ...]:
    """(src, dst) pairs from ``source`` and/or ``dest``: either spec alone,
    or both, checked to agree."""
    pairs_d = normalize_dest(dest, size, what=what) if dest is not None else None
    pairs_s = (normalize_source(source, size, what=what)
               if source is not None else None)
    if pairs_d is not None and pairs_s is not None and pairs_d != pairs_s:
        raise ValueError(
            f"{what}: inconsistent routing — dest spec gives pairs "
            f"{pairs_d} but source spec gives pairs {pairs_s}"
        )
    if pairs_d is None and pairs_s is None:
        raise ValueError(
            f"{what}: provide a routing spec via dest= and/or source= "
            "(e.g. dest=shift(1) for a ring)"
        )
    return pairs_d if pairs_d is not None else pairs_s
