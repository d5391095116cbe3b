"""Flow-sensitive dataflow taint pass: rank-local and approximate lineage.

PyTorch counterpart of ``mpi4jax_tpu/analysis/dataflow.py``.  The JAX
package propagates taint over the closed jaxpr of a trace; the port
propagates it over the lineage record of an abstract run
(``analysis/lineage.py``), with the same two lineages, codes, texts and
trail cap:

``rank``-local lineage (MPX141, ERROR)
    Values that differ across ranks: a var whose ``aval.vma`` is set (the
    region's arguments, the outputs of non-replicating ops, what a
    ``RankConcrete`` entered).  Replicating collectives launder it: an
    op's eqn replicates when every JAX primitive its JAX op lowers to
    does (:func:`jax_primitives`, :func:`replicates`), so ``allreduce``
    with ``SUM``/``MAX``/``MIN``, ``bcast``, ``barrier``, ``allgather``
    and ``gather`` launder and ``PROD``, a callable, a color split,
    ``reduce_scatter``, ``alltoall``, ``scatter``, ``scan`` and the
    point-to-point ops do not, as in the JAX package.  The sink is a
    ``cond``/``switch`` predicate whose arms issue different collective
    schedules.

``approx``imate lineage (MPX142, ADVISORY)
    Values that passed a float-to-smaller-float ``aten._to_copy`` (the
    quantize half of ``ops/_compress.py:roundtrip``), seeded only when the
    recorded graph shows codec or error-feedback activity
    (:func:`graph_arms_approx`).  Sinks: the index operands of the gathers
    and scatters (``params["index_invars"]``) and a predicate that gates
    communication.

Every finding carries its trail from seed to sink in
``Finding.frontier``.  The arms of a ``cond`` see the values around them
as closures do (the port's arms are Python closures, not sub-jaxprs with
binders).  Pure Python: hand-built records drive it in the tests.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .report import Finding
from .walker import _iter_jaxprs, _sub_jaxprs, eqn_collectives, is_collective

# taint kinds
RANK = "rank"
APPROX = "approx"

# collectives whose result is replicated across the reducing axis (they
# launder rank-local taint); psum_scatter starts with "psum" but leaves a
# different shard on every rank
REPLICATING_PREFIXES = ("psum", "pmin", "pmax", "all_gather")
_NON_REPLICATING = ("psum_scatter",)

# trails are capped: the seed end and the live end, one elision marker
_TRAIL_CAP = 24
_ELLIPSIS = "... (taint path elided) ..."

Taint = Dict[str, Tuple[str, ...]]

# the reductions the JAX package lowers to one XLA collective on a whole
# or grid comm (everything else is the butterfly of ppermutes)
_NATIVE_REDUCTION = {"sum": "psum_invariant", "max": "pmax", "min": "pmin"}


def replicates(primitive_name: str) -> bool:
    """True for collectives whose output is rank-invariant."""
    if primitive_name.startswith(_NON_REPLICATING):
        return False
    return primitive_name.startswith(REPLICATING_PREFIXES)


def _log2ceil(k) -> int:
    return (int(k) - 1).bit_length() if k and int(k) > 1 else 0


def jax_primitives(op: str, reduction: Optional[str] = None,
                   k: Optional[int] = None, split: bool = False
                   ) -> Tuple[str, ...]:
    """The collective primitives the JAX package's ``op`` lowers to in a
    region over a ``k``-rank group (JAX 0.9 names; ``split``: a color
    split).  An async start stands for its op; a wait, ``send`` (its
    exchange is the matching ``recv``'s) and ``flush`` for none."""
    if op.endswith("_wait") or op in ("send", "flush"):
        return ()
    base = op[:-len("_start")] if op.endswith("_start") else op
    lg = _log2ceil(k)
    red = str(reduction or "sum").lower()
    butterfly = ("ppermute",) * (2 * lg)
    if base in ("allreduce", "reduce"):
        if split or red not in _NATIVE_REDUCTION:
            return butterfly
        return (_NATIVE_REDUCTION[red],)
    if base == "reduce_scatter":
        return ("reduce_scatter",) if red == "sum" and not split else butterfly
    if base == "bcast":
        return ("ppermute",) * lg if split else ("psum_invariant",)
    if base in ("allgather", "gather"):
        return ("all_gather",)
    if base in ("alltoall", "scatter"):
        return ("all_to_all",)
    if base == "scan":
        return ("ppermute",) * lg
    if base in ("sendrecv", "recv"):
        return ("ppermute",)
    if base == "barrier":
        return ("psum_invariant",)
    return ()


def seeds_rank(op: str, reduction: Optional[str] = None,
               split: bool = False) -> bool:
    """Whether ``op``'s output is rank-varying by its type: a collective
    whose lowering does not replicate (the wait of an async pair takes its
    start's verdict)."""
    base = op[:-len("_wait")] if op.endswith("_wait") else op
    if base == "p2p":
        base = "recv"
    # the group's size changes how many primitives, never which: any group
    # of two ranks or more gives the verdict
    prims = jax_primitives(base, reduction, 2, split)
    return bool(prims) and not all(replicates(p) for p in prims)


def _eqn_replicates(eqn) -> bool:
    prims = eqn.params.get("primitives")
    if prims is None:
        return replicates(eqn.primitive.name)
    prims = [p for p in prims if is_collective(p)]
    return bool(prims) and all(replicates(p) for p in prims)


def collective_signature(jaxpr) -> Tuple[Tuple[str, int], ...]:
    """The multiset of collective primitives in ``jaxpr`` (all nesting
    levels) as a sorted (name, count) tuple: two arms with equal
    signatures issue the same schedule shape."""
    counts: Dict[str, int] = {}

    def _walk(j):
        for eqn in j.eqns:
            for name in eqn_collectives(eqn):
                counts[name] = counts.get(name, 0) + 1
            for sub in _sub_jaxprs(eqn):
                _walk(sub)

    _walk(jaxpr)
    return tuple(sorted(counts.items()))


def _fmt_sig(sig) -> str:
    if not sig:
        return "{no collectives}"
    return "{" + ", ".join(f"{n}x{c}" for n, c in sig) + "}"


def graph_arms_approx(graph) -> bool:
    """True when the recorded dispatch graph shows lossy-codec activity:
    a wire codec on any event, an error-feedback step (the ``ef`` extra
    ``ops/_compress.py:ef_allreduce`` stamps), or a codec other than
    ``off`` in the configuration snapshot.  Without it a float downcast
    is ordinary mixed precision and must not taint."""
    if graph is None:
        return False
    meta = getattr(graph, "meta", None) or {}
    if meta.get("compress") not in (None, "off"):
        return True
    for e in getattr(graph, "events", ()):
        if getattr(e, "codec", None):
            return True
        extra = getattr(e, "extra", None)
        if extra and extra.get("ef"):
            return True
    return False


_FLOAT_NAME = re.compile(r"(?:bfloat|float)(\d+)")


def _float_bytes(d) -> Optional[int]:
    """Itemsize when ``d`` is a float dtype (numpy, torch or a name),
    else None."""
    if d is None:
        return None
    name = str(d).replace("torch.", "")
    try:
        dt = np.dtype(name)
    except TypeError:
        m = _FLOAT_NAME.match(name)
        return int(m.group(1)) // 8 if m else None
    if dt.kind == "f" or _FLOAT_NAME.match(dt.name):
        return dt.itemsize
    return None


def _is_lossy_downcast(eqn) -> bool:
    """A float -> smaller-float conversion: the quantize half of a codec
    roundtrip."""
    if not eqn.invars or "new_dtype" not in eqn.params:
        return False
    old = _float_bytes(
        getattr(getattr(eqn.invars[0], "aval", None), "dtype", None))
    new = _float_bytes(eqn.params.get("new_dtype"))
    return old is not None and new is not None and new < old


def _merge(taints) -> Taint:
    """Union taint dicts; on collision the shorter trail wins."""
    out: Taint = {}
    for t in taints:
        for kind, trail in t.items():
            if kind not in out or len(trail) < len(out[kind]):
                out[kind] = trail
    return out


def _extend(trail: Tuple[str, ...], step: str) -> Tuple[str, ...]:
    if len(trail) >= _TRAIL_CAP:
        keep = _TRAIL_CAP // 3
        if _ELLIPSIS not in trail:
            trail = trail[:keep] + (_ELLIPSIS,) + trail[-keep:]
        else:
            trail = trail[:keep + 1] + trail[-(keep - 1):]
    return trail + (step,)


class _Pass:
    """One forward propagation over one record tree."""

    def __init__(self, approx_armed: bool, rank: Optional[int] = None):
        self.approx_armed = approx_armed
        self.rank = rank
        self.findings: List[Finding] = []
        self._seen = set()

    def _taint_of(self, atom, env) -> Taint:
        if hasattr(atom, "val"):
            return {}
        t = dict(env.get(atom, ()))
        if RANK not in t:
            aval = getattr(atom, "aval", None)
            vma = getattr(aval, "vma", None)
            if vma:
                axes = ",".join(sorted(str(a) for a in vma))
                what = getattr(aval, "origin", None) or "typed value"
                t[RANK] = (f"rank-varying {what} (vma={{{axes}}})",)
        return t

    def _emit(self, code, op, message, suggestion, frontier):
        key = (code, op, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            code=code, op=op, message=message, suggestion=suggestion,
            rank=self.rank, frontier=tuple(frontier),
        ))

    def _check_sinks(self, eqn, name, env):
        if name == "cond":
            pred = self._taint_of(eqn.invars[0], env)
            sigs = [collective_signature(bj) if bj is not None else ()
                    for bj in (next(_iter_jaxprs(b), None)
                               for b in eqn.params.get("branches", ()))]
            if RANK in pred and len(set(sigs)) > 1:
                rendered = ", ".join(
                    f"branch {i}: {_fmt_sig(s)}" for i, s in enumerate(sigs))
                self._emit(
                    "MPX141", "cond",
                    "rank-local lineage reaches a branch predicate whose "
                    f"branches issue different collective schedules "
                    f"({rendered}) — if the predicate differs across "
                    "ranks the schedule itself diverges and the "
                    "communicating side hangs",
                    "replicate the gating value first (allreduce it), or "
                    "make every branch issue the same collectives "
                    "(docs/sharp_bits.md)",
                    _extend(pred[RANK], "cond predicate (schedule gate)"),
                )
            if APPROX in pred and any(sigs):
                self._emit(
                    "MPX142", "cond",
                    "approximate (wire-codec) lineage reaches a branch "
                    "predicate that gates communication — quantization "
                    "error can flip the decision differently per rank",
                    "derive the gating value from exact (pre-codec) "
                    "data, or carry the error through error feedback "
                    "(docs/compression.md)",
                    _extend(pred[APPROX], "cond predicate (schedule gate)"),
                )
            return
        for atom in eqn.params.get("index_invars", ()):
            t = self._taint_of(atom, env)
            if APPROX in t:
                self._emit(
                    "MPX142", name,
                    "approximate (wire-codec) lineage reaches an "
                    f"index operand of `{name}` — a routing/offset "
                    "decision that assumes exact arithmetic; "
                    "quantization error can route or commit "
                    "differently per rank",
                    "compute routing indices and commit offsets from "
                    "exact values (docs/compression.md)",
                    _extend(t[APPROX], f"{name} index operand"),
                )
                break

    def run(self, jaxpr, env) -> dict:
        """Propagate taint through ``jaxpr`` from ``env`` (var -> Taint);
        returns the final environment."""
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            self._check_sinks(eqn, name, env)
            out = _merge([self._taint_of(a, env) for a in eqn.invars])
            if out:
                out = {k: _extend(tr, name) for k, tr in out.items()}
            if self.approx_armed and _is_lossy_downcast(eqn):
                out.setdefault(
                    APPROX,
                    (f"{name} -> {eqn.params.get('new_dtype')} (lossy "
                     "codec downcast, approx seed)",))
            if _eqn_replicates(eqn):
                out.pop(RANK, None)
            if name == "cond":
                out = _merge([out, self._run_cond(eqn, env)])
            if out:
                for ov in eqn.outvars:
                    env[ov] = out
        return env

    def _run_cond(self, eqn, env) -> Taint:
        """Each arm runs on a copy of the environment (its closures); the
        outputs' taint merges across arms."""
        out: Taint = {}
        for b in eqn.params.get("branches", ()):
            for bj in _iter_jaxprs(b):
                sub_env = self.run(bj, dict(env))
                out = _merge([out] + [sub_env.get(ov, {})
                                      for ov in bj.outvars])
        return out


def hazard_jaxpr_findings(closed_jaxpr, *, approx_armed: bool = False,
                          rank: Optional[int] = None) -> List[Finding]:
    """MPX141/MPX142 findings for an abstract run's lineage record.
    ``approx_armed`` gates the lossy-downcast seeds (pass
    ``graph_arms_approx(graph)`` of the run's recording); ``rank`` stamps
    findings of a per-rank run."""
    p = _Pass(approx_armed, rank=rank)
    j = next(_iter_jaxprs(closed_jaxpr), closed_jaxpr)
    p.run(j, {})
    return p.findings
