"""Structural checks over the lineage record no event stream can see.

PyTorch counterpart of ``mpi4jax_tpu/analysis/walker.py``.  The JAX
package walks the closed jaxpr of a traced program; the port walks the
lineage record of an abstract run (``analysis/lineage.py``), whose
``cond`` eqns (``parallel/control.py``: ``cond``, ``switch``) hold one
sub-record per arm.  It flags a branch whose arms disagree about
communicating (MPX108): if the predicate ever varies across ranks, the
communicating arm hangs waiting for ranks that took the other one.

An op's eqn counts the collectives its JAX op lowers to
(``params["primitives"]``, ``dataflow.jax_primitives``), so counts and
messages equal the JAX package's; an eqn without that key counts by its
own name, as a JAX equation does.  Duck-typed like the JAX walker:
anything with ``.eqns`` is a record, params may hold records or
sequences of them, so hand-built records drive it in the tests.
"""

from __future__ import annotations

from typing import List

from .report import Finding

# primitive-name prefixes that communicate (the JAX package's list:
# pbroadcast/pcast are typing promotions that lower to nothing)
COLLECTIVE_PRIMITIVE_PREFIXES = (
    "psum",
    "pmin",
    "pmax",
    "ppermute",
    "all_gather",
    "all_to_all",
    "psum_scatter",
    "reduce_scatter",
)


def _iter_jaxprs(v):
    """Every record reachable from a params value (a record, an object
    holding one as ``.jaxpr``, or a (nested) sequence of them)."""
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(v, "jaxpr"):
        yield from _iter_jaxprs(v.jaxpr)
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _iter_jaxprs(x)


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        yield from _iter_jaxprs(v)


def is_collective(primitive_name: str) -> bool:
    return primitive_name.startswith(COLLECTIVE_PRIMITIVE_PREFIXES)


def eqn_collectives(eqn) -> List[str]:
    """The collective primitives one eqn stands for: an op's lowering
    (``params["primitives"]``), else its own name if it is one."""
    prims = eqn.params.get("primitives")
    if prims is None:
        prims = (eqn.primitive.name,)
    return [p for p in prims if is_collective(p)]


def count_collectives(jaxpr) -> int:
    """Number of collectives in ``jaxpr``, nested arms included."""
    n = 0
    for eqn in jaxpr.eqns:
        n += len(eqn_collectives(eqn))
        for sub in _sub_jaxprs(eqn):
            n += count_collectives(sub)
    return n


def find_cond_divergences(jaxpr) -> List[dict]:
    """All ``cond`` eqns (at any depth) whose arms disagree on whether
    they communicate, with per-arm collective counts."""
    out: List[dict] = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "cond":
            counts = [
                sum(count_collectives(j) for j in _iter_jaxprs(b))
                for b in eqn.params.get("branches", ())
            ]
            if any(counts) and not all(counts):
                out.append({"counts": counts})
        for sub in _sub_jaxprs(eqn):
            out.extend(find_cond_divergences(sub))
    return out


def check_cond_divergence(closed_jaxpr) -> List[Finding]:
    """MPX108 findings for an abstract run's lineage record (the JAX
    package's texts)."""
    findings: List[Finding] = []
    for rec in find_cond_divergences(
            next(_iter_jaxprs(closed_jaxpr), closed_jaxpr)):
        counts = rec["counts"]
        with_c = [i for i, c in enumerate(counts) if c]
        without = [i for i, c in enumerate(counts) if not c]
        findings.append(Finding(
            code="MPX108", op="cond",
            message=(f"lax.cond branches disagree about communicating: "
                     f"branch(es) {with_c} contain "
                     f"{sum(counts)} collective(s), branch(es) {without} "
                     "contain none — a rank-varying predicate hangs the "
                     "communicating side"),
            suggestion=("hoist the collective out of the cond, or make "
                        "every branch issue the same collectives (e.g. "
                        "reduce a masked value)"),
        ))
    return findings
