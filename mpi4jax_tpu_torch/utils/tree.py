"""Nested containers of tensors, flattened in the JAX package's order.

``jax.tree_util`` flattens a dict in sorted key order, and a list or a
tuple in order; every other object is a leaf.  The throughput layer
issues one collective per leaf in that order (``compress.ef_allreduce``,
the fusion queue), so the port flattens the same way: the buckets, and
the order of the collectives, are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> Tuple[list, Any]:
    """``(children, rebuild)`` of a container; ``None`` for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree), lambda vals: type(tree)(*vals)
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda vals: type(tree)(vals)
    return None, None


def tree_flatten(tree) -> Tuple[List[Any], Callable[[list], Any]]:
    """The leaves of ``tree`` and a function that rebuilds a tree of the
    same structure from as many leaves."""
    kids, rebuild = _children(tree)
    if kids is None:
        return [tree], lambda leaves: leaves[0]
    leaves, parts = [], []
    for kid in kids:
        sub, unflatten = tree_flatten(kid)
        parts.append((len(sub), unflatten))
        leaves += sub

    def unflatten(vals):
        out, pos = [], 0
        for n, sub_unflatten in parts:
            out.append(sub_unflatten(vals[pos:pos + n]))
            pos += n
        return rebuild(out)

    return leaves, unflatten


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied to the leaves of ``tree`` and the matching leaves of
    every tree of ``rest`` (each of the same structure)."""
    leaves, unflatten = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    for other in others:
        if len(other) != len(leaves):
            raise ValueError(f"tree_map: trees of {len(leaves)} and "
                             f"{len(other)} leaves")
    return unflatten([fn(*args) for args in zip(leaves, *others)])
