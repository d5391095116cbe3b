"""``cond`` and ``switch``: branches the verifier can see both arms of.

The port's counterpart of ``jax.lax.cond`` and ``jax.lax.switch``, with
their signatures.  A Python ``if`` on a tensor cannot be taken in an
abstract run (``analysis/crossrank.py`` raises ``DataDependentBranch``),
as it cannot on a tracer in JAX; these two can:

- in a concrete run the predicate is read on the host (one
  synchronisation with the device, as ``bool(tensor)`` would be) and one
  arm runs;
- a Python value or a ``RankConcrete`` (the rank of a per-rank run)
  selects its arm at once, as the JAX package's per-rank re-trace does
  with a concrete predicate;
- in an abstract run with a ``meta`` predicate every arm runs, the first
  (``true_fn``, or ``branches[0]``) into the recording and each other arm
  into a recorder of its own whose events are dropped, so the matcher
  never sees two arms as one schedule.  The lineage capture
  (``analysis/lineage.py``) keeps every arm's record, from which the
  verifier reads each arm's collectives (MPX108, MPX141, MPX142).  Arms
  whose outputs differ in structure, shape or dtype raise ``TypeError``,
  as ``lax.cond`` does, and the branch returns fresh ``meta`` outputs of
  the first arm's shapes.

As in ``lax.cond``, the predicate must be a scalar; ``switch`` clamps its
index into range.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["cond", "switch"]


def cond(pred, true_fn, false_fn, *operands):
    """``true_fn(*operands)`` if ``pred`` else ``false_fn(*operands)``
    (``jax.lax.cond``)."""
    # the JAX package's branch order: index 0 is false_fn
    return _branch("cond", pred, (false_fn, true_fn), operands, first=1)


def switch(index, branches, *operands):
    """``branches[index](*operands)`` with ``index`` clamped into range
    (``jax.lax.switch``)."""
    branches = tuple(branches)
    if not branches:
        raise ValueError("switch: needs at least one branch")
    return _branch("switch", index, branches, operands, first=0)


def _branch(kind, sel, fns, operands, first):
    if isinstance(sel, torch.Tensor) and sel.device.type == "meta":
        if sel.numel() != 1:
            raise TypeError(f"{kind}: the predicate must be a scalar, got "
                            f"shape {tuple(sel.shape)}")
        return _abstract(sel, fns, operands, first)
    return fns[_select(kind, sel, len(fns))](*operands)


def _select(kind, sel, n: int) -> int:
    if isinstance(sel, torch.Tensor):
        if sel.numel() != 1:
            raise TypeError(f"{kind}: the predicate must be a scalar, got "
                            f"shape {tuple(sel.shape)}")
        sel = sel.item()  # the one host synchronisation
    if kind == "cond":
        return 1 if bool(sel) else 0
    return min(max(int(sel), 0), n - 1)


def _signature(out):
    leaves, spec = tree_flatten(out)
    return spec, [(tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                  else type(x) for x in leaves]


def _abstract(sel, fns, operands, first):
    """Every arm of an abstract run (see the module docstring)."""
    from ..analysis import hook, lineage

    cap = lineage.current()
    order = [first] + [i for i in range(len(fns)) if i != first]
    outs, records = {}, {}
    for i in order:
        with hook.branch_recording(main=i == first):
            if cap is None:
                outs[i] = fns[i](*operands)
                continue
            with cap.branch() as rec:
                outs[i] = fns[i](*operands)
            records[i] = rec
    spec0, sig0 = _signature(outs[first])
    for i in order[1:]:
        spec, sig = _signature(outs[i])
        if spec != spec0 or sig != sig0:
            raise TypeError(
                f"branches {first} and {i} return different structures, "
                f"shapes or dtypes: {sig0} vs {sig}")
    leaves, spec = tree_flatten(outs[first])
    result = tree_unflatten(
        [torch.empty_strided(tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
                             device="meta")
         if isinstance(x, torch.Tensor) else x for x in leaves], spec)
    if cap is not None:
        n = len(fns)
        lineage.record_branch(sel, operands, [records[i] for i in range(n)],
                              [outs[i] for i in range(n)], result)
    return result
