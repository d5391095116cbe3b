"""The lineage capture: the port's closed jaxpr.

The JAX package's dataflow pass (``analysis/dataflow.py``) and its cost
pass (``analysis/cost.py``: ``jaxpr_traffic_bytes``) both walk the closed
jaxpr of a traced program.  The port has no jaxpr: an abstract run
(``crossrank.abstract_run``) calls the program on ``meta`` tensors.  This
module records that run as a jaxpr-like graph, one :class:`Record`:

- a :class:`Capture` (a ``TorchDispatchMode``) is pushed over the run.
  Every aten op becomes an :class:`Eqn` named ``aten.<op>``, whose
  ``invars`` are the :class:`Var` of each input tensor and whose
  ``outvars`` are fresh vars bound to its output tensors (keyed by the
  tensor, weakly).  An in-place op binds its target to a fresh var that
  depends on the old one and on the other inputs: it merges into its
  target.  A write reaches every tensor of the target's storage (its
  base and its other views, as a JAX program's ``x.at[i].set(t)`` makes
  all of ``x`` depend on ``t``): the next read of any of them merges the
  writes made since it was bound (an ``aliased write`` eqn).
  ``params["bytes"]`` is the bytes its outputs write (a view or an
  allocation writes none);
- the ops record one eqn each at the dispatch point
  (``ops/_base.py:_record``, :func:`op_eqn`), named after the op, with
  the JAX primitives its JAX op lowers to in ``params["primitives"]``
  (``dataflow.jax_primitives``);
- the kernels' ``meta`` routes and the dispatch point make their outputs
  with ``torch.empty``: :func:`derive` tells the capture what each output
  derives from and adds its bytes (the kernels reach it through
  ``kernels/_build.py:meta_outputs``, where this module registers it);
- ``cond`` and ``switch`` (``parallel/control.py``) record one ``cond``
  eqn whose ``params["branches"]`` hold a sub-record per arm, in the JAX
  package's branch order.

The seeds of rank lineage ride on a var's ``aval.vma`` (the JAX package
reads the varying type ``shard_map`` gives a value): the region's
arguments (one rank's values by the port's convention), the outputs of
the non-replicating ops, and what a ``RankConcrete`` scalar enters.
The approximate seed is an ``aten._to_copy`` to a smaller float (its
``params["new_dtype"]``); the index operands of the gathers and
scatters are listed in ``params["index_invars"]``.

Nothing runs while recording: the capture only follows ``meta`` tensors,
and it costs nothing outside an abstract run.
"""

from __future__ import annotations

import bisect
import itertools
from contextlib import contextmanager
from typing import List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakTensorKeyDictionary

from ..kernels import _build as _kernel_build

# aten ops that allocate without writing (their bytes are the writer's)
_ALLOCATORS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "empty_permuted",
})

# aten ops whose index operands are exactness-required sinks (MPX142):
# name -> positional argument indices holding the indices (the JAX
# package's _INDEX_SINKS: gather, dynamic_slice, dynamic_update_slice,
# scatter*)
_INDEX_ARGS = {
    "gather": (2,),
    "index_select": (2,),
    "index": (1,),
    "index_put": (1,),
    "index_put_": (1,),
    "_index_put_impl_": (1,),
    "index_add": (2,),
    "index_add_": (2,),
    "index_copy": (2,),
    "index_copy_": (2,),
    "index_fill": (2,),
    "index_fill_": (2,),
    "take": (1,),
    "take_along_dim": (1,),
    "embedding": (1,),
    "narrow": (2,),
    "narrow_copy": (2,),
}


class Aval:
    """A var's abstract value: its dtype and, for rank lineage, the ``vma``
    (the varying axes) and the seed's wording (``origin``)."""

    __slots__ = ("dtype", "vma", "origin")

    def __init__(self, dtype=None, vma=None, origin=None):
        self.dtype = dtype
        self.vma = vma
        self.origin = origin


_ids = itertools.count()


class Var:
    __slots__ = ("id", "aval")

    def __init__(self, aval: Aval):
        self.id = next(_ids)
        self.aval = aval

    def __repr__(self):
        return f"v{self.id}"


class Primitive:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


class Eqn:
    """One recorded operation: ``primitive.name``, ``invars``, ``outvars``
    and ``params`` (``bytes``, and per kind ``primitives``,
    ``new_dtype``, ``index_invars``, ``branches``)."""

    __slots__ = ("primitive", "invars", "outvars", "params")

    def __init__(self, name: str, invars, outvars, params=None):
        self.primitive = Primitive(name)
        self.invars = tuple(invars)
        self.outvars = tuple(outvars)
        self.params = dict(params or {})


class Record:
    """A recorded program (or one arm of a branch): ``eqns`` in order,
    ``invars`` the seeded arguments, ``outvars`` what an arm returned."""

    __slots__ = ("invars", "outvars", "eqns")

    def __init__(self):
        self.invars: tuple = ()
        self.outvars: tuple = ()
        self.eqns: List[Eqn] = []


def _aval_of(t: torch.Tensor, vma=None, origin=None) -> Aval:
    return Aval(t.dtype, vma, origin)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _first(pair):
    return pair[0]


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError, AttributeError):
        return None  # a tensor without storage: no aliases to follow


class _RankScalars(TorchFunctionMode):
    """Seeds rank lineage where a ``RankConcrete`` (the rank of a
    per-rank run) enters a torch function: the aten layer sees only its
    value."""

    def __init__(self, capture: "Capture"):
        super().__init__()
        self.capture = capture

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from .schedule import is_rank_concrete

        if any(is_rank_concrete(a) for a in tree_leaves((args, kwargs))):
            outs = _tensors(out)
            written = []
            if not outs and args and isinstance(args[0], torch.Tensor):
                outs = written = [args[0]]  # in place: x[i] = rank, x.fill_(rank)
            if outs:
                self.capture.emit(
                    "rank", [self.capture.var_of(t) for t in outs], outs,
                    origin=f"RankConcrete scalar into {getattr(func, '__name__', func)}")
                self.capture.wrote(written)
        return out


class Capture(TorchDispatchMode):
    """The lineage of one abstract run (see the module docstring);
    ``record`` is the top-level :class:`Record`."""

    def __init__(self, axes=("rank",)):
        super().__init__()
        self.axes = tuple(axes)
        self.vars = WeakTensorKeyDictionary()  # tensor -> (Var, seq bound)
        self._writes: dict = {}  # storage -> [(seq, Var of the write)]
        self._seq = itertools.count()
        self.record = Record()
        self._stack: List[Record] = [self.record]
        self._rank = _RankScalars(self)

    # -- vars -------------------------------------------------------------

    def var_of(self, t: torch.Tensor) -> Var:
        """``t``'s var, merged with the writes into its storage made
        since ``t`` was bound (through a view, its base or itself)."""
        got = self.vars.get(t)
        if got is None:
            v, seq = Var(_aval_of(t)), -1
            self.bind(t, v)
        else:
            v, seq = got
        if not self._writes:  # nothing written in place yet
            return v
        writes = self._writes.get(_storage_key(t), ())
        later = [w for _, w in
                 writes[bisect.bisect_right(writes, seq, key=_first):]]
        if later:
            v = self.emit("aliased write", [v, *later], [t]).outvars[0]
        return v

    def bind(self, t: torch.Tensor, var: Var) -> None:
        self.vars[t] = (var, next(self._seq))

    def wrote(self, targets) -> None:
        """Each of ``targets`` (just bound to the var of a write) was
        written in place: the other tensors of its storage see it."""
        for t in targets:
            key = _storage_key(t)
            if key is None:
                continue
            var = self.vars[t][0]
            seq = next(self._seq)
            self._writes.setdefault(key, []).append((seq, var))
            self.vars[t] = (var, seq)  # its own write is in its var

    def seed_args(self, tree) -> None:
        """The region's arguments are one rank's values: seed each tensor's
        rank lineage (the varying type ``shard_map`` gives a sharded
        input)."""
        invars = []
        for i, t in enumerate(_tensors(tree)):
            v = Var(_aval_of(t, vma=self.axes,
                             origin=f"region argument {i}"))
            self.bind(t, v)
            invars.append(v)
        self.record.invars = tuple(invars)

    # -- emission -----------------------------------------------------------

    def emit(self, name: str, invars, outs, params=None, nbytes: int = 0,
             vma=None, origin=None) -> Eqn:
        """Record one eqn whose outputs ``outs`` (tensors) get fresh vars;
        ``vma`` seeds their rank lineage."""
        outvars = []
        for t in outs:
            v = Var(_aval_of(t, vma=vma if vma is not None else (
                self.axes if origin else None), origin=origin))
            self.bind(t, v)
            outvars.append(v)
        p = dict(params or {})
        p["bytes"] = int(nbytes)
        eqn = Eqn(name, invars, outvars, p)
        self._stack[-1].eqns.append(eqn)
        return eqn

    @contextmanager
    def branch(self):
        """Record the eqns of one arm of a branch into their own record."""
        rec = Record()
        self._stack.append(rec)
        try:
            yield rec
        finally:
            self._stack.pop()

    # -- the aten layer -----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._aten(func, args, kwargs, out)
        return out

    def _aten(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        schema = func._schema
        ins = _tensors((args, kwargs))
        invars = [self.var_of(t) for t in ins]
        written, views = [], set()
        for i, a in enumerate(schema.arguments):
            info = a.alias_info
            if info is not None and info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                written.extend(_tensors(val))
        for i, r in enumerate(schema.returns):
            if r.alias_info is not None and not r.alias_info.is_write:
                views.add(i)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        fresh, nbytes = [], 0
        written_ids = {id(t) for t in written}
        in_ids = {id(t) for t in ins}
        for i, t in enumerate(outs):
            for x in _tensors(t):
                if id(x) in in_ids and id(x) not in written_ids:
                    continue  # returned as it came in
                fresh.append(x)
                if name not in _ALLOCATORS and i not in views:
                    nbytes += _nbytes(x)
        for x in written:  # an out= or in-place target not returned
            if all(x is not y for y in fresh):
                fresh.append(x)
                nbytes += _nbytes(x)
        params = {}
        if name in ("_to_copy", "to") and ins:
            params["new_dtype"] = kwargs.get("dtype", ins[0].dtype)
        pos = _INDEX_ARGS.get(name)
        if pos is None and name.startswith("scatter"):
            pos = (2,)
        if pos is not None:
            idx = []
            for p in pos:
                if p < len(args):
                    idx.extend(self.var_of(t) for t in _tensors(args[p]))
            params["index_invars"] = tuple(idx)
        self.emit(f"aten.{name}", invars, fresh, params, nbytes)
        self.wrote(written)


# the capture of the abstract run in progress (innermost wins)
_active: List[Capture] = []


def current() -> Optional[Capture]:
    return _active[-1] if _active else None


@contextmanager
def capturing(capture: Capture):
    """Push ``capture`` over the code inside (both of its modes)."""
    _active.append(capture)
    try:
        with capture, capture._rank:
            yield capture
    finally:
        _active.pop()


def derive(outputs, inputs, name: str) -> None:
    """Tell the capture that ``outputs`` (made with ``torch.empty``: the
    kernels' ``meta`` routes) derive from ``inputs`` by the operation
    ``name``, and add the bytes they write.  No-op outside a capture."""
    cap = current()
    if cap is None:
        return
    outs = _tensors(outputs)
    cap.emit(name, [cap.var_of(t) for t in _tensors(inputs)], outs,
             nbytes=sum(_nbytes(t) for t in outs))


_kernel_build.set_meta_hook(derive)


def op_eqn(opname: str, comm, arrays, ana, out) -> None:
    """Record one op of an abstract run (``ops/_base.py:_record``): its
    outputs derive from its inputs; a non-replicating collective's outputs
    are rank-varying, a replicating one's launder rank lineage
    (``dataflow.replicates_op``)."""
    cap = current()
    if cap is None:
        return
    from .dataflow import jax_primitives, seeds_rank

    outs = _tensors(out)
    piece = getattr(out[0] if isinstance(out, tuple) and out else out,
                    "piece", None)
    if not outs and isinstance(piece, torch.Tensor):
        outs = [piece]  # an async start's result rides on its handle
    reduction = (ana or {}).get("reduction")
    try:
        k = comm.min_size()
    except (RuntimeError, AttributeError):
        k = None
    split = getattr(comm, "groups", None) is not None
    prims = jax_primitives(opname, reduction, k, split)
    vma = cap.axes if seeds_rank(opname, reduction, split) else None
    cap.emit(opname, [cap.var_of(t) for t in _tensors(tuple(arrays))], outs,
             {"primitives": prims}, sum(_nbytes(t) for t in outs), vma=vma,
             origin=f"{opname} output" if vma else None)


def record_branch(sel, operands, records, outs, result) -> None:
    """Record a ``cond``/``switch`` of an abstract run: ``records`` the
    arms' sub-records in the JAX package's branch order, ``outs`` each
    arm's outputs (same order), ``result`` what the branch returned."""
    cap = current()
    if cap is None:
        return
    for rec, out in zip(records, outs):
        rec.outvars = tuple(cap.var_of(t) for t in _tensors(out))
    invars = [cap.var_of(sel)] + [cap.var_of(t) for t in _tensors(operands)]
    cap.emit("cond", invars, _tensors(result),
             {"branches": tuple(records)})
