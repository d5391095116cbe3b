"""The collective verifier (``analyze``): the port's ``mpi4jax_tpu.analysis``.

The hazards the JAX package's ``docs/sharp_bits.md`` states in prose
(unmatched point-to-point, rank-dependent structure, token misuse,
rank-divergent schedules that deadlock) are checked mechanically here,
each with a stable ``MPX1xx`` code, a one-line finding and a suggested
rewrite.  Two ways in:

- **explicit**: ``analyze(fn, *args, comm=...) -> Report`` re-runs ``fn``
  abstractly on ``meta`` templates of its arguments (nothing runs on a
  device, nothing is sent), records every op at the shared dispatch
  point (``ops/_base.py:run_body``), and runs the checker registry;
  ``ranks='all'`` re-runs it once per rank and matches the per-rank
  schedules for deadlocks (MPX120-MPX125);
- **ambient**: ``MPI4JAX_TPU_ANALYZE={off,warn,error}`` (or
  ``set_analyze_mode``) verifies every region, and every op outside
  one, at its first call for each key and before it runs; ``error``
  turns any finding into :class:`AnalysisError` on every rank before a
  message is sent.  ``python -m mpi4jax_tpu_torch.analysis script.py``
  runs scripts under it and applies the CI exit-code contract.

The value-lineage passes run over the lineage record of each abstract
run (``lineage.py``, the port's closed jaxpr): MPX108 (``walker.py``)
and MPX141/MPX142 (``dataflow.py``), over branches written with
``cond``/``switch`` (``parallel/control.py``).  ``analyze(cost=True)``
extends the cross-rank pass into the critical-path timing simulation of
the alpha-beta-gamma cost model (``cost.py``, ``costmodel.py``):
``Report.cost`` and the advisories MPX131-MPX135 and MPX144.

Nothing here imports JAX or the JAX package: the pure modules
(``report``, ``graph``, ``checkers``, ``hazards``, ``schedule``,
``matcher``, ``progress``, ``walker``, ``dataflow``, ``costmodel``,
``cost``) are the port's own copies.
"""

from __future__ import annotations

from typing import Optional

from .checkers import CHECKERS, registered_codes, run_checkers  # noqa: F401
from .dataflow import graph_arms_approx, hazard_jaxpr_findings  # noqa: F401
from .graph import CollectiveEvent, CollectiveGraph  # noqa: F401
from .hook import (  # noqa: F401
    Recorder,
    analysis_cache_token,
    clear_analysis_caches,
    effective_mode,
    pop_recorder,
    push_recorder,
    set_analyze_mode,
)
from .report import (  # noqa: F401
    CODES,
    AnalysisError,
    Finding,
    Report,
    finding_from_exception,
)
from .walker import check_cond_divergence  # noqa: F401


def analyze(fn, *args, comm=None, wrap: Optional[bool] = None,
            static_argnums=None, ranks=None, cost: bool = False,
            cost_model=None) -> Report:
    """Statically verify the collective structure of ``fn(*args)``.

    ``fn`` is re-run abstractly: every tensor of ``args`` becomes a
    ``meta`` tensor of its shape and dtype (pass ``meta`` tensors, the
    port's ``ShapeDtypeStruct``, or real ones), the ops record their
    events and return their abstract outputs without running, and the
    kernels take their ``meta`` routes.  ``args`` are one rank's
    tensors.  Three calling conventions, as in the JAX package:

    - ``fn`` decorated with ``spmd``: analyzed as-is (its comm, statics and
      unroll adopted);
    - a plain per-rank function: run as a region over ``comm`` (or the
      default comm), like ``run``;
    - ``wrap=False``: run exactly as given (ops outside any region).

    ``comm`` may be bound to a *virtual* grid,
    ``ProcessGrid(shape, axes, device, rank=r)``, built without
    ``init_distributed``: nothing of the analysis touches
    ``torch.distributed``.  Its device picks the program's route where
    the program reads ``comm.device``.

    ``ranks`` enables the **cross-rank schedule verification**: ``'all'``
    re-runs ``fn`` once per rank of the comm, with ``comm.Get_rank()``
    returning that rank (a ``RankConcrete``), so rank-dependent Python
    branches take their real paths; the per-rank schedules are matched
    (collectives by (comm, seq), point-to-point by (src, dst, tag) FIFO,
    start/wait by span) and checked for progress (MPX120-MPX125).  An int
    ``n`` analyzes ranks ``0..n-1``; an iterable names them.

    A Python branch on a tensor's value raises
    ``analysis.crossrank.DataDependentBranch``: branch on data with
    ``cond``/``switch``, whose arms the verifier sees (MPX108, MPX141,
    MPX142).

    ``cost=True`` extends the cross-rank pass into the critical-path
    timing simulation (``cost.py``): ``Report.cost`` holds the predicted
    step time, the per-op and per-link-class breakdown, the critical path
    and the amortization, and MPX131-MPX135 and MPX144 join the findings.
    Parameters come from ``cost_model`` (a path, a parsed dict or a
    ``costmodel.CostModel``), else ``MPI4JAX_TPU_COST_MODEL``, else the
    tuning layer's links section, else the card's defaults
    (``costmodel.DEFAULT_PARAMS``).  ``cost`` implies ``ranks='all'`` when
    ``ranks`` is not given; with ``cost=False`` the report and the memo
    keys are those of a run without the cost model.

    Returns a :class:`Report`; ``report.raise_if_findings()`` converts it
    into the :class:`AnalysisError` the ambient ``error`` mode raises.
    Results are memoized per (function, argument shapes, statics, ranks,
    configuration); ``clear_caches()`` drops the memo.
    """
    from ..parallel.region import normalize_statics, resolve_comm, spmd
    from ..utils import config
    from . import crossrank
    from .hook import _analyze_cache

    ranks_implied = cost and ranks is None
    if ranks_implied:
        ranks = "all"
    is_spmd = getattr(fn, "_mpx_spmd", False)
    if wrap is None:
        wrap = not is_spmd
    if ranks is not None and not wrap and not is_spmd:
        what = ("analyze(cost=True) implies ranks='all' (the timing runs "
                "over the matched cross-rank schedules) and"
                if ranks_implied else "analyze(ranks=...)")
        raise ValueError(
            f"{what} needs a region-style function (plain "
            "per-rank or spmd-decorated): an eager-style wrap=False "
            "function has no per-rank program to re-run"
        )
    region_comm = comm
    if not wrap and is_spmd:
        kw = fn._mpx_spmd_kwargs
        region_comm = comm if comm is not None else kw["comm"]
        if static_argnums is None:
            static_argnums = kw["static_argnums"]
        target = spmd(fn._mpx_fn, comm=region_comm,
                      static_argnums=static_argnums or (),
                      unroll=kw.get("unroll"))
    elif wrap:
        target = spmd(fn, comm=comm, static_argnums=static_argnums or ())
    else:
        target = fn

    statics = normalize_statics(static_argnums, len(args))
    dyn = tuple(a for i, a in enumerate(args) if i not in statics)
    stat_vals = tuple(args[i] for i in statics)
    rank_list = c = None
    if ranks is not None:
        c = resolve_comm(region_comm)
        _, world = crossrank.comm_shape(c)
        rank_list = crossrank.resolve_rank_list(ranks, world)
    model = None
    if cost:
        from . import cost as _cost

        model = _cost.resolve_model(cost_model)
    from ..ops._algos import algo_cache_token

    key = (fn, comm, stat_vals, crossrank.avals(dyn), wrap, rank_list,
           config.config_stamp(), algo_cache_token())
    if cost:
        # only with the pass on: keys with cost off stay as they were
        key = key + ("cost", model.stamp())
    try:
        hash(key)
    except TypeError:
        key = None
    if key is not None and key in _analyze_cache:
        return _analyze_cache[key]
    if rank_list is not None:
        report = crossrank.cross_rank_report(target, args, {}, c, rank_list,
                                             cost_model=model)
    else:
        axes = tuple(region_comm.axes) if region_comm is not None else ("rank",)
        report = crossrank.single_report(target, args, {}, seed=False,
                                         axes=axes)
    if key is not None:
        _analyze_cache[key] = report
    return report
