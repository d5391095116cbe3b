"""The static alpha-beta-gamma communication cost model.

PyTorch counterpart of ``mpi4jax_tpu/analysis/costmodel.py``, formula for
formula (the tests hold every formula equal to the JAX package's under
one parameter dict).  An analytical model in the Hockney/LogP family,
per **link class**:

- ``ici``: links between ranks of one host;
- ``dcn``: the network between hosts;

with three parameter groups per prediction: **alpha** (``alpha_us``, the
latency of one round on the class), **beta** (``gb_per_s``, the per-rank
bandwidth of the class) and **gamma** (``gamma_gb_per_s``, the local fold
throughput a reduction pays per byte), plus ``compute_gb_per_s`` (the
memory-streaming rate the compute estimate divides a program's bytes by)
and ``dispatch_us`` (the host's fixed cost per step).

``collective_cost`` maps each of the 13 ops and its algorithms
(butterfly, ring, van de Geijn, two-level hier) to ``(rounds, bytes)``
per link class.  The byte models of the reduction family are imported
from the lowerings they describe (``ops/_hierarchy.py``:
``flat_link_bytes``, ``hier_link_bytes``, ``dcn_leg_bytes``;
``ops/_algos.py``: ``resolve_dcn_algo``, ``algorithm_bytes_per_rank``),
as the JAX cost model imports them.  The codec's wire bytes come from the
port's ``ops/_codec.py``.

The parameters load from a file (``MPI4JAX_TPU_COST_MODEL``, schema
``mpx-cost-model/1``, or an ``mpx-tuning/1`` file of ``python -m
mpi4jax_tpu_torch.autotune``), from the active tuning layer's links
section, or fall back to :data:`DEFAULT_PARAMS`, which are the card's own
(see there).
"""


from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from ..ops import _codec
# the byte models of the reduction family: the lowerings' own
# (ops/_algos.py, ops/_hierarchy.py), so the priced bytes never drift from
# what the lowerings ship
from ..ops._algos import (RING_MIN_GROUP, algorithm_bytes_per_rank,  # noqa: F401
                          resolve_dcn_algo)
from ..ops._hierarchy import (dcn_leg_bytes, flat_link_bytes,  # noqa: F401
                              hier_link_bytes)
from ..utils import config

ICI = "ici"
DCN = "dcn"
LINK_CLASSES = (ICI, DCN)

SCHEMA = "mpx-cost-model/1"

# the tuning superset (autotune/schema.py): an ``mpx-tuning/1`` file
# carries the same links/gamma/compute/dispatch/measured sections plus
# the config-layer knobs, so EITHER schema feeds this model —
# ``benchmarks/micro.py --cost-calibrate`` now emits the superset and
# ``MPI4JAX_TPU_COST_MODEL`` keeps accepting both (docs/autotune.md)
TUNING_SCHEMA = "mpx-tuning/1"
ACCEPTED_SCHEMAS = (SCHEMA, TUNING_SCHEMA)

# ops whose lowering folds operands locally (the gamma term)
REDUCTION_OPS = ("allreduce", "reduce", "reduce_scatter", "scan")

# the 13 public collectives the formula matrix covers (ops/__init__.py)
MODELED_OPS = (
    "allgather", "allreduce", "alltoall", "barrier", "bcast", "gather",
    "recv", "reduce", "reduce_scatter", "scan", "scatter", "send",
    "sendrecv",
)

# The defaults are the card's own: the fit of ``python -m
# mpi4jax_tpu_torch.autotune --budget-s 30 --ranks 4 --device cuda:0`` over
# four gloo ranks that share one NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (DEFAULT_SOURCE).  That fabric stages every exchange through host
# memory, so ``ici`` is the host-staged gloo link of one machine, not
# NVLink; ``dcn`` is ``ici`` scaled by the JAX package's documented
# inter-host ratios (25x the latency, 1/8 the bandwidth), as the runner
# scales it, since one machine has no second host to measure.
# ``gamma_gb_per_s`` is the measured device fold (``a.add_(b)``) and
# ``compute_gb_per_s`` the measured device copy, each with the four ranks
# sharing the card (one rank alone: 916.5949 and 1468.7168 GB/s), and
# ``dispatch_us`` the measured host time of one region step of the port
# with the four ranks sharing the host's cores (one rank alone: 51.6991).
# how a report names the defaults (the JAX package: "analytic defaults")
DEFAULTS_NAME = "the card's defaults"
DEFAULT_SOURCE = (
    "python -m mpi4jax_tpu_torch.autotune --budget-s 30 on 4 gloo ranks "
    "staged through host memory on one NVIDIA H100 80GB HBM3, 700.00 W"
)
DEFAULT_PARAMS = {
    "links": {
        ICI: {"alpha_us": 1420.3027, "gb_per_s": 1.2182},
        DCN: {"alpha_us": 35507.5666, "gb_per_s": 0.1523},
    },
    "gamma_gb_per_s": 263.091,
    "compute_gb_per_s": 457.4544,
    "dispatch_us": 543.6039,
}

# the inter-host ratios the runner scales the dcn class by (the JAX
# package's analytic dcn/ici figures: 25 us vs 1 us, 12.5 vs 100 GB/s)
DCN_ALPHA_RATIO = 25.0
DCN_BANDWIDTH_RATIO = 0.125


@dataclass(frozen=True)
class LinkTerm:
    """One link class's share of an op: latency rounds + wire bytes."""

    rounds: int = 0
    nbytes: int = 0

    def __bool__(self) -> bool:
        return bool(self.rounds or self.nbytes)


@dataclass(frozen=True)
class OpCost:
    """Modeled per-rank cost of one collective instance."""

    ici: LinkTerm = LinkTerm()
    dcn: LinkTerm = LinkTerm()
    gamma_bytes: int = 0

    def link(self, name: str) -> LinkTerm:
        return self.ici if name == ICI else self.dcn


ZERO_COST = OpCost()


class CostModel:
    """Parameter set + time arithmetic.  ``source`` records where the
    parameters came from (a tuning-file path, or ``None`` for the
    analytic defaults); ``measured`` carries the calibrated crossovers
    the checker texts cite (MPX111/MPX113)."""

    __slots__ = ("params", "source", "measured", "tuned_stamp")

    def __init__(self, params: Optional[dict] = None,
                 source: Optional[str] = None,
                 measured: Optional[dict] = None,
                 tuned_stamp: Optional[str] = None):
        # provenance of a tuning-layer-sourced model: the mpx-tuning/1
        # content stamp the MPX131-133 advisory texts cite as
        # ``tuned@<stamp>`` (None for files loaded via the cost-model
        # flag or the analytic defaults)
        self.tuned_stamp = tuned_stamp
        base = {
            "links": {
                lc: dict(DEFAULT_PARAMS["links"][lc]) for lc in LINK_CLASSES
            },
        }
        for k in ("gamma_gb_per_s", "compute_gb_per_s", "dispatch_us"):
            base[k] = DEFAULT_PARAMS[k]
        if params:
            for lc, vals in (params.get("links") or {}).items():
                base["links"][lc].update(vals)
            for k in ("gamma_gb_per_s", "compute_gb_per_s", "dispatch_us"):
                if k in params:
                    base[k] = float(params[k])
        self.params = base
        self.source = source
        self.measured = dict(measured or {})

    # -- time arithmetic ---------------------------------------------------
    # 1 GB/s == 1000 bytes/us, so bytes / (gb_per_s * 1000) is microseconds.

    def link_time_us(self, link: str, rounds: int, nbytes: int) -> float:
        p = self.params["links"][link]
        return rounds * p["alpha_us"] + nbytes / (p["gb_per_s"] * 1e3)

    def time_us(self, cost: OpCost) -> float:
        t = self.link_time_us(ICI, cost.ici.rounds, cost.ici.nbytes)
        t += self.link_time_us(DCN, cost.dcn.rounds, cost.dcn.nbytes)
        t += cost.gamma_bytes / (self.params["gamma_gb_per_s"] * 1e3)
        return t

    def compute_us(self, traffic_bytes: int) -> float:
        """Roofline compute time of ``traffic_bytes`` of jaxpr memory
        traffic (analysis/cost.py ``jaxpr_traffic_bytes``)."""
        return traffic_bytes / (self.params["compute_gb_per_s"] * 1e3)

    @property
    def dispatch_us(self) -> float:
        return self.params["dispatch_us"]

    def stamp(self) -> tuple:
        """Hashable identity for memo keys (only folded in when the cost
        pass is ON, so cost=off cache keys stay byte-identical)."""
        links = tuple(
            (lc, self.params["links"][lc]["alpha_us"],
             self.params["links"][lc]["gb_per_s"])
            for lc in LINK_CLASSES
        )
        return (links, self.params["gamma_gb_per_s"],
                self.params["compute_gb_per_s"], self.params["dispatch_us"],
                self.source, self.tuned_stamp)

    def to_json(self) -> dict:
        out = {"schema": SCHEMA, "links": {
            lc: dict(self.params["links"][lc]) for lc in LINK_CLASSES
        }}
        for k in ("gamma_gb_per_s", "compute_gb_per_s", "dispatch_us"):
            out[k] = self.params[k]
        if self.source:
            out["source"] = self.source
        if self.measured:
            out["measured"] = dict(self.measured)
        return out

    def __repr__(self):
        return f"CostModel({self.source or DEFAULTS_NAME})"


# ---------------------------------------------------------------------------
# tuning-file loading (the mpx-cost-model/1 schema)
# ---------------------------------------------------------------------------


def validate_model_dict(payload) -> Tuple[dict, dict]:
    """Validate a parsed tuning payload; returns ``(params, measured)``
    or raises ``ValueError`` with a clear message.  The schema is
    exactly what ``benchmarks/micro.py --cost-calibrate`` emits, so a
    calibration capture loads verbatim."""
    if not isinstance(payload, dict):
        raise ValueError(
            "cost-model tuning file must be a JSON object "
            f"(got {type(payload).__name__})"
        )
    if "links" not in payload and isinstance(payload.get("cost_model"),
                                             dict):
        # a full ``benchmarks/micro.py --save`` capture embeds the
        # tuning payload under "cost_model" — accept it whole, so the
        # sweep artifact IS a valid MPI4JAX_TPU_COST_MODEL file
        payload = payload["cost_model"]
    schema = payload.get("schema", SCHEMA)
    if schema not in ACCEPTED_SCHEMAS:
        raise ValueError(
            f"cost-model tuning file declares schema {schema!r}; this "
            f"build reads {ACCEPTED_SCHEMAS}"
        )
    params: dict = {}
    links = payload.get("links")
    if links is not None:
        if not isinstance(links, dict):
            raise ValueError("cost-model 'links' must be an object")
        for lc, vals in links.items():
            if lc not in LINK_CLASSES:
                raise ValueError(
                    f"cost-model link class {lc!r} unknown (expected one "
                    f"of {LINK_CLASSES})"
                )
            if not isinstance(vals, dict):
                raise ValueError(f"cost-model links[{lc!r}] must be an "
                                 "object")
            for key, val in vals.items():
                if key not in ("alpha_us", "gb_per_s"):
                    raise ValueError(
                        f"cost-model links[{lc!r}] key {key!r} unknown "
                        "(expected alpha_us / gb_per_s)"
                    )
                if not isinstance(val, (int, float)) or isinstance(
                        val, bool):
                    raise ValueError(
                        f"cost-model links[{lc!r}].{key} must be a "
                        f"number (got {val!r})"
                    )
                if key == "gb_per_s" and val <= 0:
                    raise ValueError(
                        f"cost-model links[{lc!r}].gb_per_s must be > 0 "
                        f"(got {val!r})"
                    )
                if key == "alpha_us" and val < 0:
                    raise ValueError(
                        f"cost-model links[{lc!r}].alpha_us must be >= 0 "
                        f"(got {val!r})"
                    )
        params["links"] = links
    for k in ("gamma_gb_per_s", "compute_gb_per_s", "dispatch_us"):
        if k in payload:
            val = payload[k]
            if not isinstance(val, (int, float)) or isinstance(val, bool) \
                    or (val <= 0 and k != "dispatch_us") or val < 0:
                raise ValueError(
                    f"cost-model {k} must be a positive number "
                    f"(got {val!r})"
                )
            params[k] = val
    measured = payload.get("measured", {})
    if not isinstance(measured, dict):
        raise ValueError("cost-model 'measured' must be an object")
    for k, v in measured.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"cost-model measured[{k!r}] must be a non-negative "
                f"number (got {v!r})"
            )
    return params, measured


def model_from_dict(payload, source: Optional[str] = None) -> CostModel:
    params, measured = validate_model_dict(payload)
    if source is None:
        source = payload.get("source")
    return CostModel(params, source=source, measured=measured)


def model_from_tuning(tf) -> CostModel:
    """A model sourced from the active tuning layer (an
    ``autotune.schema.TuningFile``): same parameter extraction as a
    direct file load, plus the ``tuned@<stamp>`` provenance the
    MPX131-133 texts cite."""
    params, measured = validate_model_dict(tf.payload)
    return CostModel(params, source=tf.path or "<tuning layer>",
                     measured=measured, tuned_stamp=tf.stamp)


def model_from_file(path: str) -> CostModel:
    try:
        with open(path) as f:
            payload = json.load(f)
    except OSError as e:
        raise ValueError(
            f"cost-model tuning file {path!r} could not be read: {e}"
        ) from e
    except json.JSONDecodeError as e:
        raise ValueError(
            f"cost-model tuning file {path!r} is not valid JSON: {e}"
        ) from e
    params, measured = validate_model_dict(payload)
    return CostModel(params, source=path, measured=measured)


# (path, mtime) -> CostModel | ValueError — config_snapshot consults the
# measured crossovers on every recorded trace, which must not re-read
# the file per event stream
_load_memo: Dict[Tuple[str, float], object] = {}


def load_model(spec=None) -> CostModel:
    """Resolve a model: ``None`` reads ``MPI4JAX_TPU_COST_MODEL`` (or
    the analytic defaults when unset), a path string loads the file, a
    dict validates in place, a :class:`CostModel` passes through."""
    if isinstance(spec, CostModel):
        return spec
    if isinstance(spec, dict):
        return model_from_dict(spec)
    path = spec if isinstance(spec, str) and spec else \
        config.cost_model_path()
    if not path:
        # the unification bridge (docs/autotune.md): with no cost-model
        # flag, an active tuning layer that carries the links section
        # feeds the model — one file serves selector and cost model
        tf = config.active_tuning()
        if tf is not None and tf.has_links():
            return model_from_tuning(tf)
        return CostModel()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = -1.0
    key = (path, mtime)
    cached = _load_memo.get(key)
    if cached is None:
        if len(_load_memo) > 16:
            _load_memo.clear()
        try:
            cached = model_from_file(path)
        except ValueError as e:
            cached = e
        _load_memo[key] = cached
    if isinstance(cached, ValueError):
        raise cached
    return cached


def measured_meta() -> dict:
    """The config-snapshot fragment the checker texts consume
    (analysis/hook.config_snapshot): the tuning file's measured
    crossovers, keyed ``measured_*``, plus the file path — empty when no
    file is configured.  Never raises (a malformed file warns once and
    falls back to no measured data; ``mpx.analyze(cost=True)`` raises
    the same error loudly)."""
    path = config.cost_model_path()
    if not path:
        # the tuning layer's measured section feeds the same advisory
        # texts, tagged with its content stamp (``tuned@<stamp>``)
        try:
            tf = config.active_tuning()
        except ValueError as e:
            warnings.warn(f"MPI4JAX_TPU_TUNING ignored for advisory "
                          f"texts: {e}", stacklevel=2)
            return {}
        if tf is None:
            return {}
        out = {"cost_model": tf.path or "<tuning layer>",
               "tuned_stamp": tf.stamp}
        for k, v in tf.measured().items():
            out[f"measured_{k}"] = v
        return out
    try:
        model = load_model(path)
    except ValueError as e:
        warnings.warn(f"MPI4JAX_TPU_COST_MODEL ignored for advisory "
                      f"texts: {e}", stacklevel=2)
        return {}
    out = {"cost_model": path}
    for k, v in model.measured.items():
        out[f"measured_{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the formula matrix: (rounds, bytes) per link class for all 13 ops
# ---------------------------------------------------------------------------


def _log2ceil(k: int) -> int:
    return (k - 1).bit_length() if k > 1 else 0


def _dcn_algo(shard_bytes: int, h: int, ring_ok: bool = True) -> str:
    """The hierarchical inter-host phase's ring/butterfly pick — the
    SAME rule ``ops/_algos.resolve_dcn_algo`` applies (pinned equal by
    tests/test_cost_pure.py), restated here over the config registry so
    the round counts below never disagree with the byte model."""
    if (ring_ok and h >= 4  # _algos.RING_MIN_GROUP, mirrored literally
            and shard_bytes >= config.dcn_crossover_bytes()):
        return "ring"
    return "butterfly"


def _hier_rounds(kind: str, nbytes: int, h: int, r: int,
                 preserve: bool) -> Tuple[int, int]:
    """(intra, inter) round counts of the two-level lowerings, mirroring
    ops/_hierarchy.py phase for phase."""
    chunk = -(-nbytes // r) if r else nbytes
    lh = _log2ceil(h)
    if kind == "allreduce":
        intra = 2 * (r - 1)  # ring reduce-scatter + ring allgather
        inter = (2 * (h - 1)
                 if _dcn_algo(chunk, h, ring_ok=not preserve) == "ring"
                 else 2 * lh)
        return intra, inter
    if kind == "reduce_scatter":
        intra = r - 1
        inter = (h - 1) if _dcn_algo(chunk, h) == "ring" else 2 * lh
        return intra, inter
    if kind == "bcast":
        intra = _log2ceil(r) + (r - 1)  # halving scatter + ring allgather
        inter = (lh + (h - 1)) if _dcn_algo(chunk, h) == "ring" else lh
        return intra, inter
    raise ValueError(f"unknown hierarchical collective kind {kind!r}")


def _flat_rounds(kind: str, algo: str, k: int) -> int:
    """Round counts of the flat lowerings, mirroring ops/_algos.py and
    ops/_base.py loop structure."""
    rounds = _log2ceil(k)
    if algo == "butterfly":
        if kind == "bcast":
            return rounds  # doubling broadcast
        return 2 * rounds  # fold + doubling broadcast
    if algo == "ring":
        if kind == "bcast":  # van de Geijn: halving scatter + allgather
            return rounds + (k - 1)
        if kind == "reduce_scatter":
            return k - 1
        return 2 * (k - 1)  # allreduce: reduce-scatter + allgather
    return 1  # native HLO: XLA schedules it; one logical round


def _dcn_wire_bytes(nbytes: int, codec: Optional[str]) -> int:
    """Post-codec bytes of a compressed DCN leg (docs/compression.md):
    the codec layer's byte math, reused so the priced wire bytes can
    never drift from what the lowering ships.  Identity for exact legs."""
    if not codec or codec == "off":
        return nbytes
    return _codec.wire_bytes(nbytes, codec)


def collective_cost(op: str, algo: Optional[str], nbytes: int, k: int,
                    hosts: Optional[int] = None,
                    hier: Optional[Tuple[int, int]] = None,
                    preserve: bool = False,
                    codec: Optional[str] = None) -> OpCost:
    """Modeled per-rank cost of one collective of ``nbytes`` payload
    over a ``k``-rank group spanning ``hosts`` hosts.

    The reduction family (allreduce / reduce / reduce_scatter / bcast)
    delegates its wire bytes to the pinned PR-6 byte models and mirrors
    their round structure; the remaining ops use the canonical formulas
    documented in docs/analysis.md 'Cost model' (and pinned by
    tests/test_cost_pure.py).  Flat algorithms on a multi-host comm land
    entirely on the DCN class — every round gated on the slowest hop,
    exactly MPX113's serialization — matching ``flat_link_bytes``'s
    attribution.

    ``codec`` prices a wire-compressed DCN leg (docs/compression.md):
    only the hierarchical lowerings compress, only their inter-host
    bytes shrink — round counts, ICI bytes, and the gamma fold are the
    logical payload's.
    """
    if k <= 1 or op in ("send", "recv", "sendrecv"):
        if op in ("send", "recv", "sendrecv"):
            raise ValueError(
                f"{op} is point-to-point: use p2p_cost (the link class "
                "depends on the endpoints, not the group)"
            )
        return ZERO_COST
    multi = hosts is not None and hosts > 1
    rounds = _log2ceil(k)
    gamma = nbytes if op in REDUCTION_OPS else 0
    kind = "allreduce" if op == "reduce" else op

    if kind in ("allreduce", "reduce_scatter", "bcast"):
        if algo == "hier" and hier is not None:
            h, r = hier
            intra_b, inter_b = hier_link_bytes(kind, nbytes, h, r, preserve)
            intra_r, inter_r = _hier_rounds(kind, nbytes, h, r, preserve)
            return OpCost(ici=LinkTerm(intra_r, intra_b),
                          dcn=LinkTerm(inter_r,
                                       _dcn_wire_bytes(inter_b, codec)),
                          gamma_bytes=gamma)
        eff = algo if algo in ("butterfly", "ring") else "native"
        intra_b, inter_b = flat_link_bytes(kind, eff, nbytes, k, hosts,
                                           preserve)
        n_rounds = _flat_rounds(kind, eff, k)
        if inter_b:
            return OpCost(dcn=LinkTerm(n_rounds, inter_b),
                          gamma_bytes=gamma)
        return OpCost(ici=LinkTerm(n_rounds, intra_b), gamma_bytes=gamma)

    chunk = -(-nbytes // k)
    if op == "allgather":
        term = LinkTerm(k - 1, (k - 1) * nbytes)  # nbytes = one block
    elif op == "alltoall":
        if algo == "hier" and hier is not None:
            # the two-level split (ops/_hierarchy.apply_hier_alltoall):
            # byte model reused from the pinned PR-6 family so the cost
            # model can never drift from what the lowering moves —
            # intra transpose (r-1 rounds over ICI), inter exchange of
            # host-aggregated blocks (h-1 rounds over DCN, 1/r the flat
            # message count)
            h, r = hier
            intra_b, inter_b = hier_link_bytes("alltoall", nbytes, h, r)
            return OpCost(ici=LinkTerm(r - 1 if r > 1 else 0, intra_b),
                          dcn=LinkTerm(h - 1,
                                       _dcn_wire_bytes(inter_b, codec)))
        term = LinkTerm(k - 1, (k - 1) * chunk)  # nbytes = full buffer
    elif op == "gather":
        term = LinkTerm(rounds, (k - 1) * nbytes)  # binomial, per-block
    elif op == "scatter":
        term = LinkTerm(rounds, (k - 1) * chunk)  # nbytes = full buffer
    elif op == "scan":
        term = LinkTerm(rounds, rounds * nbytes)  # log-depth prefix
    elif op == "barrier":
        term = LinkTerm(rounds, 0)  # latency only
    else:
        raise ValueError(f"collective_cost: unmodeled op {op!r} "
                         f"(modeled: {MODELED_OPS})")
    if multi:
        return OpCost(dcn=term, gamma_bytes=gamma)
    return OpCost(ici=term, gamma_bytes=gamma)


def p2p_cost(nbytes: int, same_host: bool = True) -> OpCost:
    """One point-to-point transfer: a single round carrying the payload
    on the endpoints' link class."""
    term = LinkTerm(1, nbytes)
    return OpCost(ici=term) if same_host else OpCost(dcn=term)


def chunked_async_cost(cost: OpCost, chunks: int) -> OpCost:
    """Modeled cost of the ``C``-chunk async split of one collective
    (ops/_async.py ``*_start``/``*_wait``): the chunks partition the
    payload, so total wire bytes are unchanged; each active link pays
    ``C - 1`` extra chunk-rounds of pipeline fill (double buffering) on
    top of the base round count.  The alpha overhead is the price of
    the split — the win, which the critical-path simulation (not this
    per-op formula) credits, is that everything past the fill is
    hideable behind independent compute issued in the start→wait gap
    (MPX131 quantifies exactly that)."""
    if chunks <= 1:
        return cost

    def _ext(term: LinkTerm) -> LinkTerm:
        if not term:
            return term
        return LinkTerm(term.rounds + chunks - 1, term.nbytes)

    return OpCost(ici=_ext(cost.ici), dcn=_ext(cost.dcn),
                  gamma_bytes=cost.gamma_bytes)


def best_algo(op: str, nbytes: int, k: int, model: CostModel,
              hosts: Optional[int] = None,
              hier: Optional[Tuple[int, int]] = None,
              candidates: Optional[Sequence[str]] = None,
              preserve: bool = False) -> Tuple[str, Dict[str, float]]:
    """Model-predicted algorithm pick for one reduction-family
    collective: evaluates every expressible candidate and returns
    ``(best, {algo: time_us})`` — the MPX133 discriminator and the
    flat-vs-hier comparator the acceptance sweep checks sign against."""
    if candidates is None:
        if op == "alltoall":
            # the permutation family has exactly two shapes: the flat
            # single-level exchange ("native" — the pairwise rounds
            # price identically) and the two-level hierarchical split
            candidates = ["native"]
            if hier is not None:
                candidates.append("hier")
        else:
            candidates = ["butterfly"]
            if k >= 4 and not preserve:  # RING_MIN_GROUP, mirrored
                candidates.append("ring")
            if hier is not None:
                candidates.append("hier")
    times = {
        a: model.time_us(collective_cost(op, a, nbytes, k, hosts=hosts,
                                         hier=hier, preserve=preserve))
        for a in candidates
    }
    return min(times, key=lambda a: (times[a], a)), times


# ---------------------------------------------------------------------------
# pipeline-parallel schedule formulas (parallel/pipeline.py, docs/pipeline.md)
# ---------------------------------------------------------------------------
#
# Wall-clock models of one pipeline round over S stages x M microbatches,
# with c = per-microbatch per-stage compute (us) and x = one boundary
# transfer of the microbatch activation (us, ``p2p_cost`` through the
# model).  Per-rank useful work is always M*c; everything else is bubble.
#
# - ladder ("naive"): every stage computes the WHOLE batch then forwards
#   it — the un-microbatched send/recv chain MPX135 flags.  Fully serial:
#       wall = S*(M*c) + (S-1)*(M*x)
# - gpipe (Huang et al.): M microbatches through S stages in lockstep
#   ticks; the blocking sendrecv boundary puts the transfer on the
#   critical path of every tick:
#       wall = (M+S-1) * (c + x)
# - 1f1b (PipeDream-flush, Narayanan et al.): same (M+S-1)-tick skeleton,
#   but the boundary goes through send_start/recv_start so the steady-
#   state transfer overlaps the next microbatch's compute.  Only the
#   (S-1) warmup-edge transfers and any per-tick excess of x over c stay
#   exposed:
#       wall = (M+S-1)*c + (S-1)*x + max(0, x-c)*(M-1)
# - interleaved (Megatron virtual stages): v stage-chunks per rank, so
#   P = S*v virtual stages of compute c/v each; the fill shrinks by v
#   while each chunk boundary moves 1/v of the activation bytes (alpha
#   paid v times as often — the classic bubble-vs-latency trade):
#       wall = M*c + (S-1)*(c/v) + (S-1)*x_v + max(0, x_v - c/v)*(M*v-1)
#   with x_v = one transfer of payload_bytes/v.
#
# The orderings the BENCH_pipeline.json acceptance grid pins (x > 0,
# M >= 2, S >= 2): ladder > gpipe (microbatching wins (S-1)*(M-1)*c of
# fill) and gpipe > 1f1b (async overlap hides M*x - max(0,x-c)*(M-1) > 0
# of wire time).  interleaved-vs-1f1b depends on alpha vs c/v — exactly
# why ``schedule='auto'`` asks this model instead of hard-coding.

PIPELINE_SCHEDULES = ("ladder", "gpipe", "1f1b", "interleaved")


def pipeline_wall_us(schedule: str, stages: int, microbatches: int,
                     payload_bytes: int, stage_compute_us: float,
                     model: CostModel, same_host: bool = True,
                     virtual: int = 2) -> float:
    """Modeled wall-clock (us) of one forward round of ``schedule`` over
    ``stages`` x ``microbatches`` with per-boundary activation payloads
    of ``payload_bytes``."""
    if stages < 1 or microbatches < 1:
        raise ValueError("pipeline_wall_us: stages and microbatches "
                         "must be >= 1")
    s, m = stages, microbatches
    c = stage_compute_us
    x = model.time_us(p2p_cost(payload_bytes, same_host=same_host))
    if schedule == "ladder":
        return s * m * c + (s - 1) * m * x
    if schedule == "gpipe":
        return (m + s - 1) * (c + x)
    if schedule == "1f1b":
        return (m + s - 1) * c + (s - 1) * x + max(0.0, x - c) * (m - 1)
    if schedule == "interleaved":
        v = max(1, virtual)
        cv = c / v
        xv = model.time_us(p2p_cost(-(-payload_bytes // v),
                                    same_host=same_host))
        return (m * c + (s - 1) * cv + (s - 1) * xv
                + max(0.0, xv - cv) * (m * v - 1))
    raise ValueError(f"pipeline_wall_us: unknown schedule {schedule!r} "
                     f"(expressible: {PIPELINE_SCHEDULES})")


def pipeline_bubble_fraction(schedule: str, stages: int, microbatches: int,
                             payload_bytes: int, stage_compute_us: float,
                             model: CostModel, same_host: bool = True,
                             virtual: int = 2) -> float:
    """Predicted bubble fraction: the share of the round's wall clock a
    rank spends NOT computing, ``1 - M*c / wall`` (0 = perfectly full)."""
    wall = pipeline_wall_us(schedule, stages, microbatches, payload_bytes,
                            stage_compute_us, model, same_host=same_host,
                            virtual=virtual)
    if wall <= 0.0:
        return 0.0
    busy = microbatches * stage_compute_us
    return max(0.0, 1.0 - busy / wall)


def best_schedule(stages: int, microbatches: int, payload_bytes: int,
                  stage_compute_us: float, model: CostModel,
                  same_host: bool = True, virtual: int = 2,
                  candidates: Optional[Sequence[str]] = None,
                  ) -> Tuple[str, Dict[str, float]]:
    """Model-predicted schedule pick, mirroring :func:`best_algo`:
    evaluates every expressible candidate and returns ``(best, {schedule:
    wall_us})`` — ``mpx.pipeline(schedule='auto')``'s argmin and the
    MPX144 mispick discriminator.  The default candidate set is what the
    PROGRAM at ``virtual`` can express — an alternative that needs
    restructuring is not a candidate: the ladder never (it is the shape
    :func:`pipeline` exists to replace); a flat program (``virtual ==
    1``) prices gpipe vs 1f1b; a program already chunked into ``virtual
    >= 2`` stage-chunks per rank can only run interleaved, because
    gpipe/1f1b apply one stage fn per rank and would need the chunks
    composed back into a single fn.  Pass ``candidates`` explicitly to
    price across program shapes (benchmarks/pipeline_replay.py's
    cross-shape argmin does)."""
    if candidates is None:
        if virtual >= 2:
            candidates = ["interleaved"]
        else:
            candidates = ["gpipe", "1f1b"]
    times = {
        sched: pipeline_wall_us(sched, stages, microbatches, payload_bytes,
                                stage_compute_us, model,
                                same_host=same_host, virtual=virtual)
        for sched in candidates
    }
    return min(times, key=lambda sched: (times[sched], sched)), times
