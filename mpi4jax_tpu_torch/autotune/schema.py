"""The ``mpx-tuning/1`` file format: parse, validate, stamp, look up.

The port's own copy of ``mpi4jax_tpu/autotune/schema.py`` (the tests hold
the validators, their messages and the stamps equal on the same
payloads), so a file either package writes loads in both.  One JSON file
carries:

- a **tuned** section: the per-knob values the config layer serves
  between the defaults and the environment (``utils/config.py``): the
  crossovers, fusion bucket bytes, overlap chunk counts (optionally
  bucketed by payload), the codec, the pipeline knobs and the
  commit-interval parameters;
- a **topologies** map: per-topology overrides keyed by the
  ``MPI4JAX_TPU_TOPOLOGY`` spec (``"2x4"``);
- the **cost-model** section (``links`` alpha/beta per link class,
  gamma, compute, dispatch: the ``mpx-cost-model/1`` subset), so one file
  feeds both the config layer and ``analysis/costmodel.py``;
- a **measured** section: the sweep-derived values the advisory texts
  cite with ``tuned@<stamp>``;
- a **provenance** block: versions, platform, device, topology, budget.

Only the standard library at import time; ``utils/config.py`` imports it
lazily from its tuning-layer getters.
"""


from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional

SCHEMA = "mpx-tuning/1"

# the cost-model subset this schema supersets (analysis/costmodel.py
# accepts both)
COST_SCHEMA = "mpx-cost-model/1"

# the tunable knobs the config layer serves, with the flag each one
# shadows: a knob value applies only when
# its environment flag is NOT explicitly set — default < tuning < env
KNOB_FLAGS = {
    "ring_crossover_bytes": "MPI4JAX_TPU_RING_CROSSOVER_BYTES",
    "dcn_crossover_bytes": "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
    # an unknown-key-rejecting validator plus a content stamp: a new
    # tuned knob needs no version bump (old files do not tune it)
    "alltoall_crossover_bytes": "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES",
    "fusion_bucket_bytes": "MPI4JAX_TPU_FUSION_BUCKET_BYTES",
    "overlap_chunks": "MPI4JAX_TPU_OVERLAP_CHUNKS",
    # the wire codec, the one string-valued knob ("off"/"bf16"/"fp8",
    # optionally payload-bucketed like overlap_chunks)
    "compress": "MPI4JAX_TPU_COMPRESS",
    # the pipeline-parallel schedule knobs (parallel/pipeline.py): the
    # microbatch count for split_microbatches and the interleaved
    # virtual-stage chunk count (tuned values are >= 1; "unset" exists
    # only as the static default 0 in the config layer)
    "pipeline_microbatches": "MPI4JAX_TPU_PIPELINE_MICROBATCHES",
    "pipeline_virtual_stages": "MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES",
}

# legal tuned codec values for the "compress" knob ("auto" is an env
# resolution directive, never a tuned value)
COMPRESS_CODECS = ("off", "bf16", "fp8")

# commit-interval parameters (tuned.commit — elastic.run's
# commit_every='auto' math, autotune/fit.py auto_commit_interval)
COMMIT_KEYS = ("pack_gb_per_s", "target_overhead")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _require_pos_int(section: str, key: str, val) -> int:
    if not _is_num(val) or val != int(val) or val < 1:
        raise ValueError(
            f"tuning file {section}.{key} must be a positive integer "
            f"(got {val!r})"
        )
    return int(val)


def _validate_chunk_buckets(section: str, buckets) -> list:
    """``overlap_chunks`` bucket form: ascending ``max_bytes`` spans,
    the last one open-ended (``max_bytes: null``)."""
    if not isinstance(buckets, list) or not buckets:
        raise ValueError(
            f"tuning file {section}.overlap_chunks must be a positive "
            f"integer or a non-empty bucket list (got {buckets!r})"
        )
    prev = 0
    for i, b in enumerate(buckets):
        if not isinstance(b, dict) or set(b) != {"max_bytes", "chunks"}:
            raise ValueError(
                f"tuning file {section}.overlap_chunks[{i}] must be an "
                "object with exactly 'max_bytes' and 'chunks' keys"
            )
        _require_pos_int(section, f"overlap_chunks[{i}].chunks",
                         b["chunks"])
        mb = b["max_bytes"]
        last = i == len(buckets) - 1
        if mb is None:
            if not last:
                raise ValueError(
                    f"tuning file {section}.overlap_chunks[{i}]: only "
                    "the last bucket may be open-ended (max_bytes null)"
                )
            continue
        _require_pos_int(section, f"overlap_chunks[{i}].max_bytes", mb)
        if mb <= prev:
            raise ValueError(
                f"tuning file {section}.overlap_chunks bucket bounds "
                f"must be strictly ascending (bucket {i}: {mb} <= {prev})"
            )
        prev = int(mb)
    return buckets


def _require_codec(section: str, key: str, val) -> str:
    if not isinstance(val, str) or val.lower() not in COMPRESS_CODECS:
        raise ValueError(
            f"tuning file {section}.{key} must be one of "
            f"{COMPRESS_CODECS} (got {val!r})"
        )
    return val.lower()


def _validate_codec_buckets(section: str, buckets) -> list:
    """``compress`` bucket form: the overlap_chunks bucket grammar with
    a ``codec`` value per span instead of a chunk count."""
    if not isinstance(buckets, list) or not buckets:
        raise ValueError(
            f"tuning file {section}.compress must be a codec string or "
            f"a non-empty bucket list (got {buckets!r})"
        )
    prev = 0
    for i, b in enumerate(buckets):
        if not isinstance(b, dict) or set(b) != {"max_bytes", "codec"}:
            raise ValueError(
                f"tuning file {section}.compress[{i}] must be an "
                "object with exactly 'max_bytes' and 'codec' keys"
            )
        _require_codec(section, f"compress[{i}].codec", b["codec"])
        mb = b["max_bytes"]
        last = i == len(buckets) - 1
        if mb is None:
            if not last:
                raise ValueError(
                    f"tuning file {section}.compress[{i}]: only the "
                    "last bucket may be open-ended (max_bytes null)"
                )
            continue
        _require_pos_int(section, f"compress[{i}].max_bytes", mb)
        if mb <= prev:
            raise ValueError(
                f"tuning file {section}.compress bucket bounds must "
                f"be strictly ascending (bucket {i}: {mb} <= {prev})"
            )
        prev = int(mb)
    return buckets


def _validate_knobs(section: str, knobs: dict,
                    allow_commit: bool = False) -> None:
    if not isinstance(knobs, dict):
        raise ValueError(f"tuning file {section!r} must be an object")
    for key, val in knobs.items():
        if key == "commit":
            if not allow_commit:
                # only the flat tuned section is read by commit_param —
                # accepting it here would be silently ignored
                raise ValueError(
                    f"tuning file {section}: 'commit' is only valid in "
                    "the top-level 'tuned' section (per-topology commit "
                    "parameters are not supported)"
                )
            if not isinstance(val, dict):
                raise ValueError("tuning file tuned.commit must be an "
                                 "object")
            for ck, cv in val.items():
                if ck not in COMMIT_KEYS:
                    raise ValueError(
                        f"tuning file tuned.commit key {ck!r} unknown "
                        f"(expected one of {COMMIT_KEYS})"
                    )
                if not _is_num(cv) or cv <= 0:
                    raise ValueError(
                        f"tuning file tuned.commit.{ck} must be a "
                        f"positive number (got {cv!r})"
                    )
            continue
        if key not in KNOB_FLAGS:
            raise ValueError(
                f"tuning file {section} knob {key!r} unknown (expected "
                f"one of {tuple(KNOB_FLAGS)} or 'commit')"
            )
        if key == "overlap_chunks" and isinstance(val, list):
            _validate_chunk_buckets(section, val)
        elif key == "compress":
            if isinstance(val, list):
                _validate_codec_buckets(section, val)
            else:
                _require_codec(section, key, val)
        else:
            _require_pos_int(section, key, val)


def validate_tuning_dict(payload) -> dict:
    """Validate a parsed ``mpx-tuning/1`` payload in place; returns it,
    or raises ``ValueError`` with a clear message.  The cost-model
    section (``links``/gamma/compute/dispatch/``measured``) is validated
    by the cost model's own rules — single source of truth — via a lazy
    import (analysis/costmodel.py is stdlib + the config registry)."""
    if not isinstance(payload, dict):
        raise ValueError(
            f"tuning file must be a JSON object (got "
            f"{type(payload).__name__})"
        )
    schema = payload.get("schema")
    if schema != SCHEMA:
        raise ValueError(
            f"tuning file declares schema {schema!r}; this build reads "
            f"{SCHEMA!r} (plain {COST_SCHEMA!r} files feed the cost "
            "model via MPI4JAX_TPU_COST_MODEL, not the tuning layer)"
        )
    if "tuned" in payload:
        _validate_knobs("tuned", payload["tuned"], allow_commit=True)
    topos = payload.get("topologies", {})
    if not isinstance(topos, dict):
        raise ValueError("tuning file 'topologies' must be an object")
    for spec, knobs in topos.items():
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(
                f"tuning file topology key {spec!r} must be a non-empty "
                "MPI4JAX_TPU_TOPOLOGY spec string"
            )
        _validate_knobs(f"topologies[{spec!r}]", knobs)
    prov = payload.get("provenance", {})
    if not isinstance(prov, dict):
        raise ValueError("tuning file 'provenance' must be an object")
    if any(k in payload for k in ("links", "gamma_gb_per_s",
                                  "compute_gb_per_s", "dispatch_us",
                                  "measured")):
        from ..analysis.costmodel import validate_model_dict

        probe = dict(payload)
        probe["schema"] = COST_SCHEMA  # re-use the subset validator
        validate_model_dict(probe)
    return payload


def stamp_of(payload: dict) -> str:
    """Content stamp of one tuning payload: 12 hex chars of the
    canonical-JSON sha256 — the ``tuned@<stamp>`` provenance tag the
    advisories cite."""
    blob = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


class TuningFile:
    """One validated tuning payload + its lookup rules."""

    __slots__ = ("payload", "path", "stamp")

    def __init__(self, payload: dict, path: Optional[str] = None):
        self.payload = validate_tuning_dict(payload)
        self.path = path
        self.stamp = stamp_of(payload)

    # -- knob lookup -------------------------------------------------------

    def knob(self, name: str, topology: Optional[str] = None,
             payload_bytes: Optional[int] = None):
        """The tuned value of ``name`` for the active ``topology`` (a
        per-topology override wins over the flat ``tuned`` scalar) and
        payload bucket (``overlap_chunks`` only), or ``None`` when the
        file does not tune it — the caller then falls back to the
        static default.  The ENV precedence check is the caller's
        (utils/config.py): this object never reads the environment."""
        if name not in KNOB_FLAGS:
            raise KeyError(f"unknown tuning knob {name!r} "
                           f"(expected one of {tuple(KNOB_FLAGS)})")
        val = None
        if topology:
            val = (self.payload.get("topologies", {})
                   .get(topology, {}).get(name))
        if val is None:
            val = self.payload.get("tuned", {}).get(name)
        if val is None:
            return None
        if name == "overlap_chunks" and isinstance(val, list):
            if payload_bytes is None:
                return int(val[-1]["chunks"])  # the open-ended bucket
            for b in val:
                if b["max_bytes"] is None or payload_bytes <= b["max_bytes"]:
                    return int(b["chunks"])
            return int(val[-1]["chunks"])
        if name == "compress":
            if isinstance(val, list):
                if payload_bytes is None:
                    return str(val[-1]["codec"]).lower()
                for b in val:
                    if b["max_bytes"] is None or \
                            payload_bytes <= b["max_bytes"]:
                        return str(b["codec"]).lower()
                return str(val[-1]["codec"]).lower()
            return str(val).lower()
        return int(val)

    def commit_param(self, name: str) -> Optional[float]:
        """A ``tuned.commit`` parameter (``pack_gb_per_s`` /
        ``target_overhead``), or ``None`` when untuned."""
        if name not in COMMIT_KEYS:
            raise KeyError(f"unknown commit parameter {name!r}")
        val = self.payload.get("tuned", {}).get("commit", {}).get(name)
        return float(val) if val is not None else None

    def knobs(self) -> Dict[str, object]:
        """Every flat tuned knob value (topology overrides excluded) —
        the telemetry report's tuned-vs-default table."""
        return {k: v for k, v in self.payload.get("tuned", {}).items()
                if k in KNOB_FLAGS}

    def measured(self) -> dict:
        return dict(self.payload.get("measured", {}))

    def has_links(self) -> bool:
        """Whether the file carries the cost-model section — the
        unification bridge: when it does (and MPI4JAX_TPU_COST_MODEL is
        unset) the cost model reads its parameters from here."""
        return isinstance(self.payload.get("links"), dict)

    def __repr__(self):
        src = self.path or "<in-memory>"
        return f"TuningFile({src}, tuned@{self.stamp})"


def load_tuning_file(path: str) -> TuningFile:
    """Read + validate one tuning file; raises ``ValueError`` on a
    missing/malformed file (a typo'd MPI4JAX_TPU_TUNING must not
    silently run untuned)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except OSError as e:
        raise ValueError(
            f"tuning file {path!r} could not be read: {e}"
        ) from e
    except json.JSONDecodeError as e:
        raise ValueError(
            f"tuning file {path!r} is not valid JSON: {e}"
        ) from e
    return TuningFile(payload, path=path)


# path -> TuningFile | ValueError: the config-layer getters consult the
# active env file on every stamp move and every config_snapshot, which
# must not re-read the file per trace.  Keyed by PATH ALONE, not
# (path, mtime): the memoized-token fast path (ops/_base._dynamic_state)
# cannot see an in-place file edit, so re-reading edited content on new
# traces while already-compiled programs keep the old values would mix
# old and new lowerings in one process.  Instead the env route pins the
# file's content at first read; ``load_tuning(path)`` is the
# explicit, epoch-bumping refresh (``refresh_tuning_file``) that
# re-reads AND stales every pin consistently.
_load_memo: Dict[str, object] = {}


def load_tuning_file_memo(path: str) -> TuningFile:
    cached = _load_memo.get(path)
    if cached is None:
        if len(_load_memo) > 16:
            _load_memo.clear()
        try:
            cached = load_tuning_file(path)
        except ValueError as e:
            cached = e
        _load_memo[path] = cached
    if isinstance(cached, ValueError):
        raise cached
    return cached


def refresh_tuning_file(path: str) -> TuningFile:
    """Force a fresh read of ``path`` and replace the memo entry — the
    ``load_tuning(path)`` route, whose config-epoch bump stales
    every consumer against the new content."""
    tf = load_tuning_file(path)
    _load_memo[path] = tf
    return tf


def as_tuning(spec, fresh: bool = False) -> TuningFile:
    """Coerce a path / dict / TuningFile into a validated TuningFile.
    ``fresh=True`` re-reads a path even when memoized (the explicit
    ``load_tuning`` refresh)."""
    if isinstance(spec, TuningFile):
        return spec
    if isinstance(spec, dict):
        return TuningFile(spec)
    if isinstance(spec, str) and spec.strip():
        path = spec.strip()
        return refresh_tuning_file(path) if fresh else \
            load_tuning_file_memo(path)
    raise TypeError(
        "expected a tuning-file path, a parsed payload dict, or a "
        f"TuningFile (got {type(spec).__name__})"
    )
