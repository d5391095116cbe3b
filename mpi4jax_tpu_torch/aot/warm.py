"""Manifest-driven warming of the persistent tier
(``python -m mpi4jax_tpu_torch.aot warm``).

PyTorch counterpart of ``mpi4jax_tpu/aot/warm.py``.  The persistent tier
(``diskcache.py``) lets a fleet's cold start skip the kernel builds, but
only after something has built each library and pinned each program once.
The warming command closes that loop: a program manifest names each
program abstractly (the function's import path and its arguments'
shapes), and ``warm`` pins every entry through ``compile`` with the
directory set, so that the libraries and the pin records exist before the
first real job starts.

The manifest is the JAX package's (JSON)::

    {
      "programs": [
        {
          "fn": "my_model.serving:decode_step",
          "args": [
            {"shape": [8, 4096], "dtype": "float32"},
            {"static": 16}
          ],
          "unroll": 8,          // optional megastep trip count
          "donate_argnums": [0] // optional
        }
      ]
    }

- ``fn`` is ``"module.path:callable"`` (or a dotted attribute after the
  colon);
- each ``args`` entry is a template ``{"shape": [...], "dtype": "..."}``,
  which becomes a zero tensor on the comm's device (one rank's shape: the
  port's tensors are rank-local), or ``{"static": <json value>}``, folded
  (its position becomes a ``static_argnums`` entry);
- record keys fold in the comm's shape, so warm with the fleet's world
  and device.  A pin that runs eagerly (on the CPU, on several ranks)
  writes its record at its first run, so ``warm`` calls it once on the
  zeros.

Exit codes (``__main__.py``): ``0`` every program warmed, ``1`` some
program failed to import or pin (the rest are still attempted), ``2`` the
manifest is unreadable or malformed, or the persistent tier is off
(warming without ``MPI4JAX_TPU_COMPILE_CACHE_DIR`` would build into the
void).  Each success bumps the ``aot.warmed`` meter and the ``warmed``
counter of ``cache_stats()["aot"]``.

Parsing (``parse_manifest``) is pure Python; only ``warm_program``
touches PyTorch.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["ProgramSpec", "ManifestError", "parse_manifest",
           "load_manifest", "warm_program", "warm_from_manifest",
           "EXIT_OK", "EXIT_FAILED", "EXIT_BAD_MANIFEST"]

EXIT_OK = 0
EXIT_FAILED = 1
EXIT_BAD_MANIFEST = 2


class ManifestError(ValueError):
    """The manifest is structurally unusable (exit code 2)."""


@dataclass
class ProgramSpec:
    """One warmable program: the abstract form ``compile`` needs."""

    fn: str                                  # "module.path:attr.path"
    args: Tuple[dict, ...]                   # raw entries, validated
    static_argnums: Tuple[int, ...] = ()
    unroll: int = 1
    donate_argnums: Tuple[int, ...] = ()
    wrap: Optional[bool] = None
    label: str = field(default="", compare=False)

    def import_path(self) -> Tuple[str, str]:
        mod, _, attr = self.fn.partition(":")
        return mod, attr


def _check_template(i: int, entry, where: str) -> dict:
    if not isinstance(entry, dict):
        raise ManifestError(
            f"{where}: args[{i}] must be an object, got "
            f"{type(entry).__name__}")
    if "static" in entry:
        extra = set(entry) - {"static"}
        if extra:
            raise ManifestError(
                f"{where}: args[{i}] mixes 'static' with {sorted(extra)}")
        return entry
    missing = {"shape", "dtype"} - set(entry)
    if missing:
        raise ManifestError(
            f"{where}: args[{i}] needs 'shape' and 'dtype' (or 'static'); "
            f"missing {sorted(missing)}")
    shape = entry["shape"]
    if (not isinstance(shape, list)
            or any(not isinstance(d, int) or d < 0 for d in shape)):
        raise ManifestError(
            f"{where}: args[{i}].shape must be a list of non-negative "
            f"ints, got {shape!r}")
    if not isinstance(entry["dtype"], str) or not entry["dtype"]:
        raise ManifestError(
            f"{where}: args[{i}].dtype must be a non-empty string")
    return entry


def parse_manifest(obj) -> List[ProgramSpec]:
    """Validate a loaded manifest object into ``ProgramSpec``\\ s.

    Raises ``ManifestError`` on any structural problem: a mistyped
    manifest fails the whole run loudly (exit 2) rather than warm a
    subset."""
    if not isinstance(obj, dict) or "programs" not in obj:
        raise ManifestError(
            "manifest must be an object with a 'programs' array")
    programs = obj["programs"]
    if not isinstance(programs, list) or not programs:
        raise ManifestError("'programs' must be a non-empty array")
    specs = []
    for n, p in enumerate(programs):
        where = f"programs[{n}]"
        if not isinstance(p, dict):
            raise ManifestError(f"{where} must be an object")
        fn = p.get("fn")
        if not isinstance(fn, str) or ":" not in fn or not fn.partition(
                ":")[2]:
            raise ManifestError(
                f"{where}.fn must be 'module.path:callable', got {fn!r}")
        raw_args = p.get("args")
        if not isinstance(raw_args, list):
            raise ManifestError(f"{where}.args must be an array")
        args = tuple(_check_template(i, a, where)
                     for i, a in enumerate(raw_args))
        statics = tuple(i for i, a in enumerate(args) if "static" in a)
        unroll = p.get("unroll", 1)
        if not isinstance(unroll, int) or unroll < 1:
            raise ManifestError(
                f"{where}.unroll must be a positive int, got {unroll!r}")
        donate = p.get("donate_argnums", [])
        if (not isinstance(donate, list)
                or any(not isinstance(d, int) for d in donate)):
            raise ManifestError(
                f"{where}.donate_argnums must be an array of ints")
        wrap = p.get("wrap")
        if wrap is not None and not isinstance(wrap, bool):
            raise ManifestError(f"{where}.wrap must be a boolean")
        specs.append(ProgramSpec(
            fn=fn, args=args, static_argnums=statics, unroll=unroll,
            donate_argnums=tuple(donate), wrap=wrap,
            label=p.get("label") or fn,
        ))
    return specs


def load_manifest(path: str) -> List[ProgramSpec]:
    """Read and parse a manifest file (``ManifestError`` on any problem,
    an unreadable file or invalid JSON included)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except OSError as e:
        raise ManifestError(f"cannot read manifest {path!r}: {e}") from e
    except json.JSONDecodeError as e:
        raise ManifestError(f"manifest {path!r} is not valid JSON: {e}") from e
    return parse_manifest(obj)


def _resolve_fn(spec: ProgramSpec):
    import importlib

    mod_name, attr_path = spec.import_path()
    mod = importlib.import_module(mod_name)
    target = mod
    for part in attr_path.split("."):
        target = getattr(target, part)
    if not callable(target):
        raise TypeError(f"{spec.fn} resolved to a non-callable "
                        f"{type(target).__name__}")
    return target


def _materialize_args(spec: ProgramSpec, device) -> tuple:
    import torch

    out = []
    for entry in spec.args:
        if "static" in entry:
            v = entry["static"]
            out.append(tuple(v) if isinstance(v, list) else v)
            continue
        dtype = getattr(torch, entry["dtype"], None)
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"{spec.fn}: unknown dtype {entry['dtype']!r}")
        out.append(torch.zeros(tuple(entry["shape"]), dtype=dtype,
                               device=device))
    return tuple(out)


def warm_program(spec: ProgramSpec, comm=None) -> dict:
    """Pin one manifest entry (import, zero tensors on the comm's device,
    ``compile``; an eager pin is then called once, its first run, which
    writes its record).  Returns a JSON-ready row; raises on failure (the
    command catches per program, so one broken entry cannot block the
    rest)."""
    import time

    from ..parallel.region import resolve_comm
    from ..telemetry import core as _telemetry
    from . import pinning

    fn = _resolve_fn(spec)
    c = resolve_comm(comm)
    args = _materialize_args(spec, c.device)
    t0 = time.perf_counter()
    program = pinning.compile(
        fn, *args, comm=c,
        static_argnums=spec.static_argnums or None,
        donate_argnums=spec.donate_argnums,
        wrap=spec.wrap, unroll=spec.unroll,
    )
    if not program.graph:
        program(*(a for i, a in enumerate(args)
                  if i not in spec.static_argnums))
    wall = time.perf_counter() - t0
    pinning._stats.warmed += 1
    _telemetry.meter("aot.warmed")
    return {
        "fn": spec.fn,
        "from_disk": program.from_disk,
        "fast_path": program.fast_path,
        "unroll": program.unroll,
        "key": program.key,
        "pin_wall_s": round(wall, 4),
    }


def warm_from_manifest(path: str, comm=None) -> Tuple[int, dict]:
    """Warm every program in ``path``; returns ``(exit_code, payload)``.
    The persistent tier must be on (``MPI4JAX_TPU_COMPILE_CACHE_DIR``):
    warming builds only to fill it."""
    from ..utils.config import compile_cache_dir

    if not compile_cache_dir():
        return EXIT_BAD_MANIFEST, {
            "error": "MPI4JAX_TPU_COMPILE_CACHE_DIR is not set: warming "
                     "has no persistent tier to populate",
        }
    try:
        specs = load_manifest(path)
    except ManifestError as e:
        return EXIT_BAD_MANIFEST, {"error": str(e)}
    results, failures = [], []
    for spec in specs:
        try:
            results.append(warm_program(spec, comm=comm))
        except Exception as e:  # noqa: BLE001 - keep warming the rest
            failures.append({"fn": spec.fn, "error": f"{type(e).__name__}: {e}"})
    payload = {
        "manifest": path,
        "warmed": len(results),
        "failed": len(failures),
        "programs": results,
        "failures": failures,
    }
    return (EXIT_OK if not failures else EXIT_FAILED), payload
