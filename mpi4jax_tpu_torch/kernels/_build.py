"""Build, load and count the port's CUDA kernels.

Every kernel is a CUDA C++ source under ``mpi4jax_tpu_torch/csrc/`` with a
plain C interface.  ``build`` compiles one with ``nvcc`` for ``sm_90a`` at
first use into the package's git-ignored ``_build/`` directory, named by
a hash of the source, the headers it includes and its ``-D`` flags, so an
edited source rebuilds; the wrapper loads the library with ``ctypes``.
FMA contraction is a per-source switch (``fmad``, part of the name's
hash).  The stencil kernels (``sw_steps``, ``sw_phase``, ``sw_wide``) are
built with it off (``-fmad=false``): each is bit for bit with its plain
PyTorch version, which rounds every product.  The flash-attention
kernels (``flash_fwd*.cu``, ``flash_bwd*.cu``) are built with it on: their parity with
the plain version is a band, and an f32 dot product without FMA takes twice the
instructions.  ``build_many`` starts one ``nvcc`` per source, all at
once.

The persistent tier (``aot/diskcache.py``).  With
``MPI4JAX_TPU_COMPILE_CACHE_DIR`` set and the library absent from
``_build/``, ``build`` looks the library up in the tier by
``library_key`` (the fingerprint of the source, its headers and its
flags, the target and ``aot/keys.py:toolchain_versions``): a hit is
written into ``_build/`` and opened, a miss is compiled and stored.  With
the directory unset nothing changes.  ``stats()["compiles"]`` counts the
compiler's invocations.

``LaunchCounter`` is the count each wrapper keeps of its kernel's
launches; ``COUNTERS`` lists them by kernel name, so a CUDA-graph runner
can account for the launches a replay makes.  ``load`` remembers the
library of each launch function, so a pin can name the libraries its
kernels came from (``libraries_of``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch

from ..utils.transforms import batch_at, transformed

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
TARGET = "sm_90a"

_stats = {"compiles": 0}
# launch function name -> (library file name, its build spec)
_LIBRARY_OF: Dict[str, Tuple[str, tuple]] = {}


def stats() -> dict:
    """``compiles``: ``nvcc`` invocations of this process."""
    return dict(_stats)


def reset_stats() -> None:
    _stats["compiles"] = 0


class LaunchCounter:
    """``launches``: kernel executions, direct or by CUDA-graph replay.
    ``captured``: launches recorded into graphs being captured; the graph
    runner adds them to ``launches`` once per replay."""

    def __init__(self):
        self.launches = 0
        self.captured = 0

    def count(self, capturing: bool) -> None:
        """One launch: captured into a graph, or run now."""
        if capturing:
            self.captured += 1
        else:
            self.launches += 1


COUNTERS: Dict[str, LaunchCounter] = {}


def counter_for(name: str) -> LaunchCounter:
    """The launch counter of kernel ``name`` (one per kernel)."""
    return COUNTERS.setdefault(name, LaunchCounter())


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _flags(defines, fmad: bool) -> list:
    flags = [f"-D{k}={v}" for k, v in (defines or {}).items()]
    flags.append(f"-fmad={'true' if fmad else 'false'}")
    return flags


def library_key(source: Path, defines: Mapping[str, int] = None,
                headers: Sequence[Path] = (), fmad: bool = False) -> str:
    """The tier's key of a build: the fingerprint of the source, its
    headers and its flags, the target, the flags and the toolchain."""
    from ..aot import keys

    flags = _flags(defines, fmad)
    text = Path(source).read_bytes() + b"".join(
        Path(h).read_bytes() for h in headers) + " ".join(flags).encode()
    return keys.derive_key(keys.fingerprint(text), TARGET, flags,
                           keys.toolchain_versions(_nvcc(), TARGET))


def from_tier(key: str, out: Path) -> bool:
    """Write the tier's library ``key`` to ``out`` and open it: True on a
    hit.  A library ``ctypes`` refuses is deleted from the tier and counts
    as a miss."""
    from ..aot import diskcache, serialization

    return diskcache.get(key, use=lambda data: serialization.load_library(
        data, out)) is not None


def to_tier(key: str, out: Path) -> None:
    """Store a library just built (a failed write is ignored)."""
    from ..aot import diskcache, serialization

    data = serialization.dumps_library(out)
    if data is not None:
        diskcache.put(key, data)


def build(source: Path, defines: Mapping[str, int] = None,
          headers: Sequence[Path] = (), fmad: bool = False) -> Path:
    """Compile ``source`` for sm_90a into ``_build/`` and return the
    library's path; a library already built from the same bytes is reused,
    and with the persistent tier on one the tier holds is fetched from it
    (see the module docstring).  ``defines`` become ``-D`` flags;
    ``headers`` (files the source includes) enter the name's hash;
    ``fmad`` lets the compiler contract a multiply and an add into one
    FMA.  The compiler's output, with ``-Xptxas -v``'s register and
    shared-memory report, goes to ``_build/<stem>.build.log``."""
    from ..aot import diskcache

    source = Path(source)
    flags = _flags(defines, fmad)
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    for h in headers:
        digest.update(Path(h).read_bytes())
    out = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    key = None
    if diskcache.enabled():
        key = library_key(source, defines, headers, fmad)
        if from_tier(key, out):
            return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        *flags, "-o", str(tmp), str(source),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    _stats["compiles"] += 1
    (BUILD_DIR / f"{source.stem}.build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source.name}:\n{res.stderr}")
    os.replace(tmp, out)
    if key is not None:
        to_tier(key, out)
    return out


def build_many(specs: Iterable[Tuple]):
    """``build`` every ``(source, defines, headers[, fmad])`` at once, one
    ``nvcc`` process each; returns the libraries' paths in order."""
    specs = list(specs)
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        return list(pool.map(lambda s: build(*s), specs))


def load(spec, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """Build ``spec`` (``(source, defines, headers[, fmad])``) and load
    it, with the ``argtypes`` of each C function named in ``signatures``;
    every launch function returns its ``cudaError_t`` as an ``int``."""
    path = build(*spec)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LIBRARY_OF[name] = (path.name, tuple(spec))
    return lib


def _kernel_of(function: str) -> str:
    """The counter name of a launch function: ``sw_steps_launch`` ->
    ``sw_steps``, ``sw_phase1_launch`` -> ``sw_phase``."""
    return function[:-len("_launch")].rstrip("0123456789")


def launch_totals() -> Dict[str, int]:
    """Every kernel's launches, direct and captured, by name."""
    return {k: c.launches + c.captured for k, c in COUNTERS.items()}


def libraries_of(before: Mapping[str, int]) -> list:
    """``[{"key", "name"}]`` of the libraries whose kernels launched since
    ``before`` (a ``launch_totals()``), their tier keys derived from their
    build specs."""
    now = launch_totals()
    moved = {k for k, n in now.items() if n != before.get(k, 0)}
    seen, out = set(), []
    for function, (name, spec) in sorted(_LIBRARY_OF.items()):
        if (function.endswith("_launch") and _kernel_of(function) in moved
                and name not in seen):
            seen.add(name)
            out.append({"key": library_key(*spec), "name": name})
    return out


def check_cuda_fields(what: str, fields, shape) -> None:
    """The checks of a launch: f32 tensors on one CUDA device, contiguous,
    each of ``shape``: a plane, or ``(lanes, *plane)`` for a batched
    launch."""
    dev = fields[0].device
    for f in fields:
        if f.device != dev or f.dtype != torch.float32:
            raise ValueError(f"{what}: fields must be f32 on one CUDA device")
        if tuple(f.shape) != tuple(shape) or not f.is_contiguous():
            raise ValueError(
                f"{what}: fields must be contiguous {tuple(shape)}, got "
                f"{tuple(f.shape)}"
            )


def lanes_of(fields) -> int:
    """The lanes of a stencil call's fields: an ``(ny, nx)`` plane is one
    lane, an ``(lanes, ny, nx)`` stack that many."""
    return fields[0].shape[0] if fields[0].dim() == 3 else 1


def per_lane(fn, fields):
    """``fn(lane's fields)`` on every lane of ``(lanes, ny, nx)`` fields,
    the outputs stacked: a plain version over a batched call's lanes."""
    outs = [fn(tuple(f[i] for f in fields)) for i in range(fields[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


class StencilCall(torch.autograd.Function):
    """A stencil entry point (``sw_steps``, ``sw_wide``, ``sw_phase1``,
    ``sw_phase2``) under a ``torch.func`` transform: ``route(fields)`` on
    the physical tensors.  Forward only, as the JAX package's stencils have
    no VJP.  The vmap rule lays the lanes out as contiguous ``(N, ny, nx)``
    planes (an unbatched field expanded; the lanes of nested vmaps folded
    into one N) and calls the route once: one launch of the kernel for all
    N lanes, each lane bit for bit its own one-lane launch."""

    @staticmethod
    def forward(route, *fields):
        return route(fields)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, route, *fields):
        lanes = [batch_at(info.batch_size, d, f) for d, f in zip(in_dims[1:], fields)]
        lead = lanes[0].shape[:-2]
        outs = StencilCall.apply(route, *(f.reshape(-1, *f.shape[-2:]).contiguous()
                                          for f in lanes))
        return tuple(o.reshape(*lead, *o.shape[-2:]) for o in outs), (0,) * len(outs)


def stencil_call(route, fields):
    """``route(fields)``; under a ``torch.func`` transform through
    ``StencilCall``, whose vmap rule makes one launch of all lanes."""
    if transformed(*fields):
        return StencilCall.apply(route, *fields)
    return route(tuple(fields))


# The verifier's lineage capture (``analysis/lineage.py``) registers
# itself here: a ``meta`` route's outputs are made empty, so the capture
# cannot see what they derive from unless the route reports them.
_meta_hook = None


def set_meta_hook(fn) -> None:
    """Install ``fn(outputs, inputs, name)``, called with every ``meta``
    route's outputs (:func:`meta_outputs`)."""
    global _meta_hook
    _meta_hook = fn


def meta_outputs(name: str, inputs, outs):
    """Report a ``meta`` route's outputs ``outs`` (the verifier's abstract
    run, ``analysis/``: nothing launched) as derived from ``inputs`` by the
    kernel ``name``; returns ``outs``.  Every kernel's ``meta`` route
    returns through here."""
    if _meta_hook is not None:
        _meta_hook(outs, inputs, name)
    return outs


def meta_fields(what: str, name: str, fields, shape):
    """The stencils' ``meta`` route: checks ``fields`` as a launch needs
    them (f32, each of ``shape``: a plane, or ``(lanes, *plane)`` for a
    batched call) and returns one empty output like each, reported by
    :func:`meta_outputs`."""
    for f in fields:
        if f.device.type != "meta" or f.dtype != torch.float32:
            raise ValueError(f"{what}: fields must be f32 meta tensors")
        if tuple(f.shape) != tuple(shape):
            raise ValueError(
                f"{what}: fields must be {tuple(shape)}, got {tuple(f.shape)}")
    return meta_outputs(name, fields, tuple(torch.empty_like(f) for f in fields))


def raise_on_error(what: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
