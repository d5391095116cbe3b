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

``LaunchCounter`` is the count each wrapper keeps of its kernel's
launches; ``COUNTERS`` lists them by kernel name, so a CUDA-graph runner
can account for the launches a replay makes.
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

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"


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


def build(source: Path, defines: Mapping[str, int] = None,
          headers: Sequence[Path] = (), fmad: bool = False) -> Path:
    """Compile ``source`` for sm_90a into ``_build/`` and return the
    library's path; a library already built from the same bytes is reused.
    ``defines`` become ``-D`` flags; ``headers`` (files the source
    includes) enter the name's hash; ``fmad`` lets the compiler contract
    a multiply and an add into one FMA.  The compiler's output, with
    ``-Xptxas -v``'s register and shared-memory report, goes to
    ``_build/<stem>.build.log``."""
    source = Path(source)
    flags = [f"-D{k}={v}" for k, v in (defines or {}).items()]
    flags.append(f"-fmad={'true' if fmad else 'false'}")
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    for h in headers:
        digest.update(Path(h).read_bytes())
    out = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        *flags, "-o", str(tmp), str(source),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{source.stem}.build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source.name}:\n{res.stderr}")
    os.replace(tmp, out)
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
    lib = ctypes.CDLL(str(build(*spec)))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_cuda_fields(what: str, fields, shape) -> None:
    """The checks of a launch: f32 tensors on one CUDA device, contiguous,
    each of ``shape``."""
    dev = fields[0].device
    for f in fields:
        if f.device != dev or f.dtype != torch.float32:
            raise ValueError(f"{what}: fields must be f32 on one CUDA device")
        if tuple(f.shape) != tuple(shape) or not f.is_contiguous():
            raise ValueError(
                f"{what}: fields must be contiguous {tuple(shape)}, got "
                f"{tuple(f.shape)}"
            )


def raise_on_error(what: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
