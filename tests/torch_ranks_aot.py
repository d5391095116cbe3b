"""Rank programs of the persistent tier's multi-rank tests.

They run on gloo ranks that ``mpi4jax_tpu_torch.parallel.launch.run``
starts, each a fresh process: a second world started with the same cache
directory is the cold start of a second process.  Like every rank
program, this module imports only torch, numpy and the port.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from mpi4jax_tpu_torch import SUM, Comm, allreduce, make_world_mesh, varying

# the fake compiler of the build tests: answers --version, and builds the
# (plain C++) source it is given into the -o library with g++
FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then echo "fake nvcc for the tier tests 0.0"; exit 0; fi
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    -gencode|-Xptxas|-Xcompiler) shift 2;;
    -*) shift;;
    *) src="$1"; shift;;
  esac
done
exec g++ -x c++ -shared -fPIC -o "$out" "$src"
"""

STUB_SOURCE = 'extern "C" int fake_launch(void) { return 7; }\n'


def make_fake_nvcc(root) -> Path:
    """``root/bin/nvcc``, the fake compiler, and ``root/stub.cu``; returns
    the root (a ``CUDA_HOME``)."""
    root = Path(root)
    (root / "bin").mkdir(parents=True, exist_ok=True)
    nvcc = root / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    (root / "stub.cu").write_text(STUB_SOURCE)
    return root


def use_fake_nvcc(root) -> None:
    """Put the fake compiler first: ``CUDA_HOME`` and ``PATH``."""
    os.environ["CUDA_HOME"] = str(root)
    os.environ["PATH"] = str(Path(root) / "bin") + os.pathsep + os.environ["PATH"]


def _comm(device):
    mesh = make_world_mesh(device=device)
    return Comm(mesh.axes[0], mesh=mesh)


def _tier_stats() -> dict:
    from mpi4jax_tpu_torch import aot

    return {k: v for k, v in aot.diskcache.stats().items() if k != "dir"}


def cold_start_step(v):
    """The JAX cold-start test's program: a SUM allreduce, halved."""
    return varying(allreduce(v, op=SUM)[0] * 0.5)


def cold_start_program(rank, cache_dir, device="cpu"):
    """Pin ``cold_start_step`` on (16,) f32 of 1.5 with the tier at
    ``cache_dir`` and call it once: ``from_disk``, the output and the
    tier's counters."""
    import mpi4jax_tpu_torch as tpx

    os.environ["MPI4JAX_TPU_COMPILE_CACHE_DIR"] = str(cache_dir)
    comm = _comm(device)
    x = torch.full((16,), 1.5, dtype=torch.float32, device=comm.device)
    pinned = tpx.compile(cold_start_step, x, comm=comm)
    out = pinned(x)
    return {"from_disk": pinned.from_disk, "out": out.cpu(),
            "aot": tpx.aot.stats()["aot"], **_tier_stats()}


def race_program(rank, tier, build_root, fake_root):
    """Every rank builds the one stub library into its own build directory
    at the same moment, through one tier: each loads a working library."""
    from mpi4jax_tpu_torch.kernels import _build

    os.environ["MPI4JAX_TPU_COMPILE_CACHE_DIR"] = str(tier)
    use_fake_nvcc(fake_root)
    _build.BUILD_DIR = Path(build_root) / f"rank{rank}"
    dist.barrier()
    path = _build.build(Path(fake_root) / "stub.cu", {"RACE": 1})
    lib = ctypes.CDLL(str(path))
    value = lib.fake_launch()
    dist.barrier()
    return {"value": value, "name": path.name,
            "compiles": _build.stats()["compiles"], **_tier_stats()}


def decode_step_program(rank, x, w, device="cpu"):
    """``models/aot_serving_step.decode_step`` on this rank's shard of the
    global ``x`` and ``w`` (numpy, leading rank axis)."""
    from mpi4jax_tpu_torch.models import aot_serving_step as AS
    from mpi4jax_tpu_torch.parallel.region import spmd

    comm = _comm(device)
    xs = torch.from_numpy(np.ascontiguousarray(x[rank])).to(comm.device)
    ws = torch.from_numpy(np.ascontiguousarray(w[rank])).to(comm.device)
    return {"out": spmd(comm=comm)(AS.decode_step)(xs, ws).cpu()}


def telemetry_demo_program(rank, tdir, device="cpu"):
    """The telemetry demo twin on this rank: its snapshot's op rows and
    the report's text."""
    from mpi4jax_tpu_torch.models import telemetry_demo as TD

    res = TD.rank_main(rank, device, tdir=str(tdir))
    return {"ops": res["snapshot"]["ops"], "report": res["report"]}


def SW_CFG():
    """The small periodic config of the card's record test."""
    from mpi4jax_tpu_torch.models import shallow_water as P

    return P.Config(nx=512, ny=256)


def sw_pair(h, u, v, dh, du, dv):
    """Two AB-2 steps of ``sw_steps`` (a kernel library the pin's record
    names on the card; the plain version on the CPU)."""
    from mpi4jax_tpu_torch.kernels import sw_steps as K

    return K.sw_steps((h, u, v, dh, du, dv), SW_CFG(), False, 2)
