"""The stencil kernels' CUDA sources built for the host, and their layout.

``csrc/sw_steps.cu``, ``csrc/sw_wide.cu`` and ``csrc/sw_phase.cu`` (all on
the streamed rows of ``csrc/sw_stream.cuh``) are compiled with the host
C++ compiler against the emulation in ``mpi4jax_tpu_torch/csrc/host/`` (a
block's threads as coroutines meeting at every barrier, ``cp.async`` a
plain copy), with the build's geometry flags and ``-ffp-contract=off``, so
that they round as ``nvcc -fmad=false`` builds them and lay out their
blocks as on an H100 (the occupancy stubs model its residency).  ``host_libs`` builds them once
a test process; ``steps_blocks``, ``wide_blocks`` and ``phase_blocks`` ask
the sources for their blocks, which the PyTorch tiling emulations
(``tests/test_torch_sw_kernel.py``, ``test_torch_sw_wide.py``) replay and
the geometry tests lay out.
"""

import ctypes
import shutil
import subprocess

import pytest

from mpi4jax_tpu_torch.kernels import sw_phase as KP
from mpi4jax_tpu_torch.kernels import sw_steps as K
from mpi4jax_tpu_torch.kernels import sw_wide as KW
from test_torch_warp_emulation import HOST, emulated_source

_BUILT = {}


def host_libs(tmp_path_factory):
    """``{"sw_steps": library, "sw_wide": library, "sw_phase": library}``
    built for the host; skips the test where no C++ compiler is found."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    if _BUILT:
        return _BUILT
    out = tmp_path_factory.mktemp("sw_host")
    for f in K.HEADERS:
        (out / f.name).write_text(emulated_source(f.read_text()))
    for mod in (K, KW, KP):
        src = out / mod.SOURCE.name
        src.write_text(emulated_source(mod.SOURCE.read_text())
                       + "\nnamespace { float4 smem4[EMU_SMEM_MAX / 16]; }\n")
        lib = out / f"lib{mod.SOURCE.stem}.so"
        defines = [f"-D{k}={v}" for k, v in mod.spec()[1].items()]
        subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                        "-w", "-I", str(HOST), *defines, "-o", str(lib), "-x", "c++",
                        str(src)], check=True)
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in mod._SIGNATURES.items():
            getattr(cdll, fn).argtypes = list(argtypes)
            getattr(cdll, fn).restype = ctypes.c_int
        _BUILT[mod.SOURCE.stem] = cdll
    return _BUILT


def steps_blocks(lib, ny, nx, nsteps):
    """``sw_steps``' blocks on a local array ``(ny, nx)``, as the source
    lays them out: ``(oy, h, ox, w, my, mx)`` each, and its geometry."""
    out, blocks = K.query_geometry(lib.sw_steps_geometry, ny, nx, nsteps, blocks=True)
    return blocks, dict(zip(K.GEOMETRY_KEYS, out))


def wide_blocks(lib, cfg, shape, nsteps):
    """``sw_wide``'s blocks over the crop of a frame of ``shape``, and its
    geometry."""
    cy, cx, rows, cols = KW.crop_region(cfg, shape)
    out, blocks = K.query_geometry(lib.sw_wide_geometry, shape[0], shape[1], cy, cx, rows,
                                   cols, nsteps, blocks=True)
    return blocks, dict(zip(K.GEOMETRY_KEYS, out))


def phase_blocks(lib, ny, nx, phase):
    """Phase ``phase``'s blocks on a local array ``(ny, nx)`` (its whole
    output), and its geometry."""
    out, blocks = K.query_geometry(lib.sw_phase_geometry, ny, nx, phase, blocks=True)
    return blocks, dict(zip(K.GEOMETRY_KEYS, out))
