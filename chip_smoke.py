"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, drives the
main path (the shallow-water solver at 3600x1800 for 0.1 simulated days,
``solve_fused(fast="auto", pinned=True)``), checks that the path launched
the kernels and that its output is right, and prints:

- the card's name and power limit (nvidia-smi), and the versions;
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
  main path, its largest difference from the plain version, its time, the
  plain version's time and the least time the card could take;
- as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero, and prints no result, without a CUDA device or outside
a checkout of the repository.  Every phase raises on failure.
"""

import json
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations per cell and step of csrc/sw_steps.cu, counted from its
# source (a division counts as one)
OPS_PER_CELL_STEP = 107
# the parity band of the JAX suite for the fused kernel against
# model_step_fast (tests/test_examples.py): reordered-arithmetic rounding
BAND_ABS, BAND_REL = 5e-6, 1e-6


def band(ref):
    return BAND_ABS + BAND_REL * ref.abs().max().item()


def time_ms(fn, reps, warmup):
    """Mean device time of one call, from CUDA events around ``reps``
    calls after ``warmup`` calls (enough of them to bring the clocks up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, ref_fields, out_fields, names):
    """Largest absolute difference over the fields; raises outside the
    band."""
    worst = 0.0
    for fname, a, b in zip(names, ref_fields, out_fields):
        if not bool(torch.isfinite(b).all()):
            raise AssertionError(f"{name}: field {fname} is not finite")
        err = (a - b).abs().max().item()
        lim = band(a)
        print(f"  {name} {fname}: max|diff| {err:.3e} (band {lim:.3e})")
        if err > lim:
            raise AssertionError(f"{name}: field {fname} off by {err:.3e} > {lim:.3e}")
        worst = max(worst, err)
    return worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from mpi4jax_tpu_torch.kernels import sw_steps as K
    from mpi4jax_tpu_torch.models.shallow_water import (
        DAY_IN_SECONDS,
        Config,
        State,
        initial_state,
        make_mesh_and_comm,
        make_stepper,
        solve_fused,
    )

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = K.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in (K.BUILD_DIR / "sw_steps.build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())

    dev = torch.device("cuda")
    cfg = Config(nx=3600, ny=1800)
    ny, nx = cfg.ny_local, cfg.nx_local
    _, comm = make_mesh_and_comm(cfg, device=dev)
    names = State._fields

    # -- kernel against plain at full width -------------------------------
    s0 = tuple(initial_state(cfg, device=dev))
    s1 = K.sw_steps_plain(s0, cfg, True, 1)  # AB-2 steps start from here
    cells = ny * nx
    bytes_moved = 12 * cells * 4
    per_case = {}
    worst = 0.0
    for first, nsteps in ((True, 1), (False, 1), (False, 2), (False, 3)):
        inp = s0 if first else s1
        ref = K.sw_steps_plain(inp, cfg, first, nsteps)
        out = K.sw_steps(inp, cfg, first, nsteps)
        torch.cuda.synchronize()
        label = f"sw_steps(first={first}, nsteps={nsteps})"
        worst = max(worst, compare(label, ref, out, names))
        ms = time_ms(lambda: K.sw_steps(inp, cfg, first, nsteps), reps=50, warmup=50)
        plain_ms = time_ms(lambda: K.sw_steps_plain(inp, cfg, first, nsteps),
                           reps=5, warmup=2)
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = OPS_PER_CELL_STEP * nsteps * cells / PEAK_F32_PER_S * 1e3
        per_case[f"first={first},nsteps={nsteps}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms "
              f"({bytes_moved / ms / 1e6:.1f} GB/s achieved)")
    del s0, s1, ref, out

    # -- main path --------------------------------------------------------
    t1 = 0.1 * DAY_IN_SECONDS
    info = {}
    K.counter.launches = 0
    wall, n_steps, final = solve_fused(cfg, t1, device=dev, fast="auto",
                                       pinned=True, return_state=True, info=info)
    launches = K.counter.launches
    per_run = 1 + (n_steps - 1) // 2  # the Euler call and the pair calls
    print(f"main path: {n_steps} steps, wall {wall:.4f} s, "
          f"{n_steps / wall:.2f} steps/s, state traffic "
          f"{12 * cells * 4 * n_steps / wall / 1e9:.1f} GB/s, "
          f"{info['runs']} runs, sw_steps launches {launches}")
    if n_steps != 441 or (n_steps - 1) % 2:
        raise AssertionError(f"expected 441 steps, got {n_steps}")
    if launches != per_run * info["runs"] or launches == 0:
        raise AssertionError(
            f"sw_steps launched {launches} times, expected "
            f"{per_run} x {info['runs']} runs"
        )
    h = final.h
    if tuple(h.shape) != (ny, nx) or not bool(torch.isfinite(h).all()):
        raise AssertionError("final h is not finite at the expected shape")
    for f in final:
        if not bool(torch.isfinite(f).all()):
            raise AssertionError("final state is not finite")
    mean_h = h[1:-1, 1:-1].mean().item()
    print(f"  final h: mean {mean_h:.4f} (depth {cfg.depth}), "
          f"min {h.min().item():.4f}, max {h.max().item():.4f}")
    if not abs(mean_h - cfg.depth) < 10:
        raise AssertionError(f"mean height {mean_h} far from depth {cfg.depth}")
    del final, h

    # the kernel path against the plain fast=True path over 20 steps
    s = initial_state(cfg, device=dev)
    first_k, multi_k = make_stepper(cfg, comm, fast="pallas2")
    first_p, multi_p = make_stepper(cfg, comm, fast=True)
    out_k = multi_k(first_k(s), 19)
    out_p = multi_p(first_p(s), 19)
    torch.cuda.synchronize()
    worst20 = compare("20 steps pallas2 vs fast", out_p, out_k, names)

    pair = per_case["first=False,nsteps=2"]
    kernels = [{
        "name": "sw_steps",
        "route": "cuda",
        "source": "mpi4jax_tpu_torch/csrc/sw_steps.cu",
        "replaces": "examples/shallow_water.py:799",
        "launches": launches,
        "max_abs_err": max(worst, worst20),
        "ms": pair["ms"],
        "plain_ms": pair["plain_ms"],
        "bound_ms": pair["bound_ms"],
        "bound_by": pair["bound_by"],
        "library_ms": None,
        "ok": True,
        "by_case": per_case,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
