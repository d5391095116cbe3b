"""Benchmark script — prints ONE JSON line.

Counterpart of the root ``bench.py``.  Workload: the shallow-water solver
at 3600 x 1800 interior, 0.1 simulated days, on one GPU, through
``solve_fused(fast="auto", pinned=True)``: the whole run is one CUDA graph,
timed after a warm-up, best of two.  A second run five times as long gives
the per-step slope, which cancels the fixed cost of each run.

    python -m mpi4jax_tpu_torch.bench
"""

from __future__ import annotations

import json

import torch

from .models.shallow_water import DAY_IN_SECONDS, Config, solve_fused


def run(device=None) -> dict:
    cfg = Config(nx=3600, ny=1800)
    t1 = 0.1 * DAY_IN_SECONDS
    info1, info5 = {}, {}
    wall, n_steps = solve_fused(cfg, t1, device=device, fast="auto",
                                pinned=True, info=info1)
    wall5, n_steps5 = solve_fused(cfg, 5 * t1, device=device, fast="auto",
                                  pinned=True, info=info5)
    per_step = (wall5 - wall) / (n_steps5 - n_steps)

    # state-traffic model: each step must at least read and write the six
    # (ny_l, nx_l) f32 state fields — a lower bound on the real traffic
    field_bytes = cfg.ny_local * cfg.nx_local * 4
    gbps = 12 * field_bytes * n_steps / wall / 1e9
    name = torch.cuda.get_device_name(device)
    out = {
        "metric": "shallow-water steps/sec/chip (3600x1800, 0.1 days)",
        "value": round(n_steps / wall, 2),
        "unit": "steps/s/chip",
        "state_traffic_gb_per_s": round(gbps, 1),
        "wall_s": round(wall, 3),
        "n_steps": n_steps,
        # both timed runs replayed a captured CUDA graph
        "pinned": bool(info1.get("pinned") and info5.get("pinned")),
        "environment": f"1-device {name}; no interconnect measured",
    }
    if per_step > 0:
        out["onchip_steps_per_s_per_chip"] = round(1 / per_step, 2)
        out["dispatch_overhead_s"] = round(wall - n_steps * per_step, 4)
    return out


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
