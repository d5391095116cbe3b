"""Offline autotuning: ``python -m mpi4jax_tpu_torch.autotune``.

Usage::

    python -m mpi4jax_tpu_torch.autotune --budget-s 60 --save tuning.json
        [--ranks N] [--device cpu] [--json]

Runs the measurement loop (``runner.autotune``) and writes the
``mpx-tuning/1`` file a job loads with ``MPI4JAX_TPU_TUNING``.  With
``--ranks N`` (N > 1) it starts N gloo ranks on ``--device`` (default:
the card, shared by every rank) and rank 0 writes the file; otherwise
this process is the one rank.

Exit codes (the analysis command's contract):

- ``0``: every knob fitted; the saved file validates;
- ``1``: partial: the file was written, but some knobs are untuned
  (listed on stderr).  On one host the alltoall crossover and the codec
  always are: their sweeps time the hierarchical lowerings, which the port
  does not have, so a run here exits 1 with a usable file;
- ``2``: usage error, or the sweeps failed outright (no file).
"""

import argparse
import json
import sys

from .runner import rank_autotune


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.autotune",
        description="measure the performance knobs on the actual ranks and "
                    "emit an mpx-tuning/1 file")
    p.add_argument("--budget-s", type=float, default=60.0,
                   help="wall-clock measurement budget in seconds "
                        "(default 60)")
    p.add_argument("--save", default="tuning.json",
                   help="output path (default tuning.json)")
    p.add_argument("--ranks", type=int, default=1,
                   help="gloo ranks to measure over (default 1: this "
                        "process)")
    p.add_argument("--device", default=None,
                   help="the ranks' device (default: the card)")
    p.add_argument("--topologies", nargs="*", default=[],
                   help="MPI4JAX_TPU_TOPOLOGY specs to sweep the "
                        "flat-vs-hier crossovers for (e.g. 2x2)")
    p.add_argument("--json", action="store_true",
                   help="print the emitted payload to stdout as JSON")
    args = p.parse_args(argv)
    if args.budget_s <= 0 or args.ranks < 1:
        print("autotune: --budget-s must be > 0 and --ranks >= 1",
              file=sys.stderr)
        return 2
    try:
        if args.ranks > 1:
            from ..parallel import launch

            out = launch.run(rank_autotune, args.ranks, device=args.device,
                             timeout=args.budget_s * 4 + 120,
                             args=(args.budget_s, args.save, args.device,
                                   args.topologies))[0]
        else:
            out = rank_autotune(0, args.budget_s, args.save, args.device,
                                args.topologies)
    except Exception as e:
        # any failed run is exit 2: a crash is never a partial fit
        print(f"autotune: failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(out["payload"]))
    print(f"autotune: tuned@{out['stamp']} -> {args.save} "
          f"({len(out['fitted'])} knob(s) fitted, "
          f"{out['elapsed_s']:.1f}s)", file=sys.stderr)
    if out["unfitted"]:
        print("autotune: untuned knob(s): " + ", ".join(out["unfitted"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
