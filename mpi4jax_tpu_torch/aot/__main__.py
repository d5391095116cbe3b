"""The persistent tier's command: ``python -m mpi4jax_tpu_torch.aot warm``.

PyTorch counterpart of ``mpi4jax_tpu/aot/__main__.py``.  ``warm MANIFEST``
fills the persistent tier (``MPI4JAX_TPU_COMPILE_CACHE_DIR``) from a
program manifest ahead of the first job, so that every later process
builds nothing (``warm.py``).

``--emit-manifest`` writes the manifest instead of reading one: the
serving runtime's bucket table expands into one entry per (phase, bucket)
program (``serving.warm_manifest``), so that one ``emit`` and one
``warm`` prepare everything a serving deployment asks for and its first
run reports ``disk_cache.misses == 0``::

    python -m mpi4jax_tpu_torch.aot warm --emit-manifest serving.json
    MPI4JAX_TPU_COMPILE_CACHE_DIR=... \\
      python -m mpi4jax_tpu_torch.aot warm serving.json

The port's additions: ``--model`` takes the serving twin's preset
(``models/serving.py:PRESETS``; the default is the
``MPI4JAX_TPU_SERVING_*`` configuration), and ``--device`` the device
the programs are pinned on (the GPU by default; ``cpu`` on a host
without one).  ``--world`` defaults to the ranks of the process group
this process is in, one without it.

Exit codes: 0 every program warmed (or the manifest was emitted); 1 some
program failed to import or pin (the rest were still attempted and the
failures are listed); 2 the manifest is unreadable or malformed, the
directory is unset, or the serving configuration cannot be emitted.
"""

from __future__ import annotations

import argparse
import json
import sys


def _default_world() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _emit_manifest(args) -> int:
    from ..serving.engine import ServingConfig, warm_manifest

    overrides = {}
    if args.model:
        from ..models.serving import PRESETS

        overrides.update(PRESETS[args.model])
    if args.max_batch:
        overrides["max_batch"] = args.max_batch
    if args.unroll:
        overrides["unroll"] = args.unroll
    try:
        cfg = ServingConfig.from_env(**overrides)
        world = args.world if args.world is not None else _default_world()
        manifest = warm_manifest(cfg, world)
        with open(args.manifest, "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
    except (ValueError, RuntimeError, OSError) as e:
        # any emit failure (a bad configuration, a world that cannot shard
        # it, an unwritable path) is the unusable-manifest exit (2), never
        # the partial-warm one (1)
        print(f"warm --emit-manifest: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"manifest": args.manifest, "world": world,
                          "programs": len(manifest["programs"])}))
    else:
        print(f"emitted {len(manifest['programs'])} serving program(s) "
              f"(world {world}) to {args.manifest}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.aot",
        description="the persistent tier's tools",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    warm_p = sub.add_parser(
        "warm",
        help="fill MPI4JAX_TPU_COMPILE_CACHE_DIR from a program manifest "
             "(a function's import path and its arguments' shapes a "
             "program), or --emit-manifest one from the serving bucket table",
    )
    warm_p.add_argument("manifest",
                        help="path to the manifest JSON (the OUTPUT path "
                             "under --emit-manifest)")
    warm_p.add_argument("--json", action="store_true",
                        help="machine-readable result payload on stdout")
    warm_p.add_argument("--emit-manifest", action="store_true",
                        help="write the serving manifest (one entry per "
                             "(phase, bucket) program of the "
                             "MPI4JAX_TPU_SERVING_* configuration) to "
                             "MANIFEST and exit")
    warm_p.add_argument("--world", type=int, default=None,
                        help="--emit-manifest: the tensor-parallel world "
                             "size the deployment runs at (default: this "
                             "process group's, 1 without one)")
    warm_p.add_argument("--max-batch", type=int, default=0,
                        help="--emit-manifest: override "
                             "MPI4JAX_TPU_SERVING_MAX_BATCH")
    warm_p.add_argument("--unroll", type=int, default=0,
                        help="--emit-manifest: override "
                             "MPI4JAX_TPU_SERVING_UNROLL")
    warm_p.add_argument("--model", default="", choices=("", "tiny", "bench"),
                        help="--emit-manifest: the serving twin's preset "
                             "(default: the MPI4JAX_TPU_SERVING_* "
                             "configuration)")
    warm_p.add_argument("--device", default=None,
                        help="the device programs are pinned on (default: "
                             "the GPU)")
    args = parser.parse_args(argv)

    if args.emit_manifest:
        return _emit_manifest(args)

    from .warm import warm_from_manifest

    if args.device is not None:
        from ..parallel.mesh import make_world_mesh, set_default_mesh

        set_default_mesh(make_world_mesh(device=args.device))
    code, payload = warm_from_manifest(args.manifest)
    if args.json:
        print(json.dumps(payload))
    else:
        if "error" in payload:
            print(f"warm: {payload['error']}", file=sys.stderr)
        else:
            for row in payload["programs"]:
                src = "disk" if row["from_disk"] else "built"
                extra = f", unroll={row['unroll']}" if row["unroll"] > 1 else ""
                print(f"warmed {row['fn']} ({src}{extra}, "
                      f"{row['pin_wall_s']}s)")
            for row in payload["failures"]:
                print(f"FAILED {row['fn']}: {row['error']}", file=sys.stderr)
            print(f"warm: {payload['warmed']} warmed, "
                  f"{payload['failed']} failed")
    return code


if __name__ == "__main__":
    sys.exit(main())
