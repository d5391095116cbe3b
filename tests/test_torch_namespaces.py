"""Each subpackage of the port exports the JAX subpackage's public names.

The top-level ``__all__`` is pinned in ``tests/test_torch_health.py``;
this file pins every subpackage both packages have.  A subpackage's
public names are its ``__all__`` where it has one, else the names its
``__init__.py`` binds (imports, definitions, assignments) that do not
start with an underscore, read from the source of both packages.  What
differs is listed here, each with its reason: a difference by design,
never a name left out by accident.
"""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

# names of the JAX subpackage the port does not have, and why
JAX_ONLY = {
    "utils": {
        # the JAX package's guard of its JAX version; the port runs no JAX
        "check_jax_version",
        # the dtype gate of XLA-typed collectives; the port's ops take the
        # dtypes torch.distributed moves, and each reduction its own
        "SUPPORTED_DTYPES",
        "check_dtype",
        # the JAX ops' argument-type decorator; the port's ops check their
        # comm and root inline (ops/_base.py:check_comm, check_root)
        "enforce_types",
        # whether tokens thread through optimization_barrier chains; the
        # port runs eagerly, program order is its ordering, so there is
        # nothing to switch
        "prefer_notoken",
    },
}

# names of the port's subpackage the JAX one does not export, and why
PORT_ONLY = {
    # the ops' flush, which the JAX package exports at the top level only
    "ops": {"flush"},
    # the profiler capture, which the JAX package keeps in
    # utils/profiling.py without re-exporting it
    "utils": {"ProfileSummary", "profile_ops"},
    # the pure in-process chaos drills (resilience/drill.py), which the JAX
    # package has as a module without listing it in __all__
    "resilience": {"drill"},
}

SUBPACKAGES = ("parallel", "ops", "utils", "resilience", "kernels",
               "experimental", "aot", "telemetry", "serving")


def public_names(package: str, sub: str) -> set:
    """The public names of ``package.sub`` from its ``__init__.py``."""
    tree = ast.parse((REPO / package / sub / "__init__.py").read_text())
    bound, declared = set(), None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            bound.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    if target.id == "__all__":
                        declared = set(ast.literal_eval(node.value))
                    bound.add(target.id)
    if declared is not None:
        return declared
    return {n for n in bound if not n.startswith("_")}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names_equal_jax_but_for_the_listed_differences(sub):
    jax_names = public_names("mpi4jax_tpu", sub)
    port_names = public_names("mpi4jax_tpu_torch", sub)
    assert jax_names - port_names == JAX_ONLY.get(sub, set())
    assert port_names - jax_names == PORT_ONLY.get(sub, set())
    module = importlib.import_module(f"mpi4jax_tpu_torch.{sub}")
    for name in port_names:
        assert getattr(module, name) is not None, name


def test_reexports_are_the_ports_own_objects():
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import experimental, kernels, ops, parallel, resilience
    from mpi4jax_tpu_torch.kernels import flash_attention
    from mpi4jax_tpu_torch.resilience import elastic

    assert parallel.Comm is tpx.Comm and parallel.spmd is tpx.spmd
    assert parallel.shift is tpx.shift and parallel.run is tpx.run
    assert ops.allreduce_start is tpx.allreduce_start
    assert ops.cache_stats is tpx.cache_stats and ops.varying is tpx.varying
    assert kernels.flash_block_partials is flash_attention.flash_block_partials
    assert experimental.notoken.allreduce is not None
    assert resilience.gossip_agreement is elastic.gossip_agreement
    assert resilience.stripe_placement is elastic.stripe_placement
    assert parallel.invert_pairs(((0, 1), (2, 0))) == ((0, 2), (1, 0))
