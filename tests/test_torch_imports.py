"""The port imports neither JAX nor the JAX package.

An AST scan of every module of ``mpi4jax_tpu_torch/``, of
``chip_smoke.py`` and of the rank programs (``tests/torch_ranks.py``,
``tests/torch_ranks_ops.py``, ``tests/torch_ranks_throughput.py``,
``tests/torch_ranks_dispatch.py`` and the later ones, to
``tests/torch_ranks_transforms.py``): no import of ``jax`` (or ``jaxlib``), none of
``mpi4jax_tpu`` or ``mpi4jax_tpu.*``.  Module names are matched exactly,
since ``mpi4jax_tpu_torch`` starts with ``mpi4jax_tpu``.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mpi4jax_tpu_torch"
FILES = sorted(p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts)
# the smoke script, and the rank programs every test rank imports afresh
FILES += [REPO / "chip_smoke.py", REPO / "tests" / "torch_ranks.py",
          REPO / "tests" / "torch_ranks_ops.py",
          REPO / "tests" / "torch_ranks_throughput.py",
          REPO / "tests" / "torch_ranks_dispatch.py",
          REPO / "tests" / "torch_ranks_runtime.py",
          REPO / "tests" / "torch_ranks_health.py",
          REPO / "tests" / "torch_ranks_elastic.py",
          REPO / "tests" / "torch_ranks_workloads.py",
          REPO / "tests" / "torch_ranks_serving.py",
          REPO / "tests" / "torch_ranks_aot.py",
          REPO / "tests" / "torch_ranks_analysis.py",
          REPO / "tests" / "torch_ranks_hierarchy.py",
          REPO / "tests" / "torch_ranks_transforms.py",
          REPO / "tests" / "torch_ranks_kernel_transforms.py"]
FORBIDDEN = ("jax", "jaxlib", "mpi4jax_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def forbidden_imports(src: str):
    """Absolute module names ``src`` imports that the port must not."""
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("src,bad", [
    ("import jax", ["jax"]),
    ("import jax.numpy as jnp", ["jax.numpy"]),
    ("from jax import lax", ["jax"]),
    ("import mpi4jax_tpu", ["mpi4jax_tpu"]),
    ("from mpi4jax_tpu.ops import sendrecv", ["mpi4jax_tpu.ops"]),
    ("import mpi4jax_tpu_torch", []),
    ("from mpi4jax_tpu_torch.ops import gather", []),
    ("from .ops import gather", []),
    ("import jaxtyping", []),
])
def test_scanner_matches_module_names_exactly(src, bad):
    assert forbidden_imports(src) == bad


def test_port_is_packaged():
    from setuptools import find_packages

    pkgs = find_packages(str(REPO), include=["mpi4jax_tpu*"])
    for sub in ("", ".parallel", ".ops", ".models", ".kernels", ".experimental",
                ".utils", ".aot", ".telemetry", ".resilience", ".analysis",
                ".models.broken"):
        assert "mpi4jax_tpu_torch" + sub in pkgs


@pytest.mark.parametrize("module", ["mpi4jax_tpu_torch.aot", "mpi4jax_tpu_torch.aot.keys",
                                    "mpi4jax_tpu_torch.aot.invalidation",
                                    "mpi4jax_tpu_torch.aot.pinning",
                                    "mpi4jax_tpu_torch.parallel.megastep",
                                    "mpi4jax_tpu_torch.native",
                                    "mpi4jax_tpu_torch.telemetry",
                                    "mpi4jax_tpu_torch.telemetry.merge",
                                    "mpi4jax_tpu_torch.resilience",
                                    "mpi4jax_tpu_torch.resilience.elastic",
                                    "mpi4jax_tpu_torch.resilience.drill",
                                    "mpi4jax_tpu_torch.models.elastic_training",
                                    "mpi4jax_tpu_torch.models.runtime_drill",
                                    "mpi4jax_tpu_torch.utils.debug",
                                    "mpi4jax_tpu_torch.parallel.moe",
                                    "mpi4jax_tpu_torch.parallel.pipeline",
                                    "mpi4jax_tpu_torch.models.moe_training",
                                    "mpi4jax_tpu_torch.models.pipeline_parallel",
                                    "mpi4jax_tpu_torch.aot.diskcache",
                                    "mpi4jax_tpu_torch.aot.serialization",
                                    "mpi4jax_tpu_torch.aot.fastpath",
                                    "mpi4jax_tpu_torch.aot.warm",
                                    "mpi4jax_tpu_torch.aot.__main__",
                                    "mpi4jax_tpu_torch.models.aot_serving_step",
                                    "mpi4jax_tpu_torch.models.telemetry_demo",
                                    "mpi4jax_tpu_torch.analysis",
                                    "mpi4jax_tpu_torch.analysis.__main__",
                                    "mpi4jax_tpu_torch.analysis.crossrank",
                                    "mpi4jax_tpu_torch.analysis.hazards",
                                    "mpi4jax_tpu_torch.analysis.progress",
                                    "mpi4jax_tpu_torch.models.broken",
                                    "mpi4jax_tpu_torch.models.broken.rank_divergent_deadlock",
                                    "mpi4jax_tpu_torch.models.broken.overlap_donation_race"])
def test_dispatch_layer_loads_no_jax(module):
    """The dispatch layer's modules, imported in a fresh interpreter, load
    neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mpi4jax_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
