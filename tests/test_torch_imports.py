"""The port imports neither JAX nor the JAX package.

An AST scan of every module of ``mpi4jax_tpu_torch/`` and of
``chip_smoke.py``: no import of ``jax`` (or ``jaxlib``), none of
``mpi4jax_tpu`` or ``mpi4jax_tpu.*``.  Module names are matched exactly,
since ``mpi4jax_tpu_torch`` starts with ``mpi4jax_tpu``.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mpi4jax_tpu_torch"
FILES = sorted(p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts)
FILES.append(REPO / "chip_smoke.py")
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
    for sub in ("", ".parallel", ".ops", ".models", ".kernels"):
        assert "mpi4jax_tpu_torch" + sub in pkgs
