"""The port's lint pack: the twin of ``tests/test_lint.py`` over
``mpi4jax_tpu_torch/`` and ``chip_smoke.py``, which that pack does not
scan.

- no unused imports (the same ``# noqa`` waivers);
- every ``MPI4JAX_TPU_*`` name the port's sources spell out (a read, a
  write, an environment dict's key or keyword) is declared in the port's
  registry, ``mpi4jax_tpu_torch/utils/config.py:FLAGS``, whose entries are
  well formed;
- the MPX codes the port's sources use are the port's catalog
  (``analysis/report.py:CODES``), and every ERROR code has a positive in
  ``mpi4jax_tpu_torch/models/broken/`` or in ``tests/test_torch_*.py``;
- the README's port section lists every declared flag.
"""

import ast
import pathlib
import re

import pytest

pytest.importorskip("torch")

from mpi4jax_tpu_torch.analysis import report  # noqa: E402
from mpi4jax_tpu_torch.utils import config  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mpi4jax_tpu_torch"

SOURCES = sorted(p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts) + [
    REPO / "chip_smoke.py"]
# the re-export modules, which the JAX pack exempts too
IMPORT_SOURCES = [p for p in SOURCES if p.name != "__init__.py"]

_FLAG_RE = re.compile(r"^MPI4JAX_TPU_[A-Z0-9_]*[A-Z0-9]$")
_MPX_RE = re.compile(r"MPX\d{3}")


def _rel(path):
    return str(path.relative_to(REPO))


def _imported_names(tree, src_lines):
    """(name, lineno) for every binding an import statement introduces,
    skipping statements with a bare ``# noqa`` or one naming F401."""
    waiver = re.compile(r"#\s*noqa(\s*$|:[^#]*\bF401\b)")
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        stmt_lines = range(node.lineno, (node.end_lineno or node.lineno) + 1)
        if any(waiver.search(src_lines[i - 1]) for i in stmt_lines):
            continue
        for alias in node.names:
            if alias.name != "*":
                out.append((alias.asname or alias.name.split(".")[0], node.lineno))
    return out


@pytest.mark.parametrize("path", IMPORT_SOURCES, ids=_rel)
def test_no_unused_imports(path):
    src = path.read_text()
    tree = ast.parse(src)
    used = {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}
    # names listed in __all__ count as used
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            used |= {el.value for el in ast.walk(node.value)
                     if isinstance(el, ast.Constant) and isinstance(el.value, str)}
    unused = [f"{_rel(path)}:{line}: {name}"
              for name, line in _imported_names(tree, src.splitlines())
              if name not in used]
    assert not unused, "unused imports:\n" + "\n".join(unused)


def _flag_names(tree):
    """(name, lineno) of every ``MPI4JAX_TPU_*`` name spelled out whole: a
    string literal (a read's or write's key, an environment dict's key) or
    a keyword argument (``dict(os.environ, MPI4JAX_TPU_X=...)``)."""
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and _FLAG_RE.match(node.value)):
            out.append((node.value, node.lineno))
        elif isinstance(node, ast.keyword) and node.arg and _FLAG_RE.match(node.arg):
            out.append((node.arg, node.value.lineno))
    return out


@pytest.mark.parametrize("path", SOURCES, ids=_rel)
def test_no_undeclared_env_flags(path):
    undeclared = [f"{_rel(path)}:{line}: {name}"
                  for name, line in _flag_names(ast.parse(path.read_text()))
                  if name not in config.FLAGS]
    assert not undeclared, (
        "undeclared environment flags (declare them in "
        "mpi4jax_tpu_torch/utils/config.py FLAGS):\n" + "\n".join(undeclared))


def test_registry_flags_are_wellformed():
    for name, flag in config.FLAGS.items():
        assert _FLAG_RE.match(name) and flag.name == name, name
        assert flag.type in ("bool", "float", "int", "str", "choice"), name
        assert flag.doc.strip(), f"{name} needs a docstring"
        if flag.type == "choice":
            assert flag.choices and flag.default in flag.choices, name
        else:
            assert flag.choices is None, name


def test_mpx_codes_sync():
    """Every MPX code the port's sources name is in its catalog, and every
    catalog code is raised or annotated somewhere in the port."""
    where = {}
    for path in SOURCES:
        if path == PORT / "analysis" / "report.py":
            continue  # the declaration site itself proves nothing
        for code in _MPX_RE.findall(path.read_text()):
            where.setdefault(code, _rel(path))
    undeclared = sorted(set(where) - set(report.CODES))
    assert not undeclared, ("MPX codes used in the port but not in "
                            "analysis/report.py CODES: "
                            + ", ".join(f"{c} ({where[c]})" for c in undeclared))
    unreferenced = sorted(set(report.CODES) - set(where))
    assert not unreferenced, ("MPX codes in analysis/report.py CODES that no "
                              "port source raises or annotates: "
                              + ", ".join(unreferenced))


def test_every_error_code_has_a_seeded_positive():
    """Every ERROR code of the catalog fires somewhere: a broken twin under
    ``models/broken/`` or a positive in the port's tests."""
    error_codes = {c for c, info in report.CODES.items()
                   if info.severity == report.ERROR}
    seeded = "\n".join(p.read_text() for p in sorted(
        (PORT / "models" / "broken").glob("*.py")))
    seeded += "\n".join(p.read_text() for p in sorted(
        (REPO / "tests").glob("test_torch_*.py")) if p.name != "test_torch_lint.py")
    uncovered = sorted(c for c in error_codes if c not in seeded)
    assert not uncovered, ("ERROR codes with neither a broken twin nor a "
                           "positive in tests/test_torch_*.py: "
                           + ", ".join(uncovered))


def _readme_port_section():
    text = (REPO / "README.md").read_text()
    start = text.index("\n## PyTorch/CUDA port\n")
    end = text.find("\n## ", start + 1)
    return text[start:end if end != -1 else len(text)]


def test_readme_lists_every_flag():
    section = _readme_port_section()
    missing = [name for name in config.FLAGS if f"`{name}`" not in section]
    assert not missing, ("flags declared in mpi4jax_tpu_torch/utils/config.py "
                         "but absent from the README's port section: "
                         + ", ".join(missing))
