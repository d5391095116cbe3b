"""``python -m mpi4jax_tpu_torch.analysis``: the JAX command's exit-code
contract on the port.

Each case runs the command in a fresh interpreter on a small script (the
command sets ``MPI4JAX_TPU_ANALYZE`` in its own process):

- **0**: every script analyzed and no error-severity finding (a clean
  region, a script ending in ``sys.exit(0)``, advisories alone);
- **1**: an error-severity finding (an ambient report, an MPX-tagged
  raise, each broken twin of ``models/broken/`` with its code; advisories
  under ``--strict-advisories``);
- **2**: a usage error (no script, an unknown option, ``--cost`` and
  ``--cost-model`` until the port's cost model), or a script that fails
  outside the verifier (an untagged exception, ``sys.exit(3)``).
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from mpi4jax_tpu_torch.models import broken  # noqa: E402

pytest_plugins = ["leaked_env_guard"]

REPO = pathlib.Path(__file__).resolve().parents[1]

PROLOGUE = """
import torch
import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch.parallel.comm import Comm
from mpi4jax_tpu_torch.parallel.mesh import make_world_mesh

comm = Comm("x", mesh=make_world_mesh(axes=("x",), device="cpu"))
x = torch.ones(4)
"""

SCRIPTS = {
    "clean": """
@tpx.spmd(comm=comm)
def step(v):
    y, _ = tpx.allreduce(v)
    return tpx.sendrecv(y, y, dest=tpx.shift(1))[0]

assert step(x).tolist() == [1.0] * 4
""",
    "clean_exit0": """
import sys
tpx.allreduce(x, comm=comm)
sys.exit(0)
""",
    "advisory": """
@tpx.spmd(comm=comm)
def step(v):
    a, _ = tpx.allreduce(v)
    b, _ = tpx.allreduce(v)
    return a + b

step(x)
""",
    "unmatched": """
@tpx.spmd(comm=comm)
def step(v):
    tpx.send(v, tpx.shift(1))
    return v

step(x)
""",
    "tagged": """
tpx.bcast(x, root=5, comm=comm)
""",
    "untagged": """
raise KeyError("not the verifier's")
""",
    "exit3": """
import sys
sys.exit(3)
""",
}


def run_cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for k in ("MPI4JAX_TPU_ANALYZE", "MPI4JAX_TPU_ANALYZE_RANKS",
              "MPI4JAX_TPU_ANALYZE_COST", "MPI4JAX_TPU_COST_MODEL",
              "MPI4JAX_TPU_TUNING"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", "mpi4jax_tpu_torch.analysis",
                           *map(str, args)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def script(tmp_path, name):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(PROLOGUE) + textwrap.dedent(SCRIPTS[name]))
    return path


@pytest.mark.parametrize("name,code", [("clean", 0), ("clean_exit0", 0),
                                       ("advisory", 0), ("unmatched", 1),
                                       ("tagged", 1), ("untagged", 2),
                                       ("exit3", 2)])
def test_exit_codes(tmp_path, name, code):
    res = run_cli("--json", script(tmp_path, name))
    assert res.returncode == code, res.stderr[-2000:]
    payload = json.loads(res.stdout)
    status = payload["scripts"][str(script(tmp_path, name))]
    # a script whose reports hold only advisories exits 0 as "findings"
    want = "findings" if name == "advisory" else \
        {0: "ok", 1: "findings", 2: "trace-failure"}[code]
    assert status == want
    assert set(payload) == {"scripts", "errors", "advisories", "reports"}


def test_json_names_the_codes_and_strict_advisories_fail(tmp_path):
    res = run_cli("--json", script(tmp_path, "unmatched"))
    payload = json.loads(res.stdout)
    assert payload["errors"] == 1
    assert [r["codes"] for r in payload["reports"]] == [{"MPX101": 1}]
    adv = script(tmp_path, "advisory")
    assert run_cli(adv).returncode == 0
    strict = run_cli("--strict-advisories", "--json", adv)
    assert strict.returncode == 1
    assert json.loads(strict.stdout)["advisories"] == 1


@pytest.mark.parametrize("args", [(), ("--bogus", "x.py"), ("--ranks",)])
def test_usage_errors_exit_2(args):
    res = run_cli(*args)
    assert res.returncode == 2
    assert "usage: python -m mpi4jax_tpu_torch.analysis" in res.stderr


@pytest.mark.parametrize("flags", [("--cost",),
                                   ("--cost", "--cost-model", "MODEL")])
def test_cost_flags_report_a_breakdown(tmp_path, flags):
    """``--cost`` reports every region with its ``cost`` breakdown, clean
    ones too; ``--cost-model`` prices it with the file's parameters."""
    model = tmp_path / "m.json"
    model.write_text(json.dumps({
        "schema": "mpx-cost-model/1",
        "links": {"ici": {"alpha_us": 123.0, "gb_per_s": 1.0}}}))
    flags = tuple(str(model) if f == "MODEL" else f for f in flags)
    res = run_cli("--ranks", "4", "--json", *flags,
                  script(tmp_path, "advisory"))
    assert res.returncode == 0, res.stderr
    from mpi4jax_tpu_torch.analysis.costmodel import DEFAULT_PARAMS

    reports = json.loads(res.stdout)["reports"]
    costs = [r["cost"] for r in reports if r.get("cost")]
    assert costs and all(c["total_us"] > 0 for c in costs)
    alpha = costs[0]["params"]["links"]["ici"]["alpha_us"]
    assert alpha == (123.0 if "--cost-model" in flags
                     else DEFAULT_PARAMS["links"]["ici"]["alpha_us"])


@pytest.mark.parametrize("name", broken.TWINS)
def test_broken_twin_exits_1_with_its_code(name):
    twin = __import__(f"mpi4jax_tpu_torch.models.broken.{name}",
                      fromlist=["CODES"])
    path = REPO / "mpi4jax_tpu_torch" / "models" / "broken" / f"{name}.py"
    res = run_cli("--ranks", "4", "--json", path)
    assert res.returncode == 1, res.stderr[-2000:]
    payload = json.loads(res.stdout)
    codes = {c for r in payload["reports"] for c in r["codes"]}
    assert twin.CODES & codes
    assert payload["scripts"] == {str(path): "findings"}
