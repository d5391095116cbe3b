"""The telemetry demo twin against ``examples/telemetry_demo.py``.

Four gloo ranks run ``models/telemetry_demo.py`` (the step five times
under ``events``); the JAX example runs in its own process on a 4-device
CPU mesh.  Held, exactly: the same three rows (allreduce, bcast,
sendrecv; f32, the native algorithm), each with the JAX row's execution
count and bytes.  The port counts every call and the JAX package once a
trace (ROADMAP, "Per-call counting"), so a port rank's ``calls`` are the
JAX row's executions a rank (its latency count over the ranks) and its
bytes that many times the JAX row's bytes a call; the merged report's
``execs`` column is the JAX table's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch_ranks as R0  # noqa: E402
import torch_ranks_aot as RA  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = Path(__file__).resolve().parent.parent
K = 4
OPS = ("allreduce", "bcast", "sendrecv")

JAX_DEMO = """
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import telemetry_demo as D
import mpi4jax_tpu as mpx
D.main()
print(json.dumps(mpx.telemetry.snapshot()["ops"], default=str))
"""


def _jax_rows(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={K}",
               MPI4JAX_TPU_TELEMETRY_DIR=str(tmp_path / "jax"),
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", JAX_DEMO, str(REPO / "examples")],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    ops = json.loads(out.stdout.strip().splitlines()[-1])
    return {r["op"]: r for r in ops.values()
            if r["op"] in OPS and r["dtype"] == "float32"}


def test_report_rows_equal_the_jax_demos_calls_and_bytes(tmp_path):
    res = launch.run(RA.telemetry_demo_program, K, device="cpu",
                     timeout=R0.RANK_TIMEOUT_S, args=(str(tmp_path / "port"),))
    want = _jax_rows(tmp_path)
    assert sorted(want) == list(OPS)
    for rank, out in enumerate(res):
        rows = {r["op"]: r for r in out["ops"].values()}
        assert sorted(rows) == list(OPS), rank
        for op in OPS:
            got, ref = rows[op], want[op]
            assert (got["algo"], got["dtype"]) == (ref["algo"], ref["dtype"])
            execs_a_rank = ref["latency"]["count"] // K
            assert got["calls"] == execs_a_rank == 5
            assert got["bytes"] == execs_a_rank * ref["bytes"] // ref["calls"]
            assert got["latency"]["count"] == execs_a_rank
    # the merged table: each row's execs column is the JAX table's
    lines = {}
    for ln in res[0]["report"].splitlines():    # the first table's rows
        cells = ln.split()
        if cells and cells[0] in OPS:
            lines.setdefault(cells[0], cells)
    assert sorted(lines) == list(OPS)
    for op in OPS:
        assert int(lines[op][8]) == want[op]["latency"]["count"] == 20
    assert os.listdir(tmp_path / "port")     # each rank's journal is there
