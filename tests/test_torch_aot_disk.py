"""The persistent tier across processes, against the JAX package.

Each test starts fresh processes (gloo ranks through
``parallel/launch.py:run``, or ``python -m`` commands), because a cold
start is a process that has built nothing:

- the twin of ``tests/test_aot.py``'s cold-start test: two gloo ranks pin
  the same program twice, in two worlds, with one cache directory; the
  second world reads its records (``from_disk``, hits >= 1, misses 0), and
  its value equals the JAX program's on a 2-device mesh (bit for bit:
  1.5 summed over two ranks and halved is exact);
- four gloo ranks race to build one library (a fake ``nvcc`` that builds
  a C stub with ``g++``) into their own build directories through one
  tier: every rank loads a working library, and the tier holds one whole
  artifact;
- ``warm --emit-manifest`` then ``warm`` over it, then a new process
  serves a trace with ``disk_cache.misses == 0``, every request's stream
  equal to the JAX engine's on a 1-device mesh (tokens equal);
- ``models/aot_serving_step.decode_step`` on 1 and 2 gloo ranks against
  the example's on a 1- and 2-device mesh, within the f32 SUM band (rtol
  1e-5, atol 1e-6: the allreduce sums in another order than XLA's
  ``psum``), and the twin run twice with one directory (the second
  ``from_disk``, hits > 0).

The ``gpu`` tests run on the card: a CUDA graph pin's record read by a
second process with every kernel library fetched from the tier, and
``MPI4JAX_TPU_CPP_DISPATCH=false`` running a pin eagerly.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as R0  # noqa: E402
import torch_ranks_aot as RA  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6


def _env(cache_dir=None, **extra):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **extra)
    env.pop("MPI4JAX_TPU_COMPILE_CACHE_DIR", None)
    if cache_dir is not None:
        env["MPI4JAX_TPU_COMPILE_CACHE_DIR"] = str(cache_dir)
    return env


def _run(args, env, timeout=240):
    out = subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _jax_comm(k):
    import jax

    import mpi4jax_tpu as mpx

    mesh = mpx.make_world_mesh((k,), ("i",), devices=jax.devices()[:k])
    return mpx.Comm("i", mesh=mesh)


# ---------------------------------------------------------------------------
# the cold start
# ---------------------------------------------------------------------------


def test_cold_start_second_process_served_from_disk(tmp_path):
    import jax.numpy as jnp

    import mpi4jax_tpu as mpx

    k = 2
    runs = [launch.run(RA.cold_start_program, k, device="cpu",
                       timeout=R0.RANK_TIMEOUT_S, args=(str(tmp_path / "tier"),))
            for _ in range(2)]
    cold, warm = runs
    for r in range(k):
        assert not cold[r]["from_disk"] and cold[r]["writes"] >= 1, cold[r]
        assert warm[r]["from_disk"], warm[r]
        assert warm[r]["hits"] >= 1 and warm[r]["misses"] == 0, warm[r]
        assert warm[r]["aot"]["disk_loads"] == 1 and warm[r]["aot"]["compiles"] == 0

    def f(v):
        return mpx.varying(mpx.allreduce(v, op=mpx.SUM)[0] * 0.5)

    comm = _jax_comm(k)
    x = jnp.full((k, 16), 1.5, jnp.float32)
    want = np.asarray(mpx.compile(f, x, comm=comm)(x))
    assert float(want[0, 0]) == k * 1.5 * 0.5
    for r in range(k):
        np.testing.assert_array_equal(np.asarray(warm[r]["out"]), want[r])
        np.testing.assert_array_equal(np.asarray(cold[r]["out"]), want[r])


def test_four_ranks_race_to_put_one_library(tmp_path):
    from mpi4jax_tpu_torch.aot import diskcache

    fake = RA.make_fake_nvcc(tmp_path / "cuda")
    tier = tmp_path / "tier"
    res = launch.run(RA.race_program, 4, device="cpu", timeout=R0.RANK_TIMEOUT_S,
                     args=(str(tier), str(tmp_path / "builds"), str(fake)))
    assert [r["value"] for r in res] == [7, 7, 7, 7]
    assert len({r["name"] for r in res}) == 1
    # each rank either compiled and stored or read another's artifact
    assert all(r["compiles"] + r["hits"] == 1 for r in res), res
    assert sum(r["writes"] for r in res) == sum(r["compiles"] for r in res) >= 1
    root = diskcache.cache_root(str(tier))
    entries = diskcache._entries(root)
    assert len(entries) == 1
    with open(entries[0][2], "rb") as f:
        assert diskcache.unpack(f.read()) is not None
    assert not [p for p in Path(root).rglob(".tmp-*")]


# ---------------------------------------------------------------------------
# warm, then serve
# ---------------------------------------------------------------------------

SERVE = """
import json, sys
from mpi4jax_tpu_torch.parallel.mesh import make_world_mesh, set_default_mesh
set_default_mesh(make_world_mesh(device="cpu"))
import mpi4jax_tpu_torch as tpx
from mpi4jax_tpu_torch import serving
from mpi4jax_tpu_torch.models import serving as MS
cfg = serving.ServingConfig.from_env(max_batch=2, clock="virtual", seed=7)
trace = serving.poisson_trace(6, 300.0, seed=5, prompt_len=(2, 4),
                              max_new=(2, 6), long_frac=0.0, vocab=64)
res, streams = MS.serve_streams(cfg, trace, None)
st = tpx.cache_stats()
print(json.dumps({"completed": res["completed"], "failed": res["failed"],
                  "streams": {str(k): list(map(int, v)) for k, v in streams.items()},
                  "disk_cache": {k: v for k, v in st["disk_cache"].items() if k != "dir"},
                  "aot": st["aot"]}))
"""


def test_warm_then_a_serving_run_misses_nothing_and_streams_equal_jax(tmp_path):
    tier, manifest = tmp_path / "tier", tmp_path / "serving.json"
    env = _env(tier)
    out = json.loads(_run(["-m", "mpi4jax_tpu_torch.aot", "warm", "--emit-manifest",
                           str(manifest), "--world", "1", "--max-batch", "2",
                           "--json"], env))
    assert out["programs"] == 6         # (prefill, decode, replay) x buckets 1, 2
    warmed = json.loads(_run(["-m", "mpi4jax_tpu_torch.aot", "warm", str(manifest),
                              "--device", "cpu", "--json"], env))
    assert (warmed["warmed"], warmed["failed"]) == (6, 0)
    served = json.loads(_run(["-c", SERVE], env).strip().splitlines()[-1])
    assert served["failed"] == 0 and served["completed"] == 6
    assert served["disk_cache"]["misses"] == 0
    # every program the run built read its record (a prefill and a decode
    # at least)
    assert served["aot"]["compiles"] == 0
    assert (served["disk_cache"]["hits"] == served["aot"]["disk_loads"]
            == served["aot"]["pins"] >= 2)

    from mpi4jax_tpu import serving as js

    eng = js.ServingEngine(js.ServingConfig(max_batch=2, clock="virtual", seed=7),
                           _jax_comm(1))
    trace = js.poisson_trace(6, 300.0, seed=5, prompt_len=(2, 4), max_new=(2, 6),
                             long_frac=0.0, vocab=64)
    res = eng.run(trace, scheduler="continuous")
    assert res["completed"] == 6
    want = {str(s.rid): [int(t) for t in s.generated] for s in eng._sched.finished}
    assert served["streams"] == want


# ---------------------------------------------------------------------------
# the aot_serving_step twin
# ---------------------------------------------------------------------------


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "aot_serving_step_example", REPO / "examples" / "aot_serving_step.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [1, 2])
def test_decode_step_equals_the_examples(k):
    import mpi4jax_tpu as mpx

    dim = 64
    rng = np.random.default_rng(3 + k)
    x = rng.standard_normal((k, 8, dim // k)).astype(np.float32)
    w = (rng.standard_normal((k, dim // k, dim)) * 0.1).astype(np.float32)
    res = launch.run(RA.decode_step_program, k, device="cpu",
                     timeout=R0.RANK_TIMEOUT_S, args=(x, w))
    ex = _jax_example()
    want = np.asarray(mpx.spmd(ex.decode_step, comm=_jax_comm(k))(x, w))
    for r in range(k):
        got = np.asarray(res[r]["out"])
        assert got.shape == want[r].shape == (8, dim // k)
        np.testing.assert_allclose(got, want[r], rtol=RTOL, atol=ATOL)


def test_aot_serving_step_twice_reads_its_record(tmp_path):
    env = _env(tmp_path / "tier")
    args = ["-m", "mpi4jax_tpu_torch.models.aot_serving_step", "--device", "cpu",
            "--steps", "3", "--json"]
    first = json.loads(_run(args, env).strip().splitlines()[-1])
    second = json.loads(_run(args, env).strip().splitlines()[-1])
    keys = {"workload", "pin_wall_s", "steps", "per_call_us", "from_disk", "aot",
            "disk_cache"}
    assert set(first) == set(second) == keys
    assert not first["from_disk"] and first["disk_cache"]["writes"] == 1
    assert second["from_disk"] and second["disk_cache"]["hits"] > 0
    assert second["disk_cache"]["misses"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


CARD_PIN = """
import json, sys
from pathlib import Path
from mpi4jax_tpu_torch.kernels import _build
_build.BUILD_DIR = Path(sys.argv[1])
import mpi4jax_tpu_torch as tpx
import torch_ranks_aot as RA
from mpi4jax_tpu_torch.models import shallow_water as P
s0 = tuple(P.initial_state(RA.SW_CFG(), device="cuda"))
pin = tpx.compile(RA.sw_pair, *s0, wrap=False)
out = pin(*s0)
st = tpx.cache_stats()["disk_cache"]
print(json.dumps({"from_disk": pin.from_disk, "graph": pin.graph,
                  "compiles": _build.stats()["compiles"], "hits": st["hits"],
                  "misses": st["misses"],
                  "launches": _build.COUNTERS["sw_steps"].launches}))
"""


@pytest.mark.gpu
def test_a_graph_pin_reads_its_record_and_its_library_on_the_card(tmp_path):
    """Two processes, each with an empty build directory, one tier: the
    second fetches the ``sw_steps`` library the first built, before its
    warm-up, and compiles nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    env = _env(tmp_path / "tier")
    env["PYTHONPATH"] = str(REPO / "tests") + os.pathsep + env["PYTHONPATH"]
    runs = [json.loads(_run(["-c", CARD_PIN, str(tmp_path / f"build{i}")],
                            env).strip().splitlines()[-1]) for i in range(2)]
    first, second = runs
    assert first["graph"] and not first["from_disk"] and first["compiles"] == 1
    assert second["graph"] and second["from_disk"], second
    assert second["compiles"] == 0 and second["misses"] == 0
    assert second["hits"] == 2          # the record and the library
    assert first["launches"] == second["launches"] >= 2


@pytest.mark.gpu
def test_cpp_dispatch_off_pins_eagerly_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import mpi4jax_tpu_torch as tpx
    from mpi4jax_tpu_torch import Comm, make_world_mesh

    mesh = make_world_mesh(device="cuda")
    comm = Comm(mesh.axes[0], mesh=mesh)
    x = torch.ones(64, device="cuda")
    pin = tpx.compile(RA.cold_start_step, x, comm=comm)
    assert pin.graph and pin.fast_path and pin.info["eager_reason"] is None
    monkeypatch.setenv("MPI4JAX_TPU_CPP_DISPATCH", "false")
    eager = tpx.compile(RA.cold_start_step, x, comm=comm)
    assert not eager.graph and not eager.fast_path
    assert eager.info["eager_reason"] == "MPI4JAX_TPU_CPP_DISPATCH"
    assert torch.equal(eager(x), pin(x))
