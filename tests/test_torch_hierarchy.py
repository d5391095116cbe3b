"""The collective algorithm layer on gloo ranks against the JAX package.

The port's side runs ``tests/torch_ranks_hierarchy.py:hierarchy_program``
on 4 gloo ranks under ``MPI4JAX_TPU_TOPOLOGY=2x2`` and on 8 under ``2x4``
and ``4x2`` (once per test run each); the JAX side runs the same cases on
the first ``k`` devices of the 8-device CPU mesh under the same spec and
the same forced lowering (``MPI4JAX_TPU_COLLECTIVE_ALGO``), inside one
``mpx.spmd`` region per (spec, lowering, comm).  Rank r's tensor is
compared with the JAX package's ``global[r]``.

Bands: every ring, hier and butterfly result bit for bit, dtype included
(f32 SUM and PROD too: the lowerings fold in the same order), except two:
the native routes under ``auto`` (``dist.all_reduce`` against ``psum``;
the port's alltoall-and-fold reduce-scatter against ``psum_scatter``)
hold f32 SUM to rtol 1e-5, atol 1e-6 (tests/test_allreduce.py:62), and
the ``hypot`` callable to rtol 1e-6 (XLA's CPU backend contracts its
``a*a + b*b`` into a fused multiply-add, one rounding fewer than
PyTorch's; its association is held by the exact ``first_nonzero``).
"""

import os
import re
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.ops import _codec as JCODEC  # noqa: E402
from mpi4jax_tpu.ops import _hierarchy as JH  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_hierarchy as R  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SPECS = {"2x2": 4, "2x4": 8, "4x2": 8}
FAMILIES = ("allreduce", "reduce", "reduce_scatter", "bcast", "alltoall")
ENV = ("MPI4JAX_TPU_TOPOLOGY", "MPI4JAX_TPU_COLLECTIVE_ALGO",
       "MPI4JAX_TPU_RING_CROSSOVER_BYTES", "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
       "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", "MPI4JAX_TPU_COMPRESS")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "hierarchy")


def port_run(results, spec):
    k = SPECS[spec]
    return results.get(f"port-{spec}", lambda: launch.run(
        R.hierarchy_program, k, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(spec,)))


class _env:
    """The JAX side's knobs, restored afterwards."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {n: os.environ.get(n) for n in ENV}
        for n in ENV:
            os.environ.pop(n, None)
        for n, v in self.values.items():
            os.environ[n] = v
        return self

    def __exit__(self, *exc):
        for n, v in self.saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        return False


def algo_env(spec, algo):
    env = {"MPI4JAX_TPU_TOPOLOGY": spec, "MPI4JAX_TPU_COLLECTIVE_ALGO": algo}
    if algo == "auto":
        for n in ("MPI4JAX_TPU_RING_CROSSOVER_BYTES",
                  "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
                  "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES"):
            env[n] = "0"
    return env


def jax_cases(spec, algo, split=False):
    """The JAX package's results of ``R.run_cases`` on the same inputs."""
    k = SPECS[spec]
    mesh = mpx.make_world_mesh((k,), ("x",), devices=jax.devices()[:k])
    comm = mpx.Comm(("x",), mesh=mesh)
    if split:
        comm = comm.Split([r % 2 for r in range(k)])
    n = k // 2 if split else k
    g = {name: jnp.asarray(v) for name, v in R.inputs(k, n).items()}
    r = R.ranks_per_host(spec, k)

    with _env(**algo_env(spec, algo)):
        @partial(mpx.spmd, comm=comm)
        def f(g):
            out = {}
            for kind, op in R.REDUCTIONS:
                out[f"allreduce/{kind}/{op}"] = mpx.allreduce(
                    g[kind], getattr(mpx, op), comm=comm)[0]
            for name in R.CALLABLES:
                fn = getattr(R, name)(jnp)
                out[f"allreduce/f/{name}"] = mpx.allreduce(g["f"], fn,
                                                           comm=comm)[0]
                if name == "first_nonzero":
                    out[f"allreduce/i/{name}"] = mpx.allreduce(
                        g["i"], fn, comm=comm)[0]
            out["reduce/f/SUM"] = mpx.reduce(g["f"], mpx.SUM, n - 1,
                                             comm=comm)[0]
            out["reduce/i/BXOR"] = mpx.reduce(g["i"], mpx.BXOR, 0, comm=comm)[0]
            for kind, op in (("fb", "SUM"), ("fb", "MAX"), ("ib", "BXOR"),
                             ("ib", "PROD"), ("bb", "LOR")):
                out[f"reduce_scatter/{kind}/{op}"] = mpx.reduce_scatter(
                    g[kind], getattr(mpx, op), comm=comm)[0]
            out["reduce_scatter/fb/first_nonzero"] = mpx.reduce_scatter(
                g["fb"], R.first_nonzero(jnp), comm=comm)[0]
            for root in R.bcast_roots(n, r):
                for kind in ("f", "i", "b"):
                    out[f"bcast/{root}/{kind}"] = mpx.bcast(g[kind], root,
                                                            comm=comm)[0]
            for kind in ("fb", "ib", "bb"):
                out[f"alltoall/{kind}"] = mpx.alltoall(g[kind], comm=comm)[0]
            return out

        return {key: np.asarray(v) for key, v in f(g).items()}


def jax_run(results, spec, algo, split=False):
    name = f"jax-{spec}-{algo}-{'split' if split else 'whole'}"
    return results.get(name, lambda: jax_cases(spec, algo, split))


def _band(algo, key):
    """``(rtol, atol)`` of a case that is not held bit for bit (see the
    module docstring), else ``None``."""
    if algo == "auto" and key in ("allreduce/f/SUM", "reduce/f/SUM",
                                  "reduce_scatter/fb/SUM"):
        return 1e-5, 1e-6
    if key.endswith("/hypot"):
        return 1e-6, 0.0
    return None


def _hold(port, ref, what, band=None):
    assert port.dtype == ref.dtype, f"{what}: dtype {port.dtype} != {ref.dtype}"
    assert port.shape == ref.shape, f"{what}: shape {port.shape} != {ref.shape}"
    if band is not None:
        np.testing.assert_allclose(port, ref, rtol=band[0], atol=band[1],
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=what)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("algo", R.ALGOS)
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_lowering_matches_jax(results, spec, algo, family):
    """Every case of one op family under one lowering and topology, bit
    for bit with the JAX package's same lowering (dtype included)."""
    port = port_run(results, spec)
    ref = jax_run(results, spec, algo)
    keys = [key for key in ref if key.split("/")[0] == family]
    assert keys
    for key in keys:
        for rank, out in enumerate(port):
            _hold(out[f"{algo}/{key}"], ref[key][rank],
                  f"{spec} {algo} {key} rank {rank}", _band(algo, key))


@pytest.mark.parametrize("algo", ("ring", "hier"))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_color_split_matches_jax(results, spec, algo):
    """The same cases on a color split by parity: plans of ``(2, 1)`` on
    ``2x2``, ``(2, 2)`` on ``2x4`` and ``(4, 1)`` on ``4x2``."""
    port = port_run(results, spec)
    ref = jax_run(results, spec, algo, split=True)
    for key in ref:
        for rank, out in enumerate(port):
            _hold(out[f"split/{algo}/{key}"], ref[key][rank],
                  f"{spec} split {algo} {key} rank {rank}", _band(algo, key))


def _exact(key, value) -> bool:
    """Whether a case's result is independent of the fold's association:
    a routing op, an integer or bool result, MIN, MAX, first-non-zero."""
    return (key.split("/")[0] in ("bcast", "alltoall")
            or value.dtype.kind in "iub"
            or key.endswith(("MIN", "MAX", "first_nonzero")))


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_hier_equals_flat_where_the_jax_package_pins_it(results, spec):
    """Hierarchical == flat under exact arithmetic: every case of ``hier``
    whose result does not depend on the association equals the flat ring's
    bits (the JAX package's pin, tests/test_hierarchy.py)."""
    for out in port_run(results, spec):
        for key, value in out.items():
            rest = key.split("/", 1)[1] if key.startswith("hier/") else None
            if rest is None or not _exact(rest, value):
                continue
            np.testing.assert_array_equal(value, out["ring/" + rest],
                                          err_msg=f"{spec} {key}")


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_plans_and_rounds(results, spec):
    """The plan each comm gets, and the exchanges a lowering makes: the
    ring allreduce ``2·(k-1)`` rounds, the hierarchy's intra rings and
    inter butterfly, one exchange for the butterfly."""
    k = SPECS[spec]
    h = int(spec.split("x")[0])
    r = k // h
    port = port_run(results, spec)
    for out in port:
        assert tuple(out["plan"]) == (h, r)
        assert tuple(out["split_plan"]) == (h, r // 2)
        assert out["calls/butterfly/allreduce/i/PROD"] == 1
        assert out["calls/ring/allreduce/i/PROD"] == 2 * (k - 1)
        # intra ring reduce-scatter + allgather, inter butterfly (h < 4)
        # or ring (h >= 4 at the DCN crossover 4 MiB: butterfly here)
        assert out["calls/hier/allreduce/i/PROD"] == 2 * (r - 1) + 1


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_plan_memo_takes_no_uid_and_makes_no_group(results, spec):
    """A plan rank 1 built again after its memo was cleared and the other
    ranks found in theirs: the same result everywhere, no process group
    created, and the next comm's uid the same on every rank."""
    port = port_run(results, spec)
    uids = {int(out["memo/next_uid"]) for out in port}
    assert len(uids) == 1
    for out in port:
        assert out["memo/groups_added"] == 0
        np.testing.assert_array_equal(out["memo/again"],
                                      port[0]["memo/again"])


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_chunked_allreduce_start_equals_synchronous(results, spec):
    """``allreduce_start`` in 3 chunks under the forced ring and hier:
    int32 and MIN/MAX bit for bit with the synchronous call, f32 SUM
    within rtol 1e-5 (its chunks are other ring blocks, so other fold
    orders, as the JAX package's)."""
    for out in port_run(results, spec):
        for algo in ("ring", "hier"):
            for kind, op in (("f", "SUM"), ("i", "BXOR"), ("f", "MAX")):
                a = out[f"async/{algo}/{kind}/{op}"]
                b = out[f"sync/{algo}/{kind}/{op}"]
                if op == "SUM":
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(a, b)


def fallback_run(results):
    return results.get("port-fallback", lambda: launch.run(
        R.fallback_program, 8, device="cpu", timeout=R0.RANK_TIMEOUT_S))


@pytest.mark.parametrize("mode", R.FALLBACKS)
def test_fallbacks_never_raise(results, mode):
    """No plan, no error: a ``3,5`` spec, round-robin host labels and one
    host give no plan and a forced ``hier`` runs flat (the butterfly's
    bits); two blocks of host labels give the ``(2, 4)`` plan from the
    host names alone; unequal color groups keep the butterfly."""
    want_plan = {"3,5": (0, 0), "round_robin": (0, 0), "one_host": (0, 0),
                 "blocks": (2, 4)}[mode]
    want_hosts = {"3,5": (0,) * 3 + (1,) * 5,
                  "round_robin": (0, 1) * 4, "one_host": (0,) * 8,
                  "blocks": (0,) * 4 + (1,) * 4}[mode]
    for out in fallback_run(results):
        assert tuple(out[f"{mode}/plan"]) == want_plan
        assert tuple(out[f"{mode}/host_of_rank"]) == want_hosts
        for key in out:
            if key.startswith(f"{mode}/hier/"):
                rest = key[len(f"{mode}/hier/"):]
                np.testing.assert_array_equal(
                    out[key], out[f"{mode}/butterfly/{rest}"], err_msg=key)


def _expected_link_rows(spec):
    """The telemetry rows ``hierarchy_program``'s counters section must
    give, from the JAX package's byte models and codec arithmetic."""
    k = SPECS[spec]
    h = int(spec.split("x")[0])
    r = k // h
    rows = {}

    def add(op, algo, dtype, nbytes, link, wire=None):
        row = rows.setdefault(f"{op}|{algo}|{dtype}", np.zeros(5, np.int64))
        row += np.array([1, nbytes, link[0], link[1],
                         link[1] if wire is None else wire], np.int64)

    def reduction(kind, algo, nbytes, kk, hh, rr):
        if algo == "hier":
            return JH.hier_link_bytes(kind, nbytes, hh, rr)
        return JH.flat_link_bytes(kind, algo, nbytes, kk, hh)

    nb = k * 3 * 2 * 4
    for algo in ("butterfly", "ring", "hier"):
        add("allreduce", algo, "int32", 60,
            reduction("allreduce", algo, 60, k, h, r))
        add("allreduce", algo, "float32", 60,
            reduction("allreduce", algo, 60, k // 2, h, r // 2))
        add("bcast", algo, "float32", 60,
            reduction("bcast", algo, 60, k // 2, h, r // 2))
        add("reduce_scatter", algo, "float32", nb,
            reduction("reduce_scatter", algo, nb, k, h, r))
        a2a = "hier" if algo == "hier" else "native"
        add("alltoall", a2a, "float32", nb,
            JH.hier_link_bytes("alltoall", nb, h, r) if a2a == "hier"
            else JH.flat_link_bytes("alltoall", "native", nb, k, h))
    # the codec calls run under auto with every crossover at 0, which the
    # inter-host phase's pick reads
    with _env(**algo_env(spec, "auto")):
        link = JH.hier_link_bytes("allreduce", 60, h, r)
        for _ in ("bf16", "fp8"):  # PROD: fp8 degrades to bf16
            add("allreduce", "hier", "float32", 60, link,
                JCODEC.wire_bytes(link[1], "bf16"))
        link = JH.hier_link_bytes("reduce_scatter", nb, h, r)
        add("reduce_scatter", "hier", "float32", nb, link,
            JCODEC.wire_bytes(link[1], "bf16"))
    return rows


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_telemetry_link_columns_equal_jax_models(results, spec):
    """The counters' ``intra_bytes``, ``inter_bytes`` and
    ``wire_inter_bytes`` of each lowering are the JAX package's byte models
    for the same calls (and, under a codec, its wire bytes): exact."""
    want = _expected_link_rows(spec)
    for out in port_run(results, spec):
        got = {key[len("telemetry/"):]: val for key, val in out.items()
               if key.startswith("telemetry/")}
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def jax_codec_cases(spec):
    """The JAX package's ``R.codec_cases`` on the same inputs and spec."""
    k = SPECS[spec]
    mesh = mpx.make_world_mesh((k,), ("x",), devices=jax.devices()[:k])
    comm = mpx.Comm(("x",), mesh=mesh)
    g = {name: jnp.asarray(v) for name, v in R.codec_inputs(k).items()}
    out = {}
    for codec in ("off",) + R.CODECS:
        with _env(MPI4JAX_TPU_TOPOLOGY=spec, MPI4JAX_TPU_COLLECTIVE_ALGO="hier",
                  MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES="1",
                  MPI4JAX_TPU_COMPRESS=codec):
            @partial(mpx.spmd, comm=comm)
            def f(ar, rs, a2a):
                return {"allreduce/SUM": mpx.allreduce(ar, mpx.SUM, comm=comm)[0],
                        "allreduce/MAX": mpx.allreduce(ar, mpx.MAX, comm=comm)[0],
                        "reduce_scatter/SUM": mpx.reduce_scatter(
                            rs.reshape(k, 64), mpx.SUM, comm=comm)[0],
                        "alltoall": mpx.alltoall(a2a.reshape(k, 32),
                                                 comm=comm)[0]}

            for key, v in f(g["ar"], g["rs"], g["a2a"]).items():
                out[f"codec/{codec}/{key}"] = np.asarray(v)
    return out


# the JAX suite's codec band for fp8 (tests/test_compress.py:79): the
# port's fp8 scale divides by 448 where the JAX package's jitted encode
# multiplies by 1/448, so its legs differ in the last bits of a scale
FP8_BAND = 5e-2


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_codec_legs_match_jax(results, spec):
    """The hierarchy's compressed inter-host legs against the JAX
    package's same legs on the same inputs: exact and bf16 bit for bit
    (the cast-through runs the exact exchanges on bf16), fp8 within the
    JAX suite's fp8 band of ``max(|ref|, 1)``."""
    port = port_run(results, spec)
    ref = results.get(f"jax-codec-{spec}", lambda: jax_codec_cases(spec))
    for key in ref:
        for rank, out in enumerate(port):
            got, want = out[key], ref[key][rank]
            if "/fp8/" in key:
                assert got.dtype == want.dtype and got.shape == want.shape
                scale = np.maximum(np.abs(want), 1.0)
                assert np.max(np.abs(got - want) / scale) <= FP8_BAND, key
            else:
                _hold(got, want, f"{spec} {key} rank {rank}")


REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _jax_example(name, env):
    """The JAX example's stdout on 4 CPU devices under ``env``."""
    import subprocess
    import sys

    full = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4", **env)
    res = subprocess.run([sys.executable, os.path.join(REPO, "examples", name)],
                         cwd=REPO, env=full, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.splitlines()


def _port_twin(results, name, rank_main, env, monkeypatch):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return results.get(name, lambda: launch.run(
        rank_main, 4, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=("cpu",)))[0]


_ROW = re.compile(r"telemetry: (\w+) algo=(\w+)(?: calls=\d+)? "
                  r"intra_host=(\d+) B inter_host=(\d+) B")


def _rows(lines):
    return sorted(m.groups() for m in map(_ROW.search, lines) if m)


def test_demo_twin_prints_the_jax_examples_plan_and_split(results,
                                                          monkeypatch):
    """``models/hierarchical_demo.py`` on 4 gloo ranks and
    ``examples/hierarchical_demo.py`` on 4 CPU devices, both under
    ``2x2``: the same plan line and the same telemetry split."""
    from mpi4jax_tpu_torch.models import hierarchical_demo as HD

    env = {"MPI4JAX_TPU_TOPOLOGY": "2x2"}
    port = _port_twin(results, "demo-2x2", HD.rank_main, env, monkeypatch)
    jax_lines = _jax_example("hierarchical_demo.py", env)
    assert port["plan"] == jax_lines[0]
    port_lines = [f"telemetry: {r['op']} algo={r['algo']} intra_host="
                  f"{r['intra_bytes']} B inter_host={r['inter_bytes']} B"
                  for r in port["rows"]]
    assert _rows(port_lines) == _rows(jax_lines) != []


def test_moe_twin_splits_its_alltoalls_as_the_jax_example(results,
                                                          monkeypatch):
    """``models/moe_training.py`` and ``examples/moe_training.py`` at 4
    under ``2x2`` with the alltoall crossover at 0: the hierarchical
    alltoalls, and the same rows by op, algorithm and link class."""
    from mpi4jax_tpu_torch.models import moe_training as MT

    env = {"MPI4JAX_TPU_TOPOLOGY": "2x2",
           "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES": "0"}
    port = _port_twin(results, "moe-2x2", MT.rank_main, env, monkeypatch)
    jax_lines = _jax_example("moe_training.py", env)
    port_lines = [f"telemetry: {r['op']} algo={r['algo']} intra_host="
                  f"{r['intra_bytes']} B inter_host={r['inter_bytes']} B"
                  for r in port["rows"]]
    rows = _rows(port_lines)
    assert rows == _rows(jax_lines)
    assert {r[1] for r in rows} == {"hier"} and all(int(r[3]) > 0 for r in rows
                                                    if r[0] != "alltoall_wait")


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_autograd_keeps_the_ops_own_backward(results, spec):
    """The lowering changes the forward only: under ``butterfly``, ``ring``
    and ``hier`` the gradients of SUM and PROD ``allreduce``, ``bcast``
    and SUM ``reduce_scatter`` are those of ``auto``'s route, within the
    band of the forward's own f32 bits (rtol 1e-5, the SUM band of
    tests/test_allreduce.py:62: ``y**2`` reads each lowering's value)."""
    for out in port_run(results, spec):
        for key, value in out.items():
            if key.startswith("grad/") and not key.startswith("grad/auto/"):
                rest = key.split("/", 2)[2]
                np.testing.assert_allclose(value, out["grad/auto/" + rest],
                                           rtol=1e-5, err_msg=key)
