"""The persistent tier's store, manifests and command against the JAX
package's, in this process.

Held against ``mpi4jax_tpu/aot`` on the same inputs:

- ``diskcache.pack`` gives the JAX container's bytes (bit for bit), and
  ``unpack`` refuses every corruption of ``tests/test_aot_pure.py``;
- one sequence of ``put`` and ``get`` calls under one byte cap evicts the
  same keys, with the same counters, in both stores;
- ``parse_manifest`` gives equal specs, or equal ``ManifestError``
  messages, over valid and malformed manifests; ``load_manifest`` the
  same errors for an unreadable file and invalid JSON;
- the ``warm`` command's exit codes with the directory unset, a malformed
  manifest, an entry that fails to import, and success;
- ``warm --emit-manifest`` writes ``serving.warm_manifest``'s manifest,
  the JAX command's with the port's module names and one rank's shapes.

And the port's own: a library through the tier with a fake ``nvcc`` (a
miss compiles and stores, a fresh build directory loads it and compiles
nothing, a library ``ctypes`` refuses is a miss and is rebuilt), the
host-hooks library reloaded with no ``g++`` call, records keyed without
the process (a comm's uid) and with the function's code, and
``through_disk_cache``.  Every comparison here is exact: bytes, key sets,
counters, messages and exit codes.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import torch_ranks_aot as RA
from mpi4jax_tpu_torch import aot
from mpi4jax_tpu_torch.aot import __main__ as tcli
from mpi4jax_tpu_torch.aot import diskcache, keys, pinning, serialization, warm
from mpi4jax_tpu_torch.kernels import _build
from torch_port_isolation import isolated_reference_state  # noqa: F401

pytest_plugins = ["leaked_env_guard"]

KEYS = [f"{i:02x}" + "ab" * 31 for i in range(6)]


@pytest.fixture
def jdisk():
    from mpi4jax_tpu.aot import diskcache as jd

    jd.reset_stats()
    return jd


@pytest.fixture
def tier(monkeypatch, tmp_path):
    d = tmp_path / "tier"
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", str(d))
    aot.reset_stats()
    return d


# ---------------------------------------------------------------------------
# the container and the store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload", [b"", b"payload bytes",
                                     bytes(range(256)) * 9],
                         ids=["empty", "short", "2304B"])
def test_pack_is_the_jax_container(jdisk, payload):
    assert diskcache.pack(payload) == jdisk.pack(payload)
    assert diskcache.unpack(jdisk.pack(payload)) == payload


@pytest.mark.parametrize("mutation", [
    lambda d: d[:-1],                       # truncated digest
    lambda d: b"XXXXXXXX" + d[8:],          # bad magic
    lambda d: d[:20] + b"\x00" + d[21:],    # flipped payload byte
    lambda d: d[:10] + b"\xff" + d[11:],    # corrupted length
    lambda d: b"",                          # empty file
], ids=["truncated", "magic", "payload-bit", "length", "empty"])
def test_unpack_refuses_every_jax_corruption(jdisk, mutation):
    data = diskcache.pack(b"payload bytes")
    assert diskcache.unpack(mutation(data)) is None
    assert jdisk.unpack(mutation(data)) is None


def _remaining(jd_or_port, base):
    root = jd_or_port.cache_root(str(base))
    return sorted(os.path.basename(p)[:-4] for _, _, p in jd_or_port._entries(root))


def test_eviction_under_one_cap_matches_jax(jdisk, monkeypatch, tmp_path):
    """Six artifacts of 100 payload bytes (156 stored) under a cap of
    three and a half: the same keys evicted in the same order, with reads
    counting as LRU touches, in both stores."""
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES", str(156 * 7 // 2))
    diskcache.reset_stats()
    port, ref = tmp_path / "port", tmp_path / "jax"
    ops = [("put", 0), ("put", 1), ("put", 2), ("get", 0), ("put", 3),
           ("get", 1), ("get", 0), ("put", 4), ("get", 2), ("put", 5),
           ("get", 3), ("get", 0)]
    for op, i in ops:
        time.sleep(0.02)  # distinct mtimes: the LRU order is the call order
        for store, base in ((diskcache, port), (jdisk, ref)):
            if op == "put":
                assert store.put(KEYS[i], bytes([i]) * 100, base=str(base))
            else:
                store.get(KEYS[i], base=str(base))
        assert _remaining(diskcache, port) == _remaining(jdisk, ref), (op, i)
    counters = ("hits", "misses", "writes", "evictions", "bytes", "entries",
                "disk_bytes")
    got, want = diskcache.stats(str(port)), jdisk.stats(str(ref))
    assert {k: got[k] for k in counters} == {k: want[k] for k in counters}
    assert got["evictions"] > 0 and got["misses"] > 0


def test_disabled_tier_stores_nothing(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", raising=False)
    diskcache.reset_stats()
    assert not diskcache.enabled() and diskcache.cache_root() is None
    assert diskcache.get(KEYS[0]) is None
    assert diskcache.put(KEYS[0], b"x") is False
    st = diskcache.stats()
    assert st["hits"] == st["misses"] == st["writes"] == 0
    assert st["enabled"] is False


def test_corrupt_and_unusable_artifacts_are_misses_and_deleted(tier):
    assert diskcache.put(KEYS[0], b"good")
    path = diskcache._path_for(diskcache.cache_root(), KEYS[0])
    with open(path, "wb") as f:
        f.write(b"rotten bits")
    assert diskcache.get(KEYS[0]) is None and not os.path.exists(path)
    assert diskcache.put(KEYS[0], b"good")
    assert diskcache.get(KEYS[0], use=lambda d: False) is None
    assert not os.path.exists(path)
    st = diskcache.stats()
    assert (st["hits"], st["misses"], st["writes"]) == (0, 2, 2)


def test_failed_write_returns_false(monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", str(blocker))
    assert diskcache.put(KEYS[0], b"x") is False


def test_schema_directory_is_the_ports_own():
    from mpi4jax_tpu.aot import keys as jkeys

    assert keys.KEY_SCHEMA != jkeys.KEY_SCHEMA
    assert keys.KEY_SCHEMA.startswith("mpx-torch-")
    v = keys.toolchain_versions("g++", "x86_64")
    assert v[0] == torch.__version__ and v[1] == torch.version.cuda
    assert "g++" in v[2] or "GCC" in v[2] or v[2] == ""
    assert v[3] == "x86_64"


# ---------------------------------------------------------------------------
# manifests and the command
# ---------------------------------------------------------------------------


MANIFESTS = {
    "valid": {"programs": [
        {"fn": "m.serving:decode_step", "label": "d",
         "args": [{"shape": [8, 16], "dtype": "float32"}, {"static": 16},
                  {"static": [1, 2]}],
         "unroll": 4, "donate_argnums": [0], "wrap": True},
        {"fn": "m:f", "args": []},
    ]},
    "not-an-object": [1, 2],
    "no-programs": {"progs": []},
    "empty-programs": {"programs": []},
    "program-not-object": {"programs": [3]},
    "bad-fn": {"programs": [{"fn": "no_colon", "args": []}]},
    "empty-attr": {"programs": [{"fn": "mod:", "args": []}]},
    "args-not-list": {"programs": [{"fn": "m:f", "args": {}}]},
    "arg-not-object": {"programs": [{"fn": "m:f", "args": [5]}]},
    "static-mixed": {"programs": [{"fn": "m:f", "args": [
        {"static": 1, "shape": [1]}]}]},
    "missing-dtype": {"programs": [{"fn": "m:f", "args": [{"shape": [1]}]}]},
    "bad-shape": {"programs": [{"fn": "m:f", "args": [
        {"shape": [-1], "dtype": "float32"}]}]},
    "empty-dtype": {"programs": [{"fn": "m:f", "args": [
        {"shape": [1], "dtype": ""}]}]},
    "bad-unroll": {"programs": [{"fn": "m:f", "args": [], "unroll": 0}]},
    "bad-donate": {"programs": [{"fn": "m:f", "args": [],
                                 "donate_argnums": ["0"]}]},
    "bad-wrap": {"programs": [{"fn": "m:f", "args": [], "wrap": "yes"}]},
}


def _parsed(module, obj):
    try:
        return [(s.fn, s.args, s.static_argnums, s.unroll, s.donate_argnums,
                 s.wrap, s.label) for s in module.parse_manifest(obj)]
    except module.ManifestError as e:
        return ("ManifestError", str(e))


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_parse_manifest_matches_jax(name):
    from mpi4jax_tpu.aot import warm as jwarm

    got, want = _parsed(warm, MANIFESTS[name]), _parsed(jwarm, MANIFESTS[name])
    assert got == want
    assert (name == "valid") == (not isinstance(got, tuple))


@pytest.mark.parametrize("content", [None, "{not json"], ids=["unreadable", "json"])
def test_load_manifest_errors_match_jax(tmp_path, content):
    from mpi4jax_tpu.aot import warm as jwarm

    path = tmp_path / "m.json"
    if content is not None:
        path.write_text(content)
    msgs = []
    for module in (warm, jwarm):
        with pytest.raises(module.ManifestError) as ei:
            module.load_manifest(str(path))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def torch_double(v):
    """A warmable port program (its name in the manifests below)."""
    return v * 2


def jax_double(v):
    """The same for the JAX command."""
    return v * 2


def _manifest(tmp_path, case, fn):
    path = tmp_path / f"{case}.json"
    if case == "malformed":
        path.write_text(json.dumps({"programs": [{"fn": "no_colon"}]}))
    else:
        target = ("no_such_module_for_warm:f" if case == "import-fails"
                  else f"test_torch_aot_disk_pure:{fn}")
        path.write_text(json.dumps({"programs": [
            {"fn": f"test_torch_aot_disk_pure:{fn}",
             "args": [{"shape": [8, 4], "dtype": "float32"}]},
            {"fn": target, "args": [{"shape": [8, 4], "dtype": "float32"}]},
        ]}))
    return str(path)


@pytest.mark.parametrize("case", ["unset", "malformed", "import-fails", "ok"])
def test_warm_exit_codes_match_jax(monkeypatch, tmp_path, case, capsys):
    """The JAX command pins on the 8-device CPU mesh ((8, 4) global
    templates), the port's on the CPU ((8, 4) one rank's)."""
    from mpi4jax_tpu.aot import __main__ as jcli

    codes = []
    for cli, fn, extra in ((tcli, "torch_double", ["--device", "cpu"]),
                           (jcli, "jax_double", [])):
        d = tmp_path / f"tier-{fn}"
        if case == "unset":
            monkeypatch.delenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", str(d))
        codes.append(cli.main(["warm", _manifest(tmp_path, case, fn), "--json",
                               *extra]))
        payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if case == "ok":
            assert payload["warmed"] == 2 and payload["failed"] == 0
        if case == "import-fails":
            assert payload["warmed"] == 1 and payload["failed"] == 1
    assert codes[0] == codes[1] == {"unset": 2, "malformed": 2,
                                    "import-fails": 1, "ok": 0}[case]


@pytest.mark.parametrize("world,flags", [(1, []), (2, ["--max-batch", "4"]),
                                         (4, ["--unroll", "2"])])
def test_emitted_serving_manifest_is_warm_manifest(tmp_path, world, flags, capsys):
    from mpi4jax_tpu.aot import __main__ as jcli

    from mpi4jax_tpu_torch.serving.engine import ServingConfig, warm_manifest

    out, jout = tmp_path / "port.json", tmp_path / "jax.json"
    assert tcli.main(["warm", "--emit-manifest", str(out), "--world", str(world),
                      *flags]) == 0
    assert jcli.main(["warm", "--emit-manifest", str(jout), "--world", str(world),
                      *flags]) == 0
    capsys.readouterr()
    over = {"max_batch": 4} if "--max-batch" in flags else {}
    over.update({"unroll": 2} if "--unroll" in flags else {})
    got = json.loads(out.read_text())
    assert got == warm_manifest(ServingConfig.from_env(**over), world)
    # the JAX command's, with the port's module and one rank's shapes (the
    # JAX shapes without their leading rank axis)
    want = json.loads(jout.read_text().replace("mpi4jax_tpu.serving.model",
                                               "mpi4jax_tpu_torch.serving.model"))
    for prog in want["programs"]:
        for arg in prog["args"]:
            assert arg["shape"][0] == world
            arg["shape"] = arg["shape"][1:]
    assert got == want


def test_emit_refuses_an_unshardable_world_with_exit_2(tmp_path, capsys):
    assert tcli.main(["warm", "--emit-manifest", str(tmp_path / "m.json"),
                      "--world", "5"]) == 2
    assert "warm --emit-manifest" in capsys.readouterr().err


def test_emit_takes_the_twins_bench_preset(tmp_path, capsys):
    from mpi4jax_tpu_torch.models import serving as MS
    from mpi4jax_tpu_torch.serving.engine import warm_manifest

    out = tmp_path / "bench.json"
    assert tcli.main(["warm", "--emit-manifest", str(out), "--model", "bench"]) == 0
    capsys.readouterr()
    assert json.loads(out.read_text()) == warm_manifest(MS.make_config("bench"), 1)


# ---------------------------------------------------------------------------
# libraries through the tier
# ---------------------------------------------------------------------------


def test_build_goes_through_the_tier_with_a_fake_nvcc(tier, monkeypatch, tmp_path):
    import ctypes

    root = RA.make_fake_nvcc(tmp_path / "cuda")
    monkeypatch.setenv("CUDA_HOME", str(root))
    monkeypatch.setenv("PATH", f"{root / 'bin'}{os.pathsep}{os.environ['PATH']}")
    spec = (root / "stub.cu", {"N": 3}, (), True)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b1")
    first = _build.build(*spec)
    assert _build.stats()["compiles"] == 1
    assert diskcache.stats()["writes"] == 1 and diskcache.stats()["misses"] == 1
    # a fresh build directory: fetched, opened, nothing compiled
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b2")
    second = _build.build(*spec)
    assert second.name == first.name and second.parent == tmp_path / "b2"
    assert _build.stats()["compiles"] == 1 and diskcache.stats()["hits"] == 1
    assert ctypes.CDLL(str(second)).fake_launch() == 7
    # a library ctypes refuses: a miss, deleted, rebuilt from source
    key = _build.library_key(*spec)
    assert diskcache.put(key, b"not a shared object")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b3")
    third = _build.build(*spec)
    assert _build.stats()["compiles"] == 2 and diskcache.stats()["misses"] == 2
    assert ctypes.CDLL(str(third)).fake_launch() == 7
    assert serialization.load_library(diskcache.get(key), tmp_path / "b4" / "x.so")


def test_build_without_the_directory_is_unchanged(monkeypatch, tmp_path):
    monkeypatch.delenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", raising=False)
    root = RA.make_fake_nvcc(tmp_path / "cuda")
    monkeypatch.setenv("CUDA_HOME", str(root))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    _build.reset_stats()
    diskcache.reset_stats()
    path = _build.build(root / "stub.cu", {"N": 3}, (), True)
    import hashlib

    flags = ["-DN=3", "-fmad=true"]
    digest = hashlib.sha256((root / "stub.cu").read_bytes() + " ".join(flags).encode())
    assert path.name == f"libstub_{digest.hexdigest()[:12]}.so"
    assert _build.stats()["compiles"] == 1
    assert diskcache.stats()["misses"] == diskcache.stats()["writes"] == 0


def test_host_hooks_library_reloads_from_the_tier(tier, monkeypatch, tmp_path):
    import ctypes

    from mpi4jax_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "h1")
    first = native.build(verbose=False)
    assert native.stats()["compiles"] == 1
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "h2")
    second = native.build(verbose=False)
    assert native.stats()["compiles"] == 1          # no g++ call
    assert os.path.basename(second) == os.path.basename(first)
    assert diskcache.stats()["hits"] == 1 and diskcache.stats()["misses"] == 1
    lib = ctypes.CDLL(second)
    lib.mpx_wallclock.restype = ctypes.c_double
    assert lib.mpx_wallclock() >= 0.0


# ---------------------------------------------------------------------------
# pin records
# ---------------------------------------------------------------------------


def _cpu_comm():
    from mpi4jax_tpu_torch import Comm, make_world_mesh

    mesh = make_world_mesh(device="cpu")
    return Comm(mesh.axes[0], mesh=mesh)


def test_record_key_is_the_same_for_every_process_and_follows_the_code():
    comm = _cpu_comm()
    clone = comm.Clone()
    assert clone.uid != comm.uid
    x = [torch.ones(4)]
    k = pinning.record_key("f", RA.cold_start_step, x, (), comm, 1)
    assert k == pinning.record_key("f", RA.cold_start_step, x, (), clone, 1)
    assert k != pinning.record_key("f", torch_double, x, (), comm, 1)
    assert k != pinning.record_key("f", RA.cold_start_step, x, (), comm, 2)
    assert k != pinning.record_key("f", RA.cold_start_step, [torch.ones(5)], (),
                                   comm, 1)

    def body(v):
        return v + 1

    def edited(v):
        return v + 2

    edited.__qualname__ = body.__qualname__
    assert (pinning.record_key("b", body, x, (), comm, 1)
            != pinning.record_key("b", edited, x, (), comm, 1))
    # the donation is a part of the pin's key, not of its record's
    p0 = pinning.program_key("f", RA.cold_start_step, x, (), comm, 1, ())
    p1 = pinning.program_key("f", RA.cold_start_step, x, (), comm, 1, (0,))
    assert p0 != p1


def test_a_second_pin_reads_the_record(tier):
    import mpi4jax_tpu_torch as tpx

    comm = _cpu_comm()
    x = torch.full((16,), 1.5)
    first = tpx.compile(RA.cold_start_step, x, comm=comm)
    assert not first.from_disk
    first(x)                       # the eager pin's first run writes it
    second = tpx.compile(RA.cold_start_step, x, comm=comm)
    assert second.from_disk and torch.equal(second(x), first(x))
    st = tpx.cache_stats()
    assert (st["aot"]["compiles"], st["aot"]["disk_loads"]) == (1, 1)
    assert (st["disk_cache"]["hits"], st["disk_cache"]["misses"],
            st["disk_cache"]["writes"]) == (1, 1, 1)
    # clear_caches resets the counters and leaves the files
    tpx.clear_caches()
    st = tpx.cache_stats()
    assert not any(st["aot"].values()) and st["disk_cache"]["hits"] == 0
    assert st["disk_cache"]["entries"] == 1


def test_an_unreadable_record_is_a_miss_and_rewritten(tier):
    import mpi4jax_tpu_torch as tpx

    comm = _cpu_comm()
    x = torch.ones(3)
    key = pinning.record_key("torch_double", torch_double, [x], (), comm, 1)
    assert diskcache.put(key, b"{\"schema\": \"something else\"}")
    pin = tpx.compile(torch_double, x, comm=comm)
    assert not pin.from_disk
    pin(x)
    assert serialization.loads_record(diskcache.get(key))["fn"] == "torch_double"
    assert diskcache.stats()["misses"] == 1


def test_record_payload_is_plain_json():
    data = serialization.dumps_record("f", [{"key": "a" * 64, "name": "libx.so"}])
    assert json.loads(data) == {"schema": keys.KEY_SCHEMA, "fn": "f",
                                "libraries": [{"key": "a" * 64, "name": "libx.so"}]}
    assert serialization.loads_record(data)["libraries"][0]["name"] == "libx.so"
    for bad in (b"\xff", b"[]", b'{"schema": "x"}',
                json.dumps({"schema": keys.KEY_SCHEMA, "fn": "f",
                            "libraries": [{"key": "a", "name": "../x.so"}]}).encode()):
        assert serialization.loads_record(bad) is None
    assert serialization.dumps_record("f", [{"key": 1}]) is None


def test_through_disk_cache_routes_the_first_call_of_each_signature(tier):
    comm = _cpu_comm()
    calls = []

    def fn(v):
        calls.append(tuple(v.shape))
        return v * 3

    f1 = aot.through_disk_cache(fn, comm, "fn")
    assert torch.equal(f1(torch.ones(2)), torch.full((2,), 3.0))
    f1(torch.ones(2))
    f1(torch.ones(4))
    st = aot.stats()
    assert (st["aot"]["compiles"], st["aot"]["disk_loads"]) == (2, 0)
    assert st["disk_cache"]["writes"] == 2
    f2 = aot.through_disk_cache(fn, comm, "fn")     # a fresh cold start
    f2(torch.ones(2))
    f2(torch.ones(4))
    assert aot.stats()["aot"]["disk_loads"] == 2
    assert calls == [(2,), (2,), (4,), (2,), (4,)]


def test_through_disk_cache_with_the_tier_off_calls_directly(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", raising=False)
    aot.reset_stats()
    f = aot.through_disk_cache(torch_double, _cpu_comm(), "d")
    assert torch.equal(f(torch.ones(2)), torch.full((2,), 2.0))
    assert not any(aot.stats()["aot"].values())


def test_fastpath_is_the_graph_replay():
    from mpi4jax_tpu_torch.aot import fastpath

    graph = object.__new__(pinning.GraphRun)
    eager = pinning.EagerRun(lambda v: v, (torch.ones(1),), "f")
    assert fastpath.supported(graph) and not fastpath.supported(eager)
    assert fastpath.cpp_call_for(graph) == (graph, True)
    assert fastpath.cpp_call_for(eager) == (eager, False)


def test_the_three_knobs_and_their_defaults(monkeypatch):
    from mpi4jax_tpu.utils import config as jconfig

    from mpi4jax_tpu_torch.utils import config

    for name in ("MPI4JAX_TPU_COMPILE_CACHE_DIR", "MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES",
                 "MPI4JAX_TPU_CPP_DISPATCH"):
        monkeypatch.delenv(name, raising=False)
    assert (config.compile_cache_dir(), config.compile_cache_max_bytes(),
            config.cpp_dispatch()) == (jconfig.compile_cache_dir(),
                                       jconfig.compile_cache_max_bytes(),
                                       jconfig.cpp_dispatch()) == ("", 1 << 30, True)
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", " /x ")
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES", "0")
    monkeypatch.setenv("MPI4JAX_TPU_CPP_DISPATCH", "false")
    assert (config.compile_cache_dir(), config.compile_cache_max_bytes(),
            config.cpp_dispatch()) == (jconfig.compile_cache_dir(),
                                       jconfig.compile_cache_max_bytes(),
                                       jconfig.cpp_dispatch()) == ("/x", 0, False)


def test_the_tier_knobs_do_not_stale_a_pin(monkeypatch, tmp_path):
    import mpi4jax_tpu_torch as tpx

    x = torch.ones(2)
    pin = tpx.compile(torch_double, x, comm=_cpu_comm())
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES", "10")
    monkeypatch.setenv("MPI4JAX_TPU_CPP_DISPATCH", "0")
    assert np.array_equal(pin(x).numpy(), [2.0, 2.0])
