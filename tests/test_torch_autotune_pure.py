"""The port's tuning layer against the JAX package's: the ``mpx-tuning/1``
schema and the fitters (``autotune/schema.py``, ``autotune/fit.py``, the
port's own copies) and the config layer's precedence.

The validators give the same verdicts and messages on the same payloads
(accepted, and every rejection of ``tests/test_autotune_pure.py``), the
stamps are equal, the knob lookups (topology overrides, payload buckets)
and the fitters agree on the same inputs, exactly.  The config layer
serves each knob the port consumes as default < tuning < an explicitly set
variable, as the JAX package's does (its effective values compared under
the same file and environment), and ``load_tuning`` stales a pin
(MPX129) as ``set_analyze_mode`` does.
"""

import json

import pytest

pytest.importorskip("torch")

from mpi4jax_tpu.autotune import fit as jfit  # noqa: E402
from mpi4jax_tpu.autotune import schema as jschema  # noqa: E402
from mpi4jax_tpu.utils import config as jconfig  # noqa: E402

from mpi4jax_tpu_torch.autotune import fit as pfit  # noqa: E402
from mpi4jax_tpu_torch.autotune import schema as pschema  # noqa: E402
from mpi4jax_tpu_torch.utils import config as pconfig  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]


def _payload(**over):
    base = {
        "schema": "mpx-tuning/1",
        "source": "test",
        "links": {"ici": {"alpha_us": 2.0, "gb_per_s": 50.0}},
        "tuned": {
            "ring_crossover_bytes": 4096,
            "dcn_crossover_bytes": 1 << 16,
            "alltoall_crossover_bytes": 1 << 15,
            "fusion_bucket_bytes": 2 << 20,
            "overlap_chunks": [
                {"max_bytes": 1 << 20, "chunks": 1},
                {"max_bytes": None, "chunks": 4},
            ],
            "compress": [{"max_bytes": 1 << 20, "codec": "off"},
                         {"max_bytes": None, "codec": "fp8"}],
            "pipeline_microbatches": 8,
            "pipeline_virtual_stages": 2,
            "commit": {"pack_gb_per_s": 3.5, "target_overhead": 0.05},
        },
        "measured": {"ring_crossover_bytes": 4096,
                     "fusion_bucket_bytes": 2 << 20},
        "topologies": {"2x4": {"ring_crossover_bytes": 9999,
                               "overlap_chunks": 3}},
        "provenance": {"torch": "test", "topology": "1x4"},
    }
    base.update(over)
    return base


@pytest.fixture(autouse=True)
def no_layers(monkeypatch):
    for flag in list(pschema.KNOB_FLAGS.values()) + [
            "MPI4JAX_TPU_TUNING", "MPI4JAX_TPU_COST_MODEL",
            "MPI4JAX_TPU_TOPOLOGY"]:
        monkeypatch.delenv(flag, raising=False)
    yield
    pconfig.load_tuning(None)
    jconfig.load_tuning(None)


def _same(f, g, *args, **kw):
    try:
        want = g(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the exception is the result
        with pytest.raises(type(e)) as ei:
            f(*args, **kw)
        assert str(ei.value) == str(e)
        return None
    got = f(*args, **kw)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------

GOOD = [
    {"schema": "mpx-tuning/1"},
    _payload(),
    _payload(tuned={"compress": "BF16"}),
    _payload(tuned={"overlap_chunks": 2}),
]
BAD = [
    [], {"schema": "mpx-tuning/999"}, {"schema": "mpx-cost-model/1"},
    {"schema": "mpx-tuning/1", "tuned": {"bogus_knob": 1}},
    {"schema": "mpx-tuning/1", "tuned": {"ring_crossover_bytes": "x"}},
    {"schema": "mpx-tuning/1", "tuned": {"ring_crossover_bytes": True}},
    {"schema": "mpx-tuning/1", "tuned": {"ring_crossover_bytes": 0}},
    {"schema": "mpx-tuning/1", "tuned": {"ring_crossover_bytes": 1.5}},
    {"schema": "mpx-tuning/1", "tuned": {"commit": {"bogus": 1}}},
    {"schema": "mpx-tuning/1", "tuned": {"commit": {"pack_gb_per_s": 0}}},
    {"schema": "mpx-tuning/1", "tuned": {"commit": 3}},
    {"schema": "mpx-tuning/1", "tuned": {"overlap_chunks": []}},
    {"schema": "mpx-tuning/1", "tuned": {"overlap_chunks": [{"max_bytes": 1}]}},
    {"schema": "mpx-tuning/1", "tuned": {"overlap_chunks": [
        {"max_bytes": None, "chunks": 2}, {"max_bytes": 4, "chunks": 1}]}},
    {"schema": "mpx-tuning/1", "tuned": {"overlap_chunks": [
        {"max_bytes": 8, "chunks": 2}, {"max_bytes": 4, "chunks": 1}]}},
    {"schema": "mpx-tuning/1", "tuned": {"compress": "zstd"}},
    {"schema": "mpx-tuning/1", "tuned": {"compress": [{"max_bytes": None}]}},
    {"schema": "mpx-tuning/1", "tuned": {"compress": [
        {"max_bytes": None, "codec": "bf16"}, {"max_bytes": 4, "codec": "off"}]}},
    {"schema": "mpx-tuning/1",
     "topologies": {"2x4": {"commit": {"target_overhead": 0.02}}}},
    {"schema": "mpx-tuning/1", "topologies": []},
    {"schema": "mpx-tuning/1", "topologies": {"": {}}},
    {"schema": "mpx-tuning/1", "provenance": 3},
    {"schema": "mpx-tuning/1", "links": {"ici": {"gb_per_s": -1}}},
    {"schema": "mpx-tuning/1", "measured": {"x": -1}},
]


@pytest.mark.parametrize("payload", GOOD + BAD, ids=str)
def test_validate_tuning_dict_equals_jax(payload):
    _same(pschema.validate_tuning_dict, jschema.validate_tuning_dict, payload)


@pytest.mark.parametrize("payload", GOOD, ids=str)
def test_stamps_and_lookups_equal_jax(payload):
    assert pschema.stamp_of(payload) == jschema.stamp_of(payload)
    p, j = pschema.TuningFile(payload), jschema.TuningFile(payload)
    assert p.stamp == j.stamp and p.knobs() == j.knobs()
    assert p.measured() == j.measured() and p.has_links() == j.has_links()
    for name in pschema.KNOB_FLAGS:
        for topo in (None, "2x4", "4x2"):
            for nbytes in (None, 1, 1 << 20, (1 << 20) + 1):
                _same(p.knob, j.knob, name, topology=topo,
                      payload_bytes=nbytes)
    for name in ("pack_gb_per_s", "target_overhead", "bogus"):
        _same(p.commit_param, j.commit_param, name)
    _same(p.knob, j.knob, "bogus")


def test_the_schema_constants_equal_jax():
    assert pschema.SCHEMA == jschema.SCHEMA
    assert pschema.COST_SCHEMA == jschema.COST_SCHEMA
    assert pschema.KNOB_FLAGS == jschema.KNOB_FLAGS
    assert pschema.COMPRESS_CODECS == jschema.COMPRESS_CODECS
    assert pschema.COMMIT_KEYS == jschema.COMMIT_KEYS
    for flag in pschema.KNOB_FLAGS.values():
        assert flag in pconfig.FLAG_NAMES


def test_files_load_and_pin_their_content(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_payload()))
    tf = pschema.load_tuning_file_memo(str(path))
    assert tf.path == str(path)
    assert tf.stamp == jschema.load_tuning_file(str(path)).stamp
    path.write_text(json.dumps(_payload(source="v2")))
    assert pschema.load_tuning_file_memo(str(path)) is tf
    tf2 = pschema.refresh_tuning_file(str(path))
    assert tf2.stamp != tf.stamp
    assert pschema.load_tuning_file_memo(str(path)) is tf2
    for name, text in (("missing.json", None), ("bad.json", "{nope")):
        p = tmp_path / name
        if text is not None:
            p.write_text(text)
        _same(pschema.load_tuning_file, jschema.load_tuning_file, str(p))
    assert pschema.as_tuning(tf) is tf
    with pytest.raises(TypeError):
        pschema.as_tuning(42)


# ---------------------------------------------------------------------------
# the fitters
# ---------------------------------------------------------------------------


def test_fitters_equal_jax():
    rows = [{"size_mb": s, "a": a, "b": b}
            for s, a, b in ((0.1, 5, 9), (1.0, 10, 11), (4.0, 30, 20),
                            (16.0, 90, 40))]
    for sweep in (rows, rows[:1], rows[2:], [], [{"size_mb": 1, "a": None,
                                                  "b": 2}]):
        _same(pfit.measured_crossover, jfit.measured_crossover, sweep,
              "size_mb", "a", "b")
    for alpha, bw, k in ((1.0, 100.0, 8), (25.0, 12.5, 4), (0.0, 1.0, 16),
                         (5.0, 10.0, 3), (-1.0, 5.0, 8), (2.0, 0.0, 8)):
        _same(pfit.analytic_crossover, jfit.analytic_crossover, alpha, bw, k)
    cands = [{"c": 4, "m": 3.0}, {"c": 1, "m": 2.0}, {"c": 16, "m": 2.0}]
    for sweep in (cands, [], [{"c": 1}]):
        _same(pfit.pick_min, jfit.pick_min, sweep, "c", "m")
    for winners in ([], [(10, 2)], [(10, 2), (20, 2)],
                    [(10, 1), (20, 4), (30, 4), (40, 2)]):
        _same(pfit.chunk_buckets, jfit.chunk_buckets, winners)
    for step, commit, target in ((0.1, 0.5, None), (0.0, 1.0, None),
                                 (1e-4, 10.0, 0.05), (0.1, -1, 0.1),
                                 (0.1, 0.001, 0.0)):
        _same(pfit.auto_commit_interval, jfit.auto_commit_interval, step,
              commit, target)
    assert pfit.DEFAULT_COMMIT_OVERHEAD == jfit.DEFAULT_COMMIT_OVERHEAD
    assert pfit.MAX_COMMIT_INTERVAL == jfit.MAX_COMMIT_INTERVAL


# ---------------------------------------------------------------------------
# the config layer: default < tuning < env
# ---------------------------------------------------------------------------

GETTERS = ["fusion_bucket_bytes", "overlap_chunks", "compress_mode",
           "pipeline_microbatches", "pipeline_virtual_stages",
           "ring_crossover_bytes", "dcn_crossover_bytes",
           "alltoall_crossover_bytes"]


def _effective(cfg):
    out = {g: getattr(cfg, g)() for g in GETTERS}
    for nbytes in (1, 1 << 20, (1 << 20) + 1):
        out[f"overlap_chunks@{nbytes}"] = cfg.overlap_chunks(nbytes)
        out[f"compress_mode@{nbytes}"] = cfg.compress_mode(nbytes)
    return out


@pytest.mark.parametrize("env", [
    {},
    {"MPI4JAX_TPU_FUSION_BUCKET_BYTES": "1234"},
    {"MPI4JAX_TPU_OVERLAP_CHUNKS": "5"},
    {"MPI4JAX_TPU_COMPRESS": "bf16"},
    {"MPI4JAX_TPU_COMPRESS": "auto"},
    {"MPI4JAX_TPU_PIPELINE_MICROBATCHES": "3"},
    {"MPI4JAX_TPU_RING_CROSSOVER_BYTES": "77"},
    {"MPI4JAX_TPU_TOPOLOGY": "2x4"},
], ids=str)
def test_precedence_default_tuning_env_equals_jax(env, monkeypatch):
    before_p, before_j = _effective(pconfig), _effective(jconfig)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    env_only = _effective(pconfig)
    assert env_only == _effective(jconfig)
    pconfig.load_tuning(_payload())
    jconfig.load_tuning(_payload())
    tuned = _effective(pconfig)
    assert tuned == _effective(jconfig)
    if not env:
        assert before_p == before_j == env_only
        assert tuned["fusion_bucket_bytes"] == 2 << 20
        assert tuned["overlap_chunks@1"] == 1 and tuned["overlap_chunks"] == 4
        assert tuned["compress_mode@1"] == "off"
        assert tuned["compress_mode@1048577"] == "fp8"
        assert tuned["pipeline_microbatches"] == 8
        assert tuned["ring_crossover_bytes"] == 4096
    for k, v in env.items():
        getter = {"MPI4JAX_TPU_FUSION_BUCKET_BYTES": "fusion_bucket_bytes",
                  "MPI4JAX_TPU_OVERLAP_CHUNKS": "overlap_chunks",
                  "MPI4JAX_TPU_PIPELINE_MICROBATCHES": "pipeline_microbatches",
                  "MPI4JAX_TPU_RING_CROSSOVER_BYTES": "ring_crossover_bytes",
                  }.get(k)
        if getter:  # an explicit variable wins over the file
            assert tuned[getter] == int(v)
    pconfig.load_tuning(None)
    jconfig.load_tuning(None)
    assert _effective(pconfig) == env_only


def test_an_explicit_variable_never_reads_a_malformed_file(tmp_path,
                                                           monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    monkeypatch.setenv("MPI4JAX_TPU_TUNING", str(bad))
    monkeypatch.setenv("MPI4JAX_TPU_FUSION_BUCKET_BYTES", "1024")
    assert pconfig.fusion_bucket_bytes() == 1024
    with pytest.raises(ValueError, match="not valid JSON"):
        pconfig.overlap_chunks()
    assert pconfig.tuning_snapshot() is None


def test_the_env_route_and_the_programmatic_override(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_payload()))
    monkeypatch.setenv("MPI4JAX_TPU_TUNING", str(path))
    tf = pconfig.active_tuning()
    assert tf.path == str(path) and pconfig.tuning_stamp() == tf.stamp
    other = pconfig.load_tuning(_payload(source="override"))
    assert pconfig.active_tuning() is other
    pconfig.load_tuning(None)
    assert pconfig.active_tuning() is tf
    snap = pconfig.tuning_snapshot()
    jconfig.load_tuning(None)
    monkeypatch.setenv("MPI4JAX_TPU_TUNING", str(path))
    want = jconfig.tuning_snapshot()
    assert snap == dict(want, path=snap["path"]) and snap["stamp"] == tf.stamp


def test_load_tuning_stales_a_pin():
    import torch

    from mpi4jax_tpu_torch import compile as pin
    from mpi4jax_tpu_torch.aot import StaleProgramError
    from mpi4jax_tpu_torch.parallel.comm import Comm
    from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid

    one = Comm(("i",), mesh=ProcessGrid((1,), ("i",), torch.device("cpu"),
                                        rank=0))
    epoch = pconfig.config_epoch()
    prog = pin(lambda x: x + 1, torch.ones(2), comm=one)
    assert prog(torch.ones(2)).tolist() == [2.0, 2.0]
    pconfig.load_tuning({"schema": "mpx-tuning/1"})
    assert pconfig.config_epoch() > epoch
    with pytest.raises(StaleProgramError) as ei:
        prog(torch.ones(2))
    assert getattr(ei.value, "mpx_code", None) == "MPX129"
