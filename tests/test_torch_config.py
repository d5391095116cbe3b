"""The port's declared flag registry against the JAX package's.

``mpi4jax_tpu_torch/utils/config.py`` keeps its own copy of the JAX
package's registry (``Flag``, ``FLAGS``, ``_getenv``): the same names but
two, each flag's type, default and choices, and a doc of the port's own.
Its readers parse the same values into the same results, or raise the
same errors with the same messages, as the JAX package's on a probe flag
declared in both registries.  An undeclared read raises in both.  The
twins of the JAX suite's registry checks (``tests/test_aot_pure.py``,
``tests/test_autotune_pure.py``, ``tests/test_fusion.py``) close the file.
"""

import math
import re

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from mpi4jax_tpu.utils import config as JC  # noqa: E402

from mpi4jax_tpu_torch.aot import invalidation as TI  # noqa: E402
from mpi4jax_tpu_torch.autotune import schema as TS  # noqa: E402
from mpi4jax_tpu_torch.ops import _fusion as TF  # noqa: E402
from mpi4jax_tpu_torch.utils import config as TC  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

# the JAX package's flags the port does not read, and why: it runs eagerly
# (program order is its ordering, no token chain to switch) and imports no
# JAX (no version to warn about)
JAX_ONLY = ("MPI4JAX_TPU_PREFER_NOTOKEN", "MPI4JAX_TPU_NO_WARN_JAX_VERSION")

# flags whose type, default or choices differ from the JAX package's by
# design, each with its reason: none
DIFFERENT_BY_DESIGN = {}

# what a pin's stamp and the services' stamp cover: a change stales or
# unstales pins, so both stay exactly as they are
FLAG_NAMES = (
    "MPI4JAX_TPU_COMPRESS", "MPI4JAX_TPU_FUSION", "MPI4JAX_TPU_FUSION_BUCKET_BYTES",
    "MPI4JAX_TPU_OVERLAP_CHUNKS", "MPI4JAX_TPU_UNROLL_DEFAULT",
    "MPI4JAX_TPU_COMPILE_CACHE_DIR", "MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES",
    "MPI4JAX_TPU_CPP_DISPATCH", "MPI4JAX_TPU_TELEMETRY", "MPI4JAX_TPU_TELEMETRY_DIR",
    "MPI4JAX_TPU_WATCHDOG_TIMEOUT", "MPI4JAX_TPU_FAULT_SPEC",
    "MPI4JAX_TPU_CHECK_NUMERICS", "MPI4JAX_TPU_TOPOLOGY",
    "MPI4JAX_TPU_BOOTSTRAP_DEADLINE", "MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS",
    "MPI4JAX_TPU_DRAIN_GRACE_S", "MPI4JAX_TPU_ELASTIC_REDUNDANCY",
    "MPI4JAX_TPU_ELASTIC_GROW", "MPI4JAX_TPU_ELASTIC_FAIL_UNIT",
    "MPI4JAX_TPU_ELASTIC_PLACEMENT", "MPI4JAX_TPU_ELASTIC_AGREEMENT",
    "MPI4JAX_TPU_ELASTIC_PORT_SPAN", "MPI4JAX_TPU_HEALTH", "MPI4JAX_TPU_HEALTH_INTERVAL",
    "MPI4JAX_TPU_FLIGHT_RING", "MPI4JAX_TPU_HEALTH_SUSPECTS", "MPI4JAX_TPU_HEALTH_PROM",
    "MPI4JAX_TPU_MOE_CAPACITY_CHUNKS", "MPI4JAX_TPU_PIPELINE_MICROBATCHES",
    "MPI4JAX_TPU_PIPELINE_VIRTUAL_STAGES", "MPI4JAX_TPU_SERVING_MAX_BATCH",
    "MPI4JAX_TPU_SERVING_BUCKETS", "MPI4JAX_TPU_SERVING_KV_SLOTS",
    "MPI4JAX_TPU_SERVING_UNROLL", "MPI4JAX_TPU_SERVING_SLO_P99_MS",
    "MPI4JAX_TPU_ANALYZE", "MPI4JAX_TPU_ANALYZE_RANKS", "MPI4JAX_TPU_TUNING",
    "MPI4JAX_TPU_COST_MODEL", "MPI4JAX_TPU_ANALYZE_COST",
    "MPI4JAX_TPU_RING_CROSSOVER_BYTES", "MPI4JAX_TPU_DCN_CROSSOVER_BYTES",
    "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES", "MPI4JAX_TPU_COLLECTIVE_ALGO",
    "MPI4JAX_TPU_COMPRESS_ERROR_BUDGET",
)
SERVICE_FLAG_NAMES = ("MPI4JAX_TPU_TELEMETRY", "MPI4JAX_TPU_WATCHDOG_TIMEOUT",
                      "MPI4JAX_TPU_FAULT_SPEC", "MPI4JAX_TPU_CHECK_NUMERICS",
                      "MPI4JAX_TPU_ANALYZE")

PORT_FLAGS = sorted(TC.FLAGS)
PROBE = "MPI4JAX_TPU_TESTFLAG"
UNSET = None  # the variable unset


def test_flags_are_the_jax_packages_but_two():
    assert len(TC.FLAGS) == 48
    assert list(TC.FLAGS) == [n for n in JC.FLAGS if n not in JAX_ONLY]
    assert set(JAX_ONLY) <= set(JC.FLAGS)
    for name, flag in TC.FLAGS.items():
        assert isinstance(flag, TC.Flag) and flag.name == name
    assert TC.Flag._fields == JC.Flag._fields


@pytest.mark.parametrize("name", PORT_FLAGS)
def test_type_default_and_choices_equal_jax(name):
    got, want = TC.FLAGS[name], JC.FLAGS[name]
    fields = ("type", "default", "choices")
    got_t = tuple(getattr(got, f) for f in fields)
    want_t = DIFFERENT_BY_DESIGN.get(name, tuple(getattr(want, f) for f in fields))
    assert got_t == want_t


@pytest.mark.parametrize("name", PORT_FLAGS)
def test_doc_is_the_ports_own(name):
    """A sentence about what the port does with the flag: non-empty, no
    word naming the JAX package's compiler or chip."""
    doc = TC.FLAGS[name].doc
    assert doc.strip() and doc != JC.FLAGS[name].doc
    assert not re.search(r"\b(XLA|TPU)s?\b", doc, re.IGNORECASE), doc


def test_stamped_names_are_unchanged_declared_flags():
    assert TC.FLAG_NAMES == FLAG_NAMES
    assert TC.SERVICE_FLAG_NAMES == SERVICE_FLAG_NAMES
    assert set(FLAG_NAMES) <= set(TC.FLAGS)
    assert set(SERVICE_FLAG_NAMES) <= set(TC.FLAGS)
    # the port's readers of the two flags the stamps leave out
    assert {"MPI4JAX_TPU_DEBUG", "MPI4JAX_TPU_TRACE"} == set(TC.FLAGS) - set(FLAG_NAMES)


def _declare(monkeypatch, flag_type, default, choices=None):
    """The probe flag, declared in both registries for the test."""
    monkeypatch.setitem(JC.FLAGS, PROBE, JC.Flag(PROBE, flag_type, default,
                                                 "test probe", choices))
    monkeypatch.setitem(TC.FLAGS, PROBE, TC.Flag(PROBE, flag_type, default,
                                                 "test probe", choices))


def _outcome(fn):
    """``fn()``'s value, or its error's type and message."""
    try:
        return ("value", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _same(monkeypatch, raw, jax_read, port_read):
    if raw is UNSET:
        monkeypatch.delenv(PROBE, raising=False)
    else:
        monkeypatch.setenv(PROBE, raw)
    want, got = _outcome(jax_read), _outcome(port_read)
    if want[0] == "value" and isinstance(want[1], float) and math.isnan(want[1]):
        assert got[0] == "value" and math.isnan(got[1])
    else:
        assert got == want
    return got


# the truthy, falsy and bad values of tests/test_comm_infra.py:134-156
BOOL_VALUES = ("1", "true", "ON", "yes", "0", "false", "OFF", "no", "", " True ",
               "maybe", UNSET)


@pytest.mark.parametrize("raw", BOOL_VALUES, ids=repr)
@pytest.mark.parametrize("default", [False, True])
def test_parse_env_bool_equals_jax(monkeypatch, raw, default):
    _declare(monkeypatch, "bool", default)
    got = _same(monkeypatch, raw,
                lambda: JC.parse_env_bool(PROBE, default),
                lambda: TC.parse_env_bool(PROBE, default))
    if raw == "maybe":
        assert got[0] == "ValueError" and "could not be parsed" in got[1]


@pytest.mark.parametrize("raw", ["", "  ", "0", "1.5", "3e2", "-1", "nan", "inf",
                                 "x", UNSET], ids=repr)
def test_parse_env_float_equals_jax(monkeypatch, raw):
    _declare(monkeypatch, "float", None)
    _same(monkeypatch, raw, lambda: JC.parse_env_float(PROBE, 7.0),
          lambda: TC.parse_env_float(PROBE, 7.0))


@pytest.mark.parametrize("raw", ["", "a", "B", " b ", "c", UNSET], ids=repr)
def test_choice_reader_equals_jax(monkeypatch, raw):
    _declare(monkeypatch, "choice", "a", ("a", "b"))
    _same(monkeypatch, raw, lambda: JC._parse_env_choice(PROBE),
          lambda: TC._choice(PROBE))


@pytest.mark.parametrize("raw", ["", "0", "1", "12", "-3", "2.5", "x", UNSET],
                         ids=repr)
@pytest.mark.parametrize("minimum", [0, 1])
def test_int_reader_equals_jax(monkeypatch, raw, minimum):
    _declare(monkeypatch, "int", 5)
    _same(monkeypatch, raw, lambda: JC._parse_env_positive_int(PROBE, 5, minimum),
          lambda: TC._int(PROBE, 5, minimum))


@pytest.mark.parametrize("reader", ["parse_env_bool", "parse_env_float", "_getenv"])
def test_undeclared_read_raises_as_in_jax(monkeypatch, reader):
    monkeypatch.setenv("MPI4JAX_TPU_NOT_A_FLAG", "1")
    for config, package in ((JC, "mpi4jax_tpu"), (TC, "mpi4jax_tpu_torch")):
        with pytest.raises(RuntimeError, match="not declared") as e:
            getattr(config, reader)("MPI4JAX_TPU_NOT_A_FLAG")
        assert f"{package}.utils.config.FLAGS" in str(e.value)


def test_undeclared_read_message_is_the_jax_packages(monkeypatch):
    def message(config):
        with pytest.raises(RuntimeError) as e:
            config.parse_env_bool("MPI4JAX_TPU_NOT_A_FLAG")
        return str(e.value)

    assert message(TC) == message(JC).replace("mpi4jax_tpu.utils",
                                              "mpi4jax_tpu_torch.utils")


def test_every_reader_reads_a_declared_flag(monkeypatch):
    """Each of the port's readers, with its variable unset, gives the
    default the registry declares for it."""
    for name in TC.FLAGS:
        monkeypatch.delenv(name, raising=False)
    assert TC.fusion_mode() == TC.FLAGS["MPI4JAX_TPU_FUSION"].default
    assert TC.compress_mode() == TC.FLAGS["MPI4JAX_TPU_COMPRESS"].default
    assert TC.telemetry_mode() == TC.FLAGS["MPI4JAX_TPU_TELEMETRY"].default
    assert TC.analyze_ranks() == TC.FLAGS["MPI4JAX_TPU_ANALYZE_RANKS"].default
    assert TC.cpp_dispatch() is TC.FLAGS["MPI4JAX_TPU_CPP_DISPATCH"].default
    assert TC.watchdog_timeout() is TC.FLAGS["MPI4JAX_TPU_WATCHDOG_TIMEOUT"].default
    assert TC.flight_ring_capacity() == TC.FLAGS["MPI4JAX_TPU_FLIGHT_RING"].default
    assert TC.serving_kv_slots() == TC.FLAGS["MPI4JAX_TPU_SERVING_KV_SLOTS"].default
    assert TC.bootstrap_deadline() == TC.FLAGS["MPI4JAX_TPU_BOOTSTRAP_DEADLINE"].default
    assert TC.elastic_agreement() == TC.FLAGS["MPI4JAX_TPU_ELASTIC_AGREEMENT"].default
    assert TC.topology_spec() == TC.FLAGS["MPI4JAX_TPU_TOPOLOGY"].default


# ---------------------------------------------------------------------------
# twins of the JAX suite's registry checks
# ---------------------------------------------------------------------------


def test_storage_only_flags_never_stale(monkeypatch):
    """tests/test_aot_pure.py:318-327."""
    ws = TI.WorldStamp.capture()
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_DIR", "/tmp/somewhere")
    monkeypatch.setenv("MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES", "123456")
    assert ws.is_current()
    ws.check()  # no raise
    for name in TI.STORAGE_ONLY_FLAGS + TI.DISPATCH_ONLY_FLAGS:
        assert name in TC.FLAGS  # the exemption list stays declared


def test_flags_declared():
    """tests/test_aot_pure.py:414-418."""
    assert "MPI4JAX_TPU_COMPILE_CACHE_DIR" in TC.FLAGS
    assert "MPI4JAX_TPU_COMPILE_CACHE_MAX_BYTES" in TC.FLAGS
    assert isinstance(TC.compile_cache_dir(), str)
    assert TC.compile_cache_max_bytes() >= 0


def test_knob_flags_match_the_registry():
    """tests/test_autotune_pure.py:243-247: every knob's flag is declared,
    and the knobs are the JAX package's."""
    from mpi4jax_tpu.autotune import schema as JS

    for flag in TS.KNOB_FLAGS.values():
        assert flag in TC.FLAGS, flag
    assert TS.KNOB_FLAGS == JS.KNOB_FLAGS


def test_fusion_flags_are_declared():
    """tests/test_fusion.py:234-238."""
    for name in ("MPI4JAX_TPU_FUSION", "MPI4JAX_TPU_FUSION_BUCKET_BYTES",
                 "MPI4JAX_TPU_OVERLAP_CHUNKS"):
        assert name in TC.FLAGS
    assert TC.FLAGS["MPI4JAX_TPU_FUSION"].choices == TC.FUSION_MODES
    assert TF.effective_mode() in TC.FUSION_MODES
