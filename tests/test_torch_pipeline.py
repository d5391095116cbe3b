"""The port's pipeline schedule compiler on four gloo ranks against the
sequential reference and the JAX package's ``pipeline``.

The ranks (``tests/torch_ranks_workloads.py:pipeline_program``) run
``tests/test_pipeline.py``'s problem (16 microbatches of one row, DIM 4)
through ``gpipe``, ``1f1b`` with megastep on and off, ``interleaved``
with ``virtual=2`` (one fn over chunk-stacked params, and a list of two
fns), and ``auto``; the last rank's output must equal:

- the port's sequential per-microbatch reference, bit for bit;
- the JAX package's ``pipeline`` on a 4-device CPU mesh with the same
  stage function: bit for bit with a substage of IEEE operations only
  (``z / (1 + |z|)``), and within ``rtol 1e-6, atol 1e-7`` with the JAX
  tests' ``tanh`` substage, which the two frameworks round differently
  (XLA's CPU ``tanh`` is its own approximation; about one ulp here).

Also ``trace()`` inside a region, MPX130 for a send span that straddles
a megastep boundary (and a ring closed inside each iteration equal to
eager steps), the eager phases under ``counters`` (``pipeline.stage_us``,
``bubble_wait_us``, ``rounds``, the op rows and ``report()``'s section),
``off`` adding no meter, and the ladder twin
(``models/pipeline_parallel.py``).  The world runs once per test run.
JAX is imported where the JAX side is computed, so that the ``gpu`` test
runs on the card, which has no JAX (``--noconftest``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as R0  # noqa: E402
import torch_ranks_workloads as RW  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.telemetry import core  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZE = 4
TANH_RTOL, TANH_ATOL = 1e-6, 1e-7
FLAT = ["gpipe", "1f1b", "1f1b_no_megastep", "auto"]
CHUNKED = ["interleaved", "interleaved_fns", "auto_fns"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R0.shared_result(
        tmp_path_factory, "workloads-pipeline",
        lambda: launch.run(RW.pipeline_program, SIZE, device="cpu",
                           timeout=R0.RANK_TIMEOUT_S, args=("cpu",)))


def _jax_substage(name):
    import jax.numpy as jnp

    if name == "tanh":
        return lambda h, w: jnp.tanh(h @ w)

    def softsign(h, w):
        z = h @ w
        return z / (1.0 + jnp.abs(z))

    return softsign


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's rounds on a 4-device CPU mesh: the last stage's
    ``(MICRO, 1, DIM)``, per substage and schedule."""
    import jax
    import jax.numpy as jnp

    import mpi4jax_tpu as mpx
    from mpi4jax_tpu.parallel.pipeline import split_microbatches

    mesh = mpx.make_world_mesh((SIZE,), ("i",), devices=jax.devices()[:SIZE])
    comm = mpx.Comm("i", mesh=mesh)
    out = {}
    for name in ("tanh", "softsign"):
        fn = _jax_substage(name)
        for virtual in (1, 2):
            x0, ws_flat = RW.pipe_problem(SIZE, virtual)
            mbs = jnp.zeros((SIZE, RW.PIPE_MICRO, 1, RW.PIPE_DIM), jnp.float32)
            mbs = mbs.at[0].set(split_microbatches(jnp.asarray(x0), RW.PIPE_MICRO))
            ws = jnp.asarray(np.stack([RW.rank_weights(ws_flat, SIZE, r, virtual)
                                       for r in range(SIZE)]))
            if virtual == 1:
                for sched in ("gpipe", "1f1b"):
                    prog = mpx.pipeline(fn, RW.PIPE_MICRO, schedule=sched, comm=comm)
                    out[f"{name}/{sched}"] = np.asarray(prog(mbs, ws))[-1]
            else:
                prog = mpx.pipeline(fn, RW.PIPE_MICRO, schedule="interleaved",
                                    virtual=2, comm=comm)
                out[f"{name}/interleaved"] = np.asarray(prog(mbs, ws))[-1]
    return out


def _last(world, key):
    return world[SIZE - 1][key]


def _jax_key(name, label):
    return f"{name}/" + {"1f1b_no_megastep": "1f1b", "auto": "1f1b",
                         "interleaved_fns": "interleaved",
                         "auto_fns": "interleaved"}.get(label, label)


@pytest.mark.parametrize("name", ["tanh", "softsign"])
@pytest.mark.parametrize("label", FLAT + CHUNKED)
def test_schedule_is_bit_for_bit_the_sequential_reference(world, name, label):
    ref = _last(world, f"{name}/ref" if label in FLAT else f"{name}/ref_v2")
    assert _last(world, f"{name}/{label}").tobytes() == ref.tobytes()


@pytest.mark.parametrize("label", FLAT + CHUNKED)
def test_schedule_is_bit_for_bit_the_jax_pipeline(world, jax_side, label):
    got = _last(world, f"softsign/{label}")
    want = jax_side[_jax_key("softsign", label)]
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("label", FLAT + CHUNKED)
def test_tanh_schedule_matches_the_jax_pipeline_in_its_band(world, jax_side,
                                                            label):
    np.testing.assert_allclose(_last(world, f"tanh/{label}"),
                               jax_side[_jax_key("tanh", label)],
                               rtol=TANH_RTOL, atol=TANH_ATOL)


def test_auto_resolves_by_the_fixed_rule(world):
    plan = world[0]["auto_fns_plan"]
    assert plan["schedule"] == "interleaved" and plan["virtual"] == 2


def test_trace_composes_inside_a_region(world):
    assert _last(world, "trace").tobytes() == _last(world, "tanh/ref").tobytes()


def test_send_span_straddling_a_megastep_boundary_is_mpx130(world):
    for r in world:
        assert "MPX130" in r["mpx130"] and "iteration 0" in r["mpx130"]


def test_spans_closed_in_each_iteration_equal_eager_steps(world):
    for r in world:
        assert r["ring_megastep"].tobytes() == r["ring_eager"].tobytes()


def test_counters_meter_the_eager_phases(world):
    for r in world:
        snap = r["counters/snapshot"]
        meters = snap["meters"]
        assert meters["pipeline.rounds"] == 1
        assert meters["pipeline.stage_us"] > 0 and "pipeline.bubble_wait_us" in meters
        uid = r["comm_uid"]
        stage = snap["ops"][core.op_key("pipeline.stage", uid, "1f1b", "")]
        wait = snap["ops"][core.op_key("pipeline.bubble_wait", uid, "1f1b", "")]
        # warmup and cooldown: two bubble_wait brackets a round
        assert stage["calls"] == 1 and wait["calls"] == 2
        assert r["counters/y"].tobytes() == r["trace"].tobytes()


def test_report_renders_the_pipeline_section_summed_over_processes(world):
    text = world[0]["counters/report"]
    assert "pipeline:" in text and "bubble fraction" in text
    rounds = [ln for ln in text.splitlines() if "steady rounds" in ln]
    assert rounds and rounds[0].split()[-1] == str(SIZE)
    stage_us = sum(r["counters/snapshot"]["meters"]["pipeline.stage_us"]
                   for r in world)
    line = [ln for ln in text.splitlines() if "stage time (us)" in ln][0]
    assert int(line.split()[-1]) == stage_us


def test_telemetry_off_adds_no_pipeline_meter(world):
    for r in world:
        assert not [m for m in r["off/meters"] if m.startswith("pipeline.")]
        assert r["off/y"].tobytes() == r["tanh/gpipe"].tobytes()


def test_ladder_twin_is_bit_for_bit(world):
    last = world[SIZE - 1]["twin"]
    assert last["last"]
    assert set(last["outputs"]) == {"ladder", "gpipe", "1f1b", "interleaved", "auto"}
    assert last["plans"]["auto"]["schedule"] == "1f1b"
    assert last["plans"]["interleaved"]["virtual"] == 2
    # the twin raises on the last rank where a form differs from its
    # reference; the forms also agree with each other here
    for label in ("ladder", "1f1b", "interleaved", "auto"):
        assert last["outputs"][label].tobytes() == last["outputs"]["gpipe"].tobytes()


@pytest.mark.gpu
def test_one_schedule_on_cuda_ranks():
    """Four gloo ranks on one card: 1f1b against the sequential reference
    on the card; runs on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    ranks = launch.run(RW.cuda_pipeline_program, SIZE, device="cuda:0",
                       timeout=R0.RANK_TIMEOUT_S, args=("cuda:0",))
    assert ranks[SIZE - 1]["y"].tobytes() == ranks[SIZE - 1]["ref"].tobytes()
