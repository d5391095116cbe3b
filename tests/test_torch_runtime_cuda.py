"""The runtime services on a card: pins under the telemetry tiers, the
fault injection and numeric guards on CUDA tensors.

Every test needs a CUDA device and decides inside the test; the file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is:

    python -m pytest --noconftest -q tests/test_torch_runtime_cuda.py

``python3 chip_smoke.py --runtime`` drives the same services through the
solver at full width (phase 11).
"""

import pytest

torch = pytest.importorskip("torch")

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import resilience, telemetry  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_steps as K  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from mpi4jax_tpu_torch.resilience import faultinject, numerics  # noqa: E402


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


@pytest.fixture(autouse=True)
def services_off():
    yield
    telemetry.set_telemetry_mode(None)
    telemetry.reset()
    resilience.reset_overrides()
    resilience.reset_fault_state()
    resilience.drain_registry()


def comm1():
    return tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cuda"))


def step(v):
    return tpx.allreduce(v)[0] * 0.5


@pytest.mark.gpu
def test_pin_keeps_its_graph_under_counters_and_counts_each_replay():
    need_cuda()
    comm = comm1()
    x = torch.ones(8, device="cuda")
    telemetry.set_telemetry_mode("counters")
    pinned = tpx.compile(step, x, comm=comm)
    telemetry.reset()
    for _ in range(3):
        pinned(x)
    assert pinned.graph and pinned.info == {"graph": True, "eager_reason": None}
    (row,) = telemetry.snapshot()["ops"].values()
    assert (row["op"], row["calls"], row["bytes"]) == ("allreduce", 3, 96)


@pytest.mark.gpu
def test_graph_replay_under_off_calls_no_telemetry(monkeypatch):
    """Under off a replayed graph pin touches nothing of telemetry: its
    capture stashed no record, so no replay counts one."""
    need_cuda()
    from mpi4jax_tpu_torch.telemetry import core

    called = []
    for name in ("count_eager_call", "effective_mode", "open_op", "close_op"):
        real = getattr(core, name)
        monkeypatch.setattr(core, name, lambda *a, _r=real, _n=name, **k:
                            called.append(_n) or _r(*a, **k))
    comm = comm1()
    x = torch.ones(8, device="cuda")
    pinned = tpx.compile(step, x, comm=comm)
    assert pinned.graph
    called.clear()
    for _ in range(3):
        pinned(x)
    assert called == []
    assert telemetry.snapshot()["ops"] == {}


@pytest.mark.gpu
@pytest.mark.parametrize("knob,set_it", [
    ("MPI4JAX_TPU_TELEMETRY=events", lambda: telemetry.set_telemetry_mode("events")),
    ("MPI4JAX_TPU_WATCHDOG_TIMEOUT", lambda: resilience.set_watchdog_timeout(30)),
    ("MPI4JAX_TPU_CHECK_NUMERICS", lambda: resilience.set_check_numerics(True)),
    ("MPI4JAX_TPU_FAULT_SPEC", lambda: resilience.set_fault_spec("delay:op=bcast")),
])
def test_pin_runs_eagerly_under_a_per_op_hook(knob, set_it):
    need_cuda()
    from mpi4jax_tpu_torch.aot import pinning

    set_it()
    before = pinning.stats()["eager_pins"]
    x = torch.ones(8, device="cuda")
    comm = comm1()
    pinned = tpx.compile(step, x, comm=comm)
    assert not pinned.graph and pinned.info["eager_reason"] == knob
    assert pinning.stats()["eager_pins"] == before + 1
    assert torch.equal(pinned(x), tpx.spmd(step, comm=comm)(x))


@pytest.mark.gpu
def test_pin_under_off_and_counters_launches_the_same_graph():
    need_cuda()
    cfg = P.Config(nx=48, ny=24)
    _, comm = P.make_mesh_and_comm(cfg, device="cuda")
    s = P.initial_state(cfg, device="cuda")

    def body(state):
        return P.model_step_fused(state, cfg, comm, False)

    outs = []
    for mode in ("off", "counters"):
        telemetry.set_telemetry_mode(mode)
        pinned = tpx.compile(body, s, comm=comm, unroll=4)
        before = K.counter.launches
        out = pinned(s)
        torch.cuda.synchronize()
        outs.append((K.counter.launches - before, pinned.graph, out))
    assert [n for n, _, _ in outs] == [4, 4] and all(g for _, g, _ in outs)
    for a, b in zip(outs[0][2], outs[1][2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corrupt_on_the_card_flips_the_cpu_bits(dtype):
    need_cuda()
    clauses = tuple(enumerate(faultinject.parse_fault_spec("corrupt:nan;corrupt:inf")))
    x = torch.randn(5, 7).to(dtype)
    for mask in (1, 2, 3):
        cpu = faultinject.apply_corrupt((x,), clauses, mask)[0]
        gpu = faultinject.apply_corrupt((x.cuda(),), clauses, mask)[0]
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert gpu.device.type == "cuda"
        assert torch.equal(gpu.cpu().view(bits), cpu.view(bits))


@pytest.mark.gpu
def test_numeric_guard_passes_finite_cuda_tensors():
    need_cuda()
    telemetry.set_telemetry_mode("counters")
    assert numerics.guard_values("MPI_Allreduce", "00000000", 0,
                                 [torch.ones(4, device="cuda")], "input") is False
    assert telemetry.snapshot()["meters"]["numeric_guard.sites"] == 1
