"""Pinned programs (``compile``), staleness (MPX129) and the megastep
solver against the JAX package.

- Staleness: the counterparts of ``tests/test_aot_pure.py:266-330`` and
  ``tests/test_megastep_pure.py:401-417`` on the port's ``WorldStamp`` and
  on pinned programs: a variable moved goes stale and moved back
  revalidates; an override goes stale; the storage-only and dispatch-only
  variables never do; the message names the re-pin; ``repin()`` recovers.
- ``compile``'s conventions and errors beside the JAX package's, its key
  and counters; ``utils/config.py``'s new knob against the JAX package's.
- ``solve_fused(unroll=N)``: the port's megastep run (on the CPU the pins
  run eagerly) over 12 steps, two megasteps of 4 and a tail of 3,
  against the JAX package's megastep run, whose ``info["unroll"]`` must be
  4 (a silent fallback there cannot pass), in the band of the JAX suite's
  ``solve_fused`` runs (``1e-5 + 2e-6 * max|a|``, tests/test_examples.py:337:
  XLA fuses the arithmetic the port rounds op by op), and against the
  port's own whole run bit for bit; on one rank for ``pallas2``, the
  walled ``wide2``, ``pallas_halo`` and ``True``, and on a (2,2) grid of
  gloo ranks for ``wide2``.
- The one-rank paths of ``allreduce``, ``bcast`` and ``sendrecv`` never
  stage an exchange (nothing a CUDA graph could not capture), with the
  bits they had.
- ``bench.py --unroll``.
"""

import os
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.aot import invalidation as JI  # noqa: E402
from mpi4jax_tpu.aot import keys as JK  # noqa: E402
from mpi4jax_tpu.utils import config as JC  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_dispatch as R  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch import bench  # noqa: E402
from mpi4jax_tpu_torch.aot import invalidation as TI  # noqa: E402
from mpi4jax_tpu_torch.aot import keys as TK  # noqa: E402
from mpi4jax_tpu_torch.aot import pinning  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.utils import config as TC  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

# the knobs a pin's stamp reads
WORLD_FLAGS = ("MPI4JAX_TPU_FUSION", "MPI4JAX_TPU_COMPRESS", "MPI4JAX_TPU_UNROLL_DEFAULT",
               "MPI4JAX_TPU_FUSION_BUCKET_BYTES", "MPI4JAX_TPU_OVERLAP_CHUNKS")
FLAG_VALUES = {"MPI4JAX_TPU_FUSION": "auto", "MPI4JAX_TPU_COMPRESS": "bf16",
               "MPI4JAX_TPU_UNROLL_DEFAULT": "8", "MPI4JAX_TPU_FUSION_BUCKET_BYTES": "1024",
               "MPI4JAX_TPU_OVERLAP_CHUNKS": "3"}


def one_rank():
    return tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))


def pinned_step():
    x = torch.arange(6.0).reshape(2, 3)
    return tpx.compile(R.step_plain, x, comm=one_rank()), x


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------


def test_stamp_current_roundtrip():
    ws = TI.WorldStamp.capture()
    assert ws.is_current() and ws.describe_staleness() is None
    ws.check()  # no raise


@pytest.mark.parametrize("flag", WORLD_FLAGS)
def test_env_flip_goes_stale_and_back(monkeypatch, flag):
    pp, x = pinned_step()
    want = pp(x)
    monkeypatch.setenv(flag, FLAG_VALUES[flag])
    assert pp.is_stale()
    with pytest.raises(TI.StaleProgramError) as e:
        pp(x)
    assert e.value.mpx_code == "MPX129" and "MPX129" in str(e.value)
    assert flag in str(e.value)  # names the variable that moved
    monkeypatch.delenv(flag)
    assert not pp.is_stale()  # same stamp, same program
    assert torch.equal(pp(x), want)


def test_programmatic_override_goes_stale():
    pp, x = pinned_step()
    tpx.set_fusion_mode("auto")
    try:
        assert pp.is_stale()
        with pytest.raises(TI.StaleProgramError, match="set_\\* override"):
            pp(x)
    finally:
        tpx.set_fusion_mode(None)
    # an override moves the epoch for good: handing control back does not
    # revalidate
    assert pp.is_stale()
    ws = TI.WorldStamp.capture()
    TC.bump_config_epoch()
    assert not ws.is_current()


@pytest.mark.parametrize("flag", TI.STORAGE_ONLY_FLAGS + TI.DISPATCH_ONLY_FLAGS)
def test_storage_and_dispatch_only_flags_never_stale(monkeypatch, flag):
    pp, x = pinned_step()
    monkeypatch.setenv(flag, "0")
    assert not pp.is_stale()
    pp(x)  # no raise
    assert flag in TC.FLAG_NAMES  # the exemption stays declared


def test_exemptions_are_the_jax_packages():
    assert TI.STORAGE_ONLY_FLAGS == JI.STORAGE_ONLY_FLAGS
    assert TI.DISPATCH_ONLY_FLAGS == JI.DISPATCH_ONLY_FLAGS
    # every knob the port reads is one of the JAX package's, by name
    assert set(TC.FLAG_NAMES) <= set(JC.FLAG_NAMES)


def test_message_names_the_repin_and_repin_recovers(monkeypatch):
    pp, x = pinned_step()
    want = pp(x)
    monkeypatch.setenv("MPI4JAX_TPU_FUSION", "force")
    with pytest.raises(TI.StaleProgramError) as e:
        pp(x)
    assert "repin()" in str(e.value) and "compile" in str(e.value)
    again = pp.repin()
    assert not again.is_stale() and pp.is_stale()
    assert torch.equal(again(x), want)
    assert again.key == pp.key  # the same program, captured anew


def test_stale_raises_are_counted():
    pinning.reset_stats()
    pp, x = pinned_step()
    pp(x)
    tpx.set_fusion_mode("off")
    try:
        with pytest.raises(TI.StaleProgramError):
            pp(x)
    finally:
        tpx.set_fusion_mode(None)
    got = tpx.aot.stats()["aot"]
    assert (got["pins"], got["calls"], got["stale_raises"], got["replays"]) == (1, 1, 1, 0)
    tpx.aot.reset_stats()
    assert set(tpx.aot.stats()["aot"].values()) == {0}


def test_set_fusion_mode_bumps_the_epoch():
    e0 = TC.config_epoch()
    tpx.set_fusion_mode("force")
    tpx.set_fusion_mode(None)
    assert TC.config_epoch() == e0 + 2
    assert TC.config_stamp()[0] == e0 + 2


@pytest.mark.parametrize("raw", [None, "", "1", "5", "0", "-2", "x"])
def test_unroll_default_parses_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("MPI4JAX_TPU_UNROLL_DEFAULT", raising=False)
    else:
        monkeypatch.setenv("MPI4JAX_TPU_UNROLL_DEFAULT", raw)
    try:
        want = JC.unroll_default()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TC.unroll_default()
        assert str(got.value) == str(e)
        return
    assert TC.unroll_default() == want


# ---------------------------------------------------------------------------
# compile: conventions, errors, key
# ---------------------------------------------------------------------------


def test_compile_adopts_the_spmd_breadcrumbs():
    mega = tpx.spmd(R.step_statics, comm=one_rank(), static_argnums=(1,), unroll=3)
    v, w = torch.ones(4), torch.zeros(2)
    pp = tpx.compile(mega, v, R.GAIN, w)
    assert pp.unroll == 3 and not pp.graph and pp.fn_name == "step_statics"
    for a, b in zip(pp(v, w), mega(v, R.GAIN, w)):
        assert torch.equal(a, b)
    # an explicit unroll replaces the adopted one
    assert tpx.compile(mega, v, R.GAIN, w, unroll=1).unroll == 1


def test_compile_errors_match_jax():
    comm = one_rank()
    with pytest.raises(ValueError, match="cannot donate static argument"):
        tpx.compile(R.step_statics, torch.ones(2), 0.5, torch.ones(2), comm=comm,
                    static_argnums=(1,), donate_argnums=(1,))
    with pytest.raises(ValueError, match="wrap=False"):
        tpx.compile(lambda v: v, torch.ones(2), wrap=False, unroll=2)
    with pytest.raises(TypeError, match="hashable"):
        tpx.compile(lambda v, s: v, torch.ones(2), [1], comm=comm, static_argnums=(1,))
    with pytest.raises(ValueError, match="out of range"):
        tpx.compile(lambda v: v, torch.ones(2), comm=comm, static_argnums=(3,))


def test_wrap_false_runs_the_function_as_given(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_UNROLL_DEFAULT", "4")
    pp = tpx.compile(lambda v, k: v * k, torch.ones(3), 2.0, wrap=False,
                     static_argnums=(1,))
    assert pp.unroll == 1  # the default degrades: no carry to thread
    assert torch.equal(pp(torch.ones(3)), torch.full((3,), 2.0))


def test_a_pin_accepts_only_its_signature():
    pp, x = pinned_step()
    with pytest.raises(ValueError, match="exactly the signature"):
        pp(x[:1])
    with pytest.raises(ValueError, match="exactly the signature"):
        pp(x.double())


def test_key_names_what_was_pinned():
    comm = one_rank()
    x = torch.ones(2, 3)
    k1 = tpx.compile(R.step_plain, x, comm=comm).key
    assert k1 == tpx.compile(R.step_plain, x.clone(), comm=comm).key
    assert len(k1) == 64
    assert k1 != tpx.compile(R.step_plain, x, comm=comm, unroll=2).key
    assert k1 != tpx.compile(R.step_plain, torch.ones(3, 3), comm=comm).key
    assert k1 != tpx.compile(R.step_token, x, comm=comm).key
    assert k1 != tpx.compile(R.step_plain, x, comm=comm, donate_argnums=0).key


@pytest.mark.parametrize("part", [
    None, True, 3, 2.5, "s", b"bytes", (1, (2, "a")), [1, 2], {3, 1},
    frozenset({"b", "a"}), {"b": 1, "a": (2, None)},
])
def test_keys_canonicalize_as_jax(part):
    assert TK.canonical(part) == JK.canonical(part)
    assert TK.fingerprint(TK.canonical(part)) == JK.fingerprint(JK.canonical(part))


def test_keys_refuse_an_address_and_derive_a_digest():
    class Anon:
        pass

    with pytest.raises(TypeError, match="memory address"):
        TK.canonical(Anon())
    key = TK.derive_key("f", ("x",), (1, 2), ("torch",))
    assert len(key) == 64 and key == TK.derive_key("f", ("x",), (1, 2), ("torch",))
    assert key != TK.derive_key("g", ("x",), (1, 2), ("torch",))


# ---------------------------------------------------------------------------
# the one-rank paths: no staged exchange, the same bits
# ---------------------------------------------------------------------------


def test_one_rank_ops_stage_no_exchange(monkeypatch):
    """On a one-rank comm ``allreduce`` (every reduction, fused, started),
    ``bcast`` and ``sendrecv`` never build an ``Exchange`` (whose gloo path
    synchronises with the host, which a CUDA graph cannot capture), and
    give the bits they gave before the dispatch layer: the input for a
    reduction and a broadcast, the input for a wrapping route, the
    template for one that delivers nothing."""
    import importlib

    def refuse(*a, **k):
        raise AssertionError("a one-rank op built an Exchange")

    for name in ("_async", "allgather", "allreduce", "alltoall", "bcast", "sendrecv"):
        mod = importlib.import_module(f"mpi4jax_tpu_torch.ops.{name}")
        monkeypatch.setattr(mod, "Exchange", refuse)
    comm = one_rank()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 4), dtype=np.float32))
    i = torch.from_numpy(rng.integers(-9, 9, (5,)).astype(np.int32))
    tmpl = torch.full_like(x, -1.0)

    def region():
        out = {}
        for op in (tpx.SUM, tpx.PROD, tpx.MIN, tpx.MAX):
            out[f"allreduce/{op.name}"] = tpx.allreduce(x, op=op)[0]
        out["allreduce/BXOR"] = tpx.allreduce(i, op=tpx.BXOR)[0]
        out["bcast"] = tpx.bcast(x, 0)[0]
        out["sendrecv/wrap"] = tpx.sendrecv(x, tmpl, dest=tpx.shift(1))[0]
        out["sendrecv/edge"] = tpx.sendrecv(x, tmpl, dest=tpx.shift(1, wrap=False))[0]
        h, _ = tpx.allreduce_start(x)
        out["allreduce_start"] = tpx.allreduce_wait(h)[0]
        return out

    plain = tpx.spmd(region, comm=comm)()
    tpx.set_fusion_mode("force")
    try:
        fused = tpx.spmd(region, comm=comm)()
    finally:
        tpx.set_fusion_mode(None)
    for out in (plain, fused):
        for key, got in out.items():
            want = (i if key.endswith("BXOR") else
                    tmpl if key == "sendrecv/edge" else x)
            assert got.dtype == want.dtype and torch.equal(got, want), key
            if key != "sendrecv/edge":  # the template itself, as before
                assert got.data_ptr() != want.data_ptr(), key  # a fresh tensor


# ---------------------------------------------------------------------------
# solve_fused(unroll=N) against the JAX package
# ---------------------------------------------------------------------------

SOLVE_MODES = [("pallas2", True), ("wide2", False), ("pallas_halo", True), (True, True)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    # shared with tests/test_torch_megastep.py: one four-rank world a run
    return R0.RunResults(tmp_path_factory, "dispatch")


def jax_solve(results, mode, periodic, grid=(1, 1)):
    def compute():
        nx, ny = R.SOLVE_SIZE if grid != (1, 1) else (48, 24)
        cfg = replace(J.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                      periodic_x=periodic)
        info = {}
        _, n, state = J.solve_fused(cfg, R.SOLVE_STEPS * cfg.dt, num_multisteps=1,
                                    fast=mode, unroll=R.SOLVE_UNROLL, return_state=True,
                                    devices=jax.devices()[:cfg.nproc], info=info)
        return n, info["unroll"], [np.asarray(f) for f in state]

    return results.get(f"jax-{mode}-{periodic}-{grid[0]}x{grid[1]}", compute)


def assert_run_band(want, got, what):
    for name, a, b in zip(J.State._fields, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, name)
        bound = 1e-5 + 2e-6 * np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= bound, f"{what}: {name} off by {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("mode,periodic", SOLVE_MODES,
                         ids=["pallas2", "wide2-walled", "pallas_halo", "fast"])
def test_solve_fused_unroll_matches_jax(results, mode, periodic):
    jn, junroll, want = jax_solve(results, mode, periodic)
    assert junroll == R.SOLVE_UNROLL  # the JAX megastep ran, no fallback
    cfg = replace(P.Config(nx=48, ny=24), periodic_x=periodic)
    info = {}
    _, n, got = P.solve_fused(cfg, R.SOLVE_STEPS * cfg.dt, num_multisteps=1,
                              fast=mode, unroll=R.SOLVE_UNROLL, return_state=True,
                              device="cpu", info=info)
    assert n == jn == R.SOLVE_STEPS
    assert info["unroll"] == R.SOLVE_UNROLL and not info["pinned"]
    assert_run_band([w[0] for w in want], got, f"solve_fused {mode} unroll")
    _, _, whole = P.solve_fused(cfg, R.SOLVE_STEPS * cfg.dt, num_multisteps=1,
                                fast=mode, return_state=True, device="cpu")
    for a, b in zip(whole, got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_solve_fused_unroll_on_a_2x2_grid_matches_jax(results):
    """wide2 on four gloo ranks: the megastep pins run eagerly, the same
    loop; every rank's state against the JAX package's ``global[r]``."""
    jn, junroll, want = jax_solve(results, "wide2", True, grid=(2, 2))
    assert junroll == R.SOLVE_UNROLL
    per_rank = results.get("port-4", lambda: launch.run(
        R.dispatch_program, 4, device="cpu", timeout=R0.RANK_TIMEOUT_S, args=(4,)))
    for r in per_rank:
        assert int(r["solve/n"]) == jn == R.SOLVE_STEPS
        assert list(r["solve/info"]) == [R.SOLVE_UNROLL, 3, 0]
        for a, b in zip(r["solve/whole"], r["solve/unroll"]):
            np.testing.assert_array_equal(a, b)
    got = [np.stack([r["solve/unroll"][k] for r in per_rank]) for k in range(6)]
    assert_run_band(want, got, "solve_fused wide2 unroll (2,2)")


def test_pinned_still_needs_one_cuda_rank():
    """A graph still needs one CUDA rank: on the CPU ``pinned=True`` runs
    the pin's body eagerly, bit for bit with ``pinned=False`` (the
    periodic pallas2 run and the wide2 carried frame), replays nothing and
    names the device."""
    cfg = P.Config(nx=48, ny=24)
    for mode in ("auto", "wide2"):
        runs = {}
        for pinned in (False, True):
            info = {}
            _, n, state = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2,
                                        fast=mode, return_state=True,
                                        device="cpu", pinned=pinned, info=info)
            runs[pinned] = (n, state, info)
        assert runs[True][0] == runs[False][0] == 7
        for a, b in zip(runs[False][1], runs[True][1]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), mode
        info = runs[True][2]
        assert not info["pinned"] and info["replays"] == 0 and info["runs"] == 3
        assert info["eager_reason"] == "device cpu"
        assert "eager_reason" not in runs[False][2]


# ---------------------------------------------------------------------------
# the bench's --unroll
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unrolls,field", [((20, 20), 20), ((20, 0), 0), ((0, 0), 0)])
def test_bench_stamps_unroll_only_when_both_runs_used_it(monkeypatch, unrolls, field):
    calls = []

    def fake(cfg, t1, *, device, fast, pinned, unroll, info):
        calls.append(unroll)
        info.update(pinned=True, unroll=unrolls[len(calls) - 1])
        return 0.1 * len(calls), 441 * len(calls) * 5 ** (len(calls) - 1)

    monkeypatch.setattr(bench, "solve_fused", fake)
    monkeypatch.setattr(bench.torch.cuda, "get_device_name", lambda d=None: "card")
    out = bench.run(unroll=unrolls[0])
    assert calls == [unrolls[0]] * 2 and out["unroll"] == field


def test_bench_parses_unroll(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(bench, "run", lambda unroll=0: seen.append(unroll) or {"u": unroll})
    bench.main(["--unroll", "20"])
    bench.main([])
    assert seen == [20, 0] and capsys.readouterr().out.count("{") == 2


def test_jax_ignores_donate_argnums_zero_the_port_does_not():
    """A reference fault, pinned (ROADMAP Queue 3): the JAX package tests
    ``if donate_argnums`` before it normalizes, so the int 0 donates
    nothing there; the port normalizes first and donates position 0."""
    mesh = mpx.make_world_mesh((1,), ("x",), devices=jax.devices()[:1])
    jp = mpx.compile(lambda v: v * 2.0, jax.numpy.ones((1, 3)),
                     comm=mpx.Comm("x", mesh=mesh), donate_argnums=0)
    tp = tpx.compile(lambda v: v * 2.0, torch.ones(3), comm=one_rank(), donate_argnums=0)
    assert jp.donate_argnums == () and tp.donate_argnums == (0,)


def test_a_static_whose_repr_holds_an_address_still_keys():
    def scale(v):
        return v * 3.0

    pp = tpx.compile(lambda v, f: f(v), torch.ones(2), scale, comm=one_rank(),
                     static_argnums=(1,))
    assert torch.equal(pp(torch.ones(2)), torch.full((2,), 3.0)) and len(pp.key) == 64
