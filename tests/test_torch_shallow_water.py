"""The port's shallow-water model against the JAX package's, on the CPU.

Same configs, same initial state, the JAX side on the 1-device CPU mesh as
``tests/test_examples.py`` runs it, the port's side on the CPU through its
plain PyTorch versions.  Tolerance: the JAX suite's band for the fused
kernel against ``model_step_fast``, ``5e-6 + 1e-6 * max|a|``: the two
frameworks evaluate the same operands in the same order, and what remains
is rounding in reordered or fused arithmetic (XLA fuses; PyTorch runs each
op on its own).
"""

import functools
import os
import sys
from dataclasses import asdict, replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

from mpi4jax_tpu_torch import convert, entry as tentry  # noqa: E402
from mpi4jax_tpu_torch import bench as tbench  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]


def assert_in_band(ref_state, port_state, what):
    for name, a, b in zip(J.State._fields, ref_state, port_state):
        a = np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        bound = 5e-6 + 1e-6 * np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= bound, f"{what}: field {name} off by {err:.3e} > {bound:.3e}"


def jax_local(state, rank=0):
    """Rank ``rank``'s block of a JAX stacked-block state, as numpy."""
    return J.State(*(np.asarray(f)[rank] for f in state))


def configs(nx, ny, nproc_y=1, nproc_x=1, periodic=True):
    j = replace(J.Config(nx=nx, ny=ny, nproc_y=nproc_y, nproc_x=nproc_x),
                periodic_x=periodic)
    return j, convert.config_from_jax(asdict(j))


def port_comm(cfg):
    return P.make_mesh_and_comm(cfg, device="cpu")[1]


# ---------------------------------------------------------------------------
# initial state and conversion
# ---------------------------------------------------------------------------

_IC_CASES = [((1, 1, 48, 24), 0), ((1, 1, 40, 270), 0), ((1, 1, 3600, 18), 0)] + [
    ((2, 4, 48, 24), r) for r in range(8)
]


@pytest.mark.parametrize("grid,rank", _IC_CASES,
                         ids=[f"{g}-r{r}" for g, r in _IC_CASES])
def test_initial_state_bitwise(grid, rank):
    npy, npx, nx, ny = grid
    jcfg, pcfg = configs(nx, ny, npy, npx)
    want = jax_local(J.initial_state(jcfg), rank)
    got = P.initial_state(pcfg, rank=rank, device="cpu")
    for name, a, b in zip(J.State._fields, want, got):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("grid", [(1, 1), (2, 4)])
def test_state_from_jax_round_trip(grid):
    jcfg, pcfg = configs(48, 24, *grid)
    stacked = [np.asarray(f) for f in J.initial_state(jcfg)]
    # perturb so that every field, dh/du/dv included, carries data
    rng = np.random.default_rng(3)
    stacked = [a + rng.standard_normal(a.shape).astype(np.float32) for a in stacked]
    per_rank = [convert.state_from_jax(stacked, pcfg, rank=r, device="cpu")
                for r in range(pcfg.nproc)]
    for k, a in enumerate(stacked):
        back = torch.stack([s[k] for s in per_rank]).numpy()
        np.testing.assert_array_equal(back, a)


def test_config_from_jax_round_trip():
    jcfg = replace(J.Config(nx=64, ny=32, nproc_y=2, nproc_x=2), periodic_x=False)
    pcfg = convert.config_from_jax(asdict(jcfg))
    assert asdict(pcfg) == asdict(jcfg)
    for prop in ("dt", "lateral_viscosity", "ny_local", "nx_local", "nproc"):
        assert getattr(pcfg, prop) == getattr(jcfg, prop)


@pytest.mark.parametrize("bad", ["shape", "rank", "count", "field"])
def test_convert_rejects_bad_input(bad):
    jcfg, pcfg = configs(48, 24)
    arrays = [np.asarray(f) for f in J.initial_state(jcfg)]
    with pytest.raises((ValueError, TypeError)):
        if bad == "shape":
            convert.state_from_jax([a[:, 1:] for a in arrays], pcfg, device="cpu")
        elif bad == "rank":
            convert.state_from_jax(arrays, pcfg, rank=1, device="cpu")
        elif bad == "count":
            convert.state_from_jax(arrays[:5], pcfg, device="cpu")
        else:
            convert.config_from_jax({"nx": 8, "bogus": 1})


def test_reassemble_matches_jax():
    jcfg, pcfg = configs(48, 24, 2, 4)
    stacked = np.asarray(J.initial_state(jcfg).h)
    np.testing.assert_array_equal(P.reassemble(stacked, pcfg),
                                  J.reassemble(stacked, jcfg))


# ---------------------------------------------------------------------------
# model_step / model_step_fast against JAX fast=False / fast=True
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(fast, periodic, nsteps, nx=48, ny=24):
    jcfg, _ = configs(nx, ny, periodic=periodic)
    _, comm = J.make_mesh_and_comm(jcfg, devices=jax.devices()[:1])
    first, multi = J.make_stepper(jcfg, comm, fast=fast)
    s = first(J.initial_state(jcfg))
    if nsteps > 1:
        s = multi(s, nsteps - 1)
    return jax_local(s)


@pytest.mark.parametrize("nsteps", [1, 20])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("fast", [False, True], ids=["model_step", "model_step_fast"])
def test_step_matches_jax(fast, periodic, nsteps):
    _, pcfg = configs(48, 24, periodic=periodic)
    first, multi = P.make_stepper(pcfg, port_comm(pcfg), fast=fast)
    s = first(P.initial_state(pcfg, device="cpu"))
    if nsteps > 1:
        s = multi(s, nsteps - 1)
    assert_in_band(_jax_run(fast, periodic, nsteps), s,
                   f"fast={fast} periodic={periodic} steps={nsteps}")


@pytest.mark.parametrize("periodic", [True, False])
def test_fast_step_equals_reference_step_in_port(periodic):
    """On one rank the port's two plain steps agree within the JAX suite's
    single-rank band for model_step_fast against model_step."""
    _, pcfg = configs(48, 24, periodic=periodic)
    comm = port_comm(pcfg)
    outs = []
    for fast in (False, True):
        first, multi = P.make_stepper(pcfg, comm, fast=fast)
        outs.append(multi(first(P.initial_state(pcfg, device="cpu")), 19))
    for a, b in zip(*outs):
        bound = 2e-5 + 1e-5 * a.abs().max().item()
        assert (a - b).abs().max().item() <= bound


# ---------------------------------------------------------------------------
# mode selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,step,chunk,size", [
    (False, "model_step", None, 1),
    (True, "model_step_fast", None, 1),
    ("pallas", "model_step_fused", None, 1),
    ("pallas2", "model_step_fused", "model_step2_fused", 2),
    ("pallas3", "model_step_fused", "model_step3_fused", 3),
    ("auto", "model_step_fused", "model_step2_fused", 2),
])
def test_select_steps_table(mode, step, chunk, size):
    _, pcfg = configs(48, 24)
    jcfg, _ = configs(48, 24)
    s, c, n = P.select_steps(mode, pcfg)
    js, jc, jn = J.select_steps(mode, jcfg)
    assert s.__name__ == step and n == size == jn
    assert (c.__name__ if c else None) == chunk
    assert (jc is None) == (c is None)


@pytest.mark.parametrize("mode,grid,nx,ny,periodic", [
    ("pallas_halo", (1, 1), 48, 24, True),
    ("wide", (1, 1), 48, 24, True),
    ("wide2", (1, 1), 48, 24, True),
    ("auto", (2, 4), 48, 24, True),    # JAX picks pallas_halo
    ("auto", (2, 4), 64, 32, True),    # JAX picks wide2
    ("auto", (1, 1), 48, 24, False),   # walls: JAX picks wide2
    ("auto", (1, 1), 48, 12, False),   # small walls: JAX picks pallas_halo
])
def test_select_steps_unported_modes_raise(mode, grid, nx, ny, periodic):
    jcfg, pcfg = configs(nx, ny, *grid, periodic=periodic)
    want = J.select_step(mode, jcfg).__name__
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        P.select_steps(mode, pcfg)
    if mode == "auto":
        picked = {"model_step_pallas_halo": "pallas_halo",
                  "model_step_wide": "wide2"}[want]
        assert repr(picked) in str(err.value)


def test_select_step_auto_needs_cfg():
    with pytest.raises(ValueError, match="needs the Config"):
        P.select_step("auto")


@pytest.mark.parametrize("mode", ["pallas", "pallas2", "pallas3"])
def test_fused_rejects_walled_config(mode):
    _, pcfg = configs(48, 24, periodic=False)
    first, _ = P.make_stepper(pcfg, port_comm(pcfg), fast=mode)
    with pytest.raises(ValueError, match="single-rank periodic-x"):
        first(P.initial_state(pcfg, device="cpu"))


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fast", [True, "auto"])
@pytest.mark.parametrize("nms,t_steps", [(5, 23), (2, 7), (10, 1)])
def test_solve_fused_step_count_equals_solve(fast, nms, t_steps):
    _, pcfg = configs(48, 24)
    t1 = t_steps * pcfg.dt
    _, _, n_host = P.solve(pcfg, t1, num_multisteps=nms, collect=False,
                           device="cpu", fast=fast)
    wall, n_fused = P.solve_fused(pcfg, t1, num_multisteps=nms, device="cpu",
                                  fast=fast)
    jcfg, _ = configs(48, 24)
    assert n_fused == n_host == 1 + max(
        0, int(np.ceil((t1 - jcfg.dt) / (jcfg.dt * nms)))) * nms
    assert wall > 0


def test_solve_snapshots_and_gather():
    _, pcfg = configs(48, 24)
    snaps, wall, n = P.solve(pcfg, 10 * pcfg.dt, num_multisteps=5,
                             device="cpu", fast="auto")
    assert n == 11 and wall > 0
    assert len(snaps) == 2 + 2 + 1
    final = snaps[-2]
    assert np.all(np.isfinite(final)) and 90 < final.mean() < 110
    # the gathered copy of the final state: uniform (nproc, ny_l, nx_l)
    assert snaps[-1].shape == (1, *final.shape)
    np.testing.assert_array_equal(snaps[-1][0], final)


def test_solve_fused_matches_jax_solve_fused():
    jcfg, pcfg = configs(48, 24)
    t1 = 7 * jcfg.dt
    _, jn, jstate = J.solve_fused(jcfg, t1, num_multisteps=2, fast="auto",
                                  return_state=True, devices=jax.devices()[:1])
    info = {}
    _, n, state = P.solve_fused(pcfg, t1, num_multisteps=2, fast="auto",
                                return_state=True, device="cpu", info=info)
    assert n == jn == 7
    assert info == {"runs": 3, "pinned": False}
    assert_in_band(jax_local(jstate), state, "solve_fused auto")


def test_entry_matches_jax_entry():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import entry as jentry

    jfn, (jstate,) = jentry()
    fn, (state,) = tentry.entry(device="cpu")
    for a, b in zip(jax_local(jstate), state):
        np.testing.assert_array_equal(b.numpy(), a)
    assert_in_band(jax_local(jax.jit(jfn)(jstate)), fn(state), "entry")


def test_pinned_needs_cuda_device():
    _, pcfg = configs(48, 24)
    with pytest.raises(ValueError, match="CUDA"):
        P.solve_fused(pcfg, pcfg.dt, device="cpu", pinned=True)


def test_pick_process_grid_matches_jax():
    for n in (1, 2, 4, 8):
        assert P.pick_process_grid(n) == J.pick_process_grid(n)
    with pytest.raises(ValueError):
        P.pick_process_grid(3)


# ---------------------------------------------------------------------------
# the device rule: no silent CPU fallback
# ---------------------------------------------------------------------------

_CFG = P.Config(nx=8, ny=8)
_ENTRY_POINTS = {
    "initial_state": lambda dev: P.initial_state(_CFG, device=dev),
    "make_mesh_and_comm": lambda dev: P.make_mesh_and_comm(_CFG, device=dev),
    "solve": lambda dev: P.solve(_CFG, _CFG.dt, device=dev),
    "solve_fused": lambda dev: P.solve_fused(_CFG, _CFG.dt, device=dev),
    "entry": lambda dev: tentry.entry(device=dev),
    "state_from_jax": lambda dev: convert.state_from_jax(
        [np.zeros((1, 10, 10), np.float32)] * 6, _CFG, device=dev),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name](None)
    _ENTRY_POINTS[name]("cpu")  # the CPU on request


def test_bench_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run()
