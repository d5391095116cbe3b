"""The port's shallow-water solver on several ranks against the JAX package.

The port's side runs as gloo ranks on the CPU (``tests/torch_ranks.py:
sw_program``, started once per test run for each grid), the JAX side on
the 8-device CPU mesh through its interpret branches, as
``tests/test_examples.py`` runs it.  Rank r's tensor is compared with the
JAX package's ``global[r]``.

Bands, from the JAX suite (``tests/test_examples.py``): ``5e-6 + 1e-6 *
max|a|`` for a stepper run (``:188``, ``:291``), ``1e-5 + 2e-6 * max|a|``
for ``solve_fused``'s carried-frame run (``:337``); the exchange
functions move data and must agree exactly.  The two frameworks evaluate
the same operands in the same order; what remains is rounding in XLA's
fused arithmetic.
"""

import os
import sys
from dataclasses import replace
from functools import partial
from math import prod

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

import torch_ranks as R  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

GRIDS = [(2, 4), (2, 2)]
BOUNDARIES = ["periodic", "walled"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.RunResults(tmp_path_factory, "multirank-sw")


def port_run(results, grid):
    """Every rank's results of ``sw_program`` on ``grid``, within a budget
    that grows with the world (``R.world_timeout``)."""
    return results.get(f"port-{grid[0]}x{grid[1]}", lambda: launch.run(
        R.sw_program, prod(grid), device="cpu", timeout=R.world_timeout(prod(grid)),
        args=(grid,)))


def jax_config(size, grid, periodic):
    nx, ny = size
    return replace(J.Config(nx=nx, ny=ny, nproc_y=grid[0], nproc_x=grid[1]),
                   periodic_x=periodic)


def jax_comm(cfg):
    return J.make_mesh_and_comm(cfg, devices=jax.devices()[:cfg.nproc])[1]


def jax_mode(mode, cfg):
    """The JAX mode an "auto" port run is compared with: the one JAX's
    "auto" resolves to."""
    if mode != "auto":
        return mode
    return {"model_step_wide": "wide2",
            "model_step_pallas_halo": "pallas_halo"}[J.select_step("auto", cfg).__name__]


def jax_stepper(results, grid, periodic, size, mode):
    cfg = jax_config(size, grid, periodic)
    mode = jax_mode(mode, cfg)

    def compute():
        first, multi = J.make_stepper(cfg, jax_comm(cfg), fast=mode)
        return [np.asarray(f) for f in multi(first(J.initial_state(cfg)), R.STEPS)]

    return results.get(f"jax-step-{grid}-{periodic}-{size}-{mode}", compute)


def stacked(per_rank, key):
    """The port's result ``key`` of every rank, stacked like the JAX
    package's global arrays: a list of ``(nproc, ...)`` arrays per field,
    or one array."""
    first = per_rank[0][key]
    if isinstance(first, tuple):
        return [np.stack([r[key][k] for r in per_rank]) for k in range(len(first))]
    return np.stack([r[key] for r in per_rank])


def assert_band(want, got, abs_, rel, what):
    for name, a, b in zip(J.State._fields, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        bound = abs_ + rel * np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= bound, f"{what}: field {name} off by {err:.3e} > {bound:.3e}"


def _step_cases():
    out = []
    for grid in GRIDS:
        for periodic in BOUNDARIES:
            for size, mode in R.mode_cases(grid):
                out.append((grid, periodic, size, mode))
    return out


# ---------------------------------------------------------------------------
# make_stepper on (2,4) and (2,2), every mode, against the JAX stepper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "grid,boundary,size,mode", _step_cases(),
    ids=[f"{g[0]}x{g[1]}-{b}-{s[0]}x{s[1]}-{m}" for g, b, s, m in _step_cases()])
def test_stepper_matches_jax(results, grid, boundary, size, mode):
    """First step, then 11 steps: whole pairs and a remainder for the pair
    modes.  Band 5e-6 + 1e-6 * max|a|."""
    periodic = boundary == "periodic"
    want = jax_stepper(results, grid, periodic, size, mode)
    got = stacked(port_run(results, grid), f"step/{boundary}/{size[0]}/{mode}")
    assert_band(want, got, 5e-6, 1e-6, f"{grid} {boundary} {mode}")


@pytest.mark.parametrize("n", R.RUN_LENGTHS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_wide_run_lengths_match_fast_step(results, grid, boundary, n):
    """``_wide_run``'s bookkeeping (Euler call, a fresh first chunk, the
    refreshes, the remainder) over runs of 1, 2, 5 and 11 steps after the
    first: wide2 against the port's model_step_fast on the same ranks,
    band 5e-6 + 1e-6 * max|a| (the JAX suite's wide-against-fast band)."""
    per_rank = port_run(results, grid)
    want = stacked(per_rank, f"run/{boundary}/{n}/True")
    got = stacked(per_rank, f"run/{boundary}/{n}/wide2")
    assert_band(want, got, 5e-6, 1e-6, f"wide2 {n} steps")


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def test_solve_fused_wide2_matches_jax(results):
    """The carried-frame run of ``solve_fused`` (Euler call, pairs, a
    remainder; 26 steps) on (2,4) against the JAX package's, band
    1e-5 + 2e-6 * max|a|."""
    cfg = jax_config(R.WIDE_SIZE, (2, 4), True)

    def compute():
        _, n, s = J.solve_fused(cfg, 23 * cfg.dt, num_multisteps=5, fast="wide2",
                                return_state=True)
        return n, [np.asarray(f) for f in s]

    jn, want = results.get("jax-solve-fused", compute)
    per_rank = port_run(results, (2, 4))
    assert int(per_rank[0]["solve_fused/n"]) == jn == 26
    # three whole runs, and the timed one spent time in its exchanges
    for r in per_rank:
        runs, exchange_s = r["solve_fused/info"]
        assert runs == 3 and exchange_s > 0
    assert_band(want, stacked(per_rank, "solve_fused/wide2"), 1e-5, 2e-6,
                "solve_fused wide2")


@pytest.mark.parametrize("mode", ["pallas_halo", True, "wide2"])
def test_solve_gathered_h_matches_jax(results, mode):
    """``solve(collect=True)``: every rank's gathered ``(nproc, ny_l,
    nx_l)`` final ``h`` equals the stacked local ones and matches the JAX
    package's root-gathered view, band 5e-6 + 1e-6 * max|a|."""
    size = R.WIDE_SIZE if mode == "wide2" else R.HALO_SIZE
    cfg = jax_config(size, (2, 4), True)

    def compute():
        snaps, _, _ = J.solve(cfg, 20 * cfg.dt, num_multisteps=5, fast=mode)
        return np.asarray(snaps[-1])

    want = results.get(f"jax-solve-{mode}", compute)
    per_rank = port_run(results, (2, 4))
    local = stacked(per_rank, f"solve/{mode}/local")
    for r in per_rank:
        np.testing.assert_array_equal(r[f"solve/{mode}/gathered"], local)
    bound = 5e-6 + 1e-6 * np.abs(want).max()
    assert np.abs(local - want).max() <= bound


@pytest.mark.parametrize("mode", ["pallas_halo", True, "wide2"])
def test_decomposition_invariance_bitwise(results, mode):
    """Port (2,4) against port (1,1) after ``reassemble``, 20 steps: the
    same bits, as the JAX suite pins for pallas_halo and the fast step.
    For wide2 the JAX suite allows 1 ulp (XLA groups the FMAs of its two
    frame shapes differently); PyTorch runs every op unfused, so the port
    is held to the same bits."""
    size = R.WIDE_SIZE if mode == "wide2" else R.HALO_SIZE
    cfg8 = R.config(size, (2, 4), True)
    cfg1 = R.config(size, (1, 1), True)
    snaps, _, _ = P.solve(cfg1, 20 * cfg1.dt, num_multisteps=5, device="cpu",
                          fast=mode)
    local = stacked(port_run(results, (2, 4)), f"solve/{mode}/local")
    np.testing.assert_array_equal(P.reassemble(local, cfg8),
                                  P.reassemble(snaps[-2][None], cfg1))


def test_pinned_multi_rank_runs_the_pin_eagerly(results):
    """``pinned=True`` on (2,4), as the JAX package pins on any mesh: a
    CUDA graph cannot capture host-staged exchanges, so the pin is its
    body run eagerly, bit for bit with ``pinned=False`` on every rank,
    ``info["pinned"]`` False and the world named; the state against the
    JAX package's ``solve_fused(pinned=True)`` on its (2,4) CPU mesh,
    band 1e-5 + 2e-6 * max|a|."""
    cfg = jax_config(R.WIDE_SIZE, (2, 4), True)

    def compute():
        _, n, s = J.solve_fused(cfg, 23 * cfg.dt, num_multisteps=5, fast="wide2",
                                return_state=True, pinned=True)
        return n, [np.asarray(f) for f in s]

    jn, want = results.get("jax-solve-fused-pinned", compute)
    assert jn == 26
    per_rank = port_run(results, (2, 4))
    for r in per_rank:
        assert r["solve_fused/pinned_info"] == {
            "runs": 3, "pinned": False, "eager_reason": "8 ranks", "replays": 0}
        for a, b in zip(r["solve_fused/wide2"], r["solve_fused/wide2/pinned"]):
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert_band(want, stacked(per_rank, "solve_fused/wide2/pinned"), 1e-5, 2e-6,
                "solve_fused wide2 pinned")


# ---------------------------------------------------------------------------
# the exchange functions, against the JAX package's on the same data
# ---------------------------------------------------------------------------


def jax_exchange(results, grid, periodic):
    cfg = jax_config(R.WIDE_SIZE, grid, periodic)
    m = J._margin_rows(2)
    local, wide = R.exchange_inputs(cfg, m)

    def compute():
        comm = jax_comm(cfg)

        @partial(mpx.spmd, comm=comm)
        def exch(*fields):
            return J._wide_exchange(tuple(fields), cfg, comm, m, mpx.create_token())[0]

        @partial(mpx.spmd, comm=comm)
        def refresh(*frames):
            return J._wide_refresh(tuple(frames), cfg, comm, m, mpx.create_token())

        @partial(mpx.spmd, comm=comm)
        def crop(*frames):
            return J._wide_crop(tuple(frames), cfg, m)

        @partial(mpx.spmd, comm=comm)
        def enforce(h):
            tok = mpx.create_token()
            return tuple(J.enforce_boundaries(h, k, cfg, comm, tok)[0]
                         for k in ("h", "u", "v"))

        @partial(mpx.spmd, comm=comm)
        def offsets(h):
            return J._rank_offsets(cfg)[None]

        as_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
        return {
            "exchange": as_np(exch(*map(jnp.asarray, local))),
            "refresh": as_np(refresh(*map(jnp.asarray, wide))),
            "crop": as_np(crop(*map(jnp.asarray, wide))),
            "enforce": as_np(enforce(jnp.asarray(local[0]))),
            "offsets": np.asarray(offsets(jnp.asarray(local[0])))[:, 0],
        }

    return results.get(f"jax-exchange-{grid}-{periodic}", compute)


@pytest.mark.parametrize("fn", ["exchange", "refresh", "crop"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_wide_exchange_functions_match_jax(results, grid, boundary, fn):
    """``_wide_exchange``, ``_wide_refresh`` and ``_wide_crop`` on seeded
    random arrays: the same values as the JAX package's, exactly (they
    only move data).  On (2,2) the px axis has two ranks, so a periodic
    run's east and west strips go to the same peer."""
    want = jax_exchange(results, grid, boundary == "periodic")[fn]
    got = stacked(port_run(results, grid), f"{fn}/{boundary}")
    for name, a, b in zip(J.State._fields, want, got):
        np.testing.assert_array_equal(b, a, err_msg=f"{fn} {name}")


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_enforce_boundaries_and_offsets_match_jax(results, grid, boundary):
    """``enforce_boundaries`` of every kind on a seeded random array (its
    strided column sends included), and ``_rank_offsets``, exactly."""
    want = jax_exchange(results, grid, boundary == "periodic")
    per_rank = port_run(results, grid)
    for kind, a in zip(("h", "u", "v"), want["enforce"]):
        np.testing.assert_array_equal(
            stacked(per_rank, f"enforce/{boundary}/{kind}"), a, err_msg=kind)
    np.testing.assert_array_equal(stacked(per_rank, f"offsets/{boundary}"),
                                  want["offsets"])
