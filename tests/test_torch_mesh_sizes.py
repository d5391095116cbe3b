"""The twins of tests/test_mesh_sizes.py: worlds of 1, 2 and 8 ranks,
ring self-communication, complex and bool, odd world sizes, and the
hybrid ensemble on one 3-axis mesh.

The port's side runs the rank programs of ``tests/torch_ranks_transforms.py``
as gloo ranks on the CPU (once per test run for each case); the JAX side
runs the same cases on the 8-device CPU mesh, its shallow-water members
through ``examples/shallow_water.py`` (its wide kernel in interpret mode,
as tests/test_examples.py runs it).  Rank r's tensor is compared with the
JAX package's ``global[r]``.

Bands: the JAX tests' own, and those of ``tests/test_torch_ops.py`` for
the same op (complex and f32 SUM and PROD rtol 1e-5, the matrix product
rtol 1e-5 and atol 1e-5); a stepper run ``5e-6 + 1e-6 * max|a|``
(tests/test_examples.py:188, as tests/test_torch_multirank_sw.py holds
it); data that only moves, bit for bit.
"""

import os
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_transforms as RT  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "mesh-sizes")


def port_run(results, program, n, arg):
    return results.get(f"{program.__name__}-{n}-{arg}", lambda: launch.run(
        program, n, device="cpu", timeout=R0.RANK_TIMEOUT_S, args=(arg,)))


def _comm(n):
    mesh = mpx.make_world_mesh(devices=jax.devices()[:n])
    return mpx.Comm(mesh.axis_names[0], mesh=mesh)


def stacked(port, key):
    return np.stack([r[key] for r in port])


@pytest.mark.parametrize("n", [1, 2, 8])
def test_collectives_all_sizes(results, n):
    """tests/test_mesh_sizes.py:24: allreduce, allgather, bcast, scan,
    sendrecv and barrier on 1, 2 and 8 ranks, against the JAX test's
    expectations and its results."""
    port = port_run(results, RT.sizes_program, n, n)
    comm = _comm(n)

    @partial(mpx.spmd, comm=comm)
    def f(x):
        a, tok = mpx.allreduce(x, op=mpx.SUM, comm=comm)
        b, tok = mpx.allgather(x, comm=comm, token=tok)
        c, tok = mpx.bcast(x, 0, comm=comm, token=tok)
        d, tok = mpx.scan(x, mpx.SUM, comm=comm, token=tok)
        e, tok = mpx.sendrecv(x, x, dest=mpx.shift(1), comm=comm, token=tok)
        mpx.barrier(comm=comm, token=tok)
        return a, b.sum(0), c, d, e

    want = f(jnp.arange(float(n))[:, None] + 1.0)
    for key, w in zip("abcde", want):
        np.testing.assert_array_equal(stacked(port, key), np.asarray(w), err_msg=key)
    total = np.arange(1.0, n + 1).sum()
    assert (stacked(port, "a") == total).all()
    assert (stacked(port, "c") == 1.0).all()
    np.testing.assert_array_equal(stacked(port, "d").ravel(),
                                  np.cumsum(np.arange(1.0, n + 1)))
    np.testing.assert_array_equal(stacked(port, "e").ravel(),
                                  np.roll(np.arange(1.0, n + 1), 1))


@pytest.mark.parametrize("n", [1, 2])
def test_ring_self_communication(results, n):
    """tests/test_mesh_sizes.py:48: shift(1) on one rank is a self-send."""
    port = port_run(results, RT.sizes_program, n, n)
    np.testing.assert_array_equal(stacked(port, "ring").ravel(),
                                  np.roll(np.arange(float(n)), 1))


def test_complex_and_bool_collectives(results):
    """tests/test_mesh_sizes.py:63 on 8 ranks, widened: complex64 SUM
    (rtol 1e-5), PROD (rtol 1e-5), a ring and gather (bit for bit), and
    bool LOR and LAND (bit for bit), against the JAX package."""
    n = 8
    port = port_run(results, RT.complex_program, n, n)
    comm = _comm(n)
    z, m = RT.complex_inputs(n)

    @partial(mpx.spmd, comm=comm)
    def f(z, m):
        return {"sum": mpx.allreduce(z, op=mpx.SUM, comm=comm)[0],
                "prod": mpx.allreduce(z, op=mpx.PROD, comm=comm)[0],
                "ring": mpx.sendrecv(z, z, dest=mpx.shift(1), comm=comm)[0],
                "gather": mpx.gather(z, 0, comm=comm)[0],
                "lor": mpx.allreduce(m, op=mpx.LOR, comm=comm)[0],
                "land": mpx.allreduce(m, op=mpx.LAND, comm=comm)[0]}

    want = {k: np.asarray(v) for k, v in f(z, m).items()}
    for key, w in want.items():
        got = stacked(port, key)
        assert got.dtype == w.dtype, (key, got.dtype, w.dtype)
        if key in ("sum", "prod"):
            np.testing.assert_allclose(got, w, rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(got, w, err_msg=key)
    np.testing.assert_allclose(stacked(port, "sum")[0], z.sum(0), rtol=1e-5)
    assert (stacked(port, "lor") == m.any(0)).all()


@pytest.mark.parametrize("n", [3, 5, 7])
def test_butterfly_allreduce_odd_sizes(results, n):
    """tests/test_mesh_sizes.py:171: PROD and a non-commutative matrix
    product fold in ascending rank order on every rank, at odd sizes; the
    JAX test's expectations and the JAX package's results."""
    port = port_run(results, RT.odd_program, n, n)
    comm = _comm(n)
    vals, mats = RT.odd_inputs(n)

    @partial(mpx.spmd, comm=comm)
    def f(x, m):
        p, tok = mpx.allreduce(x, op=mpx.PROD, comm=comm)
        mm, _ = mpx.allreduce(m, op=jnp.matmul, comm=comm, token=tok)
        return p, mm

    p, mm = (np.asarray(v) for v in f(vals, mats))
    np.testing.assert_allclose(stacked(port, "prod"), p, rtol=1e-5)
    np.testing.assert_allclose(stacked(port, "prod")[:, 0], np.prod(vals), rtol=1e-6)
    np.testing.assert_allclose(stacked(port, "matmul"), mm, rtol=1e-5, atol=1e-5)
    expected = np.eye(2, dtype=np.float32)
    for r in range(n):
        expected = expected @ mats[r]
    got = stacked(port, "matmul")
    for r in range(n):
        np.testing.assert_array_equal(got[r], got[0])
        np.testing.assert_allclose(got[r], expected, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the hybrid ensemble on one 3-axis mesh
# ---------------------------------------------------------------------------


def jax_ensemble(results, case):
    """tests/test_mesh_sizes.py:121's ensemble in the JAX package: members
    on the ``("py", "px")`` sub-communicator of a ``(2, 2, 2)`` mesh,
    stepped by ``model_step_fast`` (case ``fast``) or by the wide kernel
    that ``auto`` picks (case ``auto``), the mean allreduced over
    ``dp``."""
    nx, ny, fast, steps = RT.ENSEMBLE_CASES[case]

    def compute():
        mesh = mpx.make_world_mesh((2, 2, 2), ("dp", "py", "px"))
        world = mpx.Comm(("dp", "py", "px"), mesh=mesh)
        sp, dpc = world.sub("py", "px"), world.sub("dp")
        cfg = J.Config(nproc_y=2, nproc_x=2, nx=nx, ny=ny)
        s0 = J.initial_state(cfg)

        def ensemble(field, delta):
            return jnp.concatenate([field, field + delta], axis=0)

        fields = [ensemble(s0.h, 0.1)] + [ensemble(f, 0.0) for f in s0[1:]]
        m = J._margin_rows(2)

        @mpx.spmd(comm=world)
        def run(*fields):
            state = J.State(*fields)
            if fast is True:
                state = J.model_step_fast(state, cfg, sp, first_step=True)
                for _ in range(steps):
                    state = J.model_step_fast(state, cfg, sp, first_step=False)
            else:
                interpret = J._resolve_interpret(sp)
                state = J._wide_run(state, 1, cfg, sp, 2, m, interpret,
                                    euler_first=True)
                state = J._wide_run(state, steps, cfg, sp, 2, m, interpret,
                                    euler_first=False)
            total, _ = mpx.allreduce(state.h, op=mpx.SUM, comm=dpc)
            return state, total * 0.5

        state, mean = run(*fields)
        return [np.asarray(f) for f in state], np.asarray(mean), \
            J.select_step(fast, cfg).__name__

    return results.get(f"jax-ensemble-{case}", compute)


def _band(want, got, what):
    bound = 5e-6 + 1e-6 * np.abs(want).max()
    err = np.abs(want - got).max()
    assert err <= bound, f"{what}: off by {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("case", list(RT.ENSEMBLE_CASES))
def test_hybrid_ensemble_spatial_mesh(results, case):
    """Two members on ``world.sub("py", "px")`` of a ``(dp, py, px) =
    (2, 2, 2)`` world, member 1 started 10 cm higher, the mean allreduced
    over ``world.sub("dp")``: the JAX test's 16 x 8 case through
    ``model_step_fast`` and a 64 x 32 one where ``auto`` picks ``wide2``
    (its kernel on each rank's widened frame).  Every field of every rank
    against the JAX package on the same 3-axis mesh (the stepper band);
    the mean on every rank is ``0.5 * (h_member0 + h_member1)`` bit for
    bit; the members differ by more than 1e-3; member 0 is bit for bit
    the same member run alone on a ``(2, 2)`` world."""
    port = port_run(results, RT.ensemble_program, 8, case)
    want_state, want_mean, want_step = jax_ensemble(results, case)
    mode = port[0]["mode"]
    assert mode == ("wide2" if case == "auto" else True)
    assert want_step == ("model_step_wide" if case == "auto" else "model_step_fast")
    coords = [r["coords"] for r in port]
    assert coords == [(r // 4, r % 4, 4, 2) for r in range(8)]
    for k, name in enumerate(J.State._fields):
        got = np.stack([r["state"][k] for r in port])
        assert np.isfinite(got).all(), name
        _band(want_state[k], got, f"{case} {name}")
    h = np.stack([r["state"][0] for r in port])
    mean = stacked(port, "mean")
    _band(want_mean, mean, f"{case} mean")
    for i in range(4):
        want = 0.5 * (h[i] + h[i + 4])
        np.testing.assert_array_equal(mean[i], want)
        np.testing.assert_array_equal(mean[i + 4], want)
    assert np.abs(h[:4] - h[4:]).max() > 1e-3
    alone = port_run(results, RT.member_program, 4, case)
    for k, name in enumerate(J.State._fields):
        np.testing.assert_array_equal(np.stack([r["state"][k] for r in port[:4]]),
                                      np.stack([r["state"][k] for r in alone]),
                                      err_msg=name)
