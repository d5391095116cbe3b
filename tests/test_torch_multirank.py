"""The port's communicator over 2, 4 and 8 gloo ranks against the JAX package.

The port's side runs ``tests/torch_ranks.py:comm_program`` as gloo ranks
on the CPU (started once per test run for each world size); the JAX side
runs the same ops on the 8-device CPU mesh (the first ``size`` devices),
on the same seeded inputs.  Rank r's tensor is compared with the JAX
package's ``global[r]``, exactly: these ops only move data.  Also here:
``parallel/launch.py``'s failure handling and the NCCL device rule.
"""

import time
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

import torch_ranks as R  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch, mesh as tmesh  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.RunResults(tmp_path_factory, "multirank-comm")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.comm_program, size, device="cpu", timeout=R.RANK_TIMEOUT_S,
        args=(size,)))


def jax_world(size):
    mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
    return mpx.Comm("x", mesh=mesh)


def jax_grid(size):
    mesh = mpx.make_world_mesh(R.grid_of(size), ("py", "px"),
                               devices=jax.devices()[:size])
    return mpx.Comm(("py", "px"), mesh=mesh)


def jax_results(results, size):
    """The JAX package's results of every op ``comm_program`` runs."""

    def compute():
        x = jnp.asarray(R.comm_inputs(size))
        tmpl = jnp.full_like(x, -3.0)
        world, grid = jax_world(size), jax_grid(size)
        out = {}
        for k, wrap in R.SHIFTS:
            out[f"world/{k}/{wrap}"] = mpx.sendrecv(
                x, tmpl, dest=mpx.shift(k, wrap=wrap), comm=world)[0]
        out["world/source"] = mpx.sendrecv(x, tmpl, source=mpx.shift(1),
                                           comm=world)[0]
        out["world/column"] = mpx.sendrecv(x[:, :, 1], tmpl[:, :, 0],
                                           dest=mpx.shift(1), comm=world)[0]
        out["world/gather"] = mpx.gather(x, 0, comm=world)[0]
        out["grid/gather"] = mpx.gather(x, 0, comm=grid)[0]

        @partial(mpx.spmd, comm=grid)
        def facts(x):
            px, py = grid.sub("px"), grid.sub("py")
            return jnp.stack([
                jnp.int32(grid.Get_size()), jnp.int32(grid.Get_rank()),
                jnp.int32(px.Get_size()), jnp.int32(px.Get_rank()),
                jnp.int32(py.Get_size()), jnp.int32(py.Get_rank()),
                jax.lax.axis_index("py"), jax.lax.axis_index("px"),
            ])[None]

        out["grid/facts"] = np.asarray(facts(x))[:, 0]
        for axis in ("px", "py"):
            @partial(mpx.spmd, comm=grid)
            def sub_gather(x, axis=axis):
                return mpx.gather(x, 0, comm=grid.sub(axis))[0]

            out[f"{axis}/gather"] = sub_gather(x)
            for k, wrap in R.SHIFTS:
                @partial(mpx.spmd, comm=grid)
                def sub_shift(x, t, axis=axis, k=k, wrap=wrap):
                    return mpx.sendrecv(x, t, dest=mpx.shift(k, wrap=wrap),
                                        comm=grid.sub(axis))[0]

                out[f"{axis}/{k}/{wrap}"] = sub_shift(x, tmpl)
        return {k: np.asarray(v) for k, v in out.items()}

    return results.get(f"jax-{size}", compute)


def stacked(per_rank, key):
    return np.stack([r[key] for r in per_rank])


SEND_KEYS = ([f"world/{k}/{w}" for k, w in R.SHIFTS]
             + ["world/source", "world/column"])


@pytest.mark.parametrize("key", SEND_KEYS)
@pytest.mark.parametrize("size", SIZES)
def test_world_sendrecv_matches_jax(results, size, key):
    """``shift(±1, wrap=True/False)`` on the 1-D world, the receiver-centric
    ``source=`` form, and a strided column as the send buffer."""
    want = jax_results(results, size)[key]
    np.testing.assert_array_equal(stacked(port_run(results, size), key), want)


@pytest.mark.parametrize("k,wrap", R.SHIFTS)
@pytest.mark.parametrize("axis", ["px", "py"])
@pytest.mark.parametrize("size", SIZES)
def test_sub_comm_sendrecv_matches_jax(results, size, axis, k, wrap):
    """Shifts on the row (px) and column (py) sub-communicators of the
    solver's grid: (2,1), (2,2), (2,4).  On (2,2) a wrapping px shift has
    the same peer on both sides."""
    key = f"{axis}/{k}/{wrap}"
    want = jax_results(results, size)[key]
    np.testing.assert_array_equal(stacked(port_run(results, size), key), want)


@pytest.mark.parametrize("key", ["world/gather", "grid/gather", "px/gather",
                                 "py/gather"])
@pytest.mark.parametrize("size", SIZES)
def test_gather_matches_jax(results, size, key):
    """Every rank gets the ``(comm size, *s)`` gather in comm-rank order."""
    want = jax_results(results, size)[key]
    np.testing.assert_array_equal(stacked(port_run(results, size), key), want)


@pytest.mark.parametrize("size", SIZES)
def test_grid_comm_facts_match_jax(results, size):
    """``make_world_mesh`` on the solver's grid: ``Get_size``/``Get_rank`` of
    the grid comm and of both sub-comms, and the axis indices."""
    want = jax_results(results, size)["grid/facts"]
    np.testing.assert_array_equal(stacked(port_run(results, size), "grid/facts"),
                                  want)


@pytest.mark.parametrize("size", SIZES)
def test_stats_count_every_multi_rank_op(results, size):
    """``comm_program`` makes 4 shifts, the ``source=`` form, the column and
    the aliasing check on the world, a gather on it and on the grid, and a
    gather and 4 shifts on each sub-comm of more than one rank (ops on a
    size-1 comm send no message).  CPU tensors are never staged."""
    py, px = R.grid_of(size)
    per_sub = 1 + len(R.SHIFTS)
    want = len(R.SHIFTS) + 3 + 2 + per_sub * ((py > 1) + (px > 1))
    np.testing.assert_array_equal(stacked(port_run(results, size), "stats"),
                                  np.tile([want, 0], (size, 1)))


@pytest.mark.parametrize("size", SIZES)
def test_result_does_not_alias_send_buffer(results, size):
    per_rank = port_run(results, size)
    np.testing.assert_array_equal(stacked(per_rank, "world/no_alias"),
                                  jax_results(results, size)["world/1/True"])


# ---------------------------------------------------------------------------
# the launcher and the device rule
# ---------------------------------------------------------------------------


def test_failing_rank_fails_the_run_quickly_with_its_traceback():
    start = time.monotonic()
    with pytest.raises(launch.RankError) as err:
        launch.run(R.raise_on, 2, device="cpu", timeout=R.RANK_TIMEOUT_S,
                   args=(1,))
    assert time.monotonic() - start < 30
    assert 1 in err.value.tracebacks
    assert "deliberate failure on rank 1" in err.value.tracebacks[1]
    assert "Traceback" in str(err.value)


def test_hung_run_is_killed_at_its_time_limit():
    start = time.monotonic()
    with pytest.raises(launch.RankError, match="time limit"):
        launch.run(R.sleep_forever, 2, device="cpu", timeout=8)
    assert time.monotonic() - start < 20


@pytest.mark.parametrize("device", ["cuda:0", None, "cpu"])
def test_nccl_refuses_ranks_sharing_a_device(device):
    """NCCL needs a GPU of its own for every rank: two ranks on one device
    (or on a host without GPUs) raise before any rank starts."""
    with pytest.raises(ValueError, match="nccl"):
        launch.run(R.raise_on, 2, backend="nccl", device=device, args=(0,))


def test_device_rule_per_backend():
    assert tmesh.device_for_rank("gloo", "cpu", 3, 4) == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tmesh.device_for_rank("mpi", "cpu", 0, 1)
    with pytest.raises(ValueError, match="one GPU per rank"):
        tmesh.device_for_rank("nccl", None, 0, 2)


def test_grid_size_must_equal_world_size():
    with pytest.raises(launch.RankError, match="world has 2"):
        launch.run(R.grid_of_wrong_size, 2, device="cpu", timeout=R.RANK_TIMEOUT_S)
