"""The ``dryrun_multichip`` twin on 2 and 4 gloo ranks against the JAX
package.

``mpi4jax_tpu_torch.entry.dryrun_multichip(n, device="cpu")`` runs the five
families of ``__graft_entry__.py:dryrun_multichip`` on n gloo ranks on the
CPU and raises if one of its checks fails.  Each family's numbers are held
here against the JAX package computed directly on the same inputs, on the
first n devices of the 8-device CPU mesh (not against
tests/test_graft_entry.py): the shallow-water states in the band of
tests/test_examples.py:188 (``5e-6 + 1e-6 * max|a|``), the DP step's
weights rtol 1e-6, ring attention's output rtol 2e-4, atol 2e-5 and its
gradient rtol 2e-3, atol 2e-4 (``__graft_entry__.py:206,223``), and the
split, scan and p2p results exactly.
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
from mpi4jax_tpu import attention as JA  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

import torch_ranks as R0  # noqa: E402
from mpi4jax_tpu_torch import entry as E  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4]
# the port's step functions by the JAX example's names
PORT_STEP = {"model_step_fused_halo": "model_step_pallas_halo",
             "model_step_wide": "model_step_wide"}
CHECKS = ["shallow_water/halo", "shallow_water/wide", "data_parallel",
          "ring_attention", "color_split_allreduce", "kernel_launches",
          "kernels_vs_plain"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "dryrun")


def port_run(results, n):
    return results.get(f"port-{n}", lambda: E.dryrun_multichip(
        n, device="cpu", timeout=R0.RANK_TIMEOUT_S))


def jax_results(results, n):
    def compute():
        devices = jax.devices()[:n]
        ny, nx = E.twin_grid(n)
        out = {}
        for key, cfg, steps in (("halo", J.Config(nproc_y=ny, nproc_x=nx, nx=8 * nx,
                                                  ny=8 * ny), 2),
                                ("wide", J.Config(nproc_y=ny, nproc_x=nx, nx=16 * nx,
                                                  ny=16 * ny), 3)):
            _, comm = J.make_mesh_and_comm(cfg, devices=devices)
            first, multi = J.make_stepper(cfg, comm, fast="auto")
            out[f"sw/{key}"] = [np.asarray(f) for f in
                                multi(first(J.initial_state(cfg)), steps)]
            out[f"sw/{key}/mode"] = J.select_step("auto", cfg).__name__
        inputs = E.twin_inputs(n)
        dp = mpx.Comm("dp", mesh=mpx.make_world_mesh((n,), ("dp",), devices=devices))

        def local_loss(w, x):
            return jnp.sum(jnp.tanh(x @ w) ** 2)

        @partial(mpx.spmd, comm=dp)
        def train_step(w, x):
            g = jax.grad(local_loss)(w, x)
            return w - 1e-2 * mpx.allreduce(g, op=mpx.SUM, comm=dp)[0]

        out["dp/w"] = np.asarray(train_step(jnp.asarray(inputs["w"]),
                                            jnp.asarray(inputs["x"])))
        q, k, v = (jnp.asarray(a) for a in inputs["qkv"])

        @partial(mpx.spmd, comm=dp)
        def ring(q, k, v):
            return JA.ring_attention(q, k, v, comm=dp, causal=True)

        @partial(mpx.spmd, comm=dp)
        def ring_loss(q, k, v):
            out = JA.ring_attention(q, k, v, comm=dp, causal=True)
            return mpx.varying(mpx.allreduce((out ** 2).sum(), op=mpx.SUM, comm=dp)[0])

        out["ring/out"] = np.asarray(ring(q, k, v))
        out["ring/grad"] = np.asarray(jax.grad(
            lambda q: jnp.sum(ring_loss(q, k, v)) / n)(q))
        split = dp.Split([i % 2 for i in range(n)] if n % 2 == 0 else [0] * n)
        xv = jnp.arange(float(n))[:, None]
        out["split/sum"] = np.asarray(mpx.allreduce(xv, op=mpx.SUM, comm=split)[0])
        out["split/groups"] = split.groups
        if n >= 3:
            uneq = dp.Split(E.unequal_colors(n))
            out["uneq/scan"] = np.asarray(mpx.scan(xv, mpx.SUM, comm=uneq)[0])
            out["uneq/ring"] = np.asarray(mpx.sendrecv(xv, xv, dest=mpx.shift(1),
                                                       comm=uneq)[0])
        if n >= 4:
            mm = mpx.make_world_mesh((2, n // 2), ("qy", "qx"), devices=devices)
            mcomm = mpx.Comm(("qy", "qx"), mesh=mm)
            out["multi/shift"] = np.asarray(mpx.sendrecv(xv, xv, dest=mpx.shift(1),
                                                         comm=mcomm)[0])
            rows = jnp.arange(float(n * n)).reshape(n, n, 1)
            out["multi/alltoall"] = np.asarray(mpx.alltoall(rows, comm=mcomm)[0])
        return out

    return results.get(f"jax-{n}", compute)


def stacked(results, n, key):
    return np.stack([r[key] for r in port_run(results, n)["ranks"]])


@pytest.mark.parametrize("n", SIZES)
def test_every_check_passes(results, n):
    checks = port_run(results, n)["checks"]
    want = CHECKS + (["unequal_split_scan_sendrecv", "multi_axis_p2p_alltoall"]
                     if n >= 4 else [])
    assert sorted(checks) == sorted(want)
    assert all(c["ok"] for c in checks.values())


@pytest.mark.parametrize("n", SIZES)
def test_cpu_launches_no_kernel(results, n):
    """Every rank counts each of the path's kernels, and CPU tensors launch
    none of them."""
    for r in port_run(results, n)["ranks"]:
        assert r["launches"] == dict.fromkeys(E.PATH_KERNELS, 0)


@pytest.mark.parametrize("n", SIZES)
def test_kernel_checks_run_on_every_rank(results, n):
    """``kernels_against_plain`` at the ranks' shapes: on the CPU each
    wrapper is its plain version, so every kernel of the path holds with
    no difference; the checks' exchanges keep the ranks in step."""
    for r in port_run(results, n)["ranks"]:
        assert r["kernels_vs_plain"] == dict.fromkeys(E.PATH_KERNELS, (0.0, True))


@pytest.mark.parametrize("key", ["halo", "wide"])
@pytest.mark.parametrize("n", SIZES)
def test_shallow_water_matches_jax(results, n, key):
    """The split-phase (tiny, "auto") and wide-halo (16 cells a rank)
    steps on the (2, n/2) grid, every field of every rank."""
    want = jax_results(results, n)
    ranks = port_run(results, n)["ranks"]
    assert PORT_STEP[ranks[0][f"sw/{key}/mode"]] == want[f"sw/{key}/mode"]
    for i, name in enumerate(J.State._fields):
        got = np.stack([r[f"sw/{key}"][i] for r in ranks])
        a = want[f"sw/{key}"][i]
        bound = 5e-6 + 1e-6 * np.abs(a).max()
        assert np.abs(got - a).max() <= bound, name


@pytest.mark.parametrize("n", SIZES)
def test_data_parallel_step_matches_jax(results, n):
    np.testing.assert_allclose(stacked(results, n, "dp/w"),
                               jax_results(results, n)["dp/w"], rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_ring_attention_matches_jax(results, n):
    """Causal ring attention's output, and the gradient of the loss
    allreduced inside the differentiated function."""
    want = jax_results(results, n)
    np.testing.assert_allclose(stacked(results, n, "ring/out"), want["ring/out"],
                               rtol=E.RING_RTOL, atol=E.RING_ATOL)
    np.testing.assert_allclose(stacked(results, n, "ring/grad"), want["ring/grad"],
                               rtol=E.GRAD_RTOL, atol=E.GRAD_ATOL)


@pytest.mark.parametrize("n", SIZES)
def test_splits_and_multi_axis_match_jax(results, n):
    want = jax_results(results, n)
    assert port_run(results, n)["ranks"][0]["split/groups"] == want["split/groups"]
    keys = ["split/sum"] + (["uneq/scan", "uneq/ring", "multi/shift",
                             "multi/alltoall"] if n >= 4 else [])
    for key in keys:
        np.testing.assert_array_equal(stacked(results, n, key), want[key], err_msg=key)
