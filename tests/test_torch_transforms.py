"""The port's ops under ``torch.func`` over 2, 4 and 8 gloo ranks against
the JAX package under ``jax.vmap``, ``jax.jacfwd``, ``jax.jacrev``,
``jax.jvp``, ``jax.vjp``, ``jax.grad`` and ``jax.hessian``.

The port's side runs the rank programs of ``tests/torch_ranks_transforms.py``
as gloo ranks on the CPU (once per test run for each world size); the
JAX side runs the same case tables on the first ``size`` devices of the
8-device CPU mesh, inside one ``mpx.spmd`` region per batch dim, on the
same seeded inputs.  Rank r's tensor is compared with the JAX package's
``global[r]``.

Bands against the JAX package: those of ``tests/test_torch_ops.py`` for
the same op (f32 SUM and PROD rtol 1e-5, the matrix-product callable rtol
1e-5 and atol 1e-5, its reduce-scatter 1e-4), and for the derivatives
those of ``tests/test_torch_autodiff.py`` (rtol 1e-5; the fold
reductions rtol 1e-4, atol 1e-6); everything else bit for bit.  Each
vmapped result is also held against the port's own lane-by-lane run of
the same case on the same ranks: bit for bit, but where
``torch_ranks_transforms.lane_band`` says why rounding may move; and a
vmapped call makes as many exchanges (``_staging.stats.calls``) as one
lane's call.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.experimental import notoken as jnotoken  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_transforms as RT  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]
CASES = [name for name, _, _ in RT.vmap_cases(4)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "transforms")


def port_run(results, program, size, *args):
    return results.get(f"{program.__name__}-{size}-{args}", lambda: launch.run(
        program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size, *args)))


def jax_comm(size):
    mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
    return mpx.Comm(("x",), mesh=mesh)


def to_numpy(v):
    if isinstance(v, jax.Array):
        return np.asarray(v)
    if isinstance(v, dict):
        return {k: to_numpy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_numpy(x) for x in v)
    return v


def stacked(port, key):
    return np.stack([r[key] for r in port])


def _case_name(name, size):
    """A case's name at ``size`` (the roots of bcast, reduce, scatter and
    gather are 0 and the last rank; the table is read at size 4)."""
    return name.replace("/3/", f"/{size - 1}/")


# ---------------------------------------------------------------------------
# vmap over every op
# ---------------------------------------------------------------------------


def jax_vmap(results, size, d):
    """The JAX package's ``jax.vmap`` of every case at batch dim ``d``."""

    def compute():
        comm = jax_comm(size)
        cases = RT.vmap_cases(size)

        @partial(mpx.spmd, comm=comm)
        def f(g):
            return {name: jax.vmap(make(mpx, jnotoken, jnp, comm), in_axes=d,
                                   out_axes=RT.OUT_DIM)(g[kind])
                    for name, kind, make in cases if not jax_errs(name, d)}

        world = {k: np.moveaxis(v, 1, d + 1)
                 for k, v in RT.lane_inputs(size).items()}
        out = to_numpy(f(world))
        mpx.flush()
        return out

    return results.get(f"jax-vmap-{size}-{d}", compute)


# the cases the JAX package's jax.vmap refuses inside its region: SUM
# reduce_scatter with the batch dim behind the block axis raises
# IndexError in the token's optimization barrier (mpi4jax_tpu/ops/token.py);
# they are held against its batch-dim-0 run, the same lanes
JAX_VMAP_ERRORS = {"reduce_scatter/f/SUM", "reduce_scatter/i/SUM",
                   "notoken/reduce_scatter"}


def jax_errs(name, d):
    return d > 0 and name in JAX_VMAP_ERRORS


def jax_band(name):
    """The band of ``tests/test_torch_ops.py`` for the op of case ``name``
    (``None``: bit for bit)."""
    if name in ("allreduce/matmul",):
        return {"rtol": 1e-5, "atol": 1e-5}
    if name == "reduce_scatter/matmul":
        return {"rtol": 1e-4, "atol": 1e-4}
    if name in ("allreduce/f/SUM", "allreduce/f/PROD", "reduce_scatter/f/SUM",
                "reduce_scatter/f/PROD", "allreduce/sqrt_sum_sq",
                "notoken/allreduce", "notoken/reduce_scatter") or (
                    name.startswith("reduce/") and name.endswith("/f/SUM")):
        return {"rtol": 1e-5}
    return None


def assert_close(got, want, band, msg):
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if band is None:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **band)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("size", SIZES)
def test_vmap_matches_jax_and_lanes(results, size, name):
    """Each op, reduction and dtype vmapped at batch dims 0, 1 and 2 with
    ``out_dims=1``: the JAX package's ``jax.vmap`` on the same inputs, the
    port's lane-by-lane run, and one exchange count."""
    name = _case_name(name, size)
    port = port_run(results, RT.vmap_program, size)
    for d in RT.IN_DIMS:
        key = f"{name}/d{d}"
        got = stacked(port, key)
        want = jax_vmap(results, size, 0 if jax_errs(name, d) else d)[name]
        assert_close(got, want, jax_band(name), key)
        assert_close(got, stacked(port, f"{key}/lanes"), RT.lane_band(name, size),
                     f"{key} lane by lane")
        for r, res in enumerate(port):
            calls, lane_calls = res[f"{key}/calls"]
            assert calls == lane_calls, (key, r, calls, lane_calls)


@pytest.mark.parametrize("name", sorted(JAX_VMAP_ERRORS))
def test_jax_vmap_errors_are_the_recorded_ones(name):
    """The JAX package's error for each case in ``JAX_VMAP_ERRORS`` (batch
    dim 1 on 4 devices), which the port does not share: it returns the
    lanes."""
    size, d = 4, 1
    comm = jax_comm(size)
    (kind, make), = [(k, m) for n, k, m in RT.vmap_cases(size) if n == name]
    f = mpx.spmd(lambda g: jax.vmap(make(mpx, jnotoken, jnp, comm), in_axes=d,
                                    out_axes=RT.OUT_DIM)(g), comm=comm)
    with pytest.raises(IndexError):
        f(np.moveaxis(RT.lane_inputs(size)[kind], 1, d + 1))


def test_every_op_and_notoken_form_is_a_case():
    """The 13 ops, each at least once, and every tokenless form."""
    ops = {name.split("/")[0] for name in CASES}
    assert ops >= {"allgather", "allreduce", "alltoall", "barrier", "bcast",
                   "gather", "send_recv", "reduce", "reduce_scatter", "scan",
                   "scatter", "sendrecv"}
    notoken = {name.split("/")[1] for name in CASES if name.startswith("notoken/")}
    assert {n.split("_i")[0] for n in notoken} == {
        "allreduce", "allgather", "alltoall", "bcast", "gather", "reduce",
        "reduce_scatter", "scan", "scatter", "sendrecv", "send_recv", "barrier"}


@pytest.mark.parametrize("size", SIZES)
def test_vmap_twins_of_the_jax_suite(results, size):
    """tests/test_allreduce.py:118 (``in_axes=1, out_axes=1``: the rank sum
    of every lane), tests/test_reduce_scatter.py:216 (``in_axes=2,
    out_axes=1``: block i's total a lane), tests/test_mesh_sizes.py:81 (a
    batched halo rotation) and :100 (gather and bcast): the JAX tests'
    own expectations, bit for bit."""
    port = port_run(results, RT.vmap_twins_program, size)
    xb = np.arange(size * 2 * 3, dtype=np.float32).reshape(size, 2, 3)
    np.testing.assert_array_equal(stacked(port, "allreduce_vmap"),
                                  np.broadcast_to(xb.sum(0, keepdims=True), xb.shape))
    rb = np.arange(size * size * 4, dtype=np.float32).reshape(size, size, 4)
    np.testing.assert_array_equal(stacked(port, "reduce_scatter_vmap"), rb.sum(0))
    x = np.arange(size * 3.0, dtype=np.float32).reshape(size, 3, 1)
    np.testing.assert_array_equal(stacked(port, "sendrecv_vmap"),
                                  np.roll(x, 1, axis=0))
    x = np.arange(size * 2.0, dtype=np.float32).reshape(size, 2, 1)
    s = np.stack([r["gather_bcast_vmap"][0] for r in port])
    b = np.stack([r["gather_bcast_vmap"][1] for r in port])
    np.testing.assert_array_equal(s, np.broadcast_to(x.sum(0, keepdims=True), x.shape))
    np.testing.assert_array_equal(b, np.broadcast_to(x[3 % size:3 % size + 1], x.shape))


@pytest.mark.parametrize("size", SIZES)
def test_checks_under_vmap_name_the_lane(results, size):
    """A leading axis other than the comm size, a root out of range
    (MPX105) and a send/recv dtype mismatch (MPX106) raise under ``vmap``
    what the lane's own call raises, message and shape included."""
    for res in port_run(results, RT.vmap_twins_program, size):
        for name, (batched, lane) in res["checks"].items():
            assert lane and batched == lane, (name, batched, lane)
        assert f"({size + 1}, 4)" in res["checks"]["alltoall_axis"][0]
        assert "MPX105" in res["checks"]["bcast_root"][0]
        assert "MPX106" in res["checks"]["sendrecv_dtype"][0]


# ---------------------------------------------------------------------------
# autodiff through the transforms
# ---------------------------------------------------------------------------


def jax_diff(results, size):
    """Every transform of every case of ``DIFF_CASES`` inside the JAX
    package's region, and its errors for the refused rules."""

    def compute():
        comm = jax_comm(size)
        inp = RT.diff_inputs(size)
        out = {}
        for name, kind, make in RT.DIFF_CASES:
            f = make(mpx, jnp, comm, size)

            @partial(mpx.spmd, comm=comm)
            def run(x, t, f=f, t0=inp[f"{kind}/t"][0]):
                y = f(x)
                # rank 0's tangent, a replicated value, re-typed as
                # rank-varying where the output is
                ct = jnp.asarray(np.resize(t0, y.shape))
                if getattr(jax.typeof(y), "vma", None):
                    ct = mpx.varying(ct, comm=comm)

                def loss(w):
                    return jnp.sum(f(w) ** 2)

                return {"jacfwd": jax.jacfwd(f)(x), "jacrev": jax.jacrev(f)(x),
                        "jvp": jax.jvp(f, (x,), (t,))[1],
                        "vjp": jax.vjp(f, x)[1](ct)[0],
                        "grad": jax.grad(loss)(x), "hessian": jax.hessian(loss)(x)}

            res = to_numpy(run(inp[f"{kind}/x"], inp[f"{kind}/t"]))
            if name == "bcast":
                res.update(_global_reverse(comm, f, inp["v/x"], inp["v/t"][0]))
            out.update({f"{name}/{k}": v for k, v in res.items()})
        x = inp["v/x"]
        for op in ("MIN", "MAX"):
            f = lambda w, op=op: mpx.allreduce(w, getattr(mpx, op), comm=comm)[0]
            out[f"refused/{op}"] = [
                _error(lambda: mpx.spmd(jax.jacfwd(f), comm=comm)(x)),
                _error(lambda: mpx.spmd(jax.jacrev(f), comm=comm)(x)),
                _error(lambda: mpx.spmd(lambda w: jax.jvp(f, (w,), (w,)),
                                        comm=comm)(x)),
                _error(lambda: mpx.spmd(jax.grad(lambda w: jnp.sum(f(w))),
                                        comm=comm)(x))]
        return out

    return results.get(f"jax-diff-{size}", compute)


def _global_reverse(comm, f, x, t0):
    """``bcast``'s reverse mode in the port's convention
    (tests/test_torch_autodiff.py:411): the transpose of the function of
    every rank's inputs, so a replicated cotangent reaches root from every
    rank; inside its region the JAX package types bcast's result as
    replicated and counts that cotangent once.  Rank s's ``jacrev`` and
    ``hessian`` take each basis vector on every rank, as the port's
    per-rank transforms do."""
    g = mpx.spmd(f, comm=comm)
    size = x.shape[0]

    def loss(a):
        return jnp.sum(g(a) ** 2)

    ct = np.broadcast_to(np.resize(t0, x.shape[1:]), x.shape)
    jac = np.asarray(jax.jacrev(g)(x)).sum(0)  # (out, size, in)
    return {"jacrev": np.moveaxis(jac, 1, 0),
            "vjp": np.asarray(jax.vjp(g, x)[1](jnp.asarray(ct))[0]),
            "grad": np.asarray(jax.grad(loss)(x)),
            "hessian": np.asarray(jax.hessian(loss)(x)).sum(2).reshape(
                size, x.shape[1], x.shape[1])}


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the result
        return f"{type(e).__name__}: {e}"
    return ""


# the fold reductions (PROD, the matrix product) and the ops whose
# backward folds take the band of test_torch_autodiff.py's other ops
FOLDED = {"prod", "matmul"}


@pytest.mark.parametrize("transform", RT.TRANSFORMS)
@pytest.mark.parametrize("name", [c[0] for c in RT.DIFF_CASES])
@pytest.mark.parametrize("size", SIZES)
def test_transforms_match_jax(results, size, name, transform):
    """``torch.func.jacfwd``, ``jacrev``, ``jvp``, ``vjp``, ``grad`` and
    ``hessian`` of every op that differentiates, in the JAX package's
    convention inside its region: rank r's result of its own function.
    Through SUM-``allreduce`` that is ``jacfwd`` = size x I (every rank's
    tangent is summed) and ``jacrev`` = I (a replicated cotangent counts
    once), as the JAX package gives."""
    key = f"{name}/{transform}"
    got = stacked(port_run(results, RT.diff_program, size), key)
    want = jax_diff(results, size)[key]
    band = {"rtol": 1e-4, "atol": 1e-6} if name in FOLDED else {"rtol": 1e-5}
    assert got.shape == want.shape, (key, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=key, **band)


@pytest.mark.parametrize("size", SIZES)
def test_linear_jacobians_are_exact(results, size):
    """The linear ops move or add whole values: their Jacobians are exact
    against the JAX package's, and a ring's ``jacfwd`` and ``jacrev`` are
    the same bits."""
    port = port_run(results, RT.diff_program, size)
    want = jax_diff(results, size)
    for name in ("allreduce", "sendrecv", "bcast", "alltoall", "allgather",
                 "gather", "scatter"):
        for t in ("jacfwd", "jacrev"):
            np.testing.assert_array_equal(stacked(port, f"{name}/{t}"),
                                          want[f"{name}/{t}"], err_msg=name)
    np.testing.assert_array_equal(stacked(port, "sendrecv/jacfwd"),
                                  stacked(port, "sendrecv/jacrev"))
    eye = np.eye(4, dtype=np.float32)
    np.testing.assert_array_equal(stacked(port, "allreduce/jacfwd"),
                                  np.broadcast_to(size * eye, (size, 4, 4)))
    np.testing.assert_array_equal(stacked(port, "allreduce/jacrev"),
                                  np.broadcast_to(eye, (size, 4, 4)))


@pytest.mark.parametrize("size", SIZES)
def test_refused_rules_stay_refused(results, size):
    """MIN and MAX on a whole comm have no derivative in the JAX package
    (``lax.pmin``/``lax.pmax``): under ``jacfwd``, ``jacrev``, ``jvp`` and
    ``grad`` the port raises the ``NotImplementedError`` it raises under
    autograd, with the same message."""
    want = jax_diff(results, size)
    for res in port_run(results, RT.diff_program, size):
        for op in ("MIN", "MAX"):
            *transformed, plain = res[f"refused/{op}"]
            assert plain.startswith("NotImplementedError") and op in plain
            assert transformed == [plain] * 4, (op, transformed)
            assert all(e.startswith("NotImplementedError")
                       for e in want[f"refused/{op}"]), want[f"refused/{op}"]


# ---------------------------------------------------------------------------
# telemetry, fusion, the async pairs and overlap() under vmap
# ---------------------------------------------------------------------------


def jax_services(results, size, label):
    """The JAX package's ``jax.vmap`` of each services program inside its
    region, with the telemetry tier or fusion mode of ``label`` set."""

    def compute():
        import os

        comm = jax_comm(size)
        env = {"counters": ("MPI4JAX_TPU_TELEMETRY", "counters"),
               "events": ("MPI4JAX_TPU_TELEMETRY", "events"),
               "fusion": ("MPI4JAX_TPU_FUSION", "force")}.get(label)
        old = None if env is None else os.environ.get(env[0])
        if env is not None:
            os.environ[env[0]] = env[1]
        try:
            x = RT.service_inputs(size)
            out = {}
            for name, build in JAX_SERVICES.items():
                out[name] = np.asarray(mpx.spmd(jax.vmap(build(comm)),
                                                comm=comm)(x))
            return out
        finally:
            if env is not None:
                if old is None:
                    os.environ.pop(env[0], None)
                else:
                    os.environ[env[0]] = old

    return results.get(f"jax-services-{size}-{label}", compute)


def _jax_two_ops(c):
    def f(v):
        a, t = mpx.allreduce(v, mpx.SUM, comm=c)
        b, t = mpx.allreduce(v * 2, mpx.SUM, comm=c, token=t)
        d, t = mpx.bcast(v, 1 % c.Get_size(), comm=c, token=t)
        return a + b + d
    return f


def _jax_async(c):
    def f(v):
        blocks = v.reshape(-1)[:2 * c.Get_size()].reshape(c.Get_size(), 2)
        h1, _ = mpx.allreduce_start(v, mpx.SUM, comm=c)
        h2, _ = mpx.alltoall_start(blocks, comm=c)
        h3, _ = mpx.reduce_scatter_start(blocks, mpx.SUM, comm=c)
        hs, _ = mpx.send_start(v, mpx.shift(1), comm=c)
        hr, _ = mpx.recv_start(v, comm=c)
        a = mpx.allreduce_wait(h1)[0]
        b = mpx.alltoall_wait(h2)[0]
        r = mpx.reduce_scatter_wait(h3)[0]
        mpx.p2p_wait(hs)
        got = mpx.p2p_wait(hr)[0]
        return a + got + b.sum() + r.sum()
    return f


def _jax_overlap(c):
    def f(v):
        blocks = v.reshape(-1)[:2 * c.Get_size()].reshape(c.Get_size(), 2)
        with mpx.overlap():
            a, _ = mpx.allreduce(v, mpx.SUM, comm=c)
            b, _ = mpx.alltoall(blocks, comm=c)
            r, _ = mpx.reduce_scatter(blocks, mpx.SUM, comm=c)
            return a + b.sum() + r.sum()
    return f


JAX_SERVICES = {"two_ops": _jax_two_ops, "async": _jax_async,
                "overlap": _jax_overlap}


@pytest.mark.parametrize("name", list(RT.SERVICES))
@pytest.mark.parametrize("label", [m[0] for m in RT.SERVICE_MODES])
@pytest.mark.parametrize("size", SIZES)
def test_services_under_vmap_match_jax(results, size, label, name):
    """The telemetry tiers ``counters`` and ``events``, forced fusion and
    no service, each around two allreduces and a bcast, the async pairs
    (allreduce, alltoall, reduce_scatter, send and recv) and
    ``overlap()``: vmapped inside the region and with the region inside
    the vmap, the JAX package's ``jax.vmap`` bit for bit (the inputs are
    whole numbers: every sum is exact in any order), and the port's
    lane-by-lane run bit for bit.  With the region inside the vmap, the
    telemetry tiers count the ops of a vmapped call as those of one
    lane's call, and two allreduces and a bcast make one lane's
    exchanges, packed under fusion.  With the vmap inside the region, a
    deferred result could not leave the vmap, so fusion and ``overlap()``
    run each op at once: one exchange an op, and under ``overlap()`` the
    synchronous op's record in place of a start and a wait.  A vmapped
    async start runs its synchronous op: one exchange where a lane's
    start issues its pieces."""
    port = port_run(results, RT.services_program, size)
    key = f"{label}/{name}"
    want = jax_services(results, size, label)[name]
    for where in ("inside", "outside"):
        got = stacked(port, f"{key}/{where}")
        np.testing.assert_array_equal(got, want, err_msg=f"{key} {where}")
    lanes = np.stack([r[f"{key}/lanes"] for r in port])
    np.testing.assert_array_equal(stacked(port, f"{key}/inside"), lanes)
    for res in port:
        if label in ("counters", "events"):
            assert res[f"{key}/lane_ops"], key
            assert res[f"{key}/outside_ops"] == res[f"{key}/lane_ops"], key
            if name != "overlap":
                assert res[f"{key}/ops"] == res[f"{key}/lane_ops"], key
        if name == "two_ops":
            assert res[f"{key}/outside_calls"] == res[f"{key}/lane_calls"], key
            assert res[f"{key}/calls"] == 3, key
        else:
            assert res[f"{key}/outside_calls"] <= res[f"{key}/lane_calls"], key
            assert res[f"{key}/calls"] <= res[f"{key}/lane_calls"], key


# ---------------------------------------------------------------------------
# a batch size that differs between ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True], ids=["shape", "batch"])
def test_divergent_batch_size_raises_as_a_divergent_shape(batched):
    """Rank 0 vmaps 3 lanes and rank 1 two: the physical tensors differ in
    size, as rank-divergent shapes do, and the ranks fail with gloo's size
    mismatch; nothing hangs."""
    with pytest.raises(launch.RankError):
        launch.run(RT.divergent_program, 2, device="cpu",
                   timeout=R0.RANK_TIMEOUT_S, args=(2, batched))
