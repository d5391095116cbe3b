"""Autodiff through the port's ops over 2, 4 and 8 gloo ranks against the
JAX package.

The port's side runs ``tests/torch_ranks_ops.py:autodiff_program`` as
gloo ranks on the CPU; rank r's backward is seeded by rank r's own loss.
The JAX side runs on the first ``size`` devices of the 8-device CPU mesh,
on the same seeded inputs: ``jax.grad`` of the sum over ranks of each
rank's loss (the transpose of every op, which the port's backward
computes), except for SUM-``allreduce``, whose transpose the JAX suite
takes with a replicated cotangent inside the region (the per-rank
identity: tests/test_allreduce.py:131-227), and for the forward mode,
``jax.jvp`` inside the region (tests/test_allreduce.py:147,
tests/test_send_recv.py:118).  Also here: the matvec suite
(tests/test_allreduce_matvec.py, atol 1e-4) and the custom-backward cases
(tests/test_custom_vjp.py, rtol 1e-6 and 1e-4/1e-5).  Bands: rtol 1e-5
unless stated (tests/test_collectives.py:227).
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_ops as R  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]
RTOL = 1e-5


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "autodiff")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.autodiff_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


def per_rank(results, size, key, i=None):
    return np.stack([r[key] if i is None else r[key][i]
                     for r in port_run(results, size)])


def _comm(size):
    return mpx.Comm("x", mesh=mpx.make_world_mesh((size,), ("x",),
                                                  devices=jax.devices()[:size]))


def global_grad(comm, loss, x):
    """``jax.grad`` of the sum over ranks of ``loss(x_local, rank)``."""

    @partial(mpx.spmd, comm=comm)
    def parts(xl):
        return loss(xl, comm.Get_rank())

    return np.asarray(jax.grad(lambda a: jnp.sum(parts(a)))(jnp.asarray(x)))


def region_jvp(comm, fn, x, t):
    """Every rank's ``jax.jvp`` of ``fn`` inside the region."""

    @partial(mpx.spmd, comm=comm)
    def f(xl, tl):
        return jax.jvp(fn, (xl,), (tl,))[1]

    return np.asarray(f(jnp.asarray(x), jnp.asarray(t)))


def _sq(t):
    return jnp.sum(t ** 2)


def _allreduce_rules(comm, size, out):
    """tests/test_allreduce.py:131-227 and the matvec and custom suites."""
    w = np.stack([np.arange(4.0, dtype=np.float32) + r for r in range(size)])

    def loss(w):
        @partial(mpx.spmd, comm=comm)
        def f(wl):
            return mpx.allreduce(jnp.sum(wl ** 2), op=mpx.SUM, comm=comm)[0]

        return f(w)[0]  # one rank's copy of the replicated loss

    out["ad/allreduce/grad"] = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    x = np.stack([np.full((3,), float(r), np.float32) for r in range(size)])
    out["ad/allreduce/jvp"] = region_jvp(
        comm, lambda a: mpx.allreduce(a, op=mpx.SUM, comm=comm)[0], x, np.ones_like(x))

    @partial(mpx.spmd, comm=comm)
    def transposes(xl):
        g = lambda a: mpx.allreduce(a, op=mpx.SUM, comm=comm)[0]  # noqa: E731
        t1 = jax.linear_transpose(g, xl)
        rep = jax.lax.psum(jnp.zeros(xl.shape, xl.dtype), "x")
        t2 = jax.linear_transpose(lambda c: t1(c)[0], rep)
        t3 = jax.linear_transpose(lambda c: t2(c)[0], xl)
        return t1(jnp.ones(xl.shape, xl.dtype))[0], t2(xl)[0], t3(rep + 1.0)[0]

    out["ad/allreduce/transposes"] = tuple(np.asarray(t) for t in transposes(
        jnp.asarray(x)))

    a, xv, yv, a_sh, x_sh = R.matvec_inputs(size)
    rep = lambda: jax.lax.psum(jnp.zeros((R.N_MATVEC,), jnp.float32), "x")  # noqa: E731

    def matvec(al, v):
        return mpx.allreduce(al @ v, op=mpx.SUM, comm=comm)[0]

    @partial(mpx.spmd, comm=comm)
    def matvec_suite(al, xl):
        mv = lambda v: matvec(al, v)  # noqa: E731
        t = jax.linear_transpose(mv, xl)
        t2 = jax.linear_transpose(lambda c: t(c)[0], rep())
        return (mv(xl), t(rep() + jnp.asarray(yv))[0], t2(xl)[0],
                jax.jvp(mv, (xl,), (jnp.ones_like(xl),))[1])

    for key, v in zip(("forward", "transpose", "double_transpose", "jvp"),
                      matvec_suite(jnp.asarray(a_sh), jnp.asarray(x_sh))):
        out[f"ad/matvec/{key}"] = np.asarray(v)
    out["ad/matvec/numpy"] = (a @ xv, (a.T @ yv).reshape(size, -1),
                              a @ np.ones(R.N_MATVEC, np.float32))

    @partial(mpx.spmd, comm=comm)
    def custom(xl, yl):
        @jax.custom_vjp
        def f(x, y):
            return mpx.allreduce((jnp.sin(x) * y).sum(), op=mpx.SUM, comm=comm)[0]

        def f_fwd(x, y):
            return f(x, y), (jnp.cos(x), jnp.sin(x), y)

        def f_bwd(res, g):
            g = mpx.allreduce(g, op=mpx.SUM, comm=comm)[0]
            cos_x, sin_x, y = res
            return (cos_x * g * y, sin_x * g)

        f.defvjp(f_fwd, f_bwd)
        return mpx.varying((f(xl, yl), jax.grad(f, (0, 1))(xl, yl)))

    val, grads = custom(jnp.ones((size, 3)), jnp.ones((size, 3)) * 2)
    out["ad/custom/val"] = np.asarray(val)
    out["ad/custom/grads"] = tuple(np.asarray(g) for g in grads)
    out["ad/netket"] = _netket(comm, size)


def _netket(comm, size, n_chains=4):
    """tests/test_custom_vjp.py:54 on the port's inputs: O and every rank's
    gw, and the full-batch gradient their sum must equal."""

    def log_pdf(w, x):
        return jnp.sum(x @ w, axis=-1)

    def expected_fun(w, x):
        return jnp.exp(jnp.sum(x @ w, axis=-1)) - 2

    @partial(jax.custom_vjp, nondiff_argnums=(0, 1))
    def expect(log_pdf, expected_fun, pars, x):
        return mpx.allreduce(expected_fun(pars, x).mean(), op=mpx.SUM,
                             comm=comm)[0] / size

    def expect_fwd(log_pdf, expected_fun, pars, x):
        l_x = expected_fun(pars, x)
        l_mean = mpx.allreduce(l_x.mean(), op=mpx.SUM, comm=comm)[0] / size
        return l_mean, (pars, x, l_x - l_mean)

    def expect_bwd(log_pdf, expected_fun, residuals, dout):
        pars, x, dl_x = residuals

        def f(pars, x):
            term = dl_x * log_pdf(pars, x) + expected_fun(pars, x)
            return mpx.allreduce(jnp.mean(term), op=mpx.SUM, comm=comm)[0] / size

        _, pb = jax.vjp(f, pars, x)
        return pb(dout)

    expect.defvjp(expect_fwd, expect_bwd)
    w, xs = R.netket_inputs(size, n_chains)

    @partial(mpx.spmd, comm=comm)
    def run(w_stack, x):
        o, vjpfun = jax.vjp(lambda w: expect(log_pdf, expected_fun, w, x), w_stack)
        (gw,) = vjpfun(jnp.ones_like(o))
        return mpx.varying((o, gw))

    o, gw = run(jnp.tile(jnp.asarray(w)[None], (size, 1, 1)), jnp.asarray(xs))
    x_all = jnp.asarray(xs.reshape(-1, 4))
    dl = expected_fun(w, x_all) - expected_fun(w, x_all).mean()
    full = jax.grad(lambda w_: jnp.mean(dl * log_pdf(w_, x_all)
                                        + expected_fun(w_, x_all)))(jnp.asarray(w))
    return np.asarray(o), np.asarray(gw), np.asarray(full)


def _other_ops(comm, size, out):
    inp = R.op_inputs(size)
    x = np.arange(float(size), dtype=np.float32)[:, None]
    out["ad/sendrecv/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.sendrecv(a, a, dest=mpx.shift(1), comm=comm)[0]), x)
    out["ad/sendrecv/jvp"] = region_jvp(
        comm, lambda a: mpx.sendrecv(a, a, dest=mpx.shift(1), comm=comm)[0], x,
        np.ones_like(x))

    @partial(mpx.spmd, comm=comm)
    def transpose(xl):
        g = lambda a: mpx.sendrecv(a, a, dest=mpx.shift(1), comm=comm)[0]  # noqa: E731
        return jax.linear_transpose(g, xl)(xl)[0]

    out["ad/sendrecv/transpose"] = np.asarray(transpose(jnp.asarray(x)))
    out["ad/sendrecv/edge_grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.sendrecv(a * 3, a, dest=mpx.shift(1, wrap=False),
                                            comm=comm)[0]), x + 1)
    x2 = np.stack([np.full((2,), float(r), np.float32) for r in range(size)])

    def pair(a, r):
        t = mpx.send(a, mpx.shift(1), tag=9, comm=comm)
        return _sq(mpx.recv(a, tag=9, comm=comm, token=t)[0])

    out["ad/send_recv/grad"] = global_grad(comm, pair, x2)
    xb = x2 + 1
    out["ad/bcast/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.bcast(a, 0, comm=comm)[0]), xb)
    out["ad/bcast/jvp"] = region_jvp(comm, lambda a: mpx.bcast(a, 1, comm=comm)[0],
                                     xb, xb * 10)
    blocks = inp["blocks"]
    out["ad/reduce_scatter/jvp"] = region_jvp(
        comm, lambda a: mpx.reduce_scatter(a, mpx.SUM, comm=comm)[0], blocks,
        np.ones_like(blocks))

    @partial(mpx.spmd, comm=comm)
    def rs_transpose(xl, ct):
        g = lambda a: mpx.reduce_scatter(a, mpx.SUM, comm=comm)[0]  # noqa: E731
        return jax.linear_transpose(g, xl)(ct)[0]

    ct = np.stack([np.full((3,), float(r), np.float32) for r in range(size)])
    out["ad/reduce_scatter/transpose"] = np.asarray(rs_transpose(
        jnp.asarray(blocks), jnp.asarray(ct)))
    out["ad/reduce_scatter/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.reduce_scatter(a, comm=comm)[0]), blocks)
    out["ad/reduce_scatter/matmul_grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.reduce_scatter(a, jnp.matmul, comm=comm)[0]),
        inp["bmats"])
    xs = np.linspace(1.0, 2.0, size).astype(np.float32)[:, None]
    out["ad/scan/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.scan(a, mpx.SUM, comm=comm)[0]), xs)

    @partial(mpx.spmd, comm=comm)
    def scan_parts(a):
        return _sq(mpx.scan(a, mpx.SUM, comm=comm)[0])

    out["ad/scan/jvp"] = float(jax.jvp(lambda a: jnp.sum(scan_parts(a)),
                                       (jnp.asarray(xs),),
                                       (jnp.ones_like(jnp.asarray(xs)),))[1])
    f = inp["f"]
    out["ad/prod/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.allreduce(a, mpx.PROD, comm=comm)[0]), f)
    out["ad/prod/jvp"] = region_jvp(
        comm, lambda a: mpx.allreduce(a, mpx.PROD, comm=comm)[0], f, np.ones_like(f))
    out["ad/matmul/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.allreduce(a, jnp.matmul, comm=comm)[0]), inp["mats"])
    out["ad/allgather/grad"] = global_grad(
        comm, lambda a, r: jnp.sum(mpx.allgather(a, comm=comm)[0] ** 2 * (r + 1)), f)
    out["ad/gather/jvp"] = region_jvp(comm, lambda a: mpx.gather(a, 0, comm=comm)[0],
                                      f, f * 2)
    out["ad/reduce/grad"] = global_grad(
        comm, lambda a, r: jnp.sum(mpx.reduce(a, mpx.SUM, 0, comm=comm)[0] ** 2
                                   * (r + 1)), f)
    out["ad/reduce_prod/grad"] = global_grad(
        comm, lambda a, r: _sq(mpx.reduce(a, mpx.PROD, size - 1, comm=comm)[0]), f)
    out["ad/scatter/grad"] = global_grad(
        comm, lambda a, r: jnp.sum(mpx.scatter(a, 0, comm=comm)[0] ** 2 * (r + 1)),
        blocks)
    out["ad/alltoall/jvp"] = region_jvp(comm, lambda a: mpx.alltoall(a, comm=comm)[0],
                                        blocks, blocks * 3)
    out["ad/alltoall/grad"] = global_grad(
        comm, lambda a, r: jnp.sum(mpx.alltoall(a, comm=comm)[0] ** 2 * (r + 1)),
        blocks)
    errors = []
    for op in (mpx.MIN, mpx.MAX):
        try:
            global_grad(comm, lambda a, r, op=op: _sq(mpx.allreduce(a, op, comm=comm)[0]),
                        f)
            errors.append("")
        except NotImplementedError as e:
            errors.append(f"NotImplementedError: {e}")
    out["ad/min_max/errors"] = errors


def jax_results(results, size):
    def compute():
        comm = _comm(size)
        out = {}
        _allreduce_rules(comm, size, out)
        _other_ops(comm, size, out)
        return out

    return results.get(f"jax-{size}", compute)


def check(results, size, key, rtol=RTOL, atol=0.0, exact=False):
    want = jax_results(results, size)[key]
    got = per_rank(results, size, key)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# SUM-allreduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_allreduce_sum_grad_and_jvp(results, size):
    """The DP pattern's gradient (``2 w`` on every rank: rank r's backward of
    its replicated loss is the identity) and the forward mode (the
    allreduce of the tangent)."""
    check(results, size, "ad/allreduce/grad", exact=True)
    check(results, size, "ad/allreduce/jvp", exact=True)


@pytest.mark.parametrize("size", SIZES)
def test_allreduce_transposes_alternate(results, size):
    """First backward the identity, second (``linear_transpose`` x2) an
    allreduce, third the identity again."""
    want = jax_results(results, size)["ad/allreduce/transposes"]
    for i in range(3):
        np.testing.assert_array_equal(per_rank(results, size, "ad/allreduce/transposes", i),
                                      want[i], err_msg=f"transpose x{i + 1}")


@pytest.mark.parametrize("key", ["forward", "transpose", "double_transpose", "jvp"])
@pytest.mark.parametrize("size", SIZES)
def test_matvec_suite(results, size, key):
    """The column-sharded matvec: ``A x``, its transpose ``A.T y`` row by
    row, the double transpose and the forward mode, against the JAX
    package's and numpy's (atol 1e-4)."""
    want = jax_results(results, size)
    got = per_rank(results, size, f"ad/matvec/{key}")
    np.testing.assert_allclose(got, want[f"ad/matvec/{key}"], atol=1e-4)
    numpy = dict(zip(("forward", "transpose", "jvp"), want["ad/matvec/numpy"]))
    numpy["double_transpose"] = numpy["forward"]
    ref = numpy[key]
    np.testing.assert_allclose(got, ref if key == "transpose" else
                               np.broadcast_to(ref, got.shape), atol=1e-4)


@pytest.mark.parametrize("size", SIZES)
def test_custom_backward_through_allreduce(results, size):
    """An allreduce in the forward and in the custom backward: the value
    ``size * 3 sin(1) * 2`` and the x-gradient ``size * cos(1) * 2`` as the
    JAX package's; the y-gradient ``size * sin(1)``."""
    want = jax_results(results, size)
    np.testing.assert_allclose(per_rank(results, size, "ad/custom/val"),
                               want["ad/custom/val"], rtol=1e-6)
    for i in range(2):
        np.testing.assert_allclose(per_rank(results, size, "ad/custom/grads", i),
                                   want["ad/custom/grads"][i], rtol=1e-6)


@pytest.mark.parametrize("size", SIZES)
def test_netket_style_expectation(results, size):
    """A backward that differentiates a fresh function through another
    allreduce: O on every rank is the mean over all chains, each rank's
    gradient covers its chains, and their sum is the full-batch gradient."""
    o, gw, full = jax_results(results, size)["ad/netket"]
    np.testing.assert_allclose(per_rank(results, size, "ad/netket", 0), o, rtol=1e-5)
    got = per_rank(results, size, "ad/netket", 1)
    np.testing.assert_allclose(got, gw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.sum(0), full, rtol=1e-4)


# ---------------------------------------------------------------------------
# the other ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_sendrecv_reverse_and_forward_mode(results, size):
    """Reverse mode is the reversed route (``2 x``; the transpose of a +1
    shift is a -1 shift; at the edge the template gets the cotangent), the
    forward mode sends the tangent along, and the transpose of the
    transpose is the forward route again."""
    for key in ("grad", "jvp", "transpose", "edge_grad"):
        check(results, size, f"ad/sendrecv/{key}", exact=True)
    x = np.arange(float(size), dtype=np.float32)[:, None]
    np.testing.assert_array_equal(per_rank(results, size, "ad/sendrecv/double"),
                                  np.roll(x + 5, 1, axis=0))


@pytest.mark.parametrize("size", SIZES)
def test_send_recv_pair_is_differentiable(results, size):
    check(results, size, "ad/send_recv/grad", exact=True)
    x = np.arange(float(size), dtype=np.float32)[:, None]
    np.testing.assert_array_equal(per_rank(results, size, "ad/send_recv/jvp"),
                                  np.roll(x + 1, 1, axis=0))


@pytest.mark.parametrize("size", SIZES)
def test_bcast_gradient_sums_onto_root(results, size):
    """``2 * size * x_root`` on root, zeros elsewhere
    (tests/test_collectives.py:126); the tangent is root's."""
    got = per_rank(results, size, "ad/bcast/grad")
    np.testing.assert_array_equal(got[0], np.full(2, 2.0 * size))
    np.testing.assert_array_equal(got[1:], 0.0)
    check(results, size, "ad/bcast/grad", exact=True)
    check(results, size, "ad/bcast/jvp", exact=True)


@pytest.mark.parametrize("size", SIZES)
def test_reduce_scatter_autodiff(results, size):
    """The tangent reduce-scattered (``size`` from ones), the transpose the
    allgather (block j is rank j's cotangent), the gradient
    ``2 * totals`` (tests/test_reduce_scatter.py:149-220)."""
    check(results, size, "ad/reduce_scatter/jvp", rtol=1e-6)
    check(results, size, "ad/reduce_scatter/transpose", exact=True)
    check(results, size, "ad/reduce_scatter/grad", rtol=1e-4)
    check(results, size, "ad/reduce_scatter/matmul_grad", rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", SIZES)
def test_scan_autodiff(results, size):
    """tests/test_collectives.py:227: the gradient ``2 * sum_{s >= r}
    prefix_s`` and the forward mode, through the sendrecv rounds."""
    check(results, size, "ad/scan/grad")
    np.testing.assert_allclose(per_rank(results, size, "ad/scan/jvp").sum(),
                               jax_results(results, size)["ad/scan/jvp"], rtol=RTOL)


@pytest.mark.parametrize("key", ["prod/grad", "prod/jvp", "matmul/grad",
                                 "allgather/grad", "gather/jvp", "reduce/grad",
                                 "reduce_prod/grad", "scatter/grad", "alltoall/jvp",
                                 "alltoall/grad"])
@pytest.mark.parametrize("size", SIZES)
def test_other_ops_differentiate_as_jax(results, size, key):
    """The fold reductions (PROD, a callable), allgather, gather, reduce,
    scatter and alltoall: every rank's cotangent reaches the ranks whose
    input it depends on, as the JAX package's transposes."""
    check(results, size, f"ad/{key}", rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("size", SIZES)
def test_min_max_grad_is_refused_as_in_jax(results, size):
    """The JAX package has no derivative of pmin/pmax; neither has the
    port's whole-comm MIN/MAX."""
    want = jax_results(results, size)["ad/min_max/errors"]
    for res in port_run(results, size):
        for got, jax_err, op in zip(res["ad/min_max/errors"], want, ("MIN", "MAX")):
            assert jax_err.startswith("NotImplementedError")
            assert got.startswith("NotImplementedError") and op in got
            assert "Queue" not in got
