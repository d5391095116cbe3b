"""The port's op surface over 2, 4 and 8 gloo ranks against the JAX package.

The port's side runs ``tests/torch_ranks_ops.py:ops_program`` as gloo
ranks on the CPU (once per test run for each world size); the JAX side
runs the same ops on the first ``size`` devices of the 8-device CPU mesh,
inside one ``mpx.spmd`` region per family, on the same seeded inputs.
Rank r's tensor is compared with the JAX package's ``global[r]``.

Bands: ops that move data, integer and bool reductions, MIN/MAX and
``scan`` (the same Hillis-Steele association) bit for bit; f32 SUM and
PROD reductions rtol 1e-5 (tests/test_allreduce.py:62,
tests/test_reduce_scatter.py:93), the matrix-product callable rtol 1e-5,
atol 1e-5 (tests/test_allreduce.py:97; its reduce-scatter 1e-4,
tests/test_reduce_scatter.py:118).  Errors are held by their MPX code
against the code the JAX package raises for the same call.
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
import torch_ranks_ops as R  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [2, 4, 8]
JOPS = {name: getattr(mpx, name) for name in R.OPS}
BLOCKS = {"f": "blocks", "i": "iblocks", "b": "bblocks"}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "ops")


def port_run(results, size):
    return results.get(f"port-{size}", lambda: launch.run(
        R.ops_program, size, device="cpu", timeout=R0.RANK_TIMEOUT_S,
        args=(size,)))


def jax_comm(size, shape=None, axes=("x",)):
    mesh = mpx.make_world_mesh(shape or (size,), axes,
                               devices=jax.devices()[:size])
    return mpx.Comm(axes, mesh=mesh)


def _collectives(comm, size):
    @partial(mpx.spmd, comm=comm)
    def f(g):
        out = {}
        for kind, op in R.REDUCTIONS:
            out[f"allreduce/{kind}/{op}"] = mpx.allreduce(g[kind], JOPS[op],
                                                          comm=comm)[0]
            out[f"reduce_scatter/{kind}/{op}"] = mpx.reduce_scatter(
                g[BLOCKS[kind]], JOPS[op], comm=comm)[0]
        for kind, op in R.SCANS:
            out[f"scan/{kind}/{op}"] = mpx.scan(g[kind], JOPS[op], comm=comm)[0]
        out["allreduce/matmul"] = mpx.allreduce(g["mats"], jnp.matmul, comm=comm)[0]
        out["allreduce/sqrt_sum_sq"] = mpx.allreduce(
            g["f"], lambda a, b: jnp.sqrt(a * a + b * b), comm=comm)[0]
        out["reduce_scatter/matmul"] = mpx.reduce_scatter(g["bmats"], jnp.matmul,
                                                          comm=comm)[0]
        for root in (0, size - 1):
            for kind in ("f", "i", "b"):
                out[f"bcast/{root}/{kind}"] = mpx.bcast(g[kind], root, comm=comm)[0]
            out[f"reduce/{root}/f/SUM"] = mpx.reduce(g["f"], mpx.SUM, root,
                                                     comm=comm)[0]
            out[f"reduce/{root}/i/MAX"] = mpx.reduce(g["i"], mpx.MAX, root,
                                                     comm=comm)[0]
            out[f"reduce/{root}/b/LOR"] = mpx.reduce(g["b"], mpx.LOR, root,
                                                     comm=comm)[0]
            out[f"scatter/{root}/f"] = mpx.scatter(g["blocks"], root, comm=comm)[0]
            out[f"scatter/{root}/i"] = mpx.scatter(g["iblocks"], root, comm=comm)[0]
        for kind in ("f", "i", "b"):
            out[f"allgather/{kind}"] = mpx.allgather(g[kind], comm=comm)[0]
        return out

    return f({k: jnp.asarray(v) for k, v in R.op_inputs(size).items()})


def _grid(size):
    comm = jax_comm(size, (2, size // 2), ("y", "x"))

    @partial(mpx.spmd, comm=comm)
    def f(x, rows):
        out, tok = {}, mpx.create_token()
        out["grid/allreduce"], tok = mpx.allreduce(x, mpx.SUM, comm=comm, token=tok)
        out["grid/prod"], tok = mpx.allreduce(x, mpx.PROD, comm=comm, token=tok)
        out["grid/bcast"], tok = mpx.bcast(x, 3 % size, comm=comm, token=tok)
        out["grid/allgather"], tok = mpx.allgather(x, comm=comm, token=tok)
        out["grid/scan"], tok = mpx.scan(x, mpx.SUM, comm=comm, token=tok)
        out["grid/sendrecv"], tok = mpx.sendrecv(x, x, dest=mpx.shift(1),
                                                 comm=comm, token=tok)
        out["grid/alltoall"], tok = mpx.alltoall(rows, comm=comm, token=tok)
        out["grid/scatter"], tok = mpx.scatter(rows, 2, comm=comm, token=tok)
        out["grid/gather"], tok = mpx.gather(x, 1, comm=comm, token=tok)
        out["grid/reduce"], tok = mpx.reduce(x, mpx.MAX, 0, comm=comm, token=tok)
        mpx.barrier(comm=comm, token=tok)
        return out

    x = jnp.arange(1.0, size + 1)[:, None]
    return f(x, jnp.arange(float(size * size)).reshape(size, size, 1))


def _small_split(comm, size):
    splits = {"eo": comm.Split([r % 2 for r in range(size)]),
              "unequal": comm.Split([0] + [1] * (size - 1))}

    @partial(mpx.spmd, comm=comm)
    def f(x):
        out = {}
        for name, c in splits.items():
            out[f"split/{name}/sum"] = mpx.allreduce(x, mpx.SUM, comm=c)[0]
            out[f"split/{name}/prod"] = mpx.allreduce(x, mpx.PROD, comm=c)[0]
            out[f"split/{name}/scan"] = mpx.scan(x, mpx.SUM, comm=c)[0]
            out[f"split/{name}/bcast"] = mpx.bcast(x, 0, comm=c)[0]
            out[f"split/{name}/ring"] = mpx.sendrecv(x, x, dest=mpx.shift(1),
                                                     comm=c)[0]
        out["split/eo/allgather"] = mpx.allgather(x, comm=splits["eo"])[0]
        return out

    out = f(jnp.arange(1.0, size + 1)[:, None])
    out.update({f"split/{n}/groups": c.groups for n, c in splits.items()})
    return out


def _point_to_point(comm, size):
    statuses = {}

    @partial(mpx.spmd, comm=comm)
    def f(x):
        out = {}
        t = mpx.send(x, mpx.shift(1), comm=comm)
        out["p2p/pair"] = mpx.recv(x, source=mpx.shift(-1), comm=comm, token=t)[0]
        t = mpx.send(x, mpx.shift(2), comm=comm)
        out["p2p/inferred"] = mpx.recv(x, comm=comm, token=t)[0]
        t = mpx.send(x, mpx.shift(1), comm=comm)
        t = mpx.send(x * 10, mpx.shift(2), comm=comm, token=t)
        a, t = mpx.recv(x, comm=comm, token=t)
        b, t = mpx.recv(x, comm=comm, token=t)
        out["p2p/fifo"] = (a, b)
        t = mpx.send(x, mpx.shift(1), tag=0, comm=comm)
        t = mpx.send(x * 100, mpx.shift(1), tag=7, comm=comm, token=t)
        b, t = mpx.recv(x, tag=7, comm=comm, token=t)
        a, t = mpx.recv(x, tag=0, comm=comm, token=t)
        out["p2p/tags"] = (a, b)
        clone = comm.Clone()
        t = mpx.send(x, mpx.shift(1), comm=clone)
        out["p2p/clone"] = mpx.recv(x, comm=clone, token=t)[0]
        t = mpx.send(x, [(0, 1)], comm=comm)
        out["p2p/single"] = mpx.recv(x, comm=comm, token=t)[0]
        four = jnp.broadcast_to(x, (4,))
        s_sr, s_rv = mpx.Status(), mpx.Status()
        y, t = mpx.sendrecv(four, four, dest=mpx.shift(1), sendtag=5, recvtag=5,
                            comm=comm, status=s_sr)
        t = mpx.send(y, mpx.shift(1), tag=3, comm=comm, token=t)
        out["p2p/status_recv"], t = mpx.recv(y, tag=3, comm=comm, status=s_rv,
                                             token=t)
        edge = mpx.Status()
        mpx.sendrecv(x, x, dest=mpx.shift(1, wrap=False), comm=comm, status=edge)
        statuses.update(sr=s_sr, rv=s_rv)
        out["status/sources"] = jnp.stack([s_sr.Get_source(), s_rv.Get_source(),
                                           edge.Get_source()])
        t = mpx.send(x, mpx.shift(1), tag=4, comm=comm)
        out["p2p/retry"] = mpx.recv(x, source=mpx.shift(-1), tag=4, comm=comm,
                                    token=t)[0]
        t = mpx.send(x, mpx.shift(1), tag=66, comm=comm)
        out["p2p/drained"] = mpx.recv(x, tag=66, comm=comm, token=t)[0]
        mat = jnp.arange(6.0).reshape(2, 3) + 10 * x
        out["p2p/row_for_column"] = mpx.sendrecv(mat[0], jnp.zeros((3, 1)),
                                                 dest=mpx.shift(1), comm=comm)[0]
        potato, tok = x, mpx.create_token()
        for _ in range(size):
            potato, tok = mpx.sendrecv(potato + 1.0, potato, dest=mpx.shift(1),
                                       comm=comm, token=tok)
        out["p2p/potato"] = potato
        potato = x
        for _ in range(size):
            tok = mpx.send(potato + 1.0, mpx.shift(1), comm=comm, token=tok)
            potato, tok = mpx.recv(potato, comm=comm, token=tok)
        out["p2p/potato_send_recv"] = potato
        return out

    out = f(jnp.arange(float(size))[:, None])
    for key, s in statuses.items():
        out[f"status/{key}"] = (s.Get_tag(), s.Get_count(), s.Get_error(),
                                s.Get_elements(), s.Get_elements(jnp.uint8),
                                s.Get_elements(jnp.float64))
    return out


def _notoken(comm, size):
    @partial(mpx.spmd, comm=comm)
    def f(x):
        tiled = jnp.tile(x, (size, 1))
        ops = [jnotoken.allreduce(x, mpx.SUM, comm=comm),
               jnotoken.allgather(x, comm=comm).sum(0),
               jnotoken.bcast(x, 0, comm=comm),
               jnotoken.gather(x, 0, comm=comm).sum(0),
               jnotoken.reduce(x, mpx.SUM, 0, comm=comm),
               jnotoken.scan(x, comm=comm),
               jnotoken.sendrecv(x, x, dest=mpx.shift(1), comm=comm),
               jnotoken.alltoall(tiled, comm=comm).sum(0),
               jnotoken.scatter(tiled, 0, comm=comm),
               jnotoken.reduce_scatter(tiled, comm=comm)]
        jnotoken.barrier(comm=comm)
        jnotoken.send(x, [(0, 1)], comm=comm)
        single = jnotoken.recv(x, comm=comm)
        val = x
        for _ in range(size):
            val = jnotoken.sendrecv(val, val, dest=mpx.shift(1), comm=comm)
        return {"notoken/ops": ops, "notoken/single": single, "notoken/potato": val}

    out = f(jnp.arange(float(size))[:, None])
    x2 = jnp.broadcast_to(jnp.arange(float(size))[:, None], (size, 2))
    jnotoken.send(x2, mpx.shift(1), tag=31, comm=comm)
    out["notoken/deferred"] = jnotoken.recv(jnp.zeros((size, 2)), tag=31, comm=comm)
    mpx.flush()
    return out


def _code(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the code is the result
        return getattr(e, "mpx_code", type(e).__name__)
    return ""


def _errors(comm, size):
    x = jnp.zeros((size, 3, 4), jnp.float32)
    out = {"errors/root": [
        _code(lambda: mpx.bcast(x, size, comm=comm)),
        _code(lambda: mpx.reduce(x, mpx.SUM, -1, comm=comm)),
        _code(lambda: mpx.scatter(jnp.zeros((size, size, 2)), size, comm=comm)),
        _code(lambda: mpx.gather(x, size, comm=comm))],
        "p2p/bare_int_error": _code(lambda: mpx.sendrecv(x, x, dest=1, comm=comm)),
        "p2p/dtype_error": _code(lambda: mpx.sendrecv(x, x.astype(jnp.int32),
                                                      dest=mpx.shift(1), comm=comm)),
        "p2p/no_send_error": _code(lambda: mpx.recv(x, tag=55, comm=comm))}
    mpx.send(x, mpx.shift(1), tag=66, comm=comm)
    out["p2p/flush_error"] = _code(mpx.flush)
    mpx.recv(x, tag=66, comm=comm)
    mpx.send(x, mpx.shift(1), tag=8, comm=comm)
    out["p2p/template_error"] = _code(lambda: mpx.recv(jnp.zeros((size, 2)), tag=8,
                                                       comm=comm))
    mpx.recv(x, tag=8, comm=comm)
    mpx.flush()
    return out


def jax_results(results, size):
    """The JAX package's results of everything ``ops_program`` compares."""

    def compute():
        comm = jax_comm(size)
        out = dict(_collectives(comm, size))
        if size >= 4:
            out.update(_grid(size))
        out.update(_small_split(comm, size))
        out.update(_point_to_point(comm, size))
        out.update(_notoken(comm, size))
        out.update(_errors(comm, size))
        return to_numpy(out)

    return results.get(f"jax-{size}", compute)


def to_numpy(v):
    """``v`` with every JAX array a numpy array, through dicts, lists and
    tuples (static values kept)."""
    if isinstance(v, jax.Array):
        return np.asarray(v)
    if isinstance(v, dict):
        return {k: to_numpy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(to_numpy(x) for x in v)
    return v


def per_rank(results, size, key):
    return np.stack([r[key] for r in port_run(results, size)])


def assert_rank_parity(results, size, key, exact=True, **band):
    """Rank r's result ``key`` (an array, or a tuple of them) against the
    JAX package's ``global[r]``, dtype included."""
    want = jax_results(results, size)[key]
    port = port_run(results, size)
    if isinstance(want, (tuple, list)):
        pairs = [(np.stack([r[key][i] for r in port]), w) for i, w in enumerate(want)]
    else:
        pairs = [(np.stack([r[key] for r in port]), want)]
    for got, w in pairs:
        assert got.dtype == w.dtype, (key, got.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(got, w, err_msg=key)
        else:
            np.testing.assert_allclose(got, w, err_msg=key, **band)


def _band(kind, op):
    """The comparison of one reduction: exact but for f32 SUM and PROD."""
    if kind == "f" and op in ("SUM", "PROD"):
        return {"exact": False, "rtol": 1e-5}
    return {}


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,op", R.REDUCTIONS, ids=[f"{k}-{o}" for k, o in R.REDUCTIONS])
@pytest.mark.parametrize("size", SIZES)
def test_allreduce_matches_jax(results, size, kind, op):
    """Every reduction of f32, int32 and bool: logical ops give bool,
    bitwise ones keep the dtype, as ``jnp.logical_*``/``jnp.bitwise_*``."""
    assert_rank_parity(results, size, f"allreduce/{kind}/{op}", **_band(kind, op))


@pytest.mark.parametrize("kind,op", R.REDUCTIONS, ids=[f"{k}-{o}" for k, o in R.REDUCTIONS])
@pytest.mark.parametrize("size", SIZES)
def test_reduce_scatter_matches_jax(results, size, kind, op):
    assert_rank_parity(results, size, f"reduce_scatter/{kind}/{op}", **_band(kind, op))


@pytest.mark.parametrize("kind,op", R.SCANS, ids=[f"{k}-{o}" for k, o in R.SCANS])
@pytest.mark.parametrize("size", SIZES)
def test_scan_matches_jax_bit_for_bit(results, size, kind, op):
    """The Hillis-Steele rounds associate as the JAX package's: f32 SUM and
    PROD agree bit for bit."""
    assert_rank_parity(results, size, f"scan/{kind}/{op}")


@pytest.mark.parametrize("size", SIZES)
def test_callable_reductions_fold_in_rank_order(results, size):
    """A non-commutative callable (2x2 matrix product) folds in ascending
    rank order, the same on every rank; a commutative one (root of the sum
    of squares) as the JAX package's."""
    mats = R.op_inputs(size)["mats"]
    want = np.eye(2, dtype=np.float32)
    for m in mats:
        want = want @ m
    got = per_rank(results, size, "allreduce/matmul")
    for r in range(size):
        np.testing.assert_array_equal(got[r], got[0])
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)
    assert_rank_parity(results, size, "allreduce/matmul", exact=False,
                       rtol=1e-5, atol=1e-5)
    assert_rank_parity(results, size, "allreduce/sqrt_sum_sq", exact=False,
                       rtol=1e-5)
    assert_rank_parity(results, size, "reduce_scatter/matmul", exact=False,
                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["f", "i", "b"])
@pytest.mark.parametrize("size", SIZES)
def test_bcast_allgather_scatter_move_data_exactly(results, size, kind):
    """Root 0 and the last rank: bcast gives every rank root's value (root
    its own), allgather ``(size, *s)`` in rank order, scatter root's row
    r to rank r."""
    for root in (0, size - 1):
        assert_rank_parity(results, size, f"bcast/{root}/{kind}")
        if kind != "b":
            assert_rank_parity(results, size, f"scatter/{root}/{kind}")
    assert_rank_parity(results, size, f"allgather/{kind}")


@pytest.mark.parametrize("size", SIZES)
def test_reduce_gives_root_the_reduction(results, size):
    """Root gets the reduction, every other rank its own input."""
    x = R.op_inputs(size)["f"]
    for root in (0, size - 1):
        assert_rank_parity(results, size, f"reduce/{root}/f/SUM", exact=False,
                           rtol=1e-5)
        assert_rank_parity(results, size, f"reduce/{root}/i/MAX")
        assert_rank_parity(results, size, f"reduce/{root}/b/LOR")
        got = per_rank(results, size, f"reduce/{root}/f/SUM")
        others = [r for r in range(size) if r != root]
        np.testing.assert_array_equal(got[others], x[others])


@pytest.mark.parametrize("size", SIZES)
def test_inputs_are_not_written(results, size):
    assert all(r["input_kept"] for r in port_run(results, size))


@pytest.mark.parametrize("size", [4, 8])
def test_every_op_on_a_two_axis_comm(results, size):
    """tests/test_collectives.py:307 on a (2, size/2) grid, row-major."""
    for key in ("allreduce", "prod", "bcast", "allgather", "scan", "sendrecv",
                "alltoall", "scatter", "gather", "reduce"):
        assert_rank_parity(results, size, f"grid/{key}")
    assert [r["grid/rank"] for r in port_run(results, size)] == list(range(size))


@pytest.mark.parametrize("key", ["sum", "prod", "scan", "bcast", "ring"])
@pytest.mark.parametrize("split", ["eo", "unequal"])
@pytest.mark.parametrize("size", SIZES)
def test_split_ops_match_jax(results, size, split, key):
    """An evens/odds and an unequal split: groups, reductions, scan,
    bcast and a ring per group."""
    assert port_run(results, size)[0][f"split/{split}/groups"] == \
        jax_results(results, size)[f"split/{split}/groups"]
    assert_rank_parity(results, size, f"split/{split}/{key}")
    if split == "eo" and key == "sum":
        assert_rank_parity(results, size, "split/eo/allgather")


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------

P2P_KEYS = ["pair", "inferred", "fifo", "tags", "clone", "single", "status_recv",
            "retry", "drained", "row_for_column", "potato", "potato_send_recv"]


@pytest.mark.parametrize("key", P2P_KEYS)
@pytest.mark.parametrize("size", SIZES)
def test_send_recv_matches_jax(results, size, key):
    """Pairs, an inferred source, FIFO per tag, tags and clones as
    channels, a single message, the hot potato by sendrecv and by
    send/recv (tests/test_send_recv.py, tests/test_notoken.py:68)."""
    assert_rank_parity(results, size, f"p2p/{key}")


@pytest.mark.parametrize("size", SIZES)
def test_status_fields_match_jax(results, size):
    """source (comm rank, -1 for none), tag (the sent one), count, error
    and elements by dtype."""
    want = jax_results(results, size)
    for r, res in enumerate(port_run(results, size)):
        for i, key in enumerate(("sr", "rv")):
            src, tag, count, dtype, err, *elems = res[f"status/{key}"]
            assert src == want["status/sources"][r, i]
            assert (tag, count, err, *elems) == tuple(want[f"status/{key}"])
            assert dtype == "torch.float32"
        assert res["status/edge_source"] == want["status/sources"][r, 2]


@pytest.mark.parametrize("size", SIZES)
def test_p2p_errors_carry_the_jax_codes(results, size):
    """A recv with nothing queued (MPX102), a send left at flush (MPX101,
    then drained), a bare int (MPX103), dtype and count mismatches
    (MPX106); a recv whose source disagrees with the send raises and
    leaves the send queued; a recv on the world never takes a clone's
    message."""
    want = jax_results(results, size)
    for res in port_run(results, size):
        for key in ("no_send_error", "flush_error", "bare_int_error", "dtype_error",
                    "template_error"):
            assert res[f"p2p/{key}"].endswith(f"[{want[f'p2p/{key}']}]"), key
        assert res["p2p/flush_after"] == ""
        assert res["p2p/mismatch_error"].startswith("ValueError")
        assert "matching send declared" in res["p2p/mismatch_error"]
        assert res["p2p/clone_error"].endswith("[MPX102]")
        assert res["p2p/clone_uid"] == (True, True)


@pytest.mark.parametrize("size", SIZES)
def test_root_and_shape_errors(results, size):
    """Roots out of range raise MPX105 as the JAX package's do; leading
    axes other than the comm size and an op that is neither an Op nor a
    callable raise."""
    want = jax_results(results, size)["errors/root"]
    for res in port_run(results, size):
        assert [e.rsplit("[", 1)[-1].rstrip("]") for e in res["errors/root"]] == \
            list(want)
        scatter_err, rs_err, op_err = res["errors/shape"]
        assert "leading axis == comm size" in scatter_err
        assert "leading axis == comm size" in rs_err
        assert op_err.startswith("TypeError")


@pytest.mark.parametrize("size", SIZES)
def test_barrier_orders_what_follows(results, size):
    """Rank r arrives 30 ms x r late; no rank leaves before the last has
    arrived."""
    times = [r["barrier/times"] for r in port_run(results, size)]
    assert min(t[1] for t in times) >= max(t[0] for t in times)


# ---------------------------------------------------------------------------
# the tokenless API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_notoken_ops_match_jax(results, size):
    """All 13 tokenless ops return data only (send and barrier None), as
    the JAX package's ``experimental.notoken`` (tests/test_notoken.py:23-97,
    272)."""
    want = jax_results(results, size)
    port = port_run(results, size)
    for i in range(len(want["notoken/ops"])):
        np.testing.assert_array_equal(np.stack([r["notoken/ops"][i] for r in port]),
                                      want["notoken/ops"][i], err_msg=str(i))
    for key in ("single", "potato", "deferred"):
        assert_rank_parity(results, size, f"notoken/{key}")
    assert all(r["notoken/none"] == (None, None) for r in port)


@pytest.mark.parametrize("size", SIZES)
def test_fold_reduction_is_one_exchange(results, size):
    assert all(r["stats/fold_allreduce"] == 1 for r in port_run(results, size))
