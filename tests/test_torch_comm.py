"""The port's communicator layer against the JAX package's, on one rank.

Routing specs, size-1 ``sendrecv`` and ``gather``, root and buffer
validation, and ``Comm.sub``: the same inputs (made with numpy) go through
the JAX op on a 1-device comm and through the port's op on the CPU.  The
JAX package's eager ops take stacked-block arrays ``(size, *s)``; the
port's take rank ``r``'s block, ``global[r]``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.parallel import rankspec as jrs  # noqa: E402

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.parallel import rankspec as trs  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]


def _jax_comm(axis="x"):
    mesh = mpx.make_world_mesh((1,), (axis,), devices=jax.devices()[:1])
    return mpx.Comm(axis, mesh=mesh)


def _torch_comm(axis="x"):
    return tpx.Comm(axis, mesh=tpx.make_world_mesh((1,), (axis,), device="cpu"))


# ---------------------------------------------------------------------------
# routing specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,wrap,size", [
    (1, True, 4), (-1, True, 4), (1, False, 4), (-1, False, 4), (3, True, 4),
    (2, False, 3), (0, True, 1), (1, True, 1), (1, False, 1), (-1, False, 1),
])
def test_shift_routes_match_jax(k, wrap, size):
    got = trs.normalize_dest(trs.shift(k, wrap=wrap), size, what="t")
    want = jrs.normalize_dest(jrs.shift(k, wrap=wrap), size, what="t")
    assert got == want
    assert repr(trs.shift(k, wrap=wrap)) == repr(jrs.shift(k, wrap=wrap))


@pytest.mark.parametrize("spec", [
    {0: 1, 1: 2, 2: 0},
    [(0, 2), (2, 0)],
    lambda r: r + 1 if r < 2 else None,
], ids=["dict", "pairs", "callable"])
def test_spec_forms_match_jax(spec):
    assert (trs.normalize_dest(spec, 3, what="t")
            == jrs.normalize_dest(spec, 3, what="t"))
    assert (trs.normalize_source(spec, 3, what="t")
            == jrs.normalize_source(spec, 3, what="t"))


@pytest.mark.parametrize("spec,exc,code", [
    (1, TypeError, "MPX103"),
    (None, ValueError, None),
    ({0: 1, 1: 1}, ValueError, None),      # duplicate destination
    ([(0, 1), (0, 2)], ValueError, None),  # duplicate source
    ({0: 5}, ValueError, None),            # out of range
])
def test_spec_errors_match_jax(spec, exc, code):
    with pytest.raises(exc) as jerr:
        jrs.normalize_dest(spec, 3, what="t")
    with pytest.raises(exc) as terr:
        trs.normalize_dest(spec, 3, what="t")
    assert getattr(terr.value, "mpx_code", None) == code
    assert getattr(jerr.value, "mpx_code", None) == code


def test_shift_inverse_and_call():
    s = trs.shift(2, wrap=False)
    assert s(1, 4) == 3 and s(2, 4) is None
    assert repr(s.inverse()) == "shift(-2, wrap=False)"
    assert trs.shift(-1)(0, 4) == 3


def test_inconsistent_source_and_dest_raise():
    with pytest.raises(ValueError, match="inconsistent routing"):
        trs.resolve_routing(trs.shift(1), {0: 1, 1: 2, 2: 0}, 3, what="t")
    with pytest.raises(ValueError, match="provide a routing spec"):
        trs.resolve_routing(None, None, 3, what="t")


# ---------------------------------------------------------------------------
# sendrecv on a size-1 comm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", [(5,), (3, 4), (2, 3, 4)])
@pytest.mark.parametrize("wrap", [True, False])
def test_sendrecv_size1_matches_jax(wrap, shape, dtype):
    rng = np.random.default_rng(7)
    send = (rng.standard_normal(shape) * 100).astype(dtype)
    tmpl = np.full(shape, -3, dtype)
    want, _ = mpx.sendrecv(jnp.asarray(send[None]), jnp.asarray(tmpl[None]),
                           dest=mpx.shift(1, wrap=wrap), comm=_jax_comm())
    got, tok = tpx.sendrecv(torch.from_numpy(send), torch.from_numpy(tmpl),
                            dest=tpx.shift(1, wrap=wrap), comm=_torch_comm())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    assert isinstance(tok, tpx.Token)


@pytest.mark.parametrize("route", ["dest", "source", "both"])
def test_sendrecv_route_forms(route):
    send = torch.arange(6.0)
    kw = {"dest": tpx.shift(-1)} if route == "dest" else (
        {"source": tpx.shift(1)} if route == "source"
        else {"dest": tpx.shift(-1), "source": tpx.shift(1)})
    got, _ = tpx.sendrecv(send, torch.zeros(6), comm=_torch_comm(), **kw)
    assert torch.equal(got, send)


def test_sendrecv_reshapes_to_recv_template():
    send = np.arange(12, dtype=np.float32)
    want, _ = mpx.sendrecv(jnp.asarray(send[None]), jnp.zeros((1, 3, 4), jnp.float32),
                           dest=mpx.shift(1), comm=_jax_comm())
    got, _ = tpx.sendrecv(torch.from_numpy(send), torch.zeros(3, 4),
                          dest=tpx.shift(1), comm=_torch_comm())
    assert tuple(got.shape) == (3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])


def test_sendrecv_result_does_not_alias_send():
    send = torch.ones(4)
    got, _ = tpx.sendrecv(send, torch.zeros(4), dest=tpx.shift(1), comm=_torch_comm())
    send.zero_()
    assert torch.equal(got, torch.ones(4))


@pytest.mark.parametrize("send,recv", [
    (np.zeros(4, np.float32), np.zeros(4, np.int32)),  # dtype
    (np.zeros(4, np.float32), np.zeros(5, np.float32)),  # element count
], ids=["dtype", "count"])
def test_sendrecv_type_signature_mpx106(send, recv):
    with pytest.raises(ValueError) as jerr:
        mpx.sendrecv(jnp.asarray(send[None]), jnp.asarray(recv[None]),
                     dest=mpx.shift(1), comm=_jax_comm())
    with pytest.raises(ValueError) as terr:
        tpx.sendrecv(torch.from_numpy(send), torch.from_numpy(recv),
                     dest=tpx.shift(1), comm=_torch_comm())
    assert terr.value.mpx_code == jerr.value.mpx_code == "MPX106"


def test_sendrecv_bare_int_route_mpx103():
    with pytest.raises(TypeError) as err:
        tpx.sendrecv(torch.zeros(2), torch.zeros(2), dest=0, comm=_torch_comm())
    assert err.value.mpx_code == "MPX103"


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4,), (3, 5), (2, 2, 3)])
def test_gather_shape_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, _ = mpx.gather(jnp.asarray(x[None]), root=0, comm=_jax_comm())
    got, tok = tpx.gather(torch.from_numpy(x), root=0, comm=_torch_comm())
    # every rank gets the uniform (size, *s) result
    assert tuple(got.shape) == (1, *shape) == np.asarray(want).shape[1:]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    assert isinstance(tok, tpx.Token)


@pytest.mark.parametrize("root", [-1, 1, 5])
def test_gather_root_out_of_range_mpx105(root):
    x = np.zeros(3, np.float32)
    with pytest.raises(ValueError) as jerr:
        mpx.gather(jnp.asarray(x[None]), root=root, comm=_jax_comm())
    with pytest.raises(ValueError) as terr:
        tpx.gather(torch.from_numpy(x), root=root, comm=_torch_comm())
    assert terr.value.mpx_code == jerr.value.mpx_code == "MPX105"


# ---------------------------------------------------------------------------
# communicators and grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [("py",), ("px",), ("py", "px")])
def test_comm_sub_matches_jax(axes):
    jmesh = mpx.make_world_mesh((1, 1), ("py", "px"), devices=jax.devices()[:1])
    jc = mpx.Comm(("py", "px"), mesh=jmesh).sub(*axes)
    tc = tpx.Comm(("py", "px"),
                  mesh=tpx.make_world_mesh((1, 1), ("py", "px"), device="cpu")).sub(*axes)
    assert tc.axes == jc.axes == axes
    assert tc.Get_size() == jc.Get_size() == 1
    assert tc.Get_rank() == 0


def test_comm_sub_rejects_foreign_axis():
    c = tpx.Comm(("py", "px"), mesh=tpx.make_world_mesh((1, 1), ("py", "px"),
                                                        device="cpu"))
    with pytest.raises(ValueError, match="not in comm axes"):
        c.sub("pz")


def test_unbound_comm_raises():
    with pytest.raises(RuntimeError, match="not bound"):
        tpx.Comm("x").Get_size()
    with pytest.raises(ValueError, match="not present"):
        tpx.Comm("y", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))


@pytest.mark.parametrize("shape", [(2,), (2, 4)])
def test_multi_rank_grid_not_yet(shape):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpx.make_world_mesh(shape, device="cpu")


def test_default_world_mesh():
    mesh = tpx.make_world_mesh(device="cpu")
    assert mesh.shape == (1,) and mesh.axes == ("mpi4jax",)
    assert mesh.coords() == (0,) and mesh.size == 1


def test_token_api():
    tok = tpx.create_token()
    x = torch.arange(3.0)
    _, tok2 = tpx.gather(x, 0, comm=_torch_comm(), token=tok)
    assert tok2 is tok
