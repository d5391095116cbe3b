"""Megastep loops (``spmd``/``compile`` ``unroll=N``) against the JAX package.

The port's side runs ``tests/torch_ranks_dispatch.py:dispatch_program`` on
one rank in this process and on 2 and 4 gloo ranks on the CPU (one world
a size per test run), the JAX side the same steps through
``mpx.compile(..., unroll=N)`` on the 8-device CPU mesh.  Rank r's result
is compared with the JAX package's ``global[r]``.

The contract:

- the port's megastep (``compile`` and ``spmd``) equals N eager region
  calls bit for bit, on every size;
- against the JAX package bit for bit on 1 and 2 ranks; on 4 ranks an
  f32 SUM adds in the backend's order, so there the band the port's SUM
  is held to against the JAX package (rtol 1e-5, tests/test_allreduce.py:62);
- ``unroll=1`` issues the same exchanges as a call without the layer,
  with the same bits;
- the carry contract, the keyword refusal, ``MPI4JAX_TPU_UNROLL_DEFAULT``,
  MPX130 and the boundary hooks, here in the test process on one rank.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu.parallel import megastep as JM  # noqa: E402

import torch_ranks as R0  # noqa: E402
import torch_ranks_dispatch as R  # noqa: E402
import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from mpi4jax_tpu_torch.parallel import megastep as TM  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SIZES = [1, 2, 4]
STEPS = ("plain", "token", "async")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "dispatch")


def port_run(results, size):
    """Every rank's ``dispatch_program`` results (numpy)."""
    if size == 1:
        def compute():
            out = R.dispatch_program(0, 1)
            return [{k: _numpy(v) for k, v in out.items()}]
    else:
        def compute():
            return launch.run(R.dispatch_program, size, device="cpu",
                              timeout=R0.RANK_TIMEOUT_S, args=(size,))
    return results.get(f"port-{size}", compute)


def _numpy(v):
    if isinstance(v, (tuple, list)):
        return tuple(_numpy(x) for x in v)
    return v.detach().numpy()


def stacked(per_rank, key):
    first = per_rank[0][key]
    if isinstance(first, tuple):
        return tuple(np.stack([r[key][k] for r in per_rank]) for k in range(len(first)))
    return np.stack([r[key] for r in per_rank])


# -- the JAX suite's steps (tests/test_megastep.py:64-75, :131-184)


def _jax_step_token(v):
    tok = mpx.create_token()
    s, tok = mpx.allreduce(v, op=mpx.SUM, token=tok)
    b, tok = mpx.bcast(mpx.varying(s), 0, token=tok)
    return mpx.varying(b * 0.25 + v * 0.5)


def _jax_step_plain(v):
    s, _ = mpx.allreduce(v, op=mpx.SUM)
    return mpx.varying(s * 0.25 + v * 0.5)


def _jax_steps(k):
    def fusion(pair):
        a, b = pair
        ra = mpx.allreduce(a, op=mpx.SUM)[0]
        rb = mpx.allreduce(b, op=mpx.SUM)[0]
        return (mpx.varying(ra * (1.0 / k)), mpx.varying(rb * (1.0 / k)))

    def start_wait(v):
        h, _ = mpx.allreduce_start(v, op=mpx.SUM)
        w = jnp.tanh(v)
        s, _ = mpx.allreduce_wait(h)
        return mpx.varying(s * (1.0 / k) + w * 0.0)

    return fusion, start_wait


def jax_run(results, size):
    def compute():
        mesh = mpx.make_world_mesh((size,), ("x",), devices=jax.devices()[:size])
        comm = mpx.Comm("x", mesh=mesh)
        x = {k: jnp.asarray(v) for k, v in R.inputs(size).items()}
        fusion, start_wait = _jax_steps(size)
        out = {}
        for name, fn in (("plain", _jax_step_plain), ("token", _jax_step_token),
                         ("async", start_wait)):
            pinned = mpx.compile(fn, x["x"], comm=comm, unroll=R.UNROLL)
            assert pinned.unroll == R.UNROLL
            out[name] = np.asarray(pinned(x["x"]))
            out[f"{name}/spmd"] = np.asarray(
                mpx.spmd(fn, comm=comm, unroll=R.UNROLL)(x["x"]))
        mpx.set_fusion_mode("auto")
        try:
            pair = (x["a"], x["b"])
            out["fusion"] = tuple(np.asarray(a) for a in mpx.compile(
                fusion, pair, comm=comm, unroll=R.UNROLL)(pair))
        finally:
            mpx.set_fusion_mode(None)

        @partial(mpx.spmd, comm=comm, static_argnums=(1,), unroll=R.UNROLL)
        def mega(v, gain, w):
            s, _ = mpx.allreduce(v, op=mpx.SUM)
            return (mpx.varying(s * gain), mpx.varying(w + 1.0))

        out["statics"] = tuple(np.asarray(a) for a in mega(x["v"], R.GAIN, x["w"]))
        return out

    return results.get(f"jax-{size}", compute)


def assert_jax(got, want, size, what):
    """Bit for bit, except an f32 SUM over more than two ranks (see the
    module docstring)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        if size <= 2:
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=what)


def assert_same(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=what)


# ---------------------------------------------------------------------------
# megastep against N eager calls and against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", STEPS + ("fusion", "statics"))
@pytest.mark.parametrize("size", SIZES)
def test_megastep_equals_n_eager_calls(results, size, step):
    per_rank = port_run(results, size)
    want = stacked(per_rank, f"{step}/eager")
    for form in ("compile", "spmd"):
        key = f"{step}/{form}"
        if key in per_rank[0]:
            assert_same(stacked(per_rank, key), want, key)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("size", SIZES)
def test_megastep_matches_jax(results, size, step):
    """``compile(step, x, unroll=4)`` and ``spmd(step, unroll=4)`` against
    the JAX package's, start/wait inside the body for ``async``."""
    per_rank = port_run(results, size)
    want = jax_run(results, size)
    assert_jax(stacked(per_rank, f"{step}/compile"), want[step], size, step)
    assert_jax(stacked(per_rank, f"{step}/spmd"), want[f"{step}/spmd"], size, step)


@pytest.mark.parametrize("size", SIZES)
def test_megastep_with_fusion_inside_body_matches_jax(results, size):
    assert_jax(stacked(port_run(results, size), "fusion/compile"),
               jax_run(results, size)["fusion"], size, "fusion")


@pytest.mark.parametrize("size", SIZES)
def test_multi_arg_carry_and_statics_match_jax(results, size):
    """tests/test_megastep.py:171: two dynamic arguments carried, a static
    gain passed to every iteration."""
    per_rank = port_run(results, size)
    want = jax_run(results, size)["statics"]
    assert_jax(stacked(per_rank, "statics/spmd"), want, size, "statics/spmd")
    assert_jax(stacked(per_rank, "statics/compile"), want, size, "statics/compile")


@pytest.mark.parametrize("size", SIZES)
def test_unroll_one_is_the_call_without_the_layer(results, size):
    """``spmd(unroll=1)`` and ``compile(unroll=1)``: the exchanges and bits
    of a plain region call (one exchange a call on several ranks, none on
    one)."""
    per_rank = port_run(results, size)
    want = stacked(per_rank, "unroll1/region")
    for name in ("spmd1", "compile1"):
        assert_same(stacked(per_rank, f"unroll1/{name}"), want, name)
        for r in per_rank:
            assert (int(r[f"unroll1/{name}/exchanges"])
                    == int(r["unroll1/region/exchanges"]) == (size > 1))


# ---------------------------------------------------------------------------
# the contracts, on one rank in this process
# ---------------------------------------------------------------------------


def one_rank():
    return tpx.Comm("x", mesh=tpx.make_world_mesh((1,), ("x",), device="cpu"))


@pytest.mark.parametrize("bad", [0, -1, "1.5", "x", None])
def test_validate_unroll_matches_jax(bad):
    with pytest.raises(Exception) as want:
        JM.validate_unroll(bad)
    with pytest.raises(type(want.value)) as got:
        TM.validate_unroll(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("good", [1, 2, "3", 440, 2.5])
def test_validate_unroll_accepts_what_jax_accepts(good):
    assert TM.validate_unroll(good) == JM.validate_unroll(good)


def test_keyword_arguments_refused_under_unroll():
    mega = tpx.spmd(R.step_plain, comm=one_rank(), unroll=2)
    with pytest.raises(TypeError, match="positional arguments only"):
        mega(v=torch.ones(3))


def test_unroll_needs_a_dynamic_argument():
    with pytest.raises(ValueError, match="at least one dynamic argument"):
        tpx.spmd(lambda: torch.zeros(2), comm=one_rank(), unroll=2)()
    with pytest.raises(ValueError, match="at least one dynamic argument"):
        tpx.compile(lambda g: torch.zeros(2), 0.5, comm=one_rank(),
                    static_argnums=(0,), unroll=2)


@pytest.mark.parametrize("bad,leaf", [
    (lambda v: v[:1], "carry leaf 0"),
    (lambda v: v.double(), "carry leaf 0"),
    (lambda v: (v, v), "structure"),
])
def test_carry_contract_names_the_leaf(bad, leaf):
    x = torch.ones(2, 3)
    # an eager pin runs its body at the call (a graph's warm-up, at compile)
    for run in (lambda: tpx.spmd(bad, comm=one_rank(), unroll=3)(x),
                lambda: tpx.compile(bad, x, comm=one_rank(), unroll=3)(x)):
        with pytest.raises(ValueError, match="carry contract") as e:
            run()
        assert leaf in str(e.value)


def test_carry_contract_counts_the_dynamic_arguments():
    with pytest.raises(ValueError, match="matching 2-tuple"):
        tpx.spmd(lambda a, b: a, comm=one_rank(), unroll=2)(torch.ones(2), torch.ones(2))


def test_unroll_default_applies_and_degrades(monkeypatch):
    """``MPI4JAX_TPU_UNROLL_DEFAULT`` sets the trip count of calls without
    ``unroll=``; a body that cannot carry a loop runs once instead of
    raising."""
    monkeypatch.setenv("MPI4JAX_TPU_UNROLL_DEFAULT", "3")
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(tpx.spmd(lambda v: v * 2.0, comm=one_rank())(x), x * 8.0)
    assert tpx.compile(lambda v: v * 2.0, x, comm=one_rank()).unroll == 3
    # keywords and no dynamic argument: one call
    assert torch.equal(tpx.spmd(lambda v: v * 2.0, comm=one_rank())(v=x), x * 2.0)
    assert torch.equal(tpx.spmd(lambda: x * 2.0, comm=one_rank())(), x * 2.0)
    assert tpx.compile(lambda g: x * g, 2.0, comm=one_rank(),
                       static_argnums=(0,)).unroll == 1
    monkeypatch.setenv("MPI4JAX_TPU_UNROLL_DEFAULT", "0")
    with pytest.raises(ValueError, match="must be >= 1"):
        tpx.spmd(lambda v: v, comm=one_rank())(x)


def test_fusion_flushes_every_iteration(monkeypatch):
    """Under fusion a bucket never holds members of two iterations: each
    iteration's queue is issued at its end."""
    from mpi4jax_tpu_torch.ops import _fusion

    flushes = []
    real = _fusion._flush_queue
    monkeypatch.setattr(_fusion, "_flush_queue",
                        lambda q: (flushes.append(len(q.entries)), real(q))[1])
    tpx.set_fusion_mode("auto")
    try:
        def step(pair):
            a, b = pair
            return (tpx.allreduce(a)[0], tpx.allreduce(b)[0])

        pair = (torch.ones(3), torch.zeros(2))
        tpx.spmd(step, comm=one_rank(), unroll=5)(pair)
    finally:
        tpx.set_fusion_mode(None)
    assert flushes == [2] * 5


def test_mpx130_start_left_in_flight_at_the_iteration_end():
    def leaky(v):
        tpx.allreduce_start(v)
        return v

    with pytest.raises(RuntimeError, match="MPX130") as e:
        tpx.spmd(leaky, comm=one_rank(), unroll=3)(torch.ones(2))
    assert e.value.mpx_code == "MPX130" and "iteration 0" in str(e.value)


def test_mpx130_wait_of_a_start_from_outside_the_loop():
    x = torch.ones(2)

    def outer(v):
        h, _ = tpx.allreduce_start(v)

        def waits(u):
            return tpx.allreduce_wait(h)[0] + u * 0.0

        from mpi4jax_tpu_torch.parallel.megastep import megastep_loop

        return megastep_loop(lambda i, c: waits(c), v, 2, one_rank(), "waits")

    with pytest.raises(RuntimeError, match="MPX130") as e:
        tpx.spmd(outer, comm=one_rank())(x)
    assert "start is not" in str(e.value)


def test_mpx130_silent_inside_one_iteration_and_mpx112_stays():
    x = torch.arange(4.0)

    def paired(v):
        h, _ = tpx.allreduce_start(v)
        return tpx.allreduce_wait(h)[0] * 0.5

    assert torch.equal(tpx.spmd(paired, comm=one_rank(), unroll=3)(x), x * 0.125)

    def never_waited(v):
        tpx.allreduce_start(v)
        return v

    with pytest.raises(RuntimeError, match="MPX112"):
        tpx.spmd(never_waited, comm=one_rank())(x)


def test_boundary_hooks_fire_in_order_and_unregister():
    seen = []
    off_a = tpx.register_boundary_hook("a", lambda step, **info: seen.append(("a", step, info)) or 1)
    off_b = tpx.register_boundary_hook("b", lambda step, **info: seen.append(("b", step, info)) or 2)
    try:
        assert TM.run_boundary_hooks(4, unroll=8) == [("a", 1), ("b", 2)]
        assert seen == [("a", 4, {"unroll": 8}), ("b", 4, {"unroll": 8})]
        off_a()
        off_a()  # a second unregister is harmless
        assert TM.run_boundary_hooks(5) == [("b", 2)]
    finally:
        off_b()
    assert TM.run_boundary_hooks(6) == []
    with pytest.raises(TypeError, match="callable"):
        tpx.register_boundary_hook("x", 3)


def test_boundary_hook_matches_jax_registry():
    """The same registry semantics as the JAX package's, hook for hook."""
    got, want = [], []
    offs = [TM.register_boundary_hook("h", lambda s, **i: got.append(s)),
            JM.register_boundary_hook("h", lambda s, **i: want.append(s))]
    try:
        for step in (1, 2, 3):
            assert len(TM.run_boundary_hooks(step)) == len(JM.run_boundary_hooks(step))
    finally:
        for off in offs:
            off()
    assert got == want == [1, 2, 3]


def test_tracing_megastep_is_true_inside_an_iteration_only():
    inside = []

    def step(v):
        inside.append(TM.tracing_megastep())
        return v

    assert not TM.tracing_megastep()
    tpx.spmd(step, comm=one_rank(), unroll=2)(torch.ones(1))
    tpx.spmd(step, comm=one_rank())(torch.ones(1))
    assert inside == [True, True, False] and not TM.tracing_megastep()


def test_in_parallel_region():
    from mpi4jax_tpu_torch.parallel.region import in_parallel_region

    c = one_rank()
    assert not in_parallel_region(c)
    assert tpx.spmd(lambda v: in_parallel_region(c), comm=c)(torch.ones(1))


def test_static_passed_by_keyword_refused_as_jax():
    mesh = mpx.make_world_mesh((1,), ("x",), devices=jax.devices()[:1])
    jf = mpx.spmd(lambda v, gain: v * gain, comm=mpx.Comm("x", mesh=mesh),
                  static_argnums=(1,))
    tf = tpx.spmd(lambda v, gain: v * gain, comm=one_rank(), static_argnums=(1,))
    with pytest.raises(TypeError) as want:
        jf(jnp.ones((1, 2)), gain=2.0)
    with pytest.raises(TypeError) as got:
        tf(torch.ones(2), gain=2.0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="out of range"):
        tf(torch.ones(2))
