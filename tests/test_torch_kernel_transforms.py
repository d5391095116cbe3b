"""The kernel entry points under ``torch.func`` against the JAX package.

The same numpy-seeded inputs go through the port and through the JAX
package's twins under the same transform:

- ``flash_block_partials(custom_backward=True)`` (the ``FlashPartials``
  Function, the route of every CUDA tensor; on the CPU its plain forward
  and backward) under ``vmap`` (no mask, a shared mask, causal, a batched
  mask), ``vmap(grad)``, ``vjp`` and ``jacrev``, against ``jax.vmap``,
  ``jax.grad``, ``jax.vjp`` and ``jax.jacrev`` of the JAX package's kernel
  path in interpret mode (``interpret=True``, its ``custom_vjp``), in the
  bands of ``tests/test_torch_flash_attention.py`` (m rtol and atol 1e-6,
  l 1e-5 and 1e-6, o 1e-5; causal o 1e-4) and of
  ``tests/test_torch_flash_backward.py`` (gradients rtol 1e-3, atol
  1e-4); ``flash_attention`` under the same transforms against the JAX
  package's;
- forward mode (``jvp``) through the kernel route raises ``TypeError`` in
  both packages (a ``custom_vjp`` refuses it), and the fold of the lanes
  into B keeps the kernels' ``B*H <= 65535``;
- ``ring_attention`` (both ``memory_efficient_grad`` settings, causal and
  not) and ``ulysses_attention`` on 2 and 4 gloo ranks
  (``tests/torch_ranks_kernel_transforms.py:attention_program``) under
  ``vmap``, ``vmap(grad)``, ``vjp``, ``jacrev`` and ``jvp``, against the
  JAX package's in its region on as many CPU devices, in the band of
  ``tests/test_torch_attention.py`` (rtol 2e-4, atol 2e-5) for outputs
  and of ``tests/test_torch_training.py`` (rtol 2e-3, atol 2e-4) for
  derivatives; the memory-efficient ring's ``jvp`` raises in both;
- the steppers of every kernel mode (``pallas``, ``pallas2``,
  ``pallas3``: ``sw_steps``; ``wide``, ``wide2``: ``sw_wide``;
  ``pallas_halo``: ``sw_phase``) on one rank and on a (2, 2) grid of gloo
  ranks, vmapped over a two-member ensemble, against ``jax.vmap`` of the
  JAX steppers in the band of ``tests/test_torch_shallow_water.py``
  (``5e-6 + 1e-6 max|a|``).

Every vmapped port run is also held against its lanes run one by one in
the port: bit for bit, on the CPU as on the card (the card's bits are
``chip_smoke.py`` phase 22's); nested vmaps fold into one call.  The JAX package's ``jax.vmap`` runs every
case here, the batched mask included (the one case the port runs lane by
lane), so no case is listed as a JAX refusal, as
``tests/test_torch_transforms.py:JAX_VMAP_ERRORS`` lists its own.
"""

import os
import sys
from dataclasses import replace
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad, jacrev, jvp, vjp, vmap  # noqa: E402

import mpi4jax_tpu as mpx  # noqa: E402
from mpi4jax_tpu import attention as JA  # noqa: E402
from mpi4jax_tpu.kernels import flash_attention as JFA  # noqa: E402

import torch_ranks as R  # noqa: E402
import torch_ranks_kernel_transforms as RK  # noqa: E402
from mpi4jax_tpu_torch import attention as TA  # noqa: E402
from mpi4jax_tpu_torch.kernels import flash_attention as FA  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from mpi4jax_tpu_torch.parallel import launch  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

BANDS = {"o": (1e-5, 1e-5), "m": (1e-6, 1e-6), "l": (1e-5, 1e-6)}
CAUSAL_O_BAND = (1e-4, 1e-4)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
ATT_RTOL, ATT_ATOL = 2e-4, 2e-5
DIFF_RTOL, DIFF_ATOL = 2e-3, 2e-4
SW_ABS, SW_REL = 5e-6, 1e-6
MASKS = ["none", "shared", "causal", "batched"]
LANES = 3


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R.RunResults(tmp_path_factory, "kernel-transforms")


def same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(as_np(a)), np.ascontiguousarray(as_np(b))
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        (a.view(np.uint8) == b.view(np.uint8)).all())


def as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(want, got, rtol, atol, what):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the flash partials: the kernel route's Function
# ---------------------------------------------------------------------------


def flash_inputs(masking, lanes=LANES, b=2, t=16, h=2, d=32, seed=0):
    """Seeded ``(q, k, v, mask)`` with a leading lane dim; the mask is
    None, one (T, T), or per lane (lanes, T, T)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((lanes, b, t, h, d), dtype=np.float32)
               for _ in range(3))
    mask = None
    if masking == "shared":
        mask = rng.random((t, t)) < 0.8
    elif masking == "batched":
        mask = rng.random((lanes, t, t)) < 0.8
    return q, k, v, mask


def port_partials(masking, scale=0.2):
    causal = masking == "causal"
    return lambda q, k, v, mask=None: FA.flash_block_partials(
        q, k, v, mask, scale=scale, causal=causal, custom_backward=True)


def jax_partials(masking, scale=0.2):
    causal = masking == "causal"
    return lambda q, k, v, mask=None: JFA.flash_block_partials(
        q, k, v, mask, scale=scale, causal=causal, interpret=True)


def assert_partials_close(want, got, masking):
    for name, a, b in zip("oml", want, got):
        rtol, atol = CAUSAL_O_BAND if (name == "o" and masking == "causal") else BANDS[name]
        assert_close(a, b, rtol, atol, name)


@pytest.mark.parametrize("masking", MASKS)
def test_vmapped_partials_match_jax_and_lanes(masking):
    """One vmapped call over three lanes: ``jax.vmap`` of the JAX kernel
    path in its bands, and each lane bit for bit the unbatched call."""
    q, k, v, mask = flash_inputs(masking)
    pt = [torch.from_numpy(x) for x in (q, k, v)]
    pm = None if mask is None else torch.from_numpy(mask)
    in_dims = (0, 0, 0, 0 if masking == "batched" else None)
    got = vmap(port_partials(masking), in_dims=in_dims)(*pt, pm)
    jm = None if mask is None else jnp.asarray(mask)
    want = jax.vmap(jax_partials(masking), in_axes=in_dims)(
        *(jnp.asarray(x) for x in (q, k, v)), jm)
    assert_partials_close(want, got, masking)
    for i in range(LANES):
        lane = port_partials(masking)(*(x[i] for x in pt),
                                      pm[i] if masking == "batched" else pm)
        assert all(same_bits(a[i], b) for a, b in zip(got, lane)), i


def normalized_loss(ns, fn):
    """``sum(normalised attention ** 2)`` of the partials ``fn``."""
    def loss(q, k, v, mask):
        o, _, l = fn(q, k, v, mask)
        l_safe = ns.where(l == 0.0, 1.0, l)
        if ns is torch:
            out = o / l_safe.transpose(1, 2)[..., None]
        else:
            out = o / jnp.moveaxis(l_safe, 1, 2)[..., None]
        return (out ** 2).sum()
    return loss


@pytest.mark.parametrize("masking", MASKS)
def test_vmapped_grad_through_partials_matches_jax_and_lanes(masking):
    """``vmap(grad)`` through the Function's backward against
    ``jax.vmap(jax.grad)`` of the JAX ``custom_vjp`` (interpret mode), and
    each lane bit for bit its own ``grad``."""
    q, k, v, mask = flash_inputs(masking, seed=1)
    pt = [torch.from_numpy(x) for x in (q, k, v)]
    pm = None if mask is None else torch.from_numpy(mask)
    in_dims = (0, 0, 0, 0 if masking == "batched" else None)
    pgrad = grad(normalized_loss(torch, port_partials(masking)), argnums=(0, 1, 2))
    got = vmap(pgrad, in_dims=in_dims)(*pt, pm)
    jgrad = jax.grad(normalized_loss(jnp, jax_partials(masking)), argnums=(0, 1, 2))
    want = jax.vmap(jgrad, in_axes=in_dims)(*(jnp.asarray(x) for x in (q, k, v)),
                                            None if mask is None else jnp.asarray(mask))
    for name, a, b in zip("qkv", want, got):
        assert_close(a, b, GRAD_RTOL, GRAD_ATOL, f"d{name}")
    for i in range(LANES):
        lane = pgrad(*(x[i] for x in pt), pm[i] if masking == "batched" else pm)
        assert all(same_bits(a[i], b) for a, b in zip(got, lane)), i


@pytest.mark.parametrize("masking", ["none", "causal"])
def test_vjp_and_jacrev_through_partials_match_jax(masking):
    """``vjp`` (the three cotangents at once) and ``jacrev`` (a vmap of the
    backward over every output cotangent) against ``jax.vjp`` and
    ``jax.jacrev`` of the JAX kernel path."""
    q, k, v, _ = flash_inputs(masking, lanes=1, b=1, t=8, h=1, seed=2)
    pt = [torch.from_numpy(x[0]) for x in (q, k, v)]
    jt = [jnp.asarray(x[0]) for x in (q, k, v)]
    ct = np.random.default_rng(3).standard_normal(q[0].shape, dtype=np.float32)
    pf = lambda q, k, v: port_partials(masking)(q, k, v)[0]  # noqa: E731
    jf = lambda q, k, v: jax_partials(masking)(q, k, v)[0]  # noqa: E731
    _, pull = vjp(pf, *pt)
    _, jpull = jax.vjp(jf, *jt)
    for name, a, b in zip("qkv", jpull(jnp.asarray(ct)), pull(torch.from_numpy(ct))):
        assert_close(a, b, GRAD_RTOL, GRAD_ATOL, f"vjp d{name}")
    for name, a, b in zip("qkv", jax.jacrev(jf, argnums=(0, 1, 2))(*jt),
                          jacrev(pf, argnums=(0, 1, 2))(*pt)):
        assert a.shape == b.shape
        assert_close(a, b, GRAD_RTOL, GRAD_ATOL, f"jacrev d{name}")


@pytest.mark.parametrize("masking", ["none", "causal"])
def test_forward_mode_through_the_kernel_route_raises_in_both(masking):
    """``jvp`` through the kernel route raises ``TypeError``, as
    ``jax.jvp`` of the JAX ``custom_vjp`` does; the plain route
    (``custom_backward=False``) differentiates forward, as the JAX jnp
    path does, and the two agree."""
    q, k, v, _ = flash_inputs(masking, lanes=1, seed=4)
    pt = [torch.from_numpy(x[0]) for x in (q, k, v)]
    jt = [jnp.asarray(x[0]) for x in (q, k, v)]
    with pytest.raises(TypeError, match="custom_backward=False"):
        jvp(lambda q: port_partials(masking)(q, pt[1], pt[2])[0], (pt[0],), (pt[0],))
    with pytest.raises(TypeError):
        jax.jvp(lambda q: jax_partials(masking)(q, jt[1], jt[2])[0], (jt[0],), (jt[0],))
    causal = masking == "causal"
    _, got = jvp(lambda q: FA.flash_block_partials(q, pt[1], pt[2], None, scale=0.2,
                                                    causal=causal)[0], (pt[0],), (pt[1],))
    _, want = jax.jvp(lambda q: JFA.flash_block_partials(q, jt[1], jt[2], None, scale=0.2,
                                                         causal=causal, force_jnp=True)[0],
                      (jt[0],), (jt[1],))
    assert_close(want, got, GRAD_RTOL, GRAD_ATOL, "jvp of the plain route")


def test_the_fold_keeps_the_kernels_batch_heads_limit():
    """N lanes fold into B, so the kernels' ``B*H <= 65535`` holds for
    ``N*B*H``: past it the rule raises and names the limit; at it, it
    runs."""
    f = port_partials("none")
    q = torch.zeros((3, 4, 1, 16384, 32))
    with pytest.raises(ValueError, match=r"N\*B\*H = 196608.*B\*H <= 65535"):
        vmap(f)(q, q, q)
    small = torch.zeros((3, 21845, 1, 1, 32))
    assert vmap(f)(small, small, small)[0].shape == small.shape


@pytest.mark.parametrize("causal", [False, True])
def test_vmapped_flash_attention_matches_jax_and_lanes(causal):
    """``flash_attention`` (the plain route on the CPU, the kernels on the
    card) under ``vmap`` and ``vmap(grad)`` against the JAX package's under
    ``jax.vmap`` and ``jax.grad``, each lane bit for bit its own call."""
    q, k, v, _ = flash_inputs("none", seed=5)
    pt = [torch.from_numpy(x) for x in (q, k, v)]
    jt = [jnp.asarray(x) for x in (q, k, v)]
    pf = partial(TA.flash_attention, causal=causal)
    jf = partial(JA.flash_attention, causal=causal)
    got = vmap(pf)(*pt)
    assert_close(jax.vmap(jf)(*jt), got, ATT_RTOL, ATT_ATOL, "out")
    ploss = grad(lambda q, k, v: (pf(q, k, v) ** 2).sum(), argnums=(0, 1, 2))
    jloss = jax.grad(lambda q, k, v: (jf(q, k, v) ** 2).sum(), argnums=(0, 1, 2))
    grads = vmap(ploss)(*pt)
    for name, a, b in zip("qkv", jax.vmap(jloss)(*jt), grads):
        assert_close(a, b, DIFF_RTOL, DIFF_ATOL, f"d{name}")
    for i in range(LANES):
        assert same_bits(got[i], pf(*(x[i] for x in pt)))
        assert all(same_bits(a[i], b) for a, b in zip(grads, ploss(*(x[i] for x in pt))))


def test_vmapped_partials_on_meta_take_the_shape_rule():
    """``meta`` tensors under ``vmap`` and ``vmap(grad)`` (the verifier's
    abstract runs) go through the Functions' rules to the kernels' shape
    rules: the batched shapes, nothing computed."""
    q = torch.empty((LANES, 2, 16, 2, 32), device="meta")
    f = port_partials("causal")
    o, m, l = vmap(f)(q, q, q)
    assert (o.shape, m.shape, l.shape) == (q.shape, (LANES, 2, 2, 16), (LANES, 2, 2, 16))
    g = vmap(grad(lambda q: f(q, q, q)[0].sum()))(q)
    assert g.shape == q.shape and g.device.type == "meta"


# ---------------------------------------------------------------------------
# ring and Ulysses attention on gloo ranks
# ---------------------------------------------------------------------------


def port_attention(results, size):
    return results.get(f"port-attention-{size}", lambda: launch.run(
        RK.attention_program, size, device="cpu", timeout=R.world_timeout(size),
        args=(size,)))


def jax_error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001  the kind is compared
        return f"{type(e).__name__}: {e}"
    return ""


def jax_attention(results, size):
    """The JAX package's runs of ``attention_program`` in its region."""

    def compute():
        comm = mpx.Comm("sp", mesh=mpx.make_world_mesh((size,), ("sp",),
                                                       devices=jax.devices()[:size]))
        spmd = partial(mpx.spmd, comm=comm)
        x = {k: jnp.asarray(a) for k, a in RK.attention_inputs(size).items()}
        first = {k: a[:, 0] for k, a in x.items()}
        out = {}
        for name, scheme, causal, me in RK.ATT_RUNS:
            f = RK.attention_fn(JA, comm, scheme, causal, me)

            def loss(q, k, v, f=f):
                return jnp.sum(f(q, k, v) ** 2)

            def run_vjp(q, k, v, ct, f=f):
                primal, pull = jax.vjp(f, q, k, v)
                return (primal, *pull(ct))

            def run_jvp(q, k, v, t, f=f):
                return jax.jvp(f, (q, k, v), (t, k, v))

            out[f"{name}/vmap"] = spmd(jax.vmap(f))(x["q"], x["k"], x["v"])
            out[f"{name}/vmap_grad"] = spmd(jax.vmap(jax.grad(loss, (0, 1, 2))))(
                x["q"], x["k"], x["v"])
            out[f"{name}/vjp"] = spmd(run_vjp)(first["q"], first["k"], first["v"],
                                               first["ct"])
            out[f"{name}/jacrev"] = spmd(jax.jacrev(f))(first["q"], first["k"],
                                                        first["v"])
            out[f"{name}/jvp_error"] = jax_error(lambda run_jvp=run_jvp: spmd(run_jvp)(
                first["q"], first["k"], first["v"], first["tan"]))
            if not out[f"{name}/jvp_error"]:
                out[f"{name}/jvp"] = spmd(run_jvp)(first["q"], first["k"], first["v"],
                                                   first["tan"])
        mpx.flush()
        return jax.tree_util.tree_map(
            lambda a: a if isinstance(a, str) else np.asarray(a), out)

    return results.get(f"jax-attention-{size}", compute)


ATT_NAMES = [name for name, *_ in RK.ATT_RUNS]


@pytest.mark.parametrize("name", ATT_NAMES)
@pytest.mark.parametrize("size", [2, 4])
def test_vmapped_attention_matches_jax_and_lanes(results, size, name):
    """``vmap`` of each scheme: the JAX package's ``jax.vmap`` in the
    output band on every rank, each lane bit for bit the port's unbatched
    run."""
    port, want = port_attention(results, size), jax_attention(results, size)
    for r, res in enumerate(port):
        assert_close(want[f"{name}/vmap"][r], res[f"{name}/vmap"], ATT_RTOL, ATT_ATOL,
                     f"rank {r}")
        assert same_bits(res[f"{name}/vmap"], res[f"{name}/lanes"]), f"rank {r}"


@pytest.mark.parametrize("name", ATT_NAMES)
@pytest.mark.parametrize("size", [2, 4])
def test_attention_derivatives_match_jax_and_lanes(results, size, name):
    """``vmap(grad)``, ``vjp`` and ``jacrev`` of each scheme (rank r's
    backward seeded by rank r's own output, in both packages) against the
    JAX package's in the derivative band; the vmapped gradients bit for
    bit each lane's own."""
    port, want = port_attention(results, size), jax_attention(results, size)
    for r, res in enumerate(port):
        for key in ("vmap_grad", "vjp", "jacrev"):
            for j, (a, b) in enumerate(zip(want[f"{name}/{key}"], res[f"{name}/{key}"])
                                       if key != "jacrev" else
                                       [(want[f"{name}/jacrev"], res[f"{name}/jacrev"])]):
                a = np.asarray(a)[r]
                assert a.shape == np.shape(b), (key, j)
                rtol, atol = (ATT_RTOL, ATT_ATOL) if (key, j) == ("vjp", 0) else (
                    DIFF_RTOL, DIFF_ATOL)
                assert_close(a, b, rtol, atol, f"rank {r} {key} {j}")
        for a, b in zip(res[f"{name}/vmap_grad"], res[f"{name}/grad_lanes"]):
            assert same_bits(a, b), f"rank {r}"


@pytest.mark.parametrize("name", ATT_NAMES)
@pytest.mark.parametrize("size", [2, 4])
def test_attention_forward_mode_raises_where_jax_raises(results, size, name):
    """``jvp`` raises ``TypeError`` on every rank where the JAX package's
    raises (the memory-efficient ring, a ``custom_vjp``), and elsewhere
    gives the JAX package's primal and tangent."""
    port, want = port_attention(results, size), jax_attention(results, size)
    jerr = want[f"{name}/jvp_error"]
    for r, res in enumerate(port):
        perr = res[f"{name}/jvp_error"]
        assert bool(perr) == bool(jerr), (perr, jerr)
        if jerr:
            assert perr.startswith("TypeError") and jerr.startswith("TypeError")
            assert "memory_efficient_grad=False" in perr
            continue
        for j, (a, b) in enumerate(zip(want[f"{name}/jvp"], res[f"{name}/jvp"])):
            assert_close(np.asarray(a)[r], b, DIFF_RTOL, DIFF_ATOL, f"rank {r} jvp {j}")
    assert bool(jerr) == name.startswith("ring/me")


# ---------------------------------------------------------------------------
# the steppers: one launch of each stencil kernel for the whole ensemble
# ---------------------------------------------------------------------------

ONE_RANK_RUNS = [("pallas", True), ("pallas2", True), ("pallas3", True), ("wide", False),
                 ("wide2", False), ("pallas_halo", True), ("pallas_halo", False)]


def jax_ensemble(grid, mode, periodic):
    """``jax.vmap`` of the JAX stepper over the two members of
    ``RK.ensemble`` (stacked-block states), as numpy ``(2, nproc, ...)``."""
    cfg = replace(J.Config(nx=RK.SW_SIZE[0], ny=RK.SW_SIZE[1], nproc_y=grid[0],
                           nproc_x=grid[1]), periodic_x=periodic)
    comm = J.make_mesh_and_comm(cfg, devices=jax.devices()[:cfg.nproc])[1]
    first, multi = J.make_stepper(cfg, comm, fast=mode)
    s = J.initial_state(cfg)
    ens = J.State(*(jnp.stack([f, f + 0.1 if i == 0 else f]) for i, f in enumerate(s)))
    out = jax.vmap(lambda s: multi(first(s), RK.SW_STEPS))(ens)
    return [np.asarray(f) for f in out]


def assert_ensemble(want, batched, alone, rank, what):
    for name, a, b, c in zip(P.State._fields, want, batched, alone):
        a = a[:, rank]
        b = as_np(b)
        assert a.shape == b.shape, (what, name)
        bound = SW_ABS + SW_REL * np.abs(a).max()
        err = np.abs(a - b).max()
        assert err <= bound, f"{what}: {name} off by {err:.3e} > {bound:.3e}"
        assert same_bits(b, as_np(c)), f"{what}: {name} not its members' bits"


@pytest.mark.parametrize("mode,periodic", ONE_RANK_RUNS)
def test_vmapped_stepper_on_one_rank_matches_jax_and_members(mode, periodic):
    """The two-member ensemble through the vmapped stepper on one rank:
    ``jax.vmap`` of the JAX stepper in band, each member bit for bit its
    own run."""
    cfg = RK.sw_config((1, 1), periodic)
    _, comm = P.make_mesh_and_comm(cfg, device="cpu")
    batched, alone = RK.vmapped_run(cfg, comm, mode, RK.ensemble(cfg, 0))
    assert batched[0].shape == (2, cfg.ny_local, cfg.nx_local)
    assert_ensemble(jax_ensemble((1, 1), mode, periodic), batched, alone, 0,
                    f"{mode} periodic={periodic}")


@pytest.mark.parametrize("mode,periodic", RK.SW_RUNS)
def test_vmapped_stepper_on_a_2x2_grid_matches_jax_and_members(results, mode, periodic):
    """The ensemble on four gloo ranks of a (2, 2) grid, every rank's block
    against the JAX package's ``jax.vmap`` on four CPU devices."""
    port = results.get("port-steppers", lambda: launch.run(
        RK.stepper_program, 4, device="cpu", timeout=R.world_timeout(4),
        args=((2, 2),)))
    want = jax_ensemble((2, 2), mode, periodic)
    for r, res in enumerate(port):
        batched, alone = res[f"{mode}/{periodic}"]
        assert_ensemble(want, batched, alone, r, f"rank {r} {mode} periodic={periodic}")



def test_nested_vmaps_fold_into_one_call(monkeypatch):
    """``vmap(vmap(...))`` folds both levels' lanes into one: the stencil's
    route is called once with 2 x 3 lanes, and the partials' fold runs
    once over 2 x 3 x B; every lane bit for bit its own call."""
    from mpi4jax_tpu_torch.kernels import sw_steps as K

    cfg = P.Config(nx=40, ny=20)
    rng = np.random.default_rng(6)
    fields = [f + torch.from_numpy(0.01 * rng.standard_normal((2, 3, *f.shape))
                                   .astype(np.float32))
              for f in P.initial_state(cfg, device="cpu")]
    seen, route = [], K._steps
    monkeypatch.setattr(K, "_steps", lambda fs, *a: (seen.append(tuple(fs[0].shape)),
                                                     route(fs, *a))[1])
    got = vmap(vmap(lambda *f: K.sw_steps(f, cfg, False, 2)))(*fields)
    assert seen == [(6, cfg.ny_local, cfg.nx_local)]
    for i in range(2):
        for j in range(3):
            want = K.sw_steps_plain(tuple(f[i, j] for f in fields), cfg, False, 2)
            assert all(same_bits(a[i, j], b) for a, b in zip(got, want)), (i, j)
    q = torch.from_numpy(rng.standard_normal((2, 3, 2, 8, 1, 32)).astype(np.float32))
    f = port_partials("none")
    out = vmap(vmap(lambda q: f(q, q, q)))(q)
    for i in range(2):
        for j in range(3):
            assert all(same_bits(a[i, j], b) for a, b in zip(out, f(q[i, j], q[i, j],
                                                                    q[i, j])))
