"""Entry points: one shallow-water step, and the multi-rank dry run.

Counterparts of ``__graft_entry__.py``: ``entry`` is one model step of the
tiny single-rank config; ``dryrun_multichip`` drives the parallelism
families over gloo ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from . import (
    SUM,
    Comm,
    allreduce,
    alltoall,
    make_world_mesh,
    scan,
    sendrecv,
    shift,
)
from .attention import reference_attention, ring_attention
from .kernels import _build
from .kernels import flash_attention as _fa
from .kernels import sw_phase as _kp
from .kernels import sw_wide as _kw
from .models import shallow_water as _sw
from .models.shallow_water import (
    Config,
    initial_state,
    make_mesh_and_comm,
    make_stepper,
    select_step,
)
from .ops.token import create_token
from .parallel.mesh import resolve_device

# causal ring attention at the JAX dry run's sizes (__graft_entry__.py:208),
# but head dim 32 for its 16: the smallest the flash kernels are built for
TWIN_ATTENTION = {"b": 1, "t_loc": 8, "h": 2, "d": 32}
# the bands of the JAX dry run: ring output and gradient against full attention
RING_RTOL, RING_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-4
# the kernels the dry run's path launches on the card
PATH_KERNELS = ("sw_phase", "sw_wide", "flash_fwd_tf32", "flash_fwd_causal_tf32",
                "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")


def _tiny_config(nproc_y: int, nproc_x: int) -> Config:
    return Config(nproc_y=nproc_y, nproc_x=nproc_x, nx=8 * nproc_x, ny=8 * nproc_y)


def entry(device=None):
    """Return ``(fn, (state,))``: one model step of the tiny single-rank
    config, through the shipped single-device kernel (``"auto"``), on
    ``device`` (default: the GPU)."""
    cfg = _tiny_config(1, 1)
    _, comm = make_mesh_and_comm(cfg, device=device)
    step = select_step("auto", cfg)

    def fn(state):
        return step(state, cfg, comm, first_step=False)

    return fn, (initial_state(cfg, device=comm.device),)


def twin_grid(n: int):
    """The dry run's ``(py, px)`` grid of ``n`` ranks."""
    nproc_y = 2 if n % 2 == 0 and n > 1 else 1
    return nproc_y, n // nproc_y


def twin_inputs(n: int) -> dict:
    """Every rank's inputs, from a numpy seed: ring attention's q, k, v
    ``(3, n, b, t_loc, h, d)``, and the data-parallel step's weights
    ``w`` (n, 4, 4) and batch ``x`` (n, 2, 4) (ones, as in the JAX dry
    run)."""
    a = TWIN_ATTENTION
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((3, n, a["b"], a["t_loc"], a["h"], a["d"]),
                              dtype=np.float32)
    return {"qkv": qkv, "w": np.ones((n, 4, 4), np.float32),
            "x": np.ones((n, 2, 4), np.float32)}


def unequal_colors(n: int):
    """The unequal split's colors: two ranks, then the rest."""
    return [0] * 2 + [1] * (n - 2)


def _bits_equal(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _held(results: dict, name: str, ref, got, exact: bool, rtol=0.0, atol=0.0):
    """Fold one comparison of kernel ``name`` into ``results[name]``:
    ``(max |diff|, held)``, bit for bit or within ``rtol``/``atol``."""
    err, ok = results.get(name, (0.0, True))
    for a, b in zip(ref, got):
        err = max(err, float((a - b).abs().max()))
        ok = ok and (_bits_equal(a, b) if exact else
                     bool(torch.allclose(b, a, rtol=rtol, atol=atol)))
    results[name] = (err, ok)


def kernels_against_plain(sw_runs, q, k, v) -> dict:
    """Each kernel of the path against its plain version at the shapes the
    path gave it on this rank (on the CPU both sides are the plain
    version): ``sw_phase`` (Euler and AB-2 phase 1, phase 2) on the
    split-phase run's initial, first and final states, and ``sw_wide``
    (Euler and AB-2, one and two steps) on widened frames of the
    wide-halo run's initial and final states, bit for bit on the crop
    region; the f32 flash partials (causal and not) and their backward on
    this rank's q, k, v within the ring's bands.  The widened frames are
    exchanged, so every rank calls this in the same order.  Returns
    ``{kernel: (max |diff|, held)}``."""
    res = {}
    for key, cfg, comm, s0, final in sw_runs:
        off = _sw._rank_offsets(cfg, comm)
        if key == "halo":
            s1 = _kp.sw_phase1_plain(s0, cfg, True, off)
            for first, inp in ((True, s0), (False, s1), (False, final)):
                _held(res, "sw_phase", _kp.sw_phase1_plain(inp, cfg, first, off),
                      _kp.sw_phase1(inp, cfg, first, off), exact=True)
            for inp in (s1, final):
                _held(res, "sw_phase", _kp.sw_phase2_plain(inp[1], inp[2], cfg, off),
                      _kp.sw_phase2(inp[1], inp[2], cfg, off), exact=True)
            continue
        m = _sw._margin_rows(2)
        o = (off[0] - (m - 1), off[1] - (m - 1))
        crop = (slice(m - 1, m - 1 + cfg.ny_local), slice(m - 1, m - 1 + cfg.nx_local))
        frame0, _ = _sw._wide_exchange(tuple(s0), cfg, comm, m, create_token())
        late, _ = _sw._wide_exchange(tuple(final), cfg, comm, m, create_token())
        frame1 = _kw.sw_wide_plain(frame0, cfg, True, 1, o)
        for first, nsteps, inp in ((True, 1, frame0), (True, 2, frame0),
                                   (False, 1, frame1), (False, 2, frame1),
                                   (False, 2, late)):
            ref = _kw.sw_wide_plain(inp, cfg, first, nsteps, o)
            got = _kw.sw_wide(inp, cfg, first, nsteps, o)
            _held(res, "sw_wide", [a[crop] for a in ref], [b[crop] for b in got],
                  exact=True)
    scale = 1.0 / q.shape[-1] ** 0.5
    gen = np.random.default_rng(1)
    g_o = torch.from_numpy(gen.standard_normal(q.shape, dtype=np.float32)).to(q.device)
    for causal, name in ((False, "flash_fwd_tf32"), (True, "flash_fwd_causal_tf32")):
        ref = _fa.block_partials_plain(q, k, v, None, scale=scale, causal=causal)
        got = _fa.flash_block_partials(q, k, v, None, scale=scale, causal=causal)
        _held(res, name, ref, got, exact=False, rtol=RING_RTOL, atol=RING_ATOL)
        g_l = torch.from_numpy(gen.standard_normal(ref[2].shape, dtype=np.float32)
                               ).to(q.device)
        args = (q, k, v, None, ref[1], g_o, g_l)
        dref = _fa.block_partials_bwd_plain(*args, scale=scale, causal=causal)
        dq, dk, dv = _fa.block_partials_bwd(*args, scale=scale, causal=causal)
        _held(res, "flash_bwd_dq_tf32", dref[:1], [dq], exact=False,
              rtol=GRAD_RTOL, atol=GRAD_ATOL)
        _held(res, "flash_bwd_dkv_tf32", dref[1:], [dk, dv], exact=False,
              rtol=GRAD_RTOL, atol=GRAD_ATOL)
    return res


def dryrun_rank(rank: int, n: int, device):
    """One rank of ``dryrun_multichip``: each family's results on this rank,
    the launches of each of the path's kernels (``PATH_KERNELS``) over
    the families, then each kernel against its plain version
    (``kernels_against_plain``; launches made for that are not counted;
    on the CPU both sides are the plain version)."""
    inputs = twin_inputs(n)
    out = {}
    for name in PATH_KERNELS:
        _build.counter_for(name).launches = 0
    sw_runs = []
    # 1. spatial decomposition: the split-phase path at the tiny size
    # ("auto" picks it), then the wide-halo path at 16 cells a rank
    ny, nx = twin_grid(n)
    for key, cfg, steps in (("halo", _tiny_config(ny, nx), 2),
                            ("wide", Config(nproc_y=ny, nproc_x=nx, nx=16 * nx,
                                            ny=16 * ny), 3)):
        mesh, comm = make_mesh_and_comm(cfg, device=device)
        first, multi = make_stepper(cfg, comm, fast="auto")
        out[f"sw/{key}/mode"] = select_step("auto", cfg).__name__
        s0 = initial_state(cfg, rank=rank, device=mesh.device)
        out[f"sw/{key}"] = tuple(multi(first(s0), steps))
        sw_runs.append((key, cfg, comm, s0, out[f"sw/{key}"]))
    dev = mesh.device

    # 2. data parallel: the gradient of the local loss, allreduced
    dp = Comm("dp", mesh=make_world_mesh((n,), ("dp",), device=device))
    w = torch.from_numpy(inputs["w"][rank]).to(dev).requires_grad_(True)
    x = torch.from_numpy(inputs["x"][rank]).to(dev)
    (g,) = torch.autograd.grad((torch.tanh(x @ w) ** 2).sum(), w)
    g, _ = allreduce(g, SUM, comm=dp)
    out["dp/w"] = (w - 1e-2 * g).detach()

    # 3. causal ring attention, forward and the gradient of a loss that is
    # allreduced inside the differentiated function
    t_loc = TWIN_ATTENTION["t_loc"]
    mine = slice(rank * t_loc, (rank + 1) * t_loc)
    q, k, v = (torch.from_numpy(a[rank]).to(dev) for a in inputs["qkv"])
    full = [torch.from_numpy(np.concatenate(list(a), axis=1)).to(dev)
            for a in inputs["qkv"]]
    out["ring/out"] = ring_attention(q, k, v, comm=dp, causal=True).detach()
    out["ring/ref"] = reference_attention(*full, causal=True)[:, mine]
    qg = q.clone().requires_grad_(True)
    loss, _ = allreduce((ring_attention(qg, k, v, comm=dp, causal=True) ** 2).sum(),
                        SUM, comm=dp)
    loss.backward()
    out["ring/grad"] = qg.grad
    fq = full[0].clone().requires_grad_(True)
    (reference_attention(fq, full[1], full[2], causal=True) ** 2).sum().backward()
    out["ring/grad_ref"] = fq.grad[:, mine]

    # 4. a color split, and on three or more ranks an unequal one
    xv = torch.tensor([float(rank)], device=dev)
    split = dp.Split([i % 2 for i in range(n)] if n % 2 == 0 else [0] * n)
    out["split/groups"] = split.groups
    out["split/sum"] = allreduce(xv, SUM, comm=split)[0]
    if n >= 3:
        uneq = dp.Split(unequal_colors(n))
        out["uneq/groups"] = uneq.groups
        out["uneq/scan"] = scan(xv, SUM, comm=uneq)[0]
        out["uneq/ring"] = sendrecv(xv, xv, dest=shift(1), comm=uneq)[0]

    # 5. a two-axis comm: p2p and alltoall in row-major rank order
    if n >= 4 and n % 2 == 0:
        mcomm = Comm(("qy", "qx"), mesh=make_world_mesh((2, n // 2), ("qy", "qx"),
                                                       device=device))
        out["multi/shift"] = sendrecv(xv, xv, dest=shift(1), comm=mcomm)[0]
        rows = torch.arange(float(n * n), device=dev).reshape(n, n, 1)
        out["multi/alltoall"] = alltoall(rows[mcomm.Get_rank()], comm=mcomm)[0]
    out["launches"] = {name: _build.counter_for(name).launches for name in PATH_KERNELS}
    out["kernels_vs_plain"] = kernels_against_plain(sw_runs, q, k, v)
    return out


def _check(name: str, ok: bool, numbers: dict, checks: dict) -> None:
    checks[name] = dict(numbers, ok=bool(ok))
    if not ok:
        raise AssertionError(f"dryrun_multichip: {name} failed: {numbers}")


def check_dryrun(ranks, n: int, on_card: bool = False) -> dict:
    """The dry run's checks on every rank's results (the assertions of the
    JAX dry run, then the kernels': on the card every kernel of the path
    launched, on the CPU none, and each held against its plain version);
    raises ``AssertionError`` at the first that fails and returns each
    check's numbers."""
    checks = {}
    for key in ("halo", "wide"):
        finite = all(np.isfinite(f).all() for r in ranks for f in r[f"sw/{key}"])
        _check(f"shallow_water/{key}", finite, {
            "mode": ranks[0][f"sw/{key}/mode"],
            "max_abs_h": float(max(np.abs(r[f"sw/{key}"][0]).max() for r in ranks)),
        }, checks)
    w = np.stack([r["dp/w"] for r in ranks])
    spread = float(np.abs(w - w[0]).max())
    _check("data_parallel", np.isfinite(w).all() and spread <= 1e-6,
           {"max_spread": spread}, checks)
    out, ref = (np.stack([r[k] for r in ranks]) for k in ("ring/out", "ring/ref"))
    grad, gref = (np.stack([r[k] for r in ranks]) for k in ("ring/grad", "ring/grad_ref"))
    _check("ring_attention", np.allclose(out, ref, rtol=RING_RTOL, atol=RING_ATOL)
           and np.allclose(grad, gref, rtol=GRAD_RTOL, atol=GRAD_ATOL), {
               "max_abs_err": float(np.abs(out - ref).max()),
               "grad_max_abs_err": float(np.abs(grad - gref).max())}, checks)
    groups = ranks[0]["split/groups"]
    s = np.array([float(r["split/sum"][0]) for r in ranks])
    _check("color_split_allreduce",
           all(s[r] == sum(g) for g in groups for r in g),
           {"groups": groups, "sums": s.tolist()}, checks)
    if n >= 3:
        groups = ranks[0]["uneq/groups"]
        sc = np.array([float(r["uneq/scan"][0]) for r in ranks])
        ring = np.array([float(r["uneq/ring"][0]) for r in ranks])
        ok = True
        for g in groups:
            run = 0.0
            for i, r in enumerate(g):
                run += r
                ok = ok and sc[r] == run and ring[r] == g[(i - 1) % len(g)]
        _check("unequal_split_scan_sendrecv", ok, {
            "groups": groups, "scan": sc.tolist(), "ring": ring.tolist()}, checks)
    if n >= 4 and n % 2 == 0:
        shifted = np.array([float(r["multi/shift"][0]) for r in ranks])
        tposed = np.stack([r["multi/alltoall"][:, 0] for r in ranks])
        rows = np.arange(float(n * n)).reshape(n, n)
        _check("multi_axis_p2p_alltoall",
               np.array_equal(shifted, np.roll(np.arange(float(n)), 1))
               and np.array_equal(tposed, rows.T),
               {"shift": shifted.tolist()}, checks)
    launches = {name: sum(r["launches"][name] for r in ranks) for name in PATH_KERNELS}
    _check("kernel_launches", all((c > 0) == on_card for c in launches.values()),
           {"on_card": on_card, "launches": launches,
            "per_rank": [r["launches"] for r in ranks]}, checks)
    held = {name: (max(r["kernels_vs_plain"][name][0] for r in ranks),
                   all(r["kernels_vs_plain"][name][1] for r in ranks))
            for name in PATH_KERNELS}
    _check("kernels_vs_plain", all(ok for _, ok in held.values()),
           {name: {"max_abs_err": e, "held": ok} for name, (e, ok) in held.items()},
           checks)
    return checks


def dryrun_multichip(n_ranks: int, device=None, *, timeout: float = 300.0) -> dict:
    """Run the parallelism families of ``__graft_entry__.py:dryrun_multichip``
    on ``n_ranks`` gloo ranks on ``device`` (default: the GPU, shared by
    every rank; ``"cpu"`` runs the plain versions): the split-phase and
    wide-halo shallow water on a ``(2, n/2)`` grid, a data-parallel step,
    causal ring attention forward and gradient with the loss allreduced
    inside the differentiated function, a color-split ``allreduce``, and,
    on three or more ranks, ``scan`` and ``sendrecv`` on an unequal split
    and p2p and ``alltoall`` on a two-axis comm.  On the card every
    kernel of that path must launch (on the CPU none may), and each is
    then held against its plain version at the shapes the path gave it.
    Returns ``{"ranks": every rank's results, "checks": each check's
    numbers}``; raises if a check fails."""
    from .parallel import launch

    dev = resolve_device(device)
    if dev.type == "cuda":
        # build the path's kernels once, before the ranks load them
        _build.build_many([_kp.spec(), _kw.spec(), _fa.fwd_tf32_spec(), _fa.tf32_spec()])
    ranks = launch.run(dryrun_rank, n_ranks, backend="gloo", device=str(dev),
                       timeout=timeout, args=(n_ranks, str(dev)))
    checks = check_dryrun(ranks, n_ranks, on_card=dev.type == "cuda")
    ny, nx = twin_grid(n_ranks)
    print(f"dryrun_multichip OK: sp=({ny},{nx}) shallow-water 3 steps "
          f"(split-phase) + 4 steps (wide-halo) + dp={n_ranks} train step + cp "
          f"ring attention fwd+grad + color-split allreduce"
          + ("/scan/ring + multi-axis p2p/alltoall" if n_ranks >= 4 else "")
          + f" on {n_ranks} ranks ({dev})")
    return {"ranks": ranks, "checks": checks}
