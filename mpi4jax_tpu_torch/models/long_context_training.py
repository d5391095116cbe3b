"""Training with sequence parallelism: ring attention x data parallel.

The twin of ``examples/long_context_training.py``, on one 2-D process grid
``("dp", "sp")``:

- activations are sharded over both axes: batch over ``dp``, sequence
  over ``sp`` (rank ``r = dp * n_sp + sp`` holds one (B_local, T_local)
  tile);
- attention runs over the ``sp`` sub-communicator through
  ``attention.ring_attention(causal=True)``, differentiated by its
  memory-efficient backward;
- parameters are replicated; each rank's gradient is partial (it saw one
  tile), so one SUM-``allreduce`` over the world per parameter completes
  it, and the SGD step runs on every rank alike.  The loss's and the
  gradients' allreduces are issued in a region (``spmd``) before any is
  used: under fusion (``main`` sets ``"auto"``, as the JAX example does)
  they go out in packed buckets of ``MPI4JAX_TPU_FUSION_BUCKET_BYTES``.

The model is a minimal pre-LN transformer block with a scalar readout
trained to regress a target sequence: ``block_forward`` on a dict of
parameters (the JAX example's function, its ``attend`` injected), or the
same as an ``nn.Module`` (``Block``).  ``main`` runs on every rank of a
world that ``parallel/launch.py:run`` started, or alone as a world of
one:

    python -m mpi4jax_tpu_torch.models.long_context_training --ranks 4 --device cpu

runs the JAX example's widths (2 rows of 32 tokens a rank, d_model 32,
4 heads, d_ff 64, five steps at lr 0.1) on four gloo ranks, a (2, 2)
grid, on the CPU; without ``--device`` the ranks share the GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import SUM, Comm, allreduce, make_world_mesh
from ..attention import ring_attention
from ..kernels import _build
from ..ops import _staging
from ..ops._fusion import set_fusion_mode
from ..parallel.mesh import resolve_device
from ..parallel.region import spmd

# the parameters, in the sorted order the gradients are reduced in
PARAM_NAMES = ("w1", "w2", "wo", "wout", "wqkv")
KERNELS = ("flash_fwd_tf32", "flash_fwd_causal_tf32", "flash_bwd_dq_tf32",
           "flash_bwd_dkv_tf32", "flash_fwd_mma", "flash_fwd_causal_mma",
           "flash_bwd_dq_mma", "flash_bwd_dkv_mma")


def param_shapes(d_model: int, d_ff: int) -> dict:
    """Each parameter's shape, as ``init_params`` of the JAX example."""
    return {"wqkv": (d_model, 3 * d_model), "wo": (d_model, d_model),
            "w1": (d_model, d_ff), "w2": (d_ff, d_model), "wout": (d_model, 1)}


def init_params(d_model: int, d_ff: int, *, generator: torch.Generator = None,
                device=None) -> dict:
    """Random parameters with the JAX example's shapes and scales (normal,
    times 1/sqrt(fan-in)), drawn on ``generator``'s device in the order
    wqkv, wo, w1, w2, wout and moved to ``device``."""
    device = resolve_device(device)
    drawn_on = generator.device if generator is not None else device
    out = {}
    for name, shape in param_shapes(d_model, d_ff).items():
        std = 1.0 / math.sqrt(shape[0])
        out[name] = (torch.randn(shape, generator=generator, device=drawn_on)
                     * std).to(device)
    return out


def _ln(x):
    """Layer norm without parameters: population variance, eps inside the
    square root, as the JAX example's ``_ln``."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + 1e-6)


def block_forward(params, x, *, heads: int, attend):
    """Pre-LN transformer block and scalar readout, ``(B, T, D) -> (B, T)``.

    ``T`` may be a rank-local sequence shard: ``attend(q, k, v)`` (each
    ``(B, T, heads, D / heads)``) is ring attention over the ``sp`` comm
    in the sharded model and full attention in the single-device
    reference.  ``jax.nn.gelu``'s default is the tanh approximation."""
    b, t, d = x.shape
    qkv = _ln(x) @ params["wqkv"]
    q, k, v = (y.reshape(b, t, heads, d // heads) for y in qkv.split(d, -1))
    att = attend(q, k, v).reshape(b, t, d)
    x = x + att @ params["wo"]
    x = x + F.gelu(_ln(x) @ params["w1"], approximate="tanh") @ params["w2"]
    return (x @ params["wout"])[..., 0]


class Block(nn.Module):
    """``block_forward`` as a module: the five weights as parameters with
    the JAX example's shapes."""

    def __init__(self, params: dict, heads: int):
        super().__init__()
        self.heads = heads
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(params[name].clone()))

    def forward(self, x, attend):
        return block_forward(dict(self.named_parameters()), x,
                             heads=self.heads, attend=attend)


def make_grad_fn(world: Comm, sp: Comm, heads: int):
    """``grads(params, x, y)`` with this rank's tile ``x`` (B, T, D) and
    ``y`` (B, T) returns the global mean squared error and every
    parameter's gradient of it.  The rank's part comes from
    ``torch.autograd.grad`` through ring attention over ``sp``; the loss
    and then every parameter's gradient, in sorted name order, are
    SUM-allreduced over ``world`` in one region, all issued before any is
    used."""

    @spmd(comm=world)
    def reduce(local, parts):
        loss, tok = allreduce(local, op=SUM, comm=world)
        out = {}
        for n, g in parts.items():
            out[n], tok = allreduce(g, op=SUM, comm=world, token=tok)
        return loss, out

    def grads(params, x, y):
        names = sorted(params)
        with torch.enable_grad():
            leaves = {n: params[n].detach().requires_grad_(True) for n in names}
            pred = block_forward(
                leaves, x, heads=heads,
                attend=lambda q, k, v: ring_attention(q, k, v, comm=sp,
                                                      causal=True))
            # this rank's part of the global mean: the allreduced loss and
            # gradients are means over every rank's tile
            denom = world.Get_size() * y.numel()
            local = torch.sum((pred - y) ** 2) / denom
            parts = torch.autograd.grad(local, [leaves[n] for n in names])
        return reduce(local.detach(), dict(zip(names, parts)))

    return grads


def sgd(params: dict, grads: dict, lr: float) -> dict:
    """One plain SGD update of every parameter."""
    with torch.no_grad():
        return {n: params[n] - lr * grads[n] for n in sorted(params)}


def make_train_step(world: Comm, sp: Comm, heads: int, lr: float = 1e-2):
    """One SGD step on ``world``'s grid, the JAX example's
    ``make_train_step``: ``step(params, x, y)`` returns the updated
    parameters and the global loss before the update (``make_grad_fn``)."""
    grads = make_grad_fn(world, sp, heads)

    def step(params, x, y):
        loss, g = grads(params, x, y)
        return sgd(params, g, lr), loss

    return step


def make_grid(device=None):
    """This rank's ``("dp", "sp")`` grid over the world (a world of one
    outside any): ``n_dp = 2`` when the world is even and larger than 1,
    as the JAX example.  Returns ``(world, sp)`` comms."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    n_dp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_world_mesh((n_dp, n // n_dp), ("dp", "sp"), device=device)
    world = Comm(("dp", "sp"), mesh=mesh)
    return world, world.sub("sp")


def train_data(seed: int, batch: int, seq: int, d_model: int):
    """The global inputs ``(batch, seq, d_model)`` and targets
    ``(batch, seq)``, f32 on the CPU from a numpy seed: any grid cuts the
    same problem into its tiles."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, d_model), dtype=np.float32)
    y = rng.standard_normal((batch, seq), dtype=np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def tile_of(a, world: Comm, b_loc: int, t_loc: int):
    """This rank's tile of a global ``(B, T, ...)`` array: batch rows of
    its ``dp`` index, sequence chunk of its ``sp`` index."""
    dp, sp = world.axis_index("dp"), world.axis_index("sp")
    return a[dp * b_loc:(dp + 1) * b_loc, sp * t_loc:(sp + 1) * t_loc]


def digest(params: dict) -> str:
    """A hash of the parameters' bytes in sorted name order."""
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(params[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, *, b_loc: int = 2, t_loc: int = 32, d_model: int = 32,
         d_ff: int = 64, heads: int = 4, steps: int = 5, lr: float = 0.1,
         seed: int = 0, fusion: str = "auto"):
    """Train ``steps`` SGD steps on this rank's tile under ``fusion``
    (``set_fusion_mode``, reset at the end); rank 0 prints the loss.  The
    parameters come from ``init_params`` on a CPU generator seeded with
    ``seed`` (the same on every rank), the data from
    ``train_data(seed + 1, ...)``.  Returns ``losses`` (the global loss
    before each step's update), per step ``wall`` (seconds, synchronised),
    ``launches`` (each flash kernel's), ``exchange`` (calls, staged bytes
    and seconds of ``ops/_staging.stats``) and ``digests`` of the
    parameters after it; ``grads0`` (the first step's gradients) and
    ``peak_bytes`` (CUDA peak memory, else 0).  The JAX example's lr 0.1
    is for its width: at d_model 1024 SGD needs about 1e-3 not to
    diverge."""
    world, sp = make_grid(device)
    dev = world.device
    n_dp, n_sp = world.mesh.shape
    gen = torch.Generator().manual_seed(seed)
    params = init_params(d_model, d_ff, generator=gen, device=dev)
    x, y = train_data(seed + 1, n_dp * b_loc, n_sp * t_loc, d_model)
    x = tile_of(x, world, b_loc, t_loc).to(dev)
    y = tile_of(y, world, b_loc, t_loc).to(dev)
    grad_fn = make_grad_fn(world, sp, heads)
    out = {"losses": [], "wall": [], "launches": [], "exchange": [],
           "digests": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    set_fusion_mode(fusion)
    try:
        for i in range(steps):
            for name in KERNELS:
                _build.counter_for(name).launches = 0
            _staging.stats.reset()
            _sync(dev)
            start = time.perf_counter()
            loss, grads = grad_fn(params, x, y)
            params = sgd(params, grads, lr)
            _sync(dev)
            out["wall"].append(time.perf_counter() - start)
            out["launches"].append({name: _build.counter_for(name).launches
                                    for name in KERNELS})
            out["exchange"].append({"calls": _staging.stats.calls,
                                    "staged_bytes": _staging.stats.staged_bytes,
                                    "seconds": _staging.stats.seconds})
            out["losses"].append(loss.item())
            if i == 0:
                out["grads0"] = grads
            out["digests"].append(digest(params))
            if world.Get_rank() == 0:
                print(f"step {i}: loss {out['losses'][-1]:.6f}, "
                      f"{out['wall'][-1]:.4f} s")
    finally:
        set_fusion_mode(None)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    return out


def rank_main(rank: int, device, kwargs: dict):
    """``main`` on one rank of a ``launch.run`` world."""
    return main(device, **kwargs)


if __name__ == "__main__":
    from ..parallel import launch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device every rank shares")
    args = parser.parse_args()
    res = launch.run(rank_main, args.ranks, backend="gloo", device=args.device,
                     args=(args.device, {}))
    losses = res[0]["losses"]
    print(f"{args.ranks} ranks: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise SystemExit("training did not reduce the loss")
