"""Carry state, configuration and parameters across from the JAX package.

The JAX package keeps the shallow-water state as stacked blocks
``(nproc, ny_l, nx_l)``; rank ``r`` of the port holds ``global[r]``.  The
long-context training example's parameters are a dict of arrays
(``examples/long_context_training.py:init_params``), replicated on every
rank; the data-parallel example's are a list of ``{"w", "b"}`` layers
(``examples/data_parallel_training.py:init_mlp``).  The MoE example's
parameters are a ``MoEParams`` of rank-stacked arrays (router, expert
layer 1, expert layer 2; ``examples/moe_training.py:build_inputs``), and
the pipeline example's stage weights a stack with the ranks on the
leading axis (``examples/pipeline_parallel.py``).  The serving engine's
state is eight global arrays with the ranks on the leading axis (its
``_state``: the five parameter shards of ``serving/model.py:shard_params``,
the KV pair and the token table).  Every function takes
plain numpy arrays, dicts and lists (a JAX array converts through
``np.asarray``, which these functions call), so nothing here imports
JAX: ``dataclasses.asdict`` the JAX config first.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .models import long_context_training as LCT
from .models.shallow_water import Config, State
from .parallel.mesh import resolve_device


def config_from_jax(cfg_fields: dict) -> Config:
    """The port's ``Config`` from the JAX ``Config``'s fields as a dict;
    keys the port does not know raise ``TypeError``."""
    known = {f.name for f in fields(Config)}
    unknown = set(cfg_fields) - known
    if unknown:
        raise TypeError(f"config_from_jax: unknown Config fields {sorted(unknown)}")
    return Config(**cfg_fields)


def state_from_jax(arrays, cfg: Config, rank: int = 0, device=None) -> State:
    """Rank ``rank``'s local ``State`` from the six stacked-block arrays
    (h, u, v, dh, du, dv), each ``(nproc, ny_l, nx_l)``."""
    device = resolve_device(device)
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != len(State._fields):
        raise ValueError(f"state_from_jax: expected 6 fields, got {len(arrays)}")
    want = (cfg.nproc, cfg.ny_local, cfg.nx_local)
    for name, a in zip(State._fields, arrays):
        if a.shape != want:
            raise ValueError(
                f"state_from_jax: field {name} has shape {a.shape}, want {want}"
            )
    if not 0 <= rank < cfg.nproc:
        raise ValueError(f"rank {rank} out of range for {cfg.nproc} ranks")
    return State(*(
        torch.from_numpy(np.array(a[rank], np.float32)).to(device)
        for a in arrays
    ))


def states_from_jax(arrays, cfg: Config, device=None):
    """Every rank's local ``State`` from the six stacked-block arrays, in
    rank order."""
    return [state_from_jax(arrays, cfg, rank=r, device=device)
            for r in range(cfg.nproc)]


def params_from_jax(params: dict, device=None) -> dict:
    """The training example's parameters as f32 tensors on ``device``,
    from ``init_params``' dict of arrays (``jax.random`` draws them; the
    port's own ``init_params`` draws others).  Shapes must be those of
    ``init_params(key, d_model, d_ff)`` for the d_model and d_ff that
    ``wqkv`` and ``w1`` show; a missing or unknown key raises ``KeyError``,
    a wrong shape ``ValueError``.  ``models.long_context_training.Block``
    makes a module of the result."""
    device = resolve_device(device)
    names = set(LCT.PARAM_NAMES)
    if set(params) != names:
        raise KeyError(
            f"params_from_jax: expected keys {sorted(names)}; missing "
            f"{sorted(names - set(params))}, unknown {sorted(set(params) - names)}")
    arrays = {k: np.asarray(v) for k, v in params.items()}
    d_model, d_ff = arrays["wqkv"].shape[0], arrays["w1"].shape[-1]
    for name, want in LCT.param_shapes(d_model, d_ff).items():
        if arrays[name].shape != want:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{arrays[name].shape}, want {want}")
    return {k: torch.from_numpy(np.array(a, np.float32)).to(device)
            for k, a in arrays.items()}


def mlp_params_from_jax(params, device=None) -> list:
    """The data-parallel example's layers as f32 tensors on ``device``,
    from ``init_mlp``'s list of ``{"w", "b"}`` dicts of arrays: each ``w``
    (fan_in, fan_out) and ``b`` (fan_out,), each layer's fan_in the last
    one's fan_out; other keys or shapes raise ``KeyError`` or
    ``ValueError``.  ``models.data_parallel_training`` trains the result."""
    device = resolve_device(device)
    out, fan_in = [], None
    for i, layer in enumerate(params):
        if set(layer) != {"w", "b"}:
            raise KeyError(f"mlp_params_from_jax: layer {i} has keys "
                           f"{sorted(layer)}, expected ['b', 'w']")
        w, b = np.asarray(layer["w"]), np.asarray(layer["b"])
        if (w.ndim != 2 or b.shape != (w.shape[1],)
                or fan_in not in (None, w.shape[0])):
            raise ValueError(f"mlp_params_from_jax: layer {i} has w {w.shape} "
                             f"and b {b.shape} after fan-out {fan_in}")
        fan_in = w.shape[1]
        out.append({k: torch.from_numpy(np.array(a, np.float32)).to(device)
                    for k, a in (("w", w), ("b", b))})
    return out


def moe_params_from_jax(params, device=None) -> list:
    """Every rank's ``parallel.moe.MoEParams`` of f32 tensors on ``device``,
    in rank order, from the JAX package's rank-stacked ``MoEParams``
    (``w_gate`` ``(k, d, k)``, replicated; ``w_in`` ``(k, d, d_ff)`` and
    ``w_out`` ``(k, d_ff, d)``, rank ``e``'s expert ``e``): the fields in
    that order, as a named tuple or any sequence of three arrays.  Other
    shapes raise ``ValueError``."""
    from .parallel.moe import MoEParams

    device = resolve_device(device)
    if len(params) != len(MoEParams._fields):
        raise ValueError(f"moe_params_from_jax: expected the fields "
                         f"{MoEParams._fields}, got {len(params)} arrays")
    w_gate, w_in, w_out = (np.asarray(a) for a in params)
    if w_gate.ndim != 3 or w_in.ndim != 3 or w_out.ndim != 3:
        raise ValueError("moe_params_from_jax: expected rank-stacked 3-D "
                         f"arrays, got {w_gate.shape}, {w_in.shape}, {w_out.shape}")
    k, d, d_ff = w_in.shape
    if (w_gate.shape != (k, d, k) or w_out.shape != (k, d_ff, d)):
        raise ValueError(
            f"moe_params_from_jax: w_gate {w_gate.shape} and w_out "
            f"{w_out.shape} do not fit w_in {w_in.shape} (want {(k, d, k)} "
            f"and {(k, d_ff, d)}: one expert a rank)")
    return [MoEParams(*(torch.from_numpy(np.array(a[r], np.float32)).to(device)
                        for a in (w_gate, w_in, w_out)))
            for r in range(k)]


def stage_params_from_jax(stacked, device=None) -> list:
    """Every rank's stage parameters as f32 tensors on ``device``, in rank
    order, from the pipeline's rank-stacked weights: an array, or a dict or
    list of arrays, each with the ranks on its leading axis (the flat
    schedules' ``(S, ...)``, the interleaved schedule's ``(S, v, ...)``),
    all of one rank count; otherwise ``ValueError``."""
    from .utils.tree import tree_flatten

    device = resolve_device(device)
    leaves, unflatten = tree_flatten(stacked)
    arrays = [np.asarray(a) for a in leaves]
    counts = {a.shape[0] if a.ndim else None for a in arrays}
    if len(counts) != 1 or None in counts:
        raise ValueError("stage_params_from_jax: every leaf needs the same "
                         f"leading rank axis, got shapes "
                         f"{[a.shape for a in arrays]}")
    (k,) = counts
    return [unflatten([torch.from_numpy(np.array(a[r], np.float32)).to(device)
                       for a in arrays])
            for r in range(k)]


def serving_state_from_jax(global_arrays, rank: int, device=None) -> tuple:
    """Rank ``rank``'s serving tensors on ``device`` from the JAX serving
    engine's global arrays: the eight of its ``_state`` (``emb``,
    ``wqkv``, ``wo``, ``w1``, ``w2`` f32, ``kk``, ``vv`` f32, ``tok_table``
    int32), or the five parameter arrays of its
    ``model.shard_params(master, k)``; each with the same leading rank
    axis.  Other counts, or leading axes that differ, raise
    ``ValueError``."""
    device = resolve_device(device)
    arrays = [np.asarray(a) for a in global_arrays]
    if len(arrays) not in (5, 8):
        raise ValueError("serving_state_from_jax: expected the 5 parameter "
                         f"arrays or the 8 state arrays, got {len(arrays)}")
    counts = {a.shape[0] if a.ndim else None for a in arrays}
    if len(counts) != 1 or None in counts:
        raise ValueError("serving_state_from_jax: every array needs the same "
                         "leading rank axis, got shapes "
                         f"{[a.shape for a in arrays]}")
    (k,) = counts
    if not 0 <= rank < k:
        raise ValueError(f"rank {rank} out of range for {k} ranks")
    dtypes = [np.float32] * 7 + [np.int32]
    return tuple(torch.from_numpy(np.array(a[rank], dt)).to(device)
                 for a, dt in zip(arrays, dtypes))
