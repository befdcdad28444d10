"""The tree mapping between the JAX package's layout and the port's.

The reference's ``init_lm`` returns a dict pytree whose layer stacks are
stacked leaves (for ``lax.scan``): ``"blocks"`` [L, ...] (a vision
model's [n_units, n_self, ...], beside ``"cross_blocks"`` [n_units,
...]), or the hybrid's ``"units"`` [n_units, period, ...] and ``"tail"``
[rem, ...]. The port keeps the same dict with each stack a list of
per-layer dicts (a vision model's self layers one flat unit-major list,
the hybrid's units a list of lists). Its distillation gate dict is keyed
``blocks/attn/gate/wq`` with stacked leaves (the hybrid's
``shared_attn/attn/gate/wq``, one block); the port's is keyed
``blocks/<i>/attn/gate/wq``, one leaf per layer, and so are the AdamW
moments over it. In pretraining the reference's moments are trees shaped
like the parameters; the port keeps them flat, keyed by the parameters'
paths (``train.loop``), and nests them for a checkpoint.

``params_from_numpy`` / ``train_state_from_numpy`` carry the reference's
arrays (numpy) into the port. ``stack_layers`` / ``unstack_layers`` map a
port tree of tensors to the reference's structure and back, which is how
the port's checkpoints are written in the reference's leaf order.
Leaves keep their dtype. A bfloat16 leaf (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects) goes through float32 first, which is exact.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(t, device):
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    return _leaf(t, device)


def _layer(t, i: int):
    if isinstance(t, dict):
        return {k: _layer(v, i) for k, v in t.items()}
    return t[i]


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: torch.device | str | None = None) -> Dict[str, Any]:
    """Stacked numpy (or array-like) parameter tree -> port parameters on
    ``device`` (``None`` = CUDA, which raises without a card).

    The dense and MoE trees stack each ``blocks`` leaf [L, ...] (a MoE
    layer's ``moe`` dict: the fp32 ``router/w`` [L, d, E], the experts'
    ``wi_gate``/``wi_up`` [L, E, d, f] and ``wo`` [L, E, f, d], and the
    ``shared`` GLU). A cross-attention model's ``blocks`` leaves are
    [n_units, n_self, ...] and become the flat list of self layers,
    unit-major; its ``cross_blocks`` [n_units, ...] one block a unit.

    The recurrent trees: the Mamba1 LM's ``blocks`` [L, ...] become the
    list of L layers; the hybrid's ``units`` [n_units, period, ...] a list
    of units, each a list of its Mamba2 layers, its ``tail`` [rem, ...] a
    list, and its ``shared_attn`` one transformer block. ``A_log``, ``D``
    and ``dt_bias`` keep their float32 in a bf16 tree."""
    from repro_torch.models.transformer import _check_family, _units, n_self_layers
    if cfg.family == "hybrid":
        return _hybrid_from_numpy(tree, cfg, resolve_device(device))
    if cfg.family != "ssm":
        _check_family(cfg)
    if bool(cfg.cross_attn_period) != ("cross_blocks" in tree):
        raise ValueError("the tree's cross_blocks do not match the config's "
                         f"cross_attn_period {cfg.cross_attn_period}")
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items()
           if k not in ("blocks", "cross_blocks")}
    blocks = _tree(tree["blocks"], device)
    if cfg.cross_attn_period:
        blocks = _flat_units(blocks)
        out["cross_blocks"] = _layers(_tree(tree["cross_blocks"], device), _units(cfg)[0])
    out["blocks"] = _layers(blocks, n_self_layers(cfg))
    return out


def _hybrid_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device) -> Dict[str, Any]:
    from repro_torch.models.hybrid import _plan
    n_units, period, rem = _plan(cfg)
    out = {k: _tree(v, device) for k, v in tree.items() if k not in ("units", "tail")}
    units = _layers(_tree(tree["units"], device), n_units)
    out["units"] = [_layers(u, period) for u in units]
    if rem:
        out["tail"] = _layers(_tree(tree["tail"], device), rem)
    elif "tail" in tree:
        raise ValueError(f"the tree has a tail, the config's plan {_plan(cfg)} none")
    return out


def _flat_units(t):
    """[n_units, n_self, ...] leaves -> [n_units * n_self, ...]."""
    if isinstance(t, dict):
        return {k: _flat_units(v) for k, v in t.items()}
    return t.reshape((-1,) + tuple(t.shape[2:]))


def _layers(stacked, n: int):
    """[n, ...] leaves -> a list of n per-layer trees."""
    have = next(iter(_leaves(stacked))).shape[0]
    if have != n:
        raise ValueError(f"tree has {have} layers, config {n}")
    return [_layer(stacked, i) for i in range(n)]


def _per_layer(tree: Dict[str, Any], cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """{"blocks/<rest>": [L, ...]} -> {"blocks/<i>/<rest>": [...]} on
    ``device`` (a vision model's [n_units, n_self, ...] leaves numbered
    unit-major); a leaf outside the layer stack (the hybrid's
    ``shared_attn/...``) keeps its key."""
    out = {}
    for path, leaf in tree.items():
        head, rest = path.split("/", 1)
        t = _leaf(leaf, device)
        if head != "blocks":
            out[path] = t
            continue
        if cfg.cross_attn_period:
            t = t.reshape((-1,) + tuple(t.shape[2:]))
        for i in range(t.shape[0]):
            out[f"blocks/{i}/{rest}"] = t[i].clone()
    return out


def train_state_from_numpy(state: Any, cfg: ModelConfig,
                           device: torch.device | str | None = None):
    """The JAX package's ``TrainState`` (params, gate, opt =
    AdamWState(m, v, count, ef), step; leaves as numpy, e.g. after
    ``jax.device_get``) -> the port's ``train.loop.TrainState`` on
    ``device`` (``None`` = CUDA): the same numbers in the port's layout.
    A distill state's gate and moments become per-layer flat dicts; a
    pretrain state (``gate`` None) keeps ``gate`` None and its moments,
    trees shaped like the parameters, become flat dicts keyed by the
    parameters' paths."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.loop import TrainState, _walk, merge_gate
    device = resolve_device(device)
    opt = state.opt
    to_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device=device)  # noqa: E731
    if state.gate is None:
        def flat(t):
            return None if t is None else dict(_walk(params_from_numpy(t, cfg, device)))
        return TrainState(params_from_numpy(state.params, cfg, device), None,
                          AdamWState(flat(opt.m), flat(opt.v), to_i32(opt.count),
                                     flat(opt.ef)),
                          to_i32(state.step))
    gate = _per_layer(state.gate, cfg, device)
    params = merge_gate(params_from_numpy(state.params, cfg, device), gate)
    return TrainState(params, gate,
                      AdamWState(_per_layer(opt.m, cfg, device),
                                 _per_layer(opt.v, cfg, device), to_i32(opt.count),
                                 None if opt.ef is None else _per_layer(opt.ef, cfg, device)),
                      to_i32(state.step))


_LAYER_KEY = re.compile(r"blocks/(\d+)/(.+)")


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _stack(layers):
    """Per-layer trees of one structure -> one tree of [L, ...] leaves."""
    if isinstance(layers[0], dict):
        return {k: _stack([x[k] for x in layers]) for k in layers[0]}
    return torch.stack(layers)


def _is_layer_list(t) -> bool:
    """A list of per-layer trees (dicts, or lists of them: the hybrid's
    units); a list of tensors is an ordinary node."""
    return isinstance(t, list) and bool(t) and all(isinstance(x, (dict, list)) for x in t)


def _unit_shape(cfg: Optional[ModelConfig]):
    """(n_units, n_self) of a vision model's self-layer stack, else None."""
    if cfg is None or not cfg.cross_attn_period:
        return None
    return cfg.num_layers // cfg.cross_attn_period, cfg.cross_attn_period - 1


def _split_units(t, units):
    """[n_units * n_self, ...] leaves -> [n_units, n_self, ...]."""
    if isinstance(t, dict):
        return {k: _split_units(v, units) for k, v in t.items()}
    return t.reshape(tuple(units) + tuple(t.shape[1:]))


def stack_layers(tree: Any, cfg: Optional[ModelConfig] = None) -> Any:
    """A port tree -> the reference's structure. A list of per-layer trees
    (``"blocks"``, ``"cross_blocks"``, the hybrid's ``"tail"``, and its
    ``"units"``, a list of lists) becomes one tree of stacked [L, ...]
    leaves ([n_units, period, ...] for the units), and the keys
    ``blocks/<i>/<rest>`` of a flat dict (the gate and its AdamW moments)
    become ``blocks/<rest>`` holding the layers stacked in order; a
    vision model's (``cfg.cross_attn_period``) ``blocks`` stacks are
    [n_units, n_self, ...]. Every other node keeps its place (the hybrid's
    ``shared_attn`` and its gate keys among them)."""
    units = _unit_shape(cfg)
    if isinstance(tree, dict):
        out, layers = {}, {}
        for k, v in tree.items():
            mt = _LAYER_KEY.fullmatch(k) if isinstance(k, str) else None
            if mt:
                layers.setdefault(f"blocks/{mt[2]}", {})[int(mt[1])] = v
            elif _is_layer_list(v):
                out[k] = _stack([stack_layers(x, cfg) for x in v])
                if k == "blocks" and units:
                    out[k] = _split_units(out[k], units)
            else:
                out[k] = stack_layers(v, cfg)
        for k, by_layer in layers.items():
            if sorted(by_layer) != list(range(len(by_layer))):
                raise ValueError(f"{k}: layers {sorted(by_layer)} are not 0..L-1")
            out[k] = torch.stack([by_layer[i] for i in range(len(by_layer))])
            if units:
                out[k] = _split_units(out[k], units)
        return out
    if _is_namedtuple(tree):
        return type(tree)(*(stack_layers(t, cfg) for t in tree))
    if _is_layer_list(tree):
        return _stack([stack_layers(x, cfg) for x in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_layers(t, cfg) for t in tree)
    return tree


def unstack_layers(ref: Any, like: Any, cfg: Optional[ModelConfig] = None,
                   device=None) -> Any:
    """The inverse of ``stack_layers`` (the same ``cfg``): ``ref`` in the
    reference's structure -> the structure of the port tree ``like``, each
    leaf copied to ``device``, or without one to the device of the
    ``like`` leaf in its place (in ``ref``'s dtype)."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return ref.to(device if device is not None else like.device, copy=True)
    flat_units = _flat_units if _unit_shape(cfg) else (lambda t: t)
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            mt = _LAYER_KEY.fullmatch(k) if isinstance(k, str) else None
            if mt:
                out[k] = unstack_layers(flat_units(ref[f"blocks/{mt[2]}"])[int(mt[1])], v,
                                        cfg, device)
            elif _is_layer_list(v):
                stacked = flat_units(ref[k]) if k == "blocks" else ref[k]
                out[k] = [unstack_layers(_layer(stacked, i), x, cfg, device)
                          for i, x in enumerate(v)]
            else:
                out[k] = unstack_layers(ref[k], v, cfg, device)
        return out
    if _is_namedtuple(like):
        return type(like)(*(unstack_layers(r, t, cfg, device) for r, t in zip(ref, like)))
    if _is_layer_list(like):
        return [unstack_layers(_layer(ref, i), x, cfg, device) for i, x in enumerate(like)]
    if isinstance(like, (list, tuple)):
        return type(like)(unstack_layers(r, t, cfg, device) for r, t in zip(ref, like))
    raise TypeError(f"unsupported tree node {type(like).__name__}")


def params_to(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The port's parameter tree (dicts and the per-layer list) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def train_state_to(state: Any, device) -> Any:
    """The port's ``train.loop.TrainState`` (either mode) on ``device``; the
    gate leaves of a distill state's ``params`` are the gate dict's, as
    the loop keeps them."""
    from repro_torch.train.loop import TrainState, merge_gate
    move = lambda d: None if d is None else {k: t.to(device) for k, t in d.items()}  # noqa: E731
    gate, opt = move(state.gate), state.opt
    params = params_to(state.params, device)
    return TrainState(params if gate is None else merge_gate(params, gate), gate,
                      opt._replace(m=move(opt.m), v=move(opt.v), count=opt.count.to(device),
                                   ef=move(opt.ef)),
                      state.step.to(device))


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t
