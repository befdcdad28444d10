"""Parameters from the JAX package's tree, as numpy, to the port's layout.

The reference's ``init_lm`` returns a dict pytree whose ``"blocks"``
leaves are stacked over layers ``[L, ...]`` (for ``lax.scan``); the port
keeps the same dict but with ``"blocks"`` a list of per-layer dicts.
Leaves keep their dtype. A bfloat16 leaf (``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects) goes through float32 first, which is exact.
"""
from __future__ import annotations

from typing import Any, Dict

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
    ``device`` (``None`` = CUDA, which raises without a card)."""
    if cfg.family != "dense" or "cross_blocks" in tree:
        raise NotImplementedError("only the dense transformer tree is converted")
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "blocks"}
    blocks = _tree(tree["blocks"], device)
    n = next(iter(_leaves(blocks))).shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.num_layers}")
    out["blocks"] = [_layer(blocks, i) for i in range(n)]
    return out


def params_to(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The port's parameter tree (dicts and the per-layer list) on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t
