"""AdamW + cosine schedule + grad clip + gradient compression, PyTorch port.

Plain functions over dicts of tensors (``{name: tensor}``), the arithmetic
of the JAX package's ``optim/adamw.py`` step for step in fp32: the
learning rate of update ``count + 1`` from ``cosine_lr``, bias-corrected
moments, and the weight decay inside the step. ``torch.optim.AdamW`` is
not used: its rounding and its schedule hook differ.

Gradient compression:
  * "bf16"    - grads rounded to bf16 (halves data-parallel bytes);
  * "topk_ef" - per-leaf top-k magnitude sparsification with an
                error-feedback residual (Stich et al.).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import OptimConfig

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    count: torch.Tensor                # int32 scalar
    ef: Optional[Tree] = None          # error-feedback residual (topk_ef)


def cosine_lr(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=step.device)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(pi * prog))


def init(params: Tree, cfg: OptimConfig) -> AdamWState:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return AdamWState(m=zeros(), v=zeros(),
                      count=torch.zeros((), dtype=torch.int32, device=dev),
                      ef=zeros() if cfg.grad_compression == "topk_ef" else None)


def global_norm(tree: Tree) -> torch.Tensor:
    total = 0
    for k in sorted(tree):              # the reference's leaf order (sorted keys)
        total = total + torch.sum(torch.square(tree[k].to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, gn


def _topk_ef(grads: Tree, ef: Tree, ratio: float) -> Tuple[Tree, Tree]:
    sent, resid = {}, {}
    for k, g in grads.items():
        g = g.to(torch.float32) + ef[k]
        flat = g.reshape(-1)
        n = max(1, int(flat.numel() * ratio))
        thresh = torch.topk(torch.abs(flat), n).values[-1]
        s = torch.where(torch.abs(g) >= thresh, g, 0.0)
        sent[k], resid[k] = s, g - s
    return sent, resid


def compress_grads(grads: Tree, state: AdamWState, cfg: OptimConfig
                   ) -> Tuple[Tree, AdamWState]:
    if cfg.grad_compression == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}, state
    if cfg.grad_compression == "topk_ef":
        sent, resid = _topk_ef(grads, state.ef, cfg.topk_ratio)
        return sent, state._replace(ef=resid)
    return grads, state


def apply(params: Tree, grads: Tree, state: AdamWState, cfg: OptimConfig
          ) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW update. Returns (new params in their dtypes, new state,
    {"lr", "grad_norm"}); the inputs are not modified."""
    grads, state = compress_grads(grads, state, cfg)
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    if cfg.grad_clip > 0:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gn = global_norm(grads)
    count = state.count + 1
    lr = cosine_lr(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device), cf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g, m, v = grads[k], state.m[k], state.v[k]
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    return new_p, AdamWState(new_m, new_v, count.to(torch.int32), state.ef), \
        {"lr": lr, "grad_norm": gn}
