"""AdamW + cosine schedule + grad clip + gradient compression, PyTorch port.

Plain functions over dicts of tensors (``{name: tensor}``), the arithmetic
of the JAX package's ``optim/adamw.py`` step for step in fp32: the
learning rate of update ``count + 1`` from ``cosine_lr``, bias-corrected
moments, and the weight decay inside the step. ``torch.optim.AdamW`` is
not used: its rounding and its schedule hook differ.

Gradient compression:
  * "bf16"    - grads rounded to bf16 (halves data-parallel bytes);
  * "topk_ef" - per-leaf top-k magnitude sparsification with an
                error-feedback residual (Stich et al.); a leaf is the
                reference's, so the per-layer leaves of one stacked
                [L, ...] leaf share one threshold.

Under a training ``Shard`` (``apply(..., shard=, layout=)``) the trees are
a rank's blocks (``distributed.sharding``): the update is elementwise and
local, the global norm sums a split leaf's squares over the ranks and
counts a replicated leaf (or part) once, and ``topk_ef``'s threshold is
the k-th largest magnitude of the whole leaf, from every rank's local
top k. ``bf16`` stays local.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import OptimConfig

Tree = Dict[str, torch.Tensor]
# path -> the leaf's distributed.sharding.Layout (None: replicated)
LayoutFn = Callable[[str], Optional[object]]


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


def global_norm(tree: Tree, shard=None, layout: Optional[LayoutFn] = None) -> torch.Tensor:
    """The l2 norm over every leaf. Under a ``shard`` the leaves are the
    rank's blocks: the split leaves' sums of squares are summed over ranks
    in one collective, a replicated part subtracted ``world - 1`` times,
    so every leaf counts once; the leaves are then added in the same
    order as without a shard (a one-rank group is bitwise the unsharded
    norm)."""
    sums = {k: torch.sum(torch.square(tree[k].to(torch.float32))) for k in sorted(tree)}
    if shard is not None:
        split = [(k, layout(k)) for k in sorted(tree)]
        split = [(k, lay) for k, lay in split if lay is not None]
        if split:
            total = shard.all_sum(torch.stack([sums[k] for k, _ in split]))
            for (k, lay), s in zip(split, total.unbind(0)):
                for at, n in lay.replicated_slices(shard.world) if shard.world > 1 else ():
                    rep = tree[k].narrow(lay.axis, at, n).to(torch.float32)
                    s = s - (shard.world - 1) * torch.sum(torch.square(rep))
                sums[k] = s
    total = 0
    for k in sorted(tree):              # the reference's leaf order (sorted keys)
        total = total + sums[k]
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Tree, max_norm: float, shard=None,
                        layout: Optional[LayoutFn] = None) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(grads, shard, layout)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, gn


def _owned(a: torch.Tensor, lay, shard) -> torch.Tensor:
    """The entries of a rank's leaf ``a`` that only it holds: its split
    blocks, and the replicated parts on rank 0 alone (flattened)."""
    pieces, at = [], 0
    for n, split in lay.local_parts(shard.world):
        if split or shard.rank == 0:
            pieces.append(a.narrow(lay.axis, at, n).reshape(-1))
        at += n
    return torch.cat(pieces) if pieces else a.new_empty((0,))


def _stacked(path: str) -> str:
    """The reference's leaf of a port path: the per-layer leaves
    ``blocks/<i>/rest`` (``units/<u>/<j>/rest``, ...) are one stacked
    [L, ...] leaf there."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def _thresholds(mags: Tree, ratio: float, shard, layout: Optional[LayoutFn]
                ) -> Dict[str, torch.Tensor]:
    """The k-th largest magnitude of each of the reference's leaves (a
    port leaf, or the layers of a stacked one together), k = max(1,
    int(its full size * ratio)), for each port leaf of ``mags``: the k
    largest of the union of each layer's k largest. Under a shard a split
    leaf's candidates are every rank's local k largest of the entries it
    owns (padded with -1), gathered in one collective packed over the
    leaves. Exact either way: the threshold is an entry's value."""
    groups: Dict[str, list] = {}
    for key in mags:
        groups.setdefault(_stacked(key), []).append(key)
    out, cands = {}, []
    for keys in groups.values():
        lays = [layout(k) if shard is not None else None for k in keys]
        full = sum(mags[k].numel() // mags[k].shape[lay.axis] * sum(n for n, _ in lay.parts)
                   if lay is not None else mags[k].numel() for k, lay in zip(keys, lays))
        n = max(1, int(full * ratio))
        own = [mags[k].reshape(-1) if lay is None else _owned(mags[k], lay, shard)
               for k, lay in zip(keys, lays)]
        top = torch.cat([torch.topk(a, min(n, a.numel())).values for a in own])
        if lays[0] is None:
            thresh = torch.topk(top, n).values[-1]
            out.update(dict.fromkeys(keys, thresh))
            continue
        top = torch.topk(top, min(n, top.numel())).values
        cands.append((keys, n, torch.cat([top, top.new_full((n - top.numel(),), -1.0)])))
    if cands:
        got = shard.all_gather(torch.cat([c for _, _, c in cands])[None], 0)
        at = 0
        for keys, n, _ in cands:
            out.update(dict.fromkeys(keys, torch.topk(got[:, at:at + n].reshape(-1),
                                                      n).values[-1]))
            at += n
    return out


def _topk_ef(grads: Tree, ef: Tree, ratio: float, shard=None,
             layout: Optional[LayoutFn] = None) -> Tuple[Tree, Tree]:
    acc = {k: g.to(torch.float32) + ef[k] for k, g in grads.items()}
    thresh = _thresholds({k: torch.abs(g) for k, g in acc.items()}, ratio, shard, layout)
    sent, resid = {}, {}
    for k, g in acc.items():
        s = torch.where(torch.abs(g) >= thresh[k], g, 0.0)
        sent[k], resid[k] = s, g - s
    return sent, resid


def compress_grads(grads: Tree, state: AdamWState, cfg: OptimConfig, shard=None,
                   layout: Optional[LayoutFn] = None) -> Tuple[Tree, AdamWState]:
    if cfg.grad_compression == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}, state
    if cfg.grad_compression == "topk_ef":
        sent, resid = _topk_ef(grads, state.ef, cfg.topk_ratio, shard, layout)
        return sent, state._replace(ef=resid)
    return grads, state


def apply(params: Tree, grads: Tree, state: AdamWState, cfg: OptimConfig, *,
          shard=None, layout: Optional[LayoutFn] = None
          ) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW update. Returns (new params in their dtypes, new state,
    {"lr", "grad_norm"}); the inputs are not modified. Under a ``shard``
    the trees are the rank's blocks and ``layout(path)`` gives each
    leaf's ``distributed.sharding.Layout`` (None where replicated)."""
    grads, state = compress_grads(grads, state, cfg, shard, layout)
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    if cfg.grad_clip > 0:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip, shard, layout)
    else:
        gn = global_norm(grads, shard, layout)
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
