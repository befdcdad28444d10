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

Over a data axis (``apply(..., data=, zero1=)``) each replica's gradient
is its rows' share, and it is first all-reduced over the data group in
fp32, so every replica compresses, clips and applies the reference's
global gradient (``bf16(sum) != sum(bf16)``: no bf16 partials are sent).
With ZeRO-1 (``zero1``: path -> ``sharding.Zero1``) the moments and the
error-feedback residual hold the rank's slice of those leaves: the
gradient and the parameter are cut to it, the norm sums the slices'
squares over the data group, ``topk_ef``'s candidates come from every
data rank's slice, the update runs on the slice, and the parameter is
all-gathered over the data group. A one-rank data group sends nothing
and runs the step without one.
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


def _rep_squares(t: torch.Tensor, lay, world: int) -> torch.Tensor:
    """The sum of squares of a rank's leaf ``t`` over its replicated parts."""
    s = torch.zeros((), dtype=torch.float32, device=t.device)
    if t.numel() == 0:                  # a ZeRO-1 layer slice another rank owns
        return s
    for at, n in lay.replicated_slices(world):
        s = s + torch.sum(torch.square(t.narrow(lay.axis, at, n).to(torch.float32)))
    return s


def _counted_once(tree: Tree, sums: Dict[str, torch.Tensor], shard, layout, data,
                  sliced) -> Dict[str, torch.Tensor]:
    """Each leaf's sum of squares counted once over the ranks: the
    ``sliced`` leaves' (each data rank's ZeRO-1 slice) and their
    replicated parts' summed over the data group in one collective, then
    the model-split leaves' summed over the model ranks in one, a
    replicated part subtracted ``world - 1`` times."""
    mw = 1 if shard is None else shard.world
    split = {k: layout(k) for k in tree} if shard is not None else {}
    split = {k: lay for k, lay in split.items() if lay is not None}
    rep = {k: _rep_squares(tree[k], lay, mw) for k, lay in split.items()
           if mw > 1 and lay.replicated_slices(mw)}
    keys = sorted(k for k in tree if k in sliced)
    if keys:
        rk = [k for k in keys if k in rep]
        got = data.all_sum(torch.stack([sums[k] for k in keys] + [rep[k] for k in rk]))
        sums.update(zip(keys, got[:len(keys)].unbind(0)))
        rep.update(zip(rk, got[len(keys):].unbind(0)))
    ks = sorted(split)
    if ks:
        total = shard.all_sum(torch.stack([sums[k] for k in ks]))
        for k, s in zip(ks, total.unbind(0)):
            sums[k] = s - (mw - 1) * rep[k] if k in rep else s
    return sums


def global_norm(tree: Tree, shard=None, layout: Optional[LayoutFn] = None, data=None,
                sliced=()) -> torch.Tensor:
    """The l2 norm over every leaf. Under a ``shard`` the leaves are the
    rank's blocks: the split leaves' sums of squares are summed over ranks
    in one collective, a replicated part subtracted ``world - 1`` times,
    so every leaf counts once; the leaves are then added in the same
    order as without a shard (a one-rank group is bitwise the unsharded
    norm). The leaves named in ``sliced`` are the data rank's ZeRO-1
    slices, their squares summed over the ``data`` group as well."""
    sums = {k: torch.sum(torch.square(tree[k].to(torch.float32))) for k in sorted(tree)}
    if shard is not None or sliced:
        sums = _counted_once(tree, sums, shard, layout, data, set(sliced))
    total = 0
    for k in sorted(tree):              # the reference's leaf order (sorted keys)
        total = total + sums[k]
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Tree, max_norm: float, shard=None,
                        layout: Optional[LayoutFn] = None, data=None,
                        sliced=()) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(grads, shard, layout, data, sliced)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, gn


def _owned(a: torch.Tensor, lay, shard) -> torch.Tensor:
    """The entries of a rank's leaf ``a`` that only it holds: its split
    blocks, and the replicated parts on rank 0 alone (flattened)."""
    if a.numel() == 0:                  # a ZeRO-1 layer slice another rank owns
        return a.reshape(-1)
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


def _full_size(t: torch.Tensor, lay) -> int:
    """The whole leaf's element count of a rank's leaf ``t`` under the model
    layout ``lay`` (None: replicated)."""
    if lay is None:
        return t.numel()
    return t.numel() // t.shape[lay.axis] * sum(n for n, _ in lay.parts)


def _thresholds(mags: Tree, ratio: float, shard, layout: Optional[LayoutFn], data=None,
                sliced=(), sizes: Optional[Dict[str, int]] = None
                ) -> Dict[str, torch.Tensor]:
    """The k-th largest magnitude of each of the reference's leaves (a
    port leaf, or the layers of a stacked one together), k = max(1,
    int(its full size * ratio)), for each port leaf of ``mags``: the k
    largest of the union of each layer's k largest. Under a shard a split
    leaf's candidates are every rank's local k largest of the entries it
    owns (padded with -1), gathered in one collective packed over the
    leaves; a leaf in ``sliced`` (the data rank's ZeRO-1 slice, whose
    whole size ``sizes`` gives) first gathers every data rank's
    candidates the same way. Exact either way: the threshold is an
    entry's value."""
    groups: Dict[str, list] = {}
    for key in mags:
        groups.setdefault(_stacked(key), []).append(key)
    out, cands = {}, []
    for keys in groups.values():
        lays = [layout(k) if shard is not None else None for k in keys]
        full = sum(sizes[k] if sizes is not None else _full_size(mags[k], lay)
                   for k, lay in zip(keys, lays))
        n = max(1, int(full * ratio))
        own = [mags[k].reshape(-1) if lay is None else _owned(mags[k], lay, shard)
               for k, lay in zip(keys, lays)]
        top = torch.cat([torch.topk(a, min(n, a.numel())).values for a in own])
        on_data = any(k in sliced for k in keys)
        if lays[0] is None and not on_data:
            thresh = torch.topk(top, n).values[-1]
            out.update(dict.fromkeys(keys, thresh))
            continue
        top = torch.topk(top, min(n, top.numel())).values
        cands.append([keys, n, torch.cat([top, top.new_full((n - top.numel(),), -1.0)]),
                      on_data, lays[0] is not None])
    for grp, axis in ((data, 3), (shard, 4)):
        picked = [c for c in cands if c[axis]]
        if not picked:
            continue
        got = grp.all_gather(torch.cat([c[2] for c in picked])[None], 0)
        at = 0
        for c in picked:
            c[2] = torch.topk(got[:, at:at + c[1]].reshape(-1), c[1]).values
            at += c[1]
    for keys, n, cand, _, _ in cands:
        out.update(dict.fromkeys(keys, cand[-1]))
    return out


def _topk_ef(grads: Tree, ef: Tree, ratio: float, shard=None,
             layout: Optional[LayoutFn] = None, data=None, sliced=(),
             sizes=None) -> Tuple[Tree, Tree]:
    acc = {k: g.to(torch.float32) + ef[k] for k, g in grads.items()}
    thresh = _thresholds({k: torch.abs(g) for k, g in acc.items()}, ratio, shard, layout,
                         data, sliced, sizes)
    sent, resid = {}, {}
    for k, g in acc.items():
        s = torch.where(torch.abs(g) >= thresh[k], g, 0.0)
        sent[k], resid[k] = s, g - s
    return sent, resid


def compress_grads(grads: Tree, state: AdamWState, cfg: OptimConfig, shard=None,
                   layout: Optional[LayoutFn] = None, data=None, sliced=(),
                   sizes=None) -> Tuple[Tree, AdamWState]:
    if cfg.grad_compression == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}, state
    if cfg.grad_compression == "topk_ef":
        sent, resid = _topk_ef(grads, state.ef, cfg.topk_ratio, shard, layout, data, sliced,
                               sizes)
        return sent, state._replace(ef=resid)
    return grads, state


def apply(params: Tree, grads: Tree, state: AdamWState, cfg: OptimConfig, *,
          shard=None, layout: Optional[LayoutFn] = None, data=None,
          zero1: Optional[Dict[str, object]] = None
          ) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW update. Returns (new params in their dtypes, new state,
    {"lr", "grad_norm"}); the inputs are not modified. Under a ``shard``
    the trees are the rank's blocks and ``layout(path)`` gives each
    leaf's ``distributed.sharding.Layout`` (None where replicated). Over
    a ``data`` shard the gradients are the replica's rows' and are
    all-reduced over it first; ``zero1`` (path -> ``sharding.Zero1``,
    the leaves whose moments hold the data rank's slice) runs those
    leaves' update on the slice and gathers the parameter."""
    sizes, zero1 = None, zero1 or {}
    if data is not None and data.world > 1:
        keys = list(grads)
        grads = dict(zip(keys, data.all_sum_packed([grads[k].to(torch.float32)
                                                    for k in keys])))
        if zero1:
            sizes = {k: _full_size(g, layout(k) if shard is not None else None)
                     for k, g in grads.items()}
            grads = {k: zero1[k].piece(g, data.rank) if k in zero1 else g
                     for k, g in grads.items()}
    sliced = tuple(zero1)
    grads, state = compress_grads(grads, state, cfg, shard, layout, data, sliced, sizes)
    grads = {k: g.to(torch.float32) for k, g in grads.items()}
    if cfg.grad_clip > 0:
        grads, gn = clip_by_global_norm(grads, cfg.grad_clip, shard, layout, data, sliced)
    else:
        gn = global_norm(grads, shard, layout, data, sliced)
    count = state.count + 1
    lr = cosine_lr(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device), cf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        if k in zero1:
            p = zero1[k].piece(p, data.rank)
        g, m, v = grads[k], state.m[k], state.v[k]
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        step = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    if zero1:
        from repro_torch.distributed.sharding import zero1_gather
        new_p = zero1_gather(new_p, zero1, data)
    return new_p, AdamWState(new_m, new_v, count.to(torch.int32), state.ef), \
        {"lr": lr, "grad_norm": gn}
