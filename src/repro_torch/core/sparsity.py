"""Sparsification: soft gate scores -> discrete block selections (paper §3.1).

PyTorch port of the JAX package's ``core/sparsity.py``. Two methods:
  * token budget — top-k over blocks, k = budget // block_size (no softmax).
  * threshold   — select blocks with softmax score > tau, capped at
    ``max_selected`` (highest scores win).

Index lists use -1 as the "no block" sentinel: ``[B, Hkv, k]`` int32.

Ties break lower index first, as ``jax.lax.top_k`` does. ``torch.topk``
does not promise an order among equal values, so ranking goes through a
stable descending sort.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import GateConfig
from repro_torch.models.common import NEG_INF


def resolve_max_selected(cfg: GateConfig,
                         max_selected: Optional[int] = None) -> int:
    """Selected-list width BEFORE the per-method floor/cap: the explicit
    cap when given, else the config token budget in blocks (floor: the
    paper's k = budget // block_size). An explicit zero/negative cap is a
    caller error, never a silent fallback to the config budget."""
    if max_selected is not None:
        if max_selected <= 0:
            raise ValueError(
                f"max_selected must be positive, got {max_selected}")
        return max_selected
    return max(1, cfg.token_budget // cfg.block_size)


def ranked_top_k(values: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, lower index first on ties
    (the ``jax.lax.top_k`` order). Returns (values, int64 indices)."""
    vals, order = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def _force_blocks(scores: torch.Tensor, n_valid_blocks: torch.Tensor,
                  cfg: GateConfig) -> torch.Tensor:
    """Pin the trailing (possibly partial) block and optionally block 0."""
    nb = scores.shape[-1]
    ar = torch.arange(nb, device=scores.device)
    big = 1e30
    if cfg.always_last_block:
        last = (n_valid_blocks - 1)[:, None, None]          # [B,1,1]
        scores = torch.where(ar[None, None, :] == last, big, scores)
    if cfg.always_first_block:
        scores = torch.where(ar[None, None, :] == 0, big, scores)
    return scores


def _selected_mask(shape, top_idx: torch.Tensor,
                   sel_valid: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, nb] bool: the blocks the CAPPED list attends (logical OR
    over the winners; invalid slots contribute nothing)."""
    cnt = torch.zeros(shape, dtype=torch.int32, device=top_idx.device)
    cnt.scatter_add_(-1, top_idx.clamp_min(0), sel_valid.to(torch.int32))
    return cnt > 0


def budget_select(scores: torch.Tensor, n_valid_blocks: torch.Tensor,
                  cfg: GateConfig, max_selected: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-budget top-k selection.

    scores: [B, Hkv, nb] gate logits for ONE query step (decode).
    n_valid_blocks: [B] number of currently visible blocks.
    Returns (block_indices [B, Hkv, k] int32 with -1 padding, mask [B,Hkv,nb]).
    """
    nb = scores.shape[-1]
    k = resolve_max_selected(cfg, max_selected)
    # the budget can never exclude the force-selected blocks (first/last)
    min_k = int(cfg.always_last_block) + int(cfg.always_first_block)
    k = min(max(k, min_k), nb)
    ar = torch.arange(nb, device=scores.device)
    valid = ar[None, None, :] < n_valid_blocks[:, None, None]
    s = torch.where(valid, scores, NEG_INF)
    s = _force_blocks(s, n_valid_blocks, cfg)
    top_vals, top_idx = ranked_top_k(s, k)
    sel_valid = top_vals > NEG_INF / 2
    idx = torch.where(sel_valid, top_idx, -1).to(torch.int32)
    return idx, _selected_mask(s.shape, top_idx, sel_valid)


def threshold_select(probs: torch.Tensor, n_valid_blocks: torch.Tensor,
                     cfg: GateConfig, max_selected: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold selection on softmaxed scores; capped at ``max_selected``
    (highest-score blocks win when the threshold admits more than the cap).

    probs: [B, Hkv, nb] gate probabilities for one query step.
    """
    nb = probs.shape[-1]
    ar = torch.arange(nb, device=probs.device)
    valid = ar[None, None, :] < n_valid_blocks[:, None, None]
    p = torch.where(valid, probs, -1.0)
    p = _force_blocks(p, n_valid_blocks, cfg)
    admitted = p > cfg.threshold
    ranked = torch.where(admitted, p, -1.0)
    k = min(max_selected, nb)
    top_vals, top_idx = ranked_top_k(ranked, k)
    sel_valid = top_vals > 0
    idx = torch.where(sel_valid, top_idx, -1).to(torch.int32)
    return idx, _selected_mask(p.shape, top_idx, sel_valid)


def select_blocks(scores_or_probs: torch.Tensor, n_valid_blocks: torch.Tensor,
                  cfg: GateConfig, max_selected: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.method == "budget":
        return budget_select(scores_or_probs, n_valid_blocks, cfg, max_selected)
    if cfg.method == "threshold":
        ms = resolve_max_selected(cfg, max_selected)
        return threshold_select(scores_or_probs, n_valid_blocks, cfg, ms)
    raise ValueError(cfg.method)


def sparsity_ratio(mask: torch.Tensor, n_valid_blocks: torch.Tensor) -> torch.Tensor:
    """Fraction of visible blocks NOT attended (higher = sparser)."""
    sel = torch.sum(mask, dim=-1).to(torch.float32)            # [B, Hkv]
    tot = torch.clamp_min(n_valid_blocks[:, None].to(torch.float32), 1.0)
    return 1.0 - torch.mean(sel / tot)
