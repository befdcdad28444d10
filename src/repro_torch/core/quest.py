"""Quest baseline (Tang et al., 2024): training-free query-aware selection.

PyTorch port of the JAX package's ``core/quest.py``. Per KV block, the
elementwise min and max of the (post-rope) keys; for a query q the upper
bound of q.k over the block is ``sum_d max(q_d * min_d, q_d * max_d)``,
computed as two contractions (the positive part of q hits the max, the
negative part the min) and summed in that order. Blocks rank by the
bound. Quest selects per query head; the group-pooled variant drives the
shared-sparsity block-sparse kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.config import GateConfig
from repro_torch.core.sparsity import select_blocks
from repro_torch.models.common import NEG_INF


class QuestMeta(NamedTuple):
    kmin: torch.Tensor      # [B, nb_max, Hkv, Dh]
    kmax: torch.Tensor      # [B, nb_max, Hkv, Dh]
    n_blocks: torch.Tensor  # [B]


def _masked_minmax(kb: torch.Tensor, valid: torch.Tensor, dim: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 min/max over ``dim`` with invalid tokens excluded; a block
    with no valid token collapses to 0."""
    kmin = torch.amin(torch.where(valid, kb, torch.inf), dim=dim)
    kmax = torch.amax(torch.where(valid, kb, -torch.inf), dim=dim)
    kmin = torch.where(torch.isfinite(kmin), kmin, 0.0)
    kmax = torch.where(torch.isfinite(kmax), kmax, 0.0)
    return kmin, kmax


def build_quest_meta(k_cache: torch.Tensor, kv_len: torch.Tensor,
                     block_size: int) -> QuestMeta:
    """Seq-major K cache [B, S, Hkv, Dh] -> per-block min/max. A
    non-block-aligned cache is floored to whole blocks, and ``n_blocks``
    is clamped to the stored row count (a ceil of ``kv_len == S`` would
    point past the metadata)."""
    b, s, hkv, dh = k_cache.shape
    nb = s // block_size
    s = nb * block_size
    kb = k_cache[:, :s].reshape(b, nb, block_size, hkv, dh).to(torch.float32)
    pos = torch.arange(s, device=k_cache.device).reshape(nb, block_size)
    valid = pos[None, :, :, None, None] < kv_len[:, None, None, None, None]
    kmin, kmax = _masked_minmax(kb, valid, 2)
    return QuestMeta(kmin, kmax, torch.clamp_max(-(-kv_len // block_size), nb))


def quest_scores(q: torch.Tensor, meta: QuestMeta, *, share_group: bool
                 ) -> torch.Tensor:
    """q [B, 1, H, Dh] -> upper-bound scores: [B, H, nb] per query head, or
    [B, Hkv, nb] max-pooled over each GQA group (``share_group``)."""
    b, _, h, dh = q.shape
    hkv = meta.kmin.shape[2]
    g = h // hkv
    qf = q[:, 0].reshape(b, hkv, g, dh).to(torch.float32)
    ub = (torch.einsum("bhgd,bnhd->bhgn", torch.clamp_min(qf, 0), meta.kmax)
          + torch.einsum("bhgd,bnhd->bhgn", torch.clamp_max(qf, 0), meta.kmin))
    nb = ub.shape[-1]
    valid = (torch.arange(nb, device=q.device)[None, None, None, :]
             < meta.n_blocks[:, None, None, None])
    ub = torch.where(valid, ub, NEG_INF)
    if share_group:
        return torch.amax(ub, dim=2)
    return ub.reshape(b, h, nb)


def quest_select(q: torch.Tensor, meta: QuestMeta, cfg: GateConfig,
                 max_selected=None, share_group: bool = True):
    scores = quest_scores(q, meta, share_group=share_group)
    return select_blocks(scores, meta.n_blocks, cfg, max_selected)


# ---------------------------------------------------------------------------
# head-major decode path (core.policy.QuestPolicy)
# ---------------------------------------------------------------------------

def quest_meta_decode(k_cache: torch.Tensor, kv_len: torch.Tensor,
                      block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block key min/max off the HEAD-MAJOR decode cache [B, Hkv, S,
    Dh] (contiguous cache or paged gather) -> (kmin, kmax) [B, Hkv, nb,
    Dh] fp32, tokens at or past ``kv_len`` excluded; S floored to whole
    blocks."""
    b, hkv, s, dh = k_cache.shape
    nb = s // block_size
    s = nb * block_size
    kb = k_cache[:, :, :s].reshape(b, hkv, nb, block_size, dh).to(torch.float32)
    pos = torch.arange(s, device=k_cache.device).reshape(nb, block_size)
    valid = pos[None, None, :, :, None] < kv_len[:, None, None, None, None]
    return _masked_minmax(kb, valid, 3)


def quest_scores_grouped(qgrp: torch.Tensor, kmin: torch.Tensor,
                         kmax: torch.Tensor, n_blocks: torch.Tensor
                         ) -> torch.Tensor:
    """GQA-group-shared Quest upper bounds, head-major: qgrp [B, Hkv, g,
    Dh] (post-rope) and kmin/kmax [B, Hkv, nb, Dh] -> [B, Hkv, nb],
    max-pooled over each group, NEG_INF on invisible blocks."""
    qf = qgrp.to(torch.float32)
    ub = (torch.einsum("bhgd,bhnd->bhgn", torch.clamp_min(qf, 0), kmax)
          + torch.einsum("bhgd,bhnd->bhgn", torch.clamp_max(qf, 0), kmin))
    ub = torch.amax(ub, dim=2)
    nb = ub.shape[-1]
    valid = torch.arange(nb, device=ub.device)[None, None, :] < n_blocks[:, None, None]
    return torch.where(valid, ub, NEG_INF)
