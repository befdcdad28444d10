"""Oracle block-sparse selection (paper §4.2), PyTorch port.

Port of the JAX package's ``core/oracle.py``: the true block row-max
attention scores of the decode query select the blocks, the accuracy
ceiling of any gate ("compute attention twice": a dense score pass ranks,
a block-sparse pass attends).
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import GateConfig
from repro_torch.core.sparsity import select_blocks
from repro_torch.models.common import NEG_INF


def _block_group_max(s: torch.Tensor, kv_len: torch.Tensor, nb: int,
                     block_size: int) -> torch.Tensor:
    """Scores [B, Hkv, g, S] -> [B, Hkv, nb]: positions at or past kv_len
    masked, then the max over each block and over the group."""
    b, hkv, g, s_max = s.shape
    valid = torch.arange(s_max, device=s.device)[None, :] < kv_len[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    s = torch.amax(s.reshape(b, hkv, g, nb, block_size), dim=-1)
    return torch.amax(s, dim=2)


def oracle_scores_decode(q: torch.Tensor, k_cache: torch.Tensor,
                         kv_len: torch.Tensor, block_size: int) -> torch.Tensor:
    """True block scores for one decode step, shared per GQA group: q [B,
    1, H, Dh] and k_cache [B, S, Hkv, Dh] (post-rope, seq-major) -> [B,
    Hkv, nb] block row-max logits, NEG_INF on invisible blocks."""
    b, _, h, dh = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    nb = s_max // block_size
    qg = q[:, 0].reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) / math.sqrt(dh)
    return _block_group_max(s, kv_len, nb, block_size)


def oracle_select(q, k_cache, kv_len, cfg: GateConfig, max_selected=None):
    scores = oracle_scores_decode(q, k_cache, kv_len, cfg.block_size)
    n_valid = -(-kv_len // cfg.block_size)
    return select_blocks(scores, n_valid, cfg, max_selected)


def oracle_scores_headmajor(qgrp: torch.Tensor, k_cache: torch.Tensor,
                            kv_len: torch.Tensor, block_size: int) -> torch.Tensor:
    """Head-major twin for the decode path (``core.policy.OraclePolicy``):
    qgrp [B, Hkv, g, Dh] post-rope regrouped queries, k_cache [B, Hkv, S,
    Dh] (contiguous cache or paged gather) -> [B, Hkv, nb]; S floored to
    whole blocks, as the gate's Kg cache is."""
    dh = qgrp.shape[-1]
    nb = k_cache.shape[2] // block_size
    s_max = nb * block_size
    s = torch.einsum("bhgd,bhsd->bhgs", qgrp.to(torch.float32),
                     k_cache[:, :, :s_max].to(torch.float32)) / math.sqrt(dh)
    return _block_group_max(s, kv_len, nb, block_size)
