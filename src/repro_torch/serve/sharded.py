"""Sequence-sharded decoding over ``torch.distributed`` (port of
``serve/sharded.py``'s ``sharded_sparse_decode``).

One layer of one contiguous ``generate`` step on a ``DecodeEngine`` with a
``distributed.sharding.Shard``: the caches are split along the SEQUENCE,
rank r holding tokens ``[r*S/w, (r+1)*S/w)`` and their Kg blocks. Each
rank scores its local blocks and keeps a local top-c candidate list; the
budget's global top-k is resolved by one all-gather of candidate scores
(the threshold method by an all-reduce of the softmax max and sum); each
rank attends its own selected blocks, and the partials merge with the
two-pass flash-decoding combine (all-reduce max of m, then sum of l, then
sum of o). Only the owning rank writes the new token's K/V and a
completed block's Kg row. The combine reorders the softmax sum, so this
path agrees with the unsharded one to fp32 rounding, not bits.

The head-sharded paged step of ``serve`` needs no body of its own: it is
``models.attn_core.attention_decode_paged`` on the rank's KV heads.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.config import GateConfig
from repro_torch.core import kcache as kc
from repro_torch.core import sparsity as sp
from repro_torch.distributed.sharding import Shard
from repro_torch.models.common import NEG_INF


def sharded_sparse_decode(qg: torch.Tensor, qr: torch.Tensor, kr_new: torch.Tensor,
                          v_new: torch.Tensor, k_loc: torch.Tensor, v_loc: torch.Tensor,
                          kg_loc: torch.Tensor, cur_len: torch.Tensor,
                          gate_wk: torch.Tensor, *, shard: Shard, cfg: GateConfig,
                          rope_theta: float, max_selected: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence-sharded decode step for ONE layer.

    qg [B, Hkv, Dg] gate query, qr [B, Hkv, G, Dh] attention query,
    kr_new/v_new [B, Hkv, Dh] the new token's key (post-rope) and value,
    all replicated; k_loc/v_loc [B, Hkv, S/w, Dh] and kg_loc [B, Hkv,
    nb/w, Dg] this rank's part of the head-major caches (updated in place);
    cur_len [B] the length BEFORE this token; gate_wk [Hkv, 3Dh, Dg].
    Returns (o [B, Hkv, G, Dh] in qr's dtype, n_sel [B, Hkv] int32: the
    selected blocks summed over ranks, for measured sparsity)."""
    b, hkv, s_loc, dh = k_loc.shape
    nb_loc = kg_loc.shape[2]
    bs = cfg.block_size
    nsh = shard.world
    dev = k_loc.device
    k_budget = sp.resolve_max_selected(cfg, max_selected)
    cap = max(1, min(int(math.ceil(k_budget / nsh * cfg.local_cap_factor)), s_loc // bs))
    tok0, blk0 = shard.rank * s_loc, shard.rank * nb_loc
    new_len = cur_len + 1
    bidx = torch.arange(b, device=dev)

    # 1) the new token's K/V, written by the owning rank only
    own_tok = (cur_len >= tok0) & (cur_len < tok0 + s_loc)
    lpos = torch.clamp(cur_len - tok0, 0, s_loc - 1).long()
    for cache, new in ((k_loc, kr_new), (v_loc, v_new)):
        cache[bidx, :, lpos] = torch.where(own_tok[:, None, None], new.to(cache.dtype),
                                           cache[bidx, :, lpos])

    # 2) the Kg row of a block the token completes, by the owning rank
    completed = (new_len % bs) == 0
    gblk = torch.clamp_min(new_len // bs - 1, 0)
    own_blk = (gblk >= blk0) & (gblk < blk0 + nb_loc) & completed
    lblk = torch.clamp(gblk - blk0, 0, nb_loc - 1).long()
    tok = (lblk * bs)[:, None] + torch.arange(bs, device=dev)[None, :]
    blk = k_loc[bidx[:, None], :, tok]                            # [B, bs, Hkv, Dh]
    kg_new = kc.finalize_block_kg({"wk": gate_wk}, blk, tok0 + lblk * bs, gblk, cfg,
                                  is_roped=True, rope_theta=rope_theta)
    kg_loc[bidx, :, lblk] = torch.where(own_blk[:, None, None], kg_new.to(kg_loc.dtype),
                                        kg_loc[bidx, :, lblk])

    # 3-4) the rank's selected blocks: local candidates, global top-k
    cand_i, mine = sharded_select(qg, kg_loc, new_len, shard=shard, cfg=cfg,
                                  k_budget=k_budget, cap=cap)
    c = cand_i.shape[-1]

    # 5) block-sparse attention over this rank's selected blocks
    pos_l = cand_i[..., None] * bs + torch.arange(bs, device=dev)  # [B, Hkv, c, bs]
    gpos = pos_l.reshape(b, hkv, c * bs, 1).expand(-1, -1, -1, dh)
    kg_ = torch.gather(k_loc, 2, gpos).to(torch.float32)
    vg_ = torch.gather(v_loc, 2, gpos).to(torch.float32)
    sc = torch.einsum("bhgd,bhkd->bhgk", qr.to(torch.float32), kg_) * (1.0 / math.sqrt(dh))
    tok_valid = (tok0 + pos_l) < new_len[:, None, None, None]
    valid = (mine[..., None] & tok_valid).reshape(b, hkv, 1, c * bs)
    sc = torch.where(valid, sc, NEG_INF)

    # 6) the two-pass combine: the global max first, then every rank
    # normalises by the global mass before its P.V
    m = shard.all_max(torch.amax(sc, dim=-1, keepdim=True))
    p = torch.where(valid, torch.exp(sc - m), 0.0)
    l = shard.all_sum(torch.sum(p, dim=-1, keepdim=True))
    o = shard.all_sum(torch.einsum("bhgk,bhkd->bhgd", p / torch.clamp_min(l, 1e-30), vg_))
    n_sel = shard.all_sum(torch.sum(mine.to(torch.int32), dim=-1))
    return o.to(qr.dtype), n_sel


def sharded_select(qg: torch.Tensor, kg_loc: torch.Tensor, new_len: torch.Tensor, *,
                   shard: Shard, cfg: GateConfig, k_budget: int, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate's selection over the sequence-sharded Kg cache: this rank's
    local top-c candidates (``cap`` of them at most; forced first and last
    blocks scored 1e30) and which of them the global selection keeps:
    (candidate ids [B, Hkv, c] within the rank's blocks, kept mask [B, Hkv,
    c]). The budget's global top-k is one all-gather of every rank's
    candidate scores; the threshold method reduces the softmax max and
    sum over ranks instead. Rank r's block i is global block ``r * nb/w +
    i``."""
    b, hkv, nb_loc, dg = kg_loc.shape
    dev = kg_loc.device
    nsh = shard.world
    blk0 = shard.rank * nb_loc
    bs = cfg.block_size
    gid = blk0 + torch.arange(nb_loc, device=dev)                 # global block ids
    n_valid = -(-new_len // bs)
    s_gate = torch.einsum("bhd,bhnd->bhn", qg.to(torch.float32),
                          kg_loc.to(torch.float32)) / math.sqrt(dg)
    vis = gid[None, None, :] < n_valid[:, None, None]
    s_raw = torch.where(vis, s_gate, NEG_INF)                     # unforced scores
    s_gate = s_raw
    if cfg.always_last_block:
        s_gate = torch.where(gid[None, None, :] == (n_valid - 1)[:, None, None], 1e30,
                             s_gate)
    if cfg.always_first_block:
        s_gate = torch.where(gid[None, None, :] == 0, 1e30, s_gate)
    c = min(cap, nb_loc)
    cand_v, cand_i = sp.ranked_top_k(s_gate, c)                   # [B, Hkv, c] local

    if cfg.method == "threshold":
        # the softmax threshold over the UNFORCED scores of all ranks;
        # forced candidates pass unconditionally
        gm = shard.all_max(torch.amax(s_raw, dim=-1, keepdim=True))
        gl = shard.all_sum(torch.sum(torch.where(vis, torch.exp(s_raw - gm), 0.0),
                                     dim=-1, keepdim=True))
        cand_raw = torch.gather(s_raw, -1, cand_i)
        probs = torch.exp(cand_raw - gm) / torch.clamp_min(gl, 1e-30)
        mine = ((probs > cfg.threshold) | (cand_v > 1e29)) & (cand_raw > NEG_INF / 2)
    else:
        # exact global top-k: every rank's candidates, one gather
        allv = shard.all_gather(cand_v[None], axis=0)             # [w, B, Hkv, c]
        allv = allv.movedim(0, -2).reshape(b, hkv, nsh * c)
        thr = sp.ranked_top_k(allv, min(k_budget, nsh * c))[0][..., -1:]
        mine = (cand_v >= thr) & (cand_v > NEG_INF / 2)
    return cand_i, mine
