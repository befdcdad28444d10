"""K Compression Cache (paper §3.2), PyTorch port.

Stores the gate's compressed key representation Kg (post pool + linear +
RoPE) so the K branch never recomputes past blocks. Updated once every
``block_size`` generated tokens; while the trailing block is partial, its
cache entry is stale and selection force-selects the last block.

The reference returns a new cache each step (JAX arrays are immutable and
the decode state is donated); the port writes the one block-sized Kg row
IN PLACE into the caller's cache tensor and returns the new counts.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.config import GateConfig
from repro_torch.core.attngate import gate_k
from repro_torch.models.common import apply_rope


class KCompressionCache(NamedTuple):
    kg: torch.Tensor            # [B, Hkv, nb_max, Dg]  (HEAD-MAJOR)
    n_complete: torch.Tensor    # [B] int32: number of finalized block entries


def finalize_block_kg(gate_params: Dict[str, Any], blk: torch.Tensor,
                      start_pos: torch.Tensor, block_index: torch.Tensor,
                      cfg: GateConfig, *, is_roped: bool,
                      rope_theta: float = 10000.0) -> torch.Tensor:
    """COMPLETE blocks of keys, one per row, [B, block_size, Hkv, Dh]
    (seq-major) -> Kg rows [B, Hkv, Dg]. ``start_pos`` and ``block_index``
    are [B] tensors (the reference's per-row vmap, written out as a batch).

    When ``is_roped`` the stored keys are rotated back to the pre-rope
    frame first (RoPE is an orthogonal rotation: inversion = apply with
    negated positions), so no second pre-rope K cache is kept.
    """
    if is_roped:
        ar = torch.arange(blk.shape[1], device=blk.device)
        pos = -(start_pos[:, None] + ar[None, :])                  # [B, bs]
        blk = apply_rope(blk, pos, rope_theta)
    return gate_k(gate_params, blk, cfg, first_block_index=block_index)[:, 0]


def update_kcache(cache: KCompressionCache, gate_params: Dict[str, Any],
                  k_cache_raw: torch.Tensor, cur_len: torch.Tensor,
                  cfg: GateConfig, *, cache_is_roped: bool = False,
                  rope_theta: float = 10000.0) -> KCompressionCache:
    """Decode-time incremental update, in place on ``cache.kg``.

    k_cache_raw: [B, Hkv, S_max, Dh] HEAD-MAJOR key cache (post-RoPE when
    ``cache_is_roped``). cur_len: [B] sequence length *after* appending the
    newest token. When ``cur_len`` crosses a block boundary, the
    just-completed block is pooled+projected and written at slot
    ``cur_len // block_size - 1``; other rows rewrite their current entry
    unchanged. Only ONE block-sized slice of the cache is read per row.
    """
    bs = cfg.block_size
    # cur_len == 0 (an empty slot) must NOT count as a completed block
    completed = ((cur_len % bs) == 0) & (cur_len > 0)       # [B] bool
    blk_idx = torch.clamp_min(cur_len // bs - 1, 0)         # [B]
    start = blk_idx * bs
    rows = torch.arange(cur_len.shape[0], device=cur_len.device)
    tok = start[:, None] + torch.arange(bs, device=cur_len.device)[None, :]
    # advanced indices on dims 0 and 2 around the head slice: [B, bs, Hkv, Dh]
    blk = k_cache_raw[rows[:, None], :, tok]
    kg_new = finalize_block_kg(gate_params, blk, start, blk_idx, cfg,
                               is_roped=cache_is_roped, rope_theta=rope_theta)
    cur = cache.kg[rows, :, blk_idx]                        # [B, Hkv, Dg]
    cache.kg[rows, :, blk_idx] = torch.where(
        completed[:, None, None], kg_new.to(cache.kg.dtype), cur)
    new_n = torch.where(completed, blk_idx + 1, cache.n_complete)
    return KCompressionCache(cache.kg, new_n.to(torch.int32))


def visible_blocks(cur_len: torch.Tensor, block_size: int) -> torch.Tensor:
    """Number of selectable blocks = ceil(cur_len / block_size); the last one
    may be partial (stale cache entry) and is force-selected upstream."""
    return -(-cur_len // block_size)
