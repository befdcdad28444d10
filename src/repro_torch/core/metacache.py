"""Selection-metadata cache: incremental per-block key min/max, PyTorch port.

Port of the JAX package's ``core/metacache.py``. The metadata twin of the Kg cache
(``core.kcache``): prefill bulk-builds it, decode pays an O(block_size)
update only when ``cur_len`` crosses a block boundary, and the trailing
PARTIAL block is overlaid on the fly from its one block-sized slice of
the K cache. So ``QuestPolicy`` never reads the whole cache per step.

Layout (head-major, the decode-path invariant):
  kmin / kmax   [B, Hkv, nb_max, Dh]  float32
  n_complete    [B] int32             finalized entries per row

Every reduction is ``_block_minmax``: the same fp32 inf-masked min/max as
``core.quest.quest_meta_decode``, so finalized entries are bitwise equal
to the recompute reference's (min and max are exact whatever the order).
Entries at slots ``>= n_complete`` are stale; ``cur_len == 0`` rows
(empty decode slots) never finalize anything.

The reference returns new arrays; ``update_metacache`` writes the one
block row IN PLACE into the caller's tensors and returns the new counts.
The paged twin lives in ``serve.paging`` (``kmin_pages``/``kmax_pages``).

``BlockHeat`` is the host-side recency/mass twin that the page-eviction
victim model reads (``serve.eviction``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quest import _masked_minmax, quest_meta_decode


class SelectionMetaCache(NamedTuple):
    kmin: torch.Tensor          # [B, Hkv, nb_max, Dh] float32 (head-major)
    kmax: torch.Tensor          # [B, Hkv, nb_max, Dh] float32
    n_complete: torch.Tensor    # [B] int32: finalized block entries


def init_metacache(batch: int, max_blocks: int, n_kv_heads: int,
                   head_dim: int, *, device=None) -> SelectionMetaCache:
    shape = (batch, n_kv_heads, max_blocks, head_dim)
    return SelectionMetaCache(
        kmin=torch.zeros(shape, dtype=torch.float32, device=device),
        kmax=torch.zeros(shape, dtype=torch.float32, device=device),
        n_complete=torch.zeros((batch,), dtype=torch.int32, device=device))


def _block_minmax(blk: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min/max over one block's seq axis, out-of-range tokens masked:
    blk [..., bs, Dh]; valid [..., bs, 1] bool."""
    return _masked_minmax(blk.to(torch.float32), valid, -2)


def prefill_metacache(cache: SelectionMetaCache, k_cache: torch.Tensor,
                      kv_len: torch.Tensor, block_size: int
                      ) -> SelectionMetaCache:
    """Bulk-populate, in place, from a prefilled head-major K cache [B,
    Hkv, S, Dh]: all ``S // block_size`` entries are written (tokens past
    ``kv_len`` masked, so a trailing partial entry is exact for this
    length and goes stale on the first decode step); ``n_complete``
    counts the full blocks only."""
    kmin, kmax = quest_meta_decode(k_cache, kv_len, block_size)
    nb = kmin.shape[2]
    cache.kmin[:, :, :nb] = kmin
    cache.kmax[:, :, :nb] = kmax
    return SelectionMetaCache(cache.kmin, cache.kmax,
                              (kv_len // block_size).to(torch.int32))


def update_metacache(cache: SelectionMetaCache, k_cache: torch.Tensor,
                     cur_len: torch.Tensor, block_size: int
                     ) -> SelectionMetaCache:
    """Decode-time incremental update, O(block_size) per row, in place.

    k_cache [B, Hkv, S_max, Dh] head-major post-rope keys; cur_len [B] the
    length AFTER the newest token. A row that crosses a block boundary
    finalizes the just-completed block at ``cur_len // bs - 1``; the other
    rows write their current entry back unchanged."""
    bs = block_size
    completed = ((cur_len % bs) == 0) & (cur_len > 0)       # [B] bool
    blk_idx = torch.clamp_min(cur_len // bs - 1, 0)         # [B]
    rows = torch.arange(cur_len.shape[0], device=cur_len.device)
    tok = (blk_idx * bs)[:, None] + torch.arange(bs, device=cur_len.device)[None, :]
    blk = k_cache[rows[:, None], :, tok].transpose(1, 2)    # [B, Hkv, bs, Dh]
    ones = torch.ones((1, 1, bs, 1), dtype=torch.bool, device=blk.device)
    mn_new, mx_new = _block_minmax(blk, ones)               # [B, Hkv, Dh]
    wm = completed[:, None, None]
    for pool, new in ((cache.kmin, mn_new), (cache.kmax, mx_new)):
        pool[rows, :, blk_idx] = torch.where(wm, new, pool[rows, :, blk_idx])
    new_n = torch.where(completed, blk_idx + 1, cache.n_complete)
    return SelectionMetaCache(cache.kmin, cache.kmax, new_n.to(torch.int32))


def trailing_meta(k_cache: torch.Tensor, cur_len: torch.Tensor,
                  block_size: int) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Min/max of each row's TRAILING (possibly partial) block, read from
    its one block-sized slice: (tmin [B, Hkv, Dh], tmax, t_idx [B])."""
    bs = block_size
    t_idx = torch.clamp_min(-(-cur_len // bs) - 1, 0)       # [B]
    start = t_idx * bs
    rem = cur_len - start                                   # tokens in block
    rows = torch.arange(cur_len.shape[0], device=cur_len.device)
    ar = torch.arange(bs, device=cur_len.device)
    # the reference's dynamic_slice clamps the start into the cache
    st = torch.clamp_max(start, k_cache.shape[2] - bs)
    blk = k_cache[rows[:, None], :, st[:, None] + ar[None, :]].transpose(1, 2)
    valid = (ar[None, :] < rem[:, None])[:, None, :, None]  # [B, 1, bs, 1]
    tmin, tmax = _block_minmax(blk, valid)
    return tmin, tmax, t_idx


def trailing_meta_paged(k_pages: torch.Tensor, page_table: torch.Tensor,
                        cur_len: torch.Tensor, page_size: int,
                        k_scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged twin of ``trailing_meta``: ONE physical page per slot.

    k_pages [P, Hkv, ps, Dh]; page_table [S, npt]; cur_len [S]. Rows with
    ``cur_len == 0`` read their first table entry (the null page for an
    empty slot). ``k_scale`` [P, Hkv, 1] (int8 pools) dequantizes the page
    first, under the scale row the latest append wrote."""
    from repro_torch.serve.paging import dequantize_block   # paging imports this module
    ps = page_size
    sidx = torch.arange(cur_len.shape[0], device=cur_len.device)
    t_idx = torch.clamp_min(-(-cur_len // ps) - 1, 0)       # [S] logical
    phys = page_table[sidx, t_idx].long()
    rem = cur_len - t_idx * ps
    blk = k_pages[phys]                                     # [S, Hkv, ps, Dh]
    if k_scale is not None:
        blk = dequantize_block(blk, k_scale[phys])
    ar = torch.arange(ps, device=cur_len.device)
    valid = (ar[None, :] < rem[:, None])[:, None, :, None]
    tmin, tmax = _block_minmax(blk, valid)
    return tmin, tmax, t_idx


class BlockHeat:
    """Host-side recency/mass twin of the selection metadata.

    RaaS-style (arXiv 2502.11147) retention signal for the page-eviction
    victim model: per (slot, logical block), the step of the LAST time any
    head selected the block (``last_touch``) and an exponential moving
    average of its selection mass (``ema`` — how often the block keeps
    being re-touched). Updated once per COMMITTED decode step from the
    touched-pages telemetry the step emits; replayed (discarded) attempts
    are never observed, so the signal matches what the request actually
    attended to. Plain numpy, as in the reference: the victim model runs
    on the host between steps, like the scheduler."""

    def __init__(self, n_slots: int, n_blocks: int, decay: float = 0.8):
        self.decay = float(decay)
        self.step = 0
        self.last_touch = np.full((n_slots, n_blocks), -1, np.int64)
        self.ema = np.zeros((n_slots, n_blocks), np.float32)

    def observe(self, touched: np.ndarray, active: np.ndarray) -> None:
        """touched [n_slots, n_blocks] bool (any layer, any head selected
        the block this step); active [n_slots] bool."""
        self.step += 1
        t = touched & active[:, None]
        self.ema[active] *= self.decay
        self.ema[t] += 1.0
        self.last_touch[t] = self.step

    def reset_row(self, slot: int) -> None:
        """A slot changed tenants (admission/retire/preempt): heat from
        the previous request must not bias the new one's victim model."""
        self.last_touch[slot] = -1
        self.ema[slot] = 0.0


def overlay_trailing(kmin: torch.Tensor, kmax: torch.Tensor,
                     tmin: torch.Tensor, tmax: torch.Tensor,
                     t_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splice the per-step trailing min/max into the cached view (new
    metadata-sized tensors; the cache is untouched). When the trailing
    block is complete the overlay equals its finalized entry, so overlaying
    unconditionally is bitwise safe."""
    nb = kmin.shape[2]
    at_t = (torch.arange(nb, device=kmin.device)[None, None, :, None]
            == t_idx[:, None, None, None])                  # [B,1,nb,1]
    return (torch.where(at_t, tmin[:, :, None, :], kmin),
            torch.where(at_t, tmax[:, :, None, :], kmax))
