"""Paged KV cache for continuous-batching sparse decode, PyTorch port.

Port of the JAX package's ``serve/paging.py``. Storage is
a global pool of fixed-size pages shared by every sequence in flight; a
per-slot page table maps logical KV block ids to physical pages. The page
size EQUALS the gate block size: one page == one gate block, so the
K-compression cache pages alongside the raw KV (``kg_pages`` holds one
row per physical page). The gate still emits LOGICAL block ids; the
logical -> physical translation happens inside the paged kernels (or in
the gathers of their plain versions).

Layout (``L`` = self-attn layers, ``P`` = pool pages, ``ps`` = page size;
head-major, consumed natively by decode):
  k_pages / v_pages  [L, P, Hkv, ps, Dh]   post-rope keys / values
  kg_pages           [L, P+G, Hkv, Dg]     gate K-compression twin
  kmin/kmax_pages    [L, P+G, Hkv, Dh] f32 selection-metadata twin (Quest;
                                           metadata-reading policies only)
  k/v_scale_pages    [L, P, Hkv, 1]  f32   per-page per-head dequant scales
                                           (int8 pools only)
  page_table         [n_slots, npt] int32  physical ids; NULL_PAGE = empty;
                                           ids >= P are eviction ghost rows
(``G`` = the eviction ghost rows, 0 without eviction; ``init_pages``).

Quantized pools (``init_pages(..., quantize="int8")``): K/V pages hold
symmetric int8 (value = int8 * scale, scale = abs-max/127 per page per KV
head over the page's valid rows). A scale row is zeroed on lazy growth,
rewritten on every append to the trailing page (which is requantized
whole) and frozen once the page completes. Dequant happens inside the
decode kernels' block loop (or on the gathered blocks of their plain
versions), so no fp copy of a cache-sized array is built; swap moves the
int8 bytes plus the scale rows. ``quantize=None`` keeps the fp pools and
the fp code path.

Physical page 0 is the null/trash page: unallocated table entries point
at it and writes of inactive slots are routed there. Several slots may
write page 0 in one scatter, and a scatter with duplicate indices leaves
an unspecified winner, so page 0 holds no data anyone reads: its Kg rows
sit past every slot's visible-block cut and its K/V rows are never
selected. The allocator never hands it out.

The reference is functional (it returns new pools and donates the old
ones); here every helper updates the pool tensors IN PLACE and returns
nothing, except ``extract_pages``, which returns host copies. Staleness
contract (as in ``core.kcache``): a page's ``kg_pages`` row (and its
``kmin_pages``/``kmax_pages`` rows) is valid only once the page is FULL; a
partial trailing page keeps a ZERO row.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config import GateConfig, ModelConfig
from repro_torch.core.kcache import finalize_block_kg
from repro_torch.core.metacache import _block_minmax
from repro_torch.device import resolve_device
from repro_torch.models.common import torch_dtype

NULL_PAGE = 0


class PagedPages(NamedTuple):
    """Device-side page pools, stacked over self-attention layers, in the
    reference's field order. ``kmin_pages``/``kmax_pages`` are the paged
    twin of the selection-metadata cache (``core.metacache``): one f32
    min/max row per physical page, allocated only for a policy that reads
    them (QuestPolicy). ``k_scale_pages``/``v_scale_pages`` are the int8
    pools' dequant scales. Each is None where not allocated."""
    k_pages: torch.Tensor                 # [L, P, Hkv, ps, Dh]  (head-major)
    v_pages: torch.Tensor                 # [L, P, Hkv, ps, Dh]
    kg_pages: Optional[torch.Tensor]      # [L, P, Hkv, Dg]
    kmin_pages: Optional[torch.Tensor] = None      # [L, P, Hkv, Dh] float32
    kmax_pages: Optional[torch.Tensor] = None      # [L, P, Hkv, Dh] float32
    k_scale_pages: Optional[torch.Tensor] = None   # [L, P, Hkv, 1] float32
    v_scale_pages: Optional[torch.Tensor] = None   # [L, P, Hkv, 1] float32


INT8_MAX = 127.0


def quantize_block(x: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(page, head) int8 quantization of fp page contents.

    x [..., ps, Dh]; ``valid`` bool, broadcastable against x, marks the
    rows that hold real tokens (a recycled page carries its previous
    tenant's rows, which must not inflate the scale). Returns (int8 page,
    f32 scale [..., 1]): scale = abs-max/127 over the valid region, 1.0 for
    an all-zero or empty region. The abs-max is multiplied by the f32
    reciprocal of 127, which is what XLA compiles the reference's
    ``amax / 127.0`` to inside its jitted pool updates; the page is then
    DIVIDED by the scale (a traced divisor stays a division there) and
    rounded half to even, as ``jnp.round`` does. So identical fp32 inputs
    give the reference's serving-path codes and scales bit for bit."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.where(valid, xf.abs(), 0.0), dim=(-2, -1))
    scale = torch.where(amax > 0, amax * (1.0 / INT8_MAX), 1.0)[..., None]
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_block(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 page [..., ps, Dh] x scale [..., 1] -> f32 page."""
    return q.to(torch.float32) * scale[..., None]


def init_pages(cfg: ModelConfig, num_pages: int, n_layers: int,
               dtype: Optional[torch.dtype] = None, with_meta: bool = False,
               ghost_rows: int = 0, quantize: Optional[str] = None, *,
               device=None, kv_heads: Optional[int] = None) -> PagedPages:
    """Zeroed pools on ``device`` (``None`` = CUDA, which raises without a
    card). ``quantize="int8"`` allocates int8 K/V pools plus two distinct
    zeroed f32 scale pools [L, P, Hkv, 1]; the Kg pool stays in the working
    dtype, so selection does not depend on the value quantization.
    ``with_meta`` adds two distinct zeroed f32 min/max pools [L, P, Hkv,
    Dh] (they stay f32 under int8, so selection does not depend on the
    value quantization). ``kv_heads`` (default ``cfg.n_kv_heads``) sizes
    the head axis of every pool: a rank of the head-sharded path allocates
    only its heads.

    ``ghost_rows`` (RaaS eviction) extends ONLY the gate and metadata pools
    (Kg, kmin/kmax) by rows with ids in ``[num_pages, num_pages +
    ghost_rows)``: an evicted page's K/V leaves the card, its
    selection-side rows are parked in a ghost row and the page table is
    pointed there, so selection reads evicted blocks' scores and metadata
    through the table unchanged. The K/V and scale pools never grow (an
    evicted int8 page's scales ride its host ``PageEntry``): attention
    reads through a table clamped to the pool, and a step that selects an
    evicted block is caught by the touched-pages telemetry and replayed
    after a restore (``serve.eviction``)."""
    if ghost_rows < 0:
        raise ValueError(f"ghost_rows must be >= 0: {ghost_rows}")
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8': {quantize!r}")
    device = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    ps = cfg.gate.block_size
    hkv, dh = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    gate_rows = num_pages + ghost_rows
    kg = (torch.zeros((n_layers, gate_rows, hkv, cfg.gate.d_gate), dtype=dt,
                      device=device) if cfg.gate.enabled else None)
    kmin = kmax = None
    if with_meta:
        kmin, kmax = (torch.zeros((n_layers, gate_rows, hkv, dh), dtype=torch.float32,
                                  device=device) for _ in range(2))
    kv_dt, k_scale, v_scale = dt, None, None
    if quantize == "int8":
        kv_dt = torch.int8
        k_scale, v_scale = (torch.zeros((n_layers, num_pages, hkv, 1),
                                        dtype=torch.float32, device=device)
                            for _ in range(2))
    return PagedPages(
        k_pages=torch.zeros((n_layers, num_pages, hkv, ps, dh), dtype=kv_dt,
                            device=device),
        v_pages=torch.zeros((n_layers, num_pages, hkv, ps, dh), dtype=kv_dt,
                            device=device),
        kg_pages=kg, kmin_pages=kmin, kmax_pages=kmax, k_scale_pages=k_scale,
        v_scale_pages=v_scale)


def scatter_prefill(pages: PagedPages, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, kg_cache: Optional[torch.Tensor],
                    length: int, page_ids: torch.Tensor,
                    block_size: int, kmin_cache: Optional[torch.Tensor] = None,
                    kmax_cache: Optional[torch.Tensor] = None) -> None:
    """Copy one request's contiguous prefill caches into its pages.

    k_cache/v_cache: head-major [L, 1, Hkv, S_max, Dh] from ``lm_prefill``
    with S_max a whole number of pages; ``page_ids`` [n] the request's
    pages in logical order, padded with NULL_PAGE (``pad_page_ids``).
    Every listed page gets a cache page (rows past the cache repeat its
    last page: filler that ``kv_len`` masks). Every listed page's Kg row
    is zeroed except the ``length // block_size`` complete-block rows,
    which are copied from ``kg_cache`` [L, 1, Hkv, nb, Dg]; the metadata
    pools' rows follow the same rule from ``kmin_cache``/``kmax_cache``
    [L, 1, Hkv, nb, Dh] (a metacache-building prefill). Int8 pools
    quantize each page over its VALID token rows only (``tok < length``),
    so the filler past the prompt does not enter the scale.
    """
    n_ids = page_ids.shape[0]
    nl, _, hkv, s_max, dh = k_cache.shape
    n_cache = s_max // block_size
    dev = k_cache.device
    src = torch.clamp_max(torch.arange(n_ids, device=dev), n_cache - 1)

    def page_rows(cache):                # [L,1,Hkv,S,Dh] -> [L,n_ids,Hkv,ps,Dh]
        rows = cache[:, 0].reshape(nl, hkv, n_cache, block_size, dh)
        return rows.transpose(1, 2)[:, src]

    if pages.k_scale_pages is not None:
        tok = (torch.arange(n_ids, device=dev)[:, None] * block_size
               + torch.arange(block_size, device=dev)[None, :])   # [n_ids, ps]
        valid = (tok < length)[None, :, None, :, None]            # page axes
        for pool, scales, cache in ((pages.k_pages, pages.k_scale_pages, k_cache),
                                    (pages.v_pages, pages.v_scale_pages, v_cache)):
            q, sc = quantize_block(page_rows(cache), valid)
            pool[:, page_ids] = q
            scales[:, page_ids] = sc
    else:
        pages.k_pages[:, page_ids] = page_rows(k_cache).to(pages.k_pages.dtype)
        pages.v_pages[:, page_ids] = page_rows(v_cache).to(pages.v_pages.dtype)
    def row_scatter(pool, rows_cache):
        """Zero every listed page's row, then copy the complete-block rows
        from the head-major contiguous cache [L, 1, Hkv, nb, *]."""
        new = torch.zeros((nl, n_ids) + tuple(pool.shape[2:]), dtype=pool.dtype,
                          device=dev)
        if rows_cache is not None:
            nb = rows_cache.shape[3]
            srcr = torch.clamp_max(torch.arange(n_ids, device=dev), nb - 1)
            rows = rows_cache[:, 0].transpose(1, 2)[:, srcr]   # [L,n_ids,Hkv,*]
            keep = torch.arange(n_ids, device=dev) < length // block_size
            new = torch.where(keep[None, :, None, None], rows.to(pool.dtype), new)
        pool[:, page_ids] = new

    if pages.kg_pages is not None:
        row_scatter(pages.kg_pages, kg_cache)
    if pages.kmin_pages is not None:
        row_scatter(pages.kmin_pages, kmin_cache)
        row_scatter(pages.kmax_pages, kmax_cache)


def append_token_paged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       kg_pages: Optional[torch.Tensor],
                       kr_new: torch.Tensor, v_new: torch.Tensor,
                       page_table: torch.Tensor, cur_len: torch.Tensor,
                       active: torch.Tensor, gate_params: Optional[Dict],
                       cfg: GateConfig, *, rope_theta: float = 10000.0) -> None:
    """ONE layer's paged twin of the contiguous write + ``update_kcache``.

    kr_new/v_new: [S, Hkv, Dh] the new token's post-rope K / V per slot.
    Writes land at (page_table[slot, cur_len // ps], :, cur_len % ps);
    rows with ``active == False`` go to the null page. Then, when gate
    parameters are given, the Kg row of each just-completed page is
    finalized (``finalize_kg_paged``)."""
    ps = cfg.block_size
    sidx = torch.arange(cur_len.shape[0], device=cur_len.device)
    logical = (cur_len // ps).long()
    off = (cur_len % ps).long()
    phys = torch.where(active, page_table[sidx, logical], NULL_PAGE).long()
    k_pages[phys, :, off] = kr_new.to(k_pages.dtype)
    v_pages[phys, :, off] = v_new.to(v_pages.dtype)
    if kg_pages is None or gate_params is None:
        return
    finalize_kg_paged(k_pages, kg_pages, page_table, cur_len, active,
                      gate_params, cfg, rope_theta=rope_theta)


def append_token_paged_quant(k_pages: torch.Tensor, v_pages: torch.Tensor,
                             kg_pages: Optional[torch.Tensor],
                             k_scale: torch.Tensor, v_scale: torch.Tensor,
                             kr_new: torch.Tensor, v_new: torch.Tensor,
                             page_table: torch.Tensor, cur_len: torch.Tensor,
                             active: torch.Tensor, gate_params: Optional[Dict],
                             cfg: GateConfig, *,
                             rope_theta: float = 10000.0) -> None:
    """Int8 twin of ``append_token_paged``, in place.

    Each slot's trailing page is REQUANTIZED: dequantized with its scale
    row, the new fp row inserted at ``cur_len % ps``, quantized again over
    the rows ``<= off``, and written back with its new scale row. Only
    that one page per slot changes; completed pages stay frozen. Inactive
    slots write to the null page. The Kg row of a just-completed page is
    finalized from the DEQUANTIZED keys, which attention will read."""
    ps = cfg.block_size
    sidx = torch.arange(cur_len.shape[0], device=cur_len.device)
    logical = (cur_len // ps).long()
    off = (cur_len % ps).long()
    phys = torch.where(active, page_table[sidx, logical], NULL_PAGE).long()
    rows = torch.arange(ps, device=cur_len.device)[None, :]
    onehot = (rows == off[:, None])[:, None, :, None]        # [S,1,ps,1]
    valid = (rows <= off[:, None])[:, None, :, None]         # [S,1,ps,1]
    for pool, scales, new in ((k_pages, k_scale, kr_new), (v_pages, v_scale, v_new)):
        page = dequantize_block(pool[phys], scales[phys])
        page = torch.where(onehot, new.to(torch.float32)[:, :, None, :], page)
        q, sc = quantize_block(page, valid)
        pool[phys] = q
        scales[phys] = sc
    if kg_pages is None or gate_params is None:
        return
    finalize_kg_paged(k_pages, kg_pages, page_table, cur_len, active,
                      gate_params, cfg, rope_theta=rope_theta, k_scale=k_scale)


def finalize_kg_paged(k_pages: torch.Tensor, kg_pages: torch.Tensor,
                      page_table: torch.Tensor, cur_len: torch.Tensor,
                      active: torch.Tensor, gate_params: Dict,
                      cfg: GateConfig, *, rope_theta: float = 10000.0,
                      k_scale: Optional[torch.Tensor] = None) -> None:
    """Finalize the Kg row of each slot's just-completed page, in place.

    Called AFTER the new token's key is written. A slot whose page
    completes ((cur_len + 1) % ps == 0) has the page's keys rotated back
    to the pre-rope frame and pooled + projected into that page's row.
    Every other slot writes the null page's row back UNCHANGED (the
    reference's ``where(completed, kg_new, kg_cur)``), so no live row
    moves. ``k_scale`` [P, Hkv, 1] (int8 pools) dequantizes the gathered
    page first."""
    ps = cfg.block_size
    sidx = torch.arange(cur_len.shape[0], device=cur_len.device)
    logical = (cur_len // ps).long()
    phys = torch.where(active, page_table[sidx, logical], NULL_PAGE).long()
    completed = active & (((cur_len + 1) % ps) == 0)
    blk = k_pages[phys]                                    # [S, Hkv, ps, Dh]
    if k_scale is not None:
        blk = dequantize_block(blk, k_scale[phys])
    blk = blk.transpose(1, 2)                              # [S, ps, Hkv, Dh]
    kg_new = finalize_block_kg(gate_params, blk, logical * ps, logical, cfg,
                               is_roped=True, rope_theta=rope_theta)
    phys_kg = torch.where(completed, phys, NULL_PAGE)
    kg_cur = kg_pages[phys_kg]
    kg_pages[phys_kg] = torch.where(completed[:, None, None],
                                    kg_new.to(kg_pages.dtype), kg_cur)


def append_meta_paged(kmin_pages: torch.Tensor, kmax_pages: torch.Tensor,
                      k_pages: torch.Tensor, page_table: torch.Tensor,
                      cur_len: torch.Tensor, active: torch.Tensor, page_size: int,
                      k_scale: Optional[torch.Tensor] = None) -> None:
    """ONE layer's paged twin of ``metacache.update_metacache``, in place.

    Called AFTER the new token's key is written (and, on int8 pools,
    after its page was requantized): a slot whose page completes
    ((cur_len + 1) % ps == 0) gets that page's key min/max written to its
    ``kmin_pages``/``kmax_pages`` rows, reading one physical page per slot.
    ``k_scale`` [P, Hkv, 1] dequantizes the page under the scale row the
    append just wrote. Inactive and non-completing slots write the null
    page's own rows back unchanged (several may; they write equal values)."""
    ps = page_size
    sidx = torch.arange(cur_len.shape[0], device=cur_len.device)
    logical = (cur_len // ps).long()
    phys = torch.where(active, page_table[sidx, logical], NULL_PAGE).long()
    completed = active & (((cur_len + 1) % ps) == 0)
    blk = k_pages[phys]                                    # [S, Hkv, ps, Dh]
    if k_scale is not None:
        blk = dequantize_block(blk, k_scale[phys])
    ones = torch.ones((1, 1, ps, 1), dtype=torch.bool, device=blk.device)
    mn_new, mx_new = _block_minmax(blk, ones)              # [S, Hkv, Dh]
    phys_w = torch.where(completed, phys, NULL_PAGE)
    wm = completed[:, None, None]
    for pool, new in ((kmin_pages, mn_new), (kmax_pages, mx_new)):
        pool.index_put_((phys_w,), torch.where(wm, new, pool[phys_w]))


def gather_kg(kg_pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, Dg] x [S, npt] -> per-slot head-major logical Kg view
    [S, Hkv, npt, Dg] (the paged gate select's plain version reads it)."""
    return kg_pages[page_table.long()].transpose(1, 2)


def gather_kv(pages_1l: torch.Tensor, page_table: torch.Tensor,
              scale_1l: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[P, Hkv, ps, Dh] x [S, npt] -> head-major contiguous view
    [S, Hkv, npt*ps, Dh]. The dense-attention fallback only: it copies a
    cache-sized array; the sparse path reads selected pages in-kernel.
    ``scale_1l`` [P, Hkv, 1] dequantizes int8 pools during the gather."""
    s, npt = page_table.shape
    g = pages_1l[page_table.long()]                        # [S,npt,Hkv,ps,Dh]
    if scale_1l is not None:
        g = dequantize_block(g, scale_1l[page_table.long()])
    g = g.transpose(1, 2)                                  # [S,Hkv,npt,ps,Dh]
    return g.reshape(s, pages_1l.shape[1], npt * pages_1l.shape[2],
                     pages_1l.shape[3])


class PageAllocator:
    """Host-side free-list allocator over the physical page pool.

    Page 0 (NULL_PAGE) is reserved. Allocation is LIFO over the free list
    (freshly freed pages are reused first). ``min_free`` records the
    low-watermark of the free list (peak-occupancy telemetry)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.min_free = len(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if the pool can't satisfy the request."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self.min_free = min(self.min_free, len(self._free))
        return out

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            if i == NULL_PAGE:
                raise ValueError("page 0 is reserved")
            if i in self._free:
                raise ValueError(f"double free of page {i}")
            self._free.append(int(i))


def pad_page_ids(ids: Sequence[int], *, min_len: int = 1,
                 device=None) -> torch.Tensor:
    """A page-id list padded with NULL_PAGE to the next power-of-two
    length, as the reference pads it to bound its jit cache. The port
    keeps the padding so a swap entry holds the same rows (and bytes) as
    the reference's; the padded rows are the trash page's."""
    n = max(len(ids), min_len)
    bucket = 1 << (n - 1).bit_length()
    return torch.tensor(list(ids) + [NULL_PAGE] * (bucket - len(ids)),
                        dtype=torch.int64, device=device)


def reset_kg_rows(pages: PagedPages, page_ids: torch.Tensor) -> None:
    """Zero the Kg and metadata rows (and, for int8 pools, the scale rows)
    of freshly (lazily) allocated pages: a recycled page still holds its
    previous tenant's rows, and a partial trailing page must read ZERO rows; a zero
    scale makes stale int8 bytes dequantize to exactly 0 until the first
    append rewrites the row. K/V contents need no reset: every read is
    masked by the logical ``kv_len``."""
    if pages.kg_pages is not None:
        pages.kg_pages[:, page_ids] = 0
    if pages.kmin_pages is not None:
        pages.kmin_pages[:, page_ids] = 0
        pages.kmax_pages[:, page_ids] = 0
    if pages.k_scale_pages is not None:
        pages.k_scale_pages[:, page_ids] = 0
        pages.v_scale_pages[:, page_ids] = 0


def copy_gate_rows(pages: PagedPages, src_ids: torch.Tensor,
                   dst_ids: torch.Tensor) -> None:
    """Copy the gate and metadata rows (Kg, kmin/kmax) from ``src_ids`` to
    ``dst_ids``, in place: the evict-time park of a page's selection-side
    state in a ghost row (its K/V go to the host through
    ``extract_pages``, then the page is reclaimed). Both id lists are
    padded with NULL_PAGE by the caller; the padding copies row 0 onto
    itself, which is inert."""
    if pages.kg_pages is not None:
        pages.kg_pages[:, dst_ids] = pages.kg_pages[:, src_ids]
    if pages.kmin_pages is not None:
        pages.kmin_pages[:, dst_ids] = pages.kmin_pages[:, src_ids]
        pages.kmax_pages[:, dst_ids] = pages.kmax_pages[:, src_ids]


def extract_pages(pages: PagedPages, page_ids: torch.Tensor
                  ) -> Tuple[Optional[torch.Tensor], ...]:
    """One request's pages for swap-out, copied to HOST memory before the
    scheduler frees them, physical ids given in LOGICAL order: (k
    [L,n,Hkv,ps,Dh], v, kg [L,n,Hkv,Dg] | None, kmin [L,n,Hkv,Dh] | None,
    kmax | None, k_scale [L,n,Hkv,1] | None, v_scale | None), the
    reference's order. Int8 pools move their raw bytes plus the scale
    rows, so the round trip is bitwise."""
    return tuple(None if pool is None else pool[:, page_ids].cpu() for pool in pages)


def restore_pages(pages: PagedPages, k: torch.Tensor, v: torch.Tensor,
                  kg: Optional[torch.Tensor], page_ids: torch.Tensor,
                  kmin: Optional[torch.Tensor] = None,
                  kmax: Optional[torch.Tensor] = None, *,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> None:
    """Scatter swapped-out page contents into fresh physical pages
    (re-admission after preemption). The new ids may differ from the old
    ones: every access goes through the page table, so the round trip is
    bitwise lossless. The metadata rows ride along; int8 pools get their
    raw bytes and scale rows back, with no requantization."""
    dev = pages.k_pages.device
    pages.k_pages[:, page_ids] = k.to(dev, pages.k_pages.dtype)
    pages.v_pages[:, page_ids] = v.to(dev, pages.v_pages.dtype)
    if pages.kg_pages is not None and kg is not None:
        pages.kg_pages[:, page_ids] = kg.to(dev, pages.kg_pages.dtype)
    if pages.kmin_pages is not None and kmin is not None:
        pages.kmin_pages[:, page_ids] = kmin.to(dev)
        pages.kmax_pages[:, page_ids] = kmax.to(dev)
    if pages.k_scale_pages is not None and k_scale is not None:
        pages.k_scale_pages[:, page_ids] = k_scale.to(dev)
        pages.v_scale_pages[:, page_ids] = v_scale.to(dev)
