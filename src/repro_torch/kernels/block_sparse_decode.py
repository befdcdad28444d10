"""Block-sparse flash decoding: plain PyTorch versions + CUDA kernels.

Replaces the TPU kernels
``repro/kernels/block_sparse_decode.py::block_sparse_decode`` (fp body
``_kernel``, int8 body ``_kernel_quant``), ``block_sparse_decode_paged``
(``_kernel_paged``, ``_kernel_paged_quant``) and
``block_sparse_decode_paged_splitk`` (``_kernel_paged_splitk``,
``_kernel_paged_splitk_quant``): all six run one CUDA body,
``csrc/block_sparse_decode_sm90.cu``. Layouts are the reference's native
head-major ones:

  q             [B, Hkv, G, Dh]   one new query token, grouped per kv head
  k_cache/v_... [B, Hkv, S, Dh]   post-rope caches
  block_indices [B, Hkv, nsel]    int32 selected block ids, -1 = padding
  kv_len        [B]               valid lengths (masks the partial last block)
  -> o          [B, Hkv, G, Dh]   in q's dtype

``sparse_decode_plain`` is the twin of the reference's
``kernels/ref.py::sparse_decode_ref`` (gather the selected blocks, masked
softmax in fp32): the CPU execution path and the oracle the kernel is
held against on the card. ``sparse_decode_cuda`` launches the body on
the current stream and counts its launches in
``sparse_decode_cuda.launches``. The body cuts each (b, kv-head)'s
selected list into segments of ``ceil(nsel / num_splits)`` entries, one
CTA each, and combines their flash partials with the split-K rescale
below; unless the caller names ``num_splits``, it takes
``split_plan(...)``, which depends on the shapes and the SM count only.

The paged pair reads the page pools ``k_pages``/``v_pages`` [P, Hkv, ps,
Dh] (ps == block_size) through ``page_table`` [B, npt] int32: the
selected ids stay LOGICAL, a block's rows come from its physical page,
and the masking stays in logical positions. ``sparse_decode_paged_plain``
is the twin of ``kernels/ref.py::paged_sparse_decode_ref``;
``sparse_decode_paged_cuda`` launches the paged instance of the body and
counts in ``sparse_decode_paged_cuda.launches``.

Fused int8 dequant (TPU bodies ``_kernel_quant`` and
``_kernel_paged_quant``): ``k_scales``/``v_scales`` are per-block
symmetric dequant factors (value = stored int8 * scale), [B, Hkv, nb] for
the contiguous cache and [P, Hkv, 1] pool rows (one per physical page)
for the paged one. The plain versions multiply only the GATHERED selected
blocks by their scales inside the fp32 upcast, as ``ref._deq`` does; None
leaves them bitwise what they are for fp caches. ``sparse_decode_quant_cuda``
and ``sparse_decode_paged_quant_cuda`` launch the int8 instances, each
with its own launch counter.

Split-K (TPU kernel ``block_sparse_decode_paged_splitk``): the selected
list is cut into ``num_splits`` segments of ``ceil(nsel / num_splits)``
entries (the tail padded with -1), each reduced to an unnormalised flash
partial (acc, m, l), and the partials merge with the two-pass rescale
``m = max_s m_s``, ``l = sum_s l_s e^{m_s - m}``, ``o = sum_s acc_s
e^{m_s - m} / l``. ``sparse_decode_paged_splitk_plain`` is the twin of
``kernels/ref.py::paged_sparse_decode_splitk_ref``. Those are the body's
own segments and combine, so ``sparse_decode_paged_splitk_cuda`` and
``sparse_decode_paged_splitk_quant_cuda`` are the paged fp and int8
instances at the caller's ``num_splits`` (required: the reference's
contract, never the plan), each with its own launch counter.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, fake
from repro_torch.models.common import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# No limit on G or Dh of their own: a CTA holds at most 32 rows of the
# group (further rows go to other CTAs) and a lane at most 4 chunks of its
# row (wider heads go to column-slice CTAs). The body refuses a shape whose
# shared memory passes 227 KB (``group_plan``; at G 1, Dh past 9216 fp32,
# 14398 bf16, 14270 int8) or whose CTAs pass a grid's 2^31 - 1, and the
# launch then raises RuntimeError.
SPLIT_CTAS_PER_SM = 2             # the decode's split plan: CTAs it aims for per SM ...
SPLIT_MIN_ENTRIES = 4             # ... with at least this many selected entries each


def split_plan(batch: int, hkv: int, nsel: int, n_sm: int) -> int:
    """Segments the decode kernel (fp or int8) cuts each (b, kv-head)'s
    selected list into: enough CTAs for ``SPLIT_CTAS_PER_SM`` on each of
    the card's ``n_sm`` SMs, each segment at least ``SPLIT_MIN_ENTRIES``
    entries long, trimmed so that no segment of ``split_segments`` is
    empty. A pure function of these four numbers: kv_len, the pool, the
    page table and the dtype do not enter it, so the contiguous and the
    paged entry points, a tight and an ample pool, and shuffled pages all
    reduce the same segments in the same order (bitwise the same output).
    8 segments of 8 entries (256 CTAs) at the main path's 4 x 8 heads x 64
    entries on 132 SMs."""
    if nsel <= 0:
        return 1
    want = -(-SPLIT_CTAS_PER_SM * n_sm // max(1, batch * hkv))
    ns = max(1, min(want, nsel // SPLIT_MIN_ENTRIES))
    per = -(-nsel // ns)
    return -(-nsel // per)


def split_segments(nsel: int, num_splits: int):
    """[(j0, j1)] of each segment: ``per = ceil(nsel / num_splits)`` entries,
    the last cut at nsel (the reference's split-K boundaries, as
    ``sparse_decode_paged_splitk_plain`` cuts them); a segment past nsel is
    empty."""
    per = -(-nsel // num_splits)
    return [(min(s * per, nsel), min((s + 1) * per, nsel)) for s in range(num_splits)]


def group_plan(g: int, dh: int, block_size: int, dtype: torch.dtype,
               quant: bool = False) -> dict:
    """How the CUDA body cuts a (g, dh) group: ``gp`` query rows a CTA,
    ``ngc`` CTAs over the group, ``ncs`` column slices, ``chunks`` a lane,
    ``rows`` of K/V a ring stage, ``smem`` bytes, and ``ok``: False where
    a launch would refuse the shapes. Asks the library, which it builds
    at first use (nvcc)."""
    lib = build.load("block_sparse_decode_sm90")
    fn = lib.block_sparse_decode_sm90_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 6)()
    rc = fn(g, dh, block_size, _DTYPES[dtype], int(quant), ctypes.addressof(out))
    keys = ("gp", "ngc", "ncs", "chunks", "rows", "smem")
    return {**dict(zip(keys, out)), "ok": rc == 0}


_N_SM: dict = {}


def n_sm(device: torch.device) -> int:
    """The card's SM count (cached per device)."""
    key = torch.device(device).index or 0
    if key not in _N_SM:
        _N_SM[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _N_SM[key]


def _deq(g: torch.Tensor, scales: Optional[torch.Tensor], idx: torch.Tensor,
         block_size: int) -> torch.Tensor:
    """Gathered blocks g [B, Hkv, nsel*bs, Dh] -> fp32, each selected block
    times its scale (``scales`` [B, Hkv, nb] gathered at ``idx``); None is
    the plain upcast."""
    if scales is None:
        return g.to(torch.float32)
    shp = g.shape
    sel = torch.gather(scales, 2, idx)                              # [B,Hkv,nsel]
    g = g.reshape(shp[:-2] + (idx.shape[-1], block_size, shp[-1]))
    return (g.to(torch.float32) * sel[..., None, None]).reshape(shp)


def sparse_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, block_indices: torch.Tensor,
                        kv_len: torch.Tensor, *, block_size: int,
                        k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch block-sparse decode (any device); ``k_scales``/
    ``v_scales`` [B, Hkv, nb] dequantize int8 caches block by block."""
    b, hkv, g, dh = q.shape
    s_max = k_cache.shape[2]
    nsel = block_indices.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    idx = torch.clamp_min(block_indices, 0).to(torch.int64)         # [B,Hkv,nsel]
    # token positions of the gathered blocks: [B,Hkv,nsel,bs]
    pos = idx[..., None] * block_size + torch.arange(block_size, device=q.device)
    gpos = torch.clamp_max(pos.reshape(b, hkv, nsel * block_size), s_max - 1)
    gidx = gpos[..., None].expand(-1, -1, -1, dh)
    kg = _deq(torch.gather(k_cache, 2, gidx), k_scales, idx, block_size)  # [B,Hkv,n*bs,Dh]
    vg = _deq(torch.gather(v_cache, 2, gidx), v_scales, idx, block_size)
    sc = torch.einsum("bhgd,bhkd->bhgk", q.to(torch.float32), kg) * scale
    valid = (block_indices[..., None] >= 0) & (pos < kv_len[:, None, None, None])
    valid = valid.reshape(b, hkv, 1, nsel * block_size)
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    # rows with zero valid keys give 0
    p = torch.where(torch.any(valid, dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vg)
    return o.to(q.dtype)


def sparse_decode_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_indices: torch.Tensor,
                              page_table: torch.Tensor, kv_len: torch.Tensor, *,
                              block_size: int,
                              k_scales: Optional[torch.Tensor] = None,
                              v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch paged block-sparse decode (any device): gather the
    selected physical pages off the pools, then the contiguous math.
    ``k_scales``/``v_scales`` [P, Hkv, 1] (or [P, Hkv]) dequantize int8
    pools; each gathered page takes the scale row of its PHYSICAL page."""
    b, hkv, g, dh = q.shape
    ps = k_pages.shape[2]
    assert ps == block_size, (ps, block_size)
    nsel = block_indices.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    idx = torch.clamp_min(block_indices, 0).to(torch.int64)         # [B,Hkv,nsel]
    pt = page_table.to(torch.int64)[:, None, :].expand(b, hkv, -1)
    phys = torch.gather(pt, 2, idx)                                 # [B,Hkv,nsel]
    har = torch.arange(hkv, device=q.device)[None, :, None]

    def pages(pool, scales):                                        # -> [B,Hkv,n*ps,Dh]
        blk = pool[phys, har].to(torch.float32)                     # [B,Hkv,nsel,ps,Dh]
        if scales is not None:
            blk = blk * scales.reshape(-1, hkv)[phys, har][..., None, None]
        return blk.reshape(b, hkv, nsel * ps, dh)

    kg, vg = pages(k_pages, k_scales), pages(v_pages, v_scales)
    # token positions are LOGICAL (masking against kv_len)
    pos = idx[..., None] * ps + torch.arange(ps, device=q.device)   # [B,Hkv,nsel,ps]
    sc = torch.einsum("bhgd,bhkd->bhgk", q.to(torch.float32), kg) * scale
    valid = (block_indices[..., None] >= 0) & (pos < kv_len[:, None, None, None])
    valid = valid.reshape(b, hkv, 1, nsel * ps)
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    p = torch.where(torch.any(valid, dim=-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vg)
    return o.to(q.dtype)


def sparse_decode_paged_splitk_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor, block_indices: torch.Tensor,
                                     page_table: torch.Tensor, kv_len: torch.Tensor, *,
                                     block_size: int, num_splits: int,
                                     k_scales: Optional[torch.Tensor] = None,
                                     v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch split-K paged decode (any device). Segment s holds
    entries ``[s*per, (s+1)*per)`` of the selected list, ``per = ceil(nsel
    / num_splits)``, padded with -1 past ``nsel``; a segment with no valid
    key has l = 0 and m = NEG_INF and drops out of the combine.
    ``num_splits <= 1`` is ``sparse_decode_paged_plain``, bitwise."""
    if num_splits <= 1:
        return sparse_decode_paged_plain(q, k_pages, v_pages, block_indices, page_table,
                                         kv_len, block_size=block_size, k_scales=k_scales,
                                         v_scales=v_scales)
    b, hkv, g, dh = q.shape
    ps = k_pages.shape[2]
    assert ps == block_size, (ps, block_size)
    nsel = block_indices.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    per = -(-nsel // num_splits)
    pad = per * num_splits - nsel
    bi = block_indices
    if pad:
        bi = torch.cat([bi, torch.full((b, hkv, pad), -1, dtype=bi.dtype, device=bi.device)],
                       dim=-1)
    bi = bi.reshape(b, hkv, num_splits, per)
    idx = torch.clamp_min(bi, 0).to(torch.int64)                    # [B,Hkv,NS,per]
    pt = page_table.to(torch.int64)[:, None, None, :].expand(b, hkv, num_splits, -1)
    phys = torch.gather(pt, 3, idx)                                 # [B,Hkv,NS,per]
    har = torch.arange(hkv, device=q.device)[None, :, None, None]

    def pages(pool, scales):                                        # -> [B,Hkv,NS,per*ps,Dh]
        blk = pool[phys, har].to(torch.float32)                     # [B,Hkv,NS,per,ps,Dh]
        if scales is not None:
            blk = blk * scales.reshape(-1, hkv)[phys, har][..., None, None]
        return blk.reshape(b, hkv, num_splits, per * ps, dh)

    kg, vg = pages(k_pages, k_scales), pages(v_pages, v_scales)
    pos = idx[..., None] * ps + torch.arange(ps, device=q.device)   # [B,Hkv,NS,per,ps]
    valid = (bi[..., None] >= 0) & (pos < kv_len[:, None, None, None, None])
    valid = valid.reshape(b, hkv, num_splits, 1, per * ps)
    sc = torch.einsum("bhgd,bhskd->bhsgk", q.to(torch.float32), kg) * scale
    sc = torch.where(valid, sc, NEG_INF)
    m_s = torch.amax(sc, dim=-1, keepdim=True)                      # [B,Hkv,NS,G,1]
    p = torch.where(sc > NEG_INF / 2, torch.exp(sc - m_s), 0.0)
    l_s = torch.sum(p, dim=-1, keepdim=True)
    acc_s = torch.einsum("bhsgk,bhskd->bhsgd", p, vg)
    m = torch.amax(m_s, dim=2, keepdim=True)                        # over splits
    rescale = torch.where(l_s > 0, torch.exp(m_s - m), 0.0)
    l = torch.sum(l_s * rescale, dim=2)                             # [B,Hkv,G,1]
    o = torch.sum(acc_s * rescale, dim=2) / torch.clamp_min(l, 1e-30)
    return o.to(q.dtype)


def _bind(lib: ctypes.CDLL, paged: bool = False, quant: bool = False):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if paged and quant:
        fn = lib.block_sparse_decode_sm90_paged_quant_launch
        types = [p] * 10 + [i] * 8 + [f, i, p]
    elif quant:
        fn = lib.block_sparse_decode_sm90_quant_launch
        types = [p] * 9 + [i] * 9 + [f, i, p]
    elif paged:
        fn = lib.block_sparse_decode_sm90_paged_launch
        types = [p] * 8 + [i] * 8 + [f, i, p]
    else:
        fn = lib.block_sparse_decode_sm90_launch
        types = [p] * 7 + [i] * 8 + [f, i, p]
    if fn.argtypes is None:
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ints,
           scales=()) -> None:
    """Device, dtype and contiguity checks shared by the wrappers: K/V in
    q's dtype, or, given ``scales``, int8 K/V with float32 scales."""
    ins = (k, v, *scales, *ints)
    if not (q.is_cuda and all(t.device == q.device for t in ins)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    kv_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _DTYPES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{name}: q must be float32 or bfloat16 and k/v "
                        f"{'int8' if scales else 'of its dtype'}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.dtype != torch.float32 for t in scales):
        raise TypeError(f"{name}: k_scales and v_scales must be float32")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: index tensors and kv_len must be int32")
    if not all(t.is_contiguous() for t in (q,) + ins):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch_sm90(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_indices: torch.Tensor, kv_len: torch.Tensor, block_size: int,
                 num_splits: Optional[int], page_table: Optional[torch.Tensor] = None,
                 s_max: int = 0, scales=None) -> torch.Tensor:
    """The launch shared by the wrappers of the sm90 body (shapes checked
    by them): ``num_splits`` None takes ``split_plan``; > 1 allocates the
    f32 partials, acc [B,Hkv,ns,G,Dh] then m and l [B,Hkv,ns,G].
    ``scales`` (k_scales, v_scales) selects the int8 instances."""
    if num_splits is not None and num_splits < 1:
        raise ValueError(f"{name}: num_splits must be >= 1, got {num_splits}")
    b, hkv, g, dh = q.shape
    nsel = block_indices.shape[-1]
    out = torch.empty_like(q)
    if nsel == 0:
        return out.zero_()
    ns = split_plan(b, hkv, nsel, n_sm(q.device)) if num_splits is None else num_splits
    work = None
    if ns > 1:
        work = torch.empty(b * hkv * ns * (g * dh + 2 * g), dtype=torch.float32,
                           device=q.device)
    lib = build.load("block_sparse_decode_sm90")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if scales is not None:
        ptrs += tuple(t.data_ptr() for t in scales)
    ptrs += (block_indices.data_ptr(),)
    if page_table is not None:
        ptrs += (page_table.data_ptr(),)
    ptrs += (kv_len.data_ptr(), out.data_ptr(), 0 if work is None else work.data_ptr())
    dims = (b, hkv, g, dh)
    if page_table is not None:
        dims += (page_table.shape[1],)
    else:                       # S, and for int8 the scales per (b, head) row
        dims += (s_max,) + ((scales[0].shape[-1],) if scales is not None else ())
    dims += (nsel, block_size, ns)
    rc = _bind(lib, paged=page_table is not None, quant=scales is not None)(
        *ptrs, *dims, 1.0 / math.sqrt(dh), _DTYPES[q.dtype], stream)
    build.check(lib, rc, f"{name} kernel launch")
    return out


def _launch_paged(name: str, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                  block_indices: torch.Tensor, page_table: torch.Tensor, kv_len: torch.Tensor,
                  block_size: int, num_splits: Optional[int], scales=None) -> torch.Tensor:
    """Checks and launch shared by the four paged wrappers (#4, 4q, 5, 5q):
    pools [P, Hkv, ps, Dh] with ps == block_size, and for int8 (``scales``
    given) scale rows [P, Hkv, 1] or [P, Hkv]."""
    _check(name, q, k_pages, v_pages, (block_indices, page_table, kv_len), scales or ())
    b, hkv, g, dh = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[2]
    if ps != block_size:
        raise ValueError(f"{name}: page size {ps} != block size {block_size}")
    if k_pages.shape != (n_pages, hkv, ps, dh) or v_pages.shape != k_pages.shape \
            or any(t.numel() != n_pages * hkv or t.shape[:2] != (n_pages, hkv)
                   for t in scales or ()) \
            or block_indices.shape[:2] != (b, hkv) or page_table.dim() != 2 \
            or page_table.shape[0] != b or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
            f"v_pages {tuple(v_pages.shape)}, scales "
            f"{None if scales is None else [tuple(t.shape) for t in scales]} (want "
            f"{(n_pages, hkv, 1)}), idx {tuple(block_indices.shape)}, page_table "
            f"{tuple(page_table.shape)}, kv_len {tuple(kv_len.shape)}")
    return _launch_sm90(name, q, k_pages, v_pages, block_indices, kv_len, block_size,
                        num_splits, page_table=page_table, scales=scales)


def sparse_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, block_indices: torch.Tensor,
                       kv_len: torch.Tensor, *, block_size: int,
                       num_splits: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA block-sparse decode kernel (``block_sparse_decode_sm90``).
    ``num_splits`` overrides the split plan (a sweep or a test); None, as
    the model calls it, takes ``split_plan``."""
    _check("sparse_decode_cuda", q, k_cache, v_cache, (block_indices, kv_len))
    b, hkv, g, dh = q.shape
    s_max = k_cache.shape[2]
    if k_cache.shape != (b, hkv, s_max, dh) or v_cache.shape != k_cache.shape \
            or block_indices.shape[:2] != (b, hkv) or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"sparse_decode_cuda: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}, idx {tuple(block_indices.shape)}, "
            f"kv_len {tuple(kv_len.shape)}")
    out = _launch_sm90("block_sparse_decode", q, k_cache, v_cache, block_indices, kv_len,
                       block_size, num_splits, s_max=s_max)
    if block_indices.shape[-1]:
        sparse_decode_cuda.launches += 1
    return out


sparse_decode_cuda.launches = 0


def sparse_decode_fake(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       block_indices: torch.Tensor, kv_len: torch.Tensor, *,
                       block_size: int) -> torch.Tensor:
    """The dry-run's stand-in for ``sparse_decode_cuda`` on fake tensors: an
    unwritten output like q, and one call (none for an empty list, as the
    wrapper counts) charged to the open ``fake.KernelLedger`` with the
    bound's work, every selected block full of valid tokens (a full
    context; an upper bound on a shorter one): the K and V rows of the
    selected tokens, q, the output, the ids and kv_len; 4 x G x Dh
    operations a selected token."""
    b, hkv, g, dh = q.shape
    nsel = block_indices.shape[-1]
    out = torch.empty_like(q)
    if nsel:
        tokens = b * hkv * min(nsel * block_size, k_cache.shape[2])
        fake.charge("block_sparse_decode", 4.0 * g * dh * tokens,
                    2 * tokens * dh * k_cache.element_size() + 2 * q.nbytes
                    + block_indices.nbytes + kv_len.nbytes)
    return out


def sparse_decode_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_indices: torch.Tensor,
                             page_table: torch.Tensor, kv_len: torch.Tensor, *,
                             block_size: int,
                             num_splits: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA paged block-sparse decode kernel (the paged instance
    of ``block_sparse_decode_sm90``); ``num_splits`` as ``sparse_decode_cuda``."""
    out = _launch_paged("sparse_decode_paged_cuda", q, k_pages, v_pages, block_indices,
                        page_table, kv_len, block_size, num_splits)
    if block_indices.shape[-1]:
        sparse_decode_paged_cuda.launches += 1
    return out


sparse_decode_paged_cuda.launches = 0


def sparse_decode_quant_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, block_indices: torch.Tensor,
                             kv_len: torch.Tensor, *, block_size: int,
                             k_scales: torch.Tensor, v_scales: torch.Tensor,
                             num_splits: Optional[int] = None) -> torch.Tensor:
    """Launch the int8 CUDA block-sparse decode (TPU body ``_kernel_quant``;
    the int8 instance of ``block_sparse_decode_sm90``): int8 caches [B, Hkv,
    S, Dh], per-block scales [B, Hkv, nb] float32; ``num_splits`` as
    ``sparse_decode_cuda``."""
    name = "sparse_decode_quant_cuda"
    _check(name, q, k_cache, v_cache, (block_indices, kv_len), (k_scales, v_scales))
    b, hkv, g, dh = q.shape
    s_max = k_cache.shape[2]
    nb = -(-s_max // block_size)
    if k_cache.shape != (b, hkv, s_max, dh) or v_cache.shape != k_cache.shape \
            or k_scales.shape != (b, hkv, nb) or v_scales.shape != k_scales.shape \
            or block_indices.shape[:2] != (b, hkv) or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, v "
            f"{tuple(v_cache.shape)}, scales {tuple(k_scales.shape)}/"
            f"{tuple(v_scales.shape)} (want {(b, hkv, nb)}), idx "
            f"{tuple(block_indices.shape)}, kv_len {tuple(kv_len.shape)}")
    out = _launch_sm90("block_sparse_decode_quant", q, k_cache, v_cache, block_indices, kv_len,
                       block_size, num_splits, s_max=s_max, scales=(k_scales, v_scales))
    if block_indices.shape[-1]:
        sparse_decode_quant_cuda.launches += 1
    return out


sparse_decode_quant_cuda.launches = 0


def sparse_decode_paged_quant_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor, block_indices: torch.Tensor,
                                   page_table: torch.Tensor, kv_len: torch.Tensor, *,
                                   block_size: int, k_scales: torch.Tensor,
                                   v_scales: torch.Tensor,
                                   num_splits: Optional[int] = None) -> torch.Tensor:
    """Launch the int8 paged CUDA block-sparse decode (TPU body
    ``_kernel_paged_quant``; the int8 paged instance of
    ``block_sparse_decode_sm90``): int8 pools [P, Hkv, ps, Dh], scale rows
    [P, Hkv, 1] (or [P, Hkv]) float32, read at each block's PHYSICAL page;
    ``num_splits`` as ``sparse_decode_cuda``."""
    out = _launch_paged("sparse_decode_paged_quant_cuda", q, k_pages, v_pages, block_indices,
                        page_table, kv_len, block_size, num_splits, (k_scales, v_scales))
    if block_indices.shape[-1]:
        sparse_decode_paged_quant_cuda.launches += 1
    return out


sparse_decode_paged_quant_cuda.launches = 0


def sparse_decode_paged_splitk_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor, block_indices: torch.Tensor,
                                    page_table: torch.Tensor, kv_len: torch.Tensor, *,
                                    block_size: int, num_splits: int) -> torch.Tensor:
    """Launch the CUDA split-K paged decode (TPU body ``_kernel_paged_splitk``
    and the combine of its entry point): the paged instance of
    ``block_sparse_decode_sm90`` at the caller's ``num_splits``, B*Hkv*
    num_splits CTAs, then (num_splits > 1) the combine kernel."""
    out = _launch_paged("sparse_decode_paged_splitk_cuda", q, k_pages, v_pages, block_indices,
                        page_table, kv_len, block_size, num_splits)
    if block_indices.shape[-1]:
        sparse_decode_paged_splitk_cuda.launches += 1
    return out


sparse_decode_paged_splitk_cuda.launches = 0


def sparse_decode_paged_splitk_quant_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                          v_pages: torch.Tensor, block_indices: torch.Tensor,
                                          page_table: torch.Tensor, kv_len: torch.Tensor, *,
                                          block_size: int, num_splits: int,
                                          k_scales: torch.Tensor,
                                          v_scales: torch.Tensor) -> torch.Tensor:
    """Launch the int8 CUDA split-K paged decode (TPU body
    ``_kernel_paged_splitk_quant``): the int8 paged instance of
    ``block_sparse_decode_sm90`` at the caller's ``num_splits``, scale rows
    [P, Hkv, 1] (or [P, Hkv]) read at each block's PHYSICAL page."""
    out = _launch_paged("sparse_decode_paged_splitk_quant_cuda", q, k_pages, v_pages,
                        block_indices, page_table, kv_len, block_size, num_splits,
                        (k_scales, v_scales))
    if block_indices.shape[-1]:
        sparse_decode_paged_splitk_quant_cuda.launches += 1
    return out


sparse_decode_paged_splitk_quant_cuda.launches = 0
