"""Block-sparse flash decoding: plain PyTorch versions + CUDA kernels.

Replaces the TPU kernels
``repro/kernels/block_sparse_decode.py::block_sparse_decode`` (fp body)
and ``block_sparse_decode_paged`` (fp body ``_kernel_paged``). Layouts
are the reference's native head-major ones:

  q             [B, Hkv, G, Dh]   one new query token, grouped per kv head
  k_cache/v_... [B, Hkv, S, Dh]   post-rope caches
  block_indices [B, Hkv, nsel]    int32 selected block ids, -1 = padding
  kv_len        [B]               valid lengths (masks the partial last block)
  -> o          [B, Hkv, G, Dh]   in q's dtype

``sparse_decode_plain`` is the twin of the reference's
``kernels/ref.py::sparse_decode_ref`` (gather the selected blocks, masked
softmax in fp32): the CPU execution path and the oracle the kernel is
held against on the card. ``sparse_decode_cuda`` launches
``csrc/block_sparse_decode.cu`` on the current stream and counts its
launches in ``sparse_decode_cuda.launches``.

The paged pair reads the page pools ``k_pages``/``v_pages`` [P, Hkv, ps,
Dh] (ps == block_size) through ``page_table`` [B, npt] int32: the
selected ids stay LOGICAL, a block's rows come from its physical page,
and the masking stays in logical positions. ``sparse_decode_paged_plain``
is the twin of ``kernels/ref.py::paged_sparse_decode_ref``;
``sparse_decode_paged_cuda`` launches the paged entry point of the same
source and counts in ``sparse_decode_paged_cuda.launches``.

Fused int8 dequant (TPU bodies ``_kernel_quant`` and
``_kernel_paged_quant``): ``k_scales``/``v_scales`` are per-block
symmetric dequant factors (value = stored int8 * scale), [B, Hkv, nb] for
the contiguous cache and [P, Hkv, 1] pool rows (one per physical page)
for the paged one. The plain versions multiply only the GATHERED selected
blocks by their scales inside the fp32 upcast, as ``ref._deq`` does; None
leaves them bitwise what they are for fp caches. ``sparse_decode_quant_cuda``
and ``sparse_decode_paged_quant_cuda`` launch the int8 instances of the
same CUDA body, each with its own launch counter.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.models.common import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_ELEMS = 4096            # G * Dh the kernel keeps in registers


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


def _bind(lib: ctypes.CDLL, paged: bool = False, quant: bool = False):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if paged and quant:
        fn = lib.block_sparse_decode_paged_quant_launch
        types = [p] * 9 + [i, i, i, i, i, i, i, f, i, p]
    elif paged:
        fn = lib.block_sparse_decode_paged_launch
        types = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
    elif quant:
        fn = lib.block_sparse_decode_quant_launch
        types = [p] * 8 + [i, i, i, i, i, i, i, i, f, i, p]
    else:
        fn = lib.block_sparse_decode_launch
        types = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
    if fn.argtypes is None:
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return fn


def sparse_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, block_indices: torch.Tensor,
                       kv_len: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Launch the CUDA block-sparse decode kernel."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in
                              (k_cache, v_cache, block_indices, kv_len))):
        raise ValueError("sparse_decode_cuda: all inputs must be on one CUDA device")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"sparse_decode_cuda: q/k/v must share dtype float32 or "
                        f"bfloat16, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if block_indices.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("sparse_decode_cuda: block_indices and kv_len must be int32")
    b, hkv, g, dh = q.shape
    s_max = k_cache.shape[2]
    nsel = block_indices.shape[-1]
    if k_cache.shape != (b, hkv, s_max, dh) or v_cache.shape != k_cache.shape \
            or block_indices.shape[:2] != (b, hkv) or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"sparse_decode_cuda: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}, idx {tuple(block_indices.shape)}, "
            f"kv_len {tuple(kv_len.shape)}")
    if g * dh > MAX_GROUP_ELEMS:
        raise ValueError(f"sparse_decode_cuda: G*Dh = {g * dh} > {MAX_GROUP_ELEMS}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, block_indices, kv_len)):
        raise ValueError("sparse_decode_cuda: inputs must be contiguous")
    out = torch.empty_like(q)
    if nsel == 0:
        return out.zero_()
    lib = build.load("block_sparse_decode")
    rc = _bind(lib)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_indices.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        b, hkv, g, dh, s_max, nsel, block_size, 1.0 / math.sqrt(dh),
        _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "block_sparse_decode kernel launch")
    sparse_decode_cuda.launches += 1
    return out


sparse_decode_cuda.launches = 0


def sparse_decode_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_indices: torch.Tensor,
                             page_table: torch.Tensor, kv_len: torch.Tensor, *,
                             block_size: int) -> torch.Tensor:
    """Launch the CUDA paged block-sparse decode kernel."""
    dev = q.device
    ins = (k_pages, v_pages, block_indices, page_table, kv_len)
    if not (q.is_cuda and all(t.device == dev for t in ins)):
        raise ValueError("sparse_decode_paged_cuda: all inputs must be on one CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"sparse_decode_paged_cuda: q/k/v must share dtype float32 or "
                        f"bfloat16, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (block_indices, page_table, kv_len)):
        raise TypeError("sparse_decode_paged_cuda: block_indices, page_table and "
                        "kv_len must be int32")
    b, hkv, g, dh = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[2]
    nsel = block_indices.shape[-1]
    if ps != block_size:
        raise ValueError(f"sparse_decode_paged_cuda: page size {ps} != block size "
                         f"{block_size}")
    if k_pages.shape != (n_pages, hkv, ps, dh) or v_pages.shape != k_pages.shape \
            or block_indices.shape[:2] != (b, hkv) or page_table.dim() != 2 \
            or page_table.shape[0] != b or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"sparse_decode_paged_cuda: shapes q {tuple(q.shape)}, k_pages "
            f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}, idx "
            f"{tuple(block_indices.shape)}, page_table {tuple(page_table.shape)}, "
            f"kv_len {tuple(kv_len.shape)}")
    if g * dh > MAX_GROUP_ELEMS:
        raise ValueError(f"sparse_decode_paged_cuda: G*Dh = {g * dh} > {MAX_GROUP_ELEMS}")
    if not all(t.is_contiguous() for t in (q,) + ins):
        raise ValueError("sparse_decode_paged_cuda: inputs must be contiguous")
    out = torch.empty_like(q)
    if nsel == 0:
        return out.zero_()
    lib = build.load("block_sparse_decode")
    rc = _bind(lib, paged=True)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_indices.data_ptr(), page_table.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, hkv, g, dh, page_table.shape[1], nsel, block_size,
        1.0 / math.sqrt(dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "block_sparse_decode_paged kernel launch")
    sparse_decode_paged_cuda.launches += 1
    return out


sparse_decode_paged_cuda.launches = 0


def _check_quant(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scales, ints) -> None:
    """Device, dtype and contiguity checks shared by the int8 wrappers."""
    ins = (k, v, *scales, *ints)
    if not (q.is_cuda and all(t.device == q.device for t in ins)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"{name}: q must be float32 or bfloat16 and k/v int8, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.dtype != torch.float32 for t in scales):
        raise TypeError(f"{name}: k_scales and v_scales must be float32")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: index tensors and kv_len must be int32")
    if q.shape[2] * q.shape[3] > MAX_GROUP_ELEMS:
        raise ValueError(f"{name}: G*Dh = {q.shape[2] * q.shape[3]} > {MAX_GROUP_ELEMS}")
    if not all(t.is_contiguous() for t in (q,) + ins):
        raise ValueError(f"{name}: inputs must be contiguous")


def sparse_decode_quant_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, block_indices: torch.Tensor,
                             kv_len: torch.Tensor, *, block_size: int,
                             k_scales: torch.Tensor,
                             v_scales: torch.Tensor) -> torch.Tensor:
    """Launch the int8 CUDA block-sparse decode (TPU body ``_kernel_quant``):
    int8 caches [B, Hkv, S, Dh], per-block scales [B, Hkv, nb] float32."""
    name = "sparse_decode_quant_cuda"
    _check_quant(name, q, k_cache, v_cache, (k_scales, v_scales), (block_indices, kv_len))
    b, hkv, g, dh = q.shape
    s_max = k_cache.shape[2]
    nb = -(-s_max // block_size)
    nsel = block_indices.shape[-1]
    if k_cache.shape != (b, hkv, s_max, dh) or v_cache.shape != k_cache.shape \
            or k_scales.shape != (b, hkv, nb) or v_scales.shape != k_scales.shape \
            or block_indices.shape[:2] != (b, hkv) or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, v "
            f"{tuple(v_cache.shape)}, scales {tuple(k_scales.shape)}/"
            f"{tuple(v_scales.shape)} (want {(b, hkv, nb)}), idx "
            f"{tuple(block_indices.shape)}, kv_len {tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    if nsel == 0:
        return out.zero_()
    lib = build.load("block_sparse_decode")
    rc = _bind(lib, quant=True)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), block_indices.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), b, hkv, g, dh, s_max, nb, nsel, block_size,
        1.0 / math.sqrt(dh), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "block_sparse_decode_quant kernel launch")
    sparse_decode_quant_cuda.launches += 1
    return out


sparse_decode_quant_cuda.launches = 0


def sparse_decode_paged_quant_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor, block_indices: torch.Tensor,
                                   page_table: torch.Tensor, kv_len: torch.Tensor, *,
                                   block_size: int, k_scales: torch.Tensor,
                                   v_scales: torch.Tensor) -> torch.Tensor:
    """Launch the int8 paged CUDA block-sparse decode (TPU body
    ``_kernel_paged_quant``): int8 pools [P, Hkv, ps, Dh], scale rows
    [P, Hkv, 1] (or [P, Hkv]) float32, read at each block's PHYSICAL page."""
    name = "sparse_decode_paged_quant_cuda"
    _check_quant(name, q, k_pages, v_pages, (k_scales, v_scales),
                 (block_indices, page_table, kv_len))
    b, hkv, g, dh = q.shape
    n_pages, ps = k_pages.shape[0], k_pages.shape[2]
    nsel = block_indices.shape[-1]
    if ps != block_size:
        raise ValueError(f"{name}: page size {ps} != block size {block_size}")
    if k_pages.shape != (n_pages, hkv, ps, dh) or v_pages.shape != k_pages.shape \
            or any(t.numel() != n_pages * hkv or t.shape[:2] != (n_pages, hkv)
                   for t in (k_scales, v_scales)) \
            or block_indices.shape[:2] != (b, hkv) or page_table.dim() != 2 \
            or page_table.shape[0] != b or tuple(kv_len.shape) != (b,):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
            f"v_pages {tuple(v_pages.shape)}, scales {tuple(k_scales.shape)}/"
            f"{tuple(v_scales.shape)} (want {(n_pages, hkv, 1)}), idx "
            f"{tuple(block_indices.shape)}, page_table {tuple(page_table.shape)}, "
            f"kv_len {tuple(kv_len.shape)}")
    out = torch.empty_like(q)
    if nsel == 0:
        return out.zero_()
    lib = build.load("block_sparse_decode")
    rc = _bind(lib, paged=True, quant=True)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), block_indices.data_ptr(), page_table.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, hkv, g, dh, page_table.shape[1], nsel,
        block_size, 1.0 / math.sqrt(dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "block_sparse_decode_paged_quant kernel launch")
    sparse_decode_paged_quant_cuda.launches += 1
    return out


sparse_decode_paged_quant_cuda.launches = 0
