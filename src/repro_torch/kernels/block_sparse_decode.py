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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.models.common import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_ELEMS = 4096            # G * Dh the kernel keeps in registers


def sparse_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, block_indices: torch.Tensor,
                        kv_len: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Plain PyTorch block-sparse decode (any device)."""
    b, hkv, g, dh = q.shape
    s_max = k_cache.shape[2]
    nsel = block_indices.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    idx = torch.clamp_min(block_indices, 0).to(torch.int64)         # [B,Hkv,nsel]
    # token positions of the gathered blocks: [B,Hkv,nsel,bs]
    pos = idx[..., None] * block_size + torch.arange(block_size, device=q.device)
    gpos = torch.clamp_max(pos.reshape(b, hkv, nsel * block_size), s_max - 1)
    gidx = gpos[..., None].expand(-1, -1, -1, dh)
    kg = torch.gather(k_cache, 2, gidx).to(torch.float32)           # [B,Hkv,n*bs,Dh]
    vg = torch.gather(v_cache, 2, gidx).to(torch.float32)
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
                              block_size: int) -> torch.Tensor:
    """Plain PyTorch paged block-sparse decode (any device): gather the
    selected physical pages off the pools, then the contiguous math."""
    b, hkv, g, dh = q.shape
    ps = k_pages.shape[2]
    assert ps == block_size, (ps, block_size)
    nsel = block_indices.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    idx = torch.clamp_min(block_indices, 0).to(torch.int64)         # [B,Hkv,nsel]
    pt = page_table.to(torch.int64)[:, None, :].expand(b, hkv, -1)
    phys = torch.gather(pt, 2, idx)                                 # [B,Hkv,nsel]
    har = torch.arange(hkv, device=q.device)[None, :, None]
    kg = k_pages[phys, har].reshape(b, hkv, nsel * ps, dh).to(torch.float32)
    vg = v_pages[phys, har].reshape(b, hkv, nsel * ps, dh).to(torch.float32)
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


def _bind(lib: ctypes.CDLL, paged: bool = False):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if paged:
        fn = lib.block_sparse_decode_paged_launch
        types = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
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
