"""Block-sparse flash decoding: plain PyTorch version + CUDA kernel.

Replaces the TPU kernel
``repro/kernels/block_sparse_decode.py::block_sparse_decode`` (fp body).
Layouts are the reference's native head-major ones:

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


def _bind(lib: ctypes.CDLL):
    fn = lib.block_sparse_decode_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
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
