"""Distillation-target flash attention forward: plain PyTorch + CUDA kernel.

Replaces the TPU kernel ``repro/kernels/gate_gt_fwd.py::gate_gt_flash_fwd``
(body ``_kernel``): a causal GQA attention forward that also emits
``blockmax``, the max masked logit of each (query row, KV block). By the
identity in ``core/distill.py``, softmax(blockmax) over the block axis is
the paper's column-blockwise max-pooled attention map, the gate's
distillation target.

  q            [B, Lq, H, Dh]   post-rope queries (seq-major, as the model has them)
  k, v         [B, Lk, Hkv, Dh] post-rope keys, values; Lk % block_size == 0
  segment_ids  [B, L] int       optional packed-document ids (Lq == Lk)
  -> o         [B, Lq, H, Dh]   in q's dtype
     blockmax  [B, H, Lq, nb]   fp32, nb = Lk // block_size; exactly NEG_INF
                                where a block is fully masked

``gate_gt_attention_plain`` is the reference's training path,
``models/common.chunked_attention(causal=True, gt_block_size=,
segment_ids=)``, which is also the port's (one loop, in
``models/common.py``): the CPU execution path and the oracle the kernel
is held against on the card. With ``segment_ids=None`` it is the Pallas
kernel's function. ``gate_gt_attention_cuda`` launches
``csrc/gate_gt_fwd.cu`` on the current stream and counts its launches in
``gate_gt_attention_cuda.launches``. The dtype picks the kernel's body:
bfloat16 runs on the tensor cores (mma.sync, bf16 products, fp32 sums) at
block sizes 8, 16, 32, 64 and 128 only, and skips the (query tile, key
tile) pairs that share no document; float32 runs on the CUDA cores in full
fp32 at any block size up to 128. Both take head dims 16, 32, 64, 128 and
256. Neither has a backward: the distillation target is a constant of the
gate's loss.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, fake
from repro_torch.models.common import chunked_attention

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instances
MAX_BLOCK = 128                   # largest block: the fp32 body stages it in chunks of 64 keys
TC_BLOCKS = (8, 16, 32, 64, 128)  # block sizes of the bf16 body: whole n8 tiles of a
                                  # 64-key tile, or a pair of tiles
TILE = 64                         # query rows / keys per tile of the bf16 body


def gate_gt_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            block_size: int, q_chunk: int = 256,
                            segment_ids: Optional[torch.Tensor] = None,
                            logit_softcap: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention forward + blockmax (any device), fp32
    inside, a loop over ``q_chunk`` query rows."""
    return chunked_attention(q, k, v, causal=True, q_chunk=q_chunk,
                             logit_softcap=logit_softcap, gt_block_size=block_size,
                             segment_ids=segment_ids)


def _bind(lib: ctypes.CDLL):
    fn = lib.gate_gt_fwd_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 7 + [i] * 8 + [f, i, p]
        fn.restype = ctypes.c_int
    return fn


def gate_gt_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           block_size: int, segment_ids: Optional[torch.Tensor] = None,
                           logit_softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. q, k, v contiguous and 16-byte aligned in one
    dtype; ``segment_ids`` int32 [B, L]. bfloat16 takes the tensor-core
    body, whose domain is narrower: ``block_size`` must be one of
    ``TC_BLOCKS`` (8, 16, 32, 64, 128), any other raises ValueError.
    float32 takes the CUDA-core body, any ``block_size`` in 1..128. The
    head dim must be one of ``HEAD_DIMS``."""
    name = "gate_gt_attention_cuda"
    if logit_softcap:
        raise NotImplementedError(f"{name}: logit_softcap {logit_softcap} (no ported "
                                  "family has one)")
    seg = segment_ids
    ins = (k, v) + (() if seg is None else (seg,))
    if not (q.is_cuda and all(t.device == q.device for t in ins)):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, lq, h, dh = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, lk, hkv, dh) or v.shape != k.shape or hkv == 0 or h % hkv:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {HEAD_DIMS}")
    if not 0 < block_size <= MAX_BLOCK or lk % block_size:
        raise ValueError(f"{name}: block size {block_size} must be in 1..{MAX_BLOCK} "
                         f"and divide Lk {lk}")
    if q.dtype == torch.bfloat16 and block_size not in TC_BLOCKS:
        raise ValueError(f"{name}: block size {block_size} is not one of the bfloat16 "
                         f"kernel's {TC_BLOCKS}")
    if seg is not None:
        if seg.dtype != torch.int32 or tuple(seg.shape) != (b, lq) or lq != lk:
            raise ValueError(f"{name}: segment_ids must be int32 [B, L] with Lq == Lk, "
                             f"got {seg.dtype} {tuple(seg.shape)} (Lq {lq}, Lk {lk})")
    if not all(t.is_contiguous() for t in (q,) + ins):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start on a 16-byte boundary")
    nb = lk // block_size
    o = torch.empty_like(q)
    bm = torch.empty((b, h, lq, nb), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or nb == 0:
        return o.zero_(), bm           # no query row, or no key: o is 0
    # the bf16 body's scratch: each 64-row tile's lowest and highest segment id
    tile_seg = (None if seg is None or q.dtype != torch.bfloat16 else
                torch.empty((b, -(-lk // TILE), 2), dtype=torch.int32, device=q.device))
    lib = build.load("gate_gt_fwd")
    rc = _bind(lib)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        None if tile_seg is None else tile_seg.data_ptr(),
        o.data_ptr(), bm.data_ptr(), b, lq, lk, h, hkv, dh, block_size, nb,
        1.0 / math.sqrt(dh), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "gate_gt_fwd kernel launch")
    gate_gt_attention_cuda.launches += 1
    return o, bm


gate_gt_attention_cuda.launches = 0


def gate_gt_attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           block_size: int, segment_ids: Optional[torch.Tensor] = None,
                           logit_softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dry-run's stand-in for ``gate_gt_attention_cuda`` on fake
    tensors: unwritten (o, blockmax) of the kernel's shapes and dtypes,
    the head dims and softcap it refuses refused alike, and one call
    charged to the open ``fake.KernelLedger`` with the bound's work:
    q, k, v, o, the segment ids read or written once and blockmax written
    once; 4 x Dh x H operations a causal (query, key) pair, every pair of
    a row counted (one document a row; an upper bound on packed ones)."""
    if logit_softcap:
        raise NotImplementedError(f"gate_gt_attention_fake: logit_softcap {logit_softcap} "
                                  "(no ported family has one)")
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"gate_gt_attention_fake: head dim {dh} not in {HEAD_DIMS}")
    nb = lk // block_size
    o = torch.empty_like(q)
    bm = torch.empty((b, h, lq, nb), dtype=torch.float32, device=q.device)
    # query i sees keys 0 .. i + lk - lq (the query rows end the keys)
    pairs = b * (lq * (lq + 1) // 2 + lq * (lk - lq))
    seg = 0 if segment_ids is None else segment_ids.nbytes
    fake.charge("gate_gt_attention", 4.0 * dh * h * pairs,
                2 * q.nbytes + k.nbytes + v.nbytes + bm.nbytes + seg)
    return o, bm
