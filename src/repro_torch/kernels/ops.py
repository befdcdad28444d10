"""Device-dispatching entry points over the port's kernels.

Models call these. The device of the tensors decides the path, and
nothing else does:

  * a ``FakeTensor`` (the dry-run's, ``launch/dryrun.py``), on any
    device, takes the kernel's ``*_fake`` stand-in: outputs of the CUDA
    wrapper's shapes and dtypes, the call charged to the open
    ``kernels.fake.KernelLedger``. Kernels #1, #2 (fp) and #6 have one,
    the kernels the dry-run's cells reach; the six others raise
    NotImplementedError on a fake tensor;
  * a CPU tensor takes the plain PyTorch version;
  * a CUDA tensor launches the hand-written CUDA kernel, or raises (a
    build or launch error propagates; nothing falls back to the plain
    version).

``launch_counts()``/``reset_launch_counts()`` read and clear each CUDA
wrapper's launch counter, so a run can show that its path went through
the kernels; a fake call counts nothing there.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import block_sparse_decode as bsd
from repro_torch.kernels import gate_gt_fwd as gt
from repro_torch.kernels import gate_select as gs

KERNELS = {"gate_select": gs.gate_select_cuda,
           "block_sparse_decode": bsd.sparse_decode_cuda,
           "gate_select_paged": gs.gate_select_paged_cuda,
           "block_sparse_decode_paged": bsd.sparse_decode_paged_cuda,
           "block_sparse_decode_quant": bsd.sparse_decode_quant_cuda,
           "block_sparse_decode_paged_quant": bsd.sparse_decode_paged_quant_cuda,
           "block_sparse_decode_paged_splitk": bsd.sparse_decode_paged_splitk_cuda,
           "block_sparse_decode_paged_splitk_quant": bsd.sparse_decode_paged_splitk_quant_cuda,
           "gate_gt_attention": gt.gate_gt_attention_cuda}


def _route(t: torch.Tensor, name: str) -> str:
    """"fake" for the dry-run's stand-in, "cuda" for the CUDA kernel,
    "plain" for the plain version."""
    if isinstance(t, FakeTensor):
        return "fake"
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _no_fake(name: str) -> None:
    raise NotImplementedError(f"{name}: no fake stand-in for this kernel (the dry-run's "
                              "cells reach gate_select, the fp block_sparse_decode and "
                              "gate_gt_attention only)")


def gate_select(qg: torch.Tensor, kg: torch.Tensor, n_valid: torch.Tensor,
                cfg, max_selected: Optional[int] = None) -> torch.Tensor:
    """Fused gate scoring + discrete block selection for ONE decode step.

    qg [B,Hkv,Dg] post-rope gate queries; kg [B,Hkv,nb,Dg] HEAD-MAJOR
    K-compression cache; n_valid [B] int32 visible blocks. Returns logical
    block ids [B,Hkv,k] int32 with -1 padding."""
    route = _route(qg, "gate_select")
    if route == "fake":
        return gs.gate_select_fake(qg, kg, n_valid, cfg, max_selected)
    if route == "cuda":
        return gs.gate_select_cuda(qg, kg, n_valid, cfg, max_selected)
    return gs.gate_select_plain(qg, kg, n_valid, cfg, max_selected)


def sparse_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  block_indices: torch.Tensor, kv_len: torch.Tensor, *,
                  block_size: int, k_scales: Optional[torch.Tensor] = None,
                  v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-sparse decode attention; caches HEAD-MAJOR [B, Hkv, S, Dh].
    ``k_scales``/``v_scales`` [B, Hkv, nb] f32 dequantize int8 caches inside
    the block loop (None = the fp kernel)."""
    route = _route(q, "sparse_decode")
    if route == "fake":
        if k_scales is not None:
            _no_fake("block_sparse_decode_quant")
        return bsd.sparse_decode_fake(q, k_cache, v_cache, block_indices, kv_len,
                                      block_size=block_size)
    if route == "cuda":
        if k_scales is not None:
            return bsd.sparse_decode_quant_cuda(q, k_cache, v_cache, block_indices,
                                                kv_len, block_size=block_size,
                                                k_scales=k_scales, v_scales=v_scales)
        return bsd.sparse_decode_cuda(q, k_cache, v_cache, block_indices,
                                      kv_len, block_size=block_size)
    return bsd.sparse_decode_plain(q, k_cache, v_cache, block_indices, kv_len,
                                   block_size=block_size, k_scales=k_scales,
                                   v_scales=v_scales)


def gate_select_paged(qg: torch.Tensor, kg_pages: torch.Tensor,
                      page_table: torch.Tensor, n_valid: torch.Tensor, cfg,
                      max_selected: Optional[int] = None) -> torch.Tensor:
    """Paged gate select: one layer's Kg pool [P,Hkv,Dg] scored through the
    page table [S,npt]; qg [S,Hkv,Dg]. Returns logical ids [S,Hkv,k]."""
    route = _route(qg, "gate_select_paged")
    if route == "fake":
        _no_fake("gate_select_paged")
    if route == "cuda":
        return gs.gate_select_paged_cuda(qg, kg_pages, page_table, n_valid,
                                         cfg, max_selected)
    return gs.gate_select_paged_plain(qg, kg_pages, page_table, n_valid, cfg,
                                      max_selected)


def paged_sparse_decode(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_indices: torch.Tensor,
                        page_table: torch.Tensor, kv_len: torch.Tensor, *,
                        block_size: int, k_scales: Optional[torch.Tensor] = None,
                        v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-sparse decode over the page pools [P,Hkv,ps,Dh]; logical
    block ids, physical pages through ``page_table`` [B,npt].
    ``k_scales``/``v_scales`` [P,Hkv,1] f32 dequantize int8 pools at each
    block's physical page (None = the fp kernel)."""
    route = _route(q, "paged_sparse_decode")
    if route == "fake":
        _no_fake("block_sparse_decode_paged_quant" if k_scales is not None
                 else "block_sparse_decode_paged")
    if route == "cuda":
        if k_scales is not None:
            return bsd.sparse_decode_paged_quant_cuda(
                q, k_pages, v_pages, block_indices, page_table, kv_len,
                block_size=block_size, k_scales=k_scales, v_scales=v_scales)
        return bsd.sparse_decode_paged_cuda(q, k_pages, v_pages, block_indices,
                                            page_table, kv_len,
                                            block_size=block_size)
    return bsd.sparse_decode_paged_plain(q, k_pages, v_pages, block_indices,
                                         page_table, kv_len,
                                         block_size=block_size, k_scales=k_scales,
                                         v_scales=v_scales)


def paged_sparse_decode_splitk(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, block_indices: torch.Tensor,
                               page_table: torch.Tensor, kv_len: torch.Tensor, *,
                               block_size: int, num_splits: int,
                               k_scales: Optional[torch.Tensor] = None,
                               v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Split-K block-sparse decode over the page pools: the selected list
    cut into ``num_splits`` segments, each a flash partial, merged by the
    two-pass rescale. ``num_splits <= 1`` is ``paged_sparse_decode``, as in
    the reference. ``k_scales``/``v_scales`` as ``paged_sparse_decode``."""
    if num_splits <= 1:
        return paged_sparse_decode(q, k_pages, v_pages, block_indices, page_table, kv_len,
                                   block_size=block_size, k_scales=k_scales,
                                   v_scales=v_scales)
    route = _route(q, "paged_sparse_decode_splitk")
    if route == "fake":
        _no_fake("block_sparse_decode_paged_splitk_quant" if k_scales is not None
                 else "block_sparse_decode_paged_splitk")
    if route == "cuda":
        if k_scales is not None:
            return bsd.sparse_decode_paged_splitk_quant_cuda(
                q, k_pages, v_pages, block_indices, page_table, kv_len,
                block_size=block_size, num_splits=num_splits, k_scales=k_scales,
                v_scales=v_scales)
        return bsd.sparse_decode_paged_splitk_cuda(
            q, k_pages, v_pages, block_indices, page_table, kv_len, block_size=block_size,
            num_splits=num_splits)
    return bsd.sparse_decode_paged_splitk_plain(
        q, k_pages, v_pages, block_indices, page_table, kv_len, block_size=block_size,
        num_splits=num_splits, k_scales=k_scales, v_scales=v_scales)


def gate_gt_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      block_size: int, q_chunk: int = 256,
                      segment_ids: Optional[torch.Tensor] = None,
                      logit_softcap: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward + distillation blockmax: q [B,L,H,Dh], k/v
    [B,L,Hkv,Dh], optional packed ``segment_ids`` [B,L] -> (o [B,L,H,Dh],
    blockmax [B,H,L,Lk//block_size] fp32). ``q_chunk`` bounds the plain
    version's score tensor; the kernel tiles on its own. There is no
    backward, in the reference either: an input that requires grad
    raises."""
    if k.shape[1] % block_size:
        raise ValueError(f"gate_gt_attention: Lk {k.shape[1]} is not a multiple of the "
                         f"block size {block_size}")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("gate_gt_attention has no backward: call it on "
                                  "tensors that do not require grad")
    route = _route(q, "gate_gt_attention")
    if route != "plain":
        seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
        fn = gt.gate_gt_attention_fake if route == "fake" else gt.gate_gt_attention_cuda
        return fn(q.contiguous(), k.contiguous(), v.contiguous(), block_size=block_size,
                  segment_ids=seg, logit_softcap=logit_softcap)
    return gt.gate_gt_attention_plain(q, k, v, block_size=block_size, q_chunk=q_chunk,
                                      segment_ids=segment_ids, logit_softcap=logit_softcap)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
