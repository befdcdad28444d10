"""Fused gate-score + block-selection: plain PyTorch versions + CUDA kernels.

Replaces the TPU kernels ``repro/kernels/gate_select.py::fused_gate_select``
(one decode step, head-major Kg cache):

  qg       [B, Hkv, Dg]      post-rope gate query of the new token
  kg       [B, Hkv, nb, Dg]  head-major K-compression cache
  n_valid  [B] int32         number of currently visible blocks
  -> idx   [B, Hkv, k] int32 selected LOGICAL block ids, -1 padding

``gate_select_plain`` is the twin of the reference's ``gate_select_ref``
(fp32 scores -> visibility mask -> [softmax] -> ``select_blocks``): the
CPU execution path and the oracle the kernel is held against on the card.
``gate_select_cuda`` launches ``csrc/gate_select.cu`` (built by
``kernels/build.py``) on the current stream and counts its launches in
``gate_select_cuda.launches``: one CTA per (b, kv-head) scores the rows
with 16-byte loads and picks the top k by a radix select over
order-preserving keys, exact with the lower index first on ties.

and ``fused_gate_select_paged`` (the same selection over the paged Kg
pool, read through the page table):

  qg          [S, Hkv, Dg]   per-slot gate queries
  kg_pages    [P, Hkv, Dg]   one Kg row per physical page
  page_table  [S, npt] int32 logical block -> physical page
  n_valid     [S] int32
  -> idx      [S, Hkv, k] int32 LOGICAL ids, -1 padding; k from npt

``gate_select_paged_plain`` is the twin of ``gate_select_paged_ref``
(``paging.gather_kg`` then the contiguous plain version);
``gate_select_paged_cuda`` launches the paged entry point of the same
source and counts in ``gate_select_paged_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.config import GateConfig
from repro_torch.core import sparsity as sp
from repro_torch.kernels import build, fake
from repro_torch.models.common import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's limits (csrc/gate_select.cu kMaxBlocks, kMaxDg): its scores,
# survivor list and staged table row live in one CTA's shared memory
MAX_BLOCKS = 16384
MAX_DG = 1024


def n_selected(cfg: GateConfig, nb: int,
               max_selected: Optional[int] = None) -> int:
    """Static selected-list width: ``sparsity.resolve_max_selected`` plus
    select_blocks' per-method floor/cap (budget floor for the forced
    blocks, cap at nb)."""
    k = sp.resolve_max_selected(cfg, max_selected)
    if cfg.method == "budget":
        k = max(k, int(cfg.always_last_block) + int(cfg.always_first_block))
    elif cfg.method != "threshold":
        raise ValueError(cfg.method)
    return min(k, nb)


def gate_scores_plain(qg: torch.Tensor, kg: torch.Tensor, n_valid: torch.Tensor,
                      cfg: GateConfig) -> torch.Tensor:
    """The values selection ranks, [B, Hkv, nb] fp32: qg.Kg^T/sqrt(Dg) with
    blocks at or past n_valid masked, softmaxed for the threshold method."""
    dg = qg.shape[-1]
    scores = torch.einsum("bhd,bhnd->bhn", qg.to(torch.float32),
                          kg.to(torch.float32)) / math.sqrt(dg)
    nb = scores.shape[-1]
    ar = torch.arange(nb, device=scores.device)
    vmask = ar[None, None] < n_valid[:, None, None]
    scores = torch.where(vmask, scores, NEG_INF)
    if cfg.method == "threshold":
        scores = torch.softmax(scores, dim=-1)
    return scores


def gate_select_plain(qg: torch.Tensor, kg: torch.Tensor,
                      n_valid: torch.Tensor, cfg: GateConfig,
                      max_selected: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch gate scoring + ``select_blocks`` (any device)."""
    scores = gate_scores_plain(qg, kg, n_valid, cfg)
    idx, _ = sp.select_blocks(scores, n_valid, cfg, max_selected)
    return idx


def gate_select_paged_plain(qg: torch.Tensor, kg_pages: torch.Tensor,
                            page_table: torch.Tensor, n_valid: torch.Tensor,
                            cfg: GateConfig, max_selected: Optional[int] = None
                            ) -> torch.Tensor:
    """Plain PyTorch paged gate select (any device): the per-slot Kg
    gather through the page table, then the contiguous selection."""
    from repro_torch.serve.paging import gather_kg   # no kernels -> serve cycle
    return gate_select_plain(qg, gather_kg(kg_pages, page_table), n_valid,
                             cfg, max_selected)


def cta_threads() -> int:
    """Threads a CTA of the built kernel (its grid is B x Hkv CTAs)."""
    return int(build.load("gate_select").gate_select_cta_threads())


def _bind(lib: ctypes.CDLL, paged: bool = False):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if paged:
        fn = lib.gate_select_paged_launch
        types = [p, p, p, p, p, i, i, i, i, i, i, f, i, i, f, i, p]
    else:
        fn = lib.gate_select_launch
        types = [p, p, p, p, i, i, i, i, i, i, f, i, i, f, i, p]
    if fn.argtypes is None:
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return fn


def _check_q(name: str, qg: torch.Tensor, kg: torch.Tensor,
             n_valid: torch.Tensor) -> None:
    if not (qg.is_cuda and kg.device == qg.device and n_valid.device == qg.device):
        raise ValueError(f"{name}: qg, kg and n_valid must be on one CUDA device")
    if qg.dtype not in _DTYPES or kg.dtype != qg.dtype:
        raise TypeError(f"{name}: qg/kg must share dtype float32 or "
                        f"bfloat16, got {qg.dtype}/{kg.dtype}")
    if n_valid.dtype != torch.int32:
        raise TypeError(f"{name}: n_valid must be int32, got {n_valid.dtype}")


def _check_limits(name: str, nb: int, dg: int) -> None:
    if nb > MAX_BLOCKS or dg > MAX_DG:
        raise ValueError(f"{name}: {nb} blocks of Dg {dg} exceed the kernel's limits "
                         f"({MAX_BLOCKS} blocks, Dg {MAX_DG})")


def gate_select_cuda(qg: torch.Tensor, kg: torch.Tensor, n_valid: torch.Tensor,
                     cfg: GateConfig, max_selected: Optional[int] = None
                     ) -> torch.Tensor:
    """Launch the CUDA gate-select kernel; same result as the plain version
    (ids equal up to swaps of blocks whose fp32 scores tie to rounding;
    bitwise equal where the scores are exact). Takes nb <= ``MAX_BLOCKS``
    and Dg <= ``MAX_DG``; raises ValueError past them."""
    _check_q("gate_select_cuda", qg, kg, n_valid)
    b, hkv, dg = qg.shape
    if kg.dim() != 4 or kg.shape[:2] != (b, hkv) or kg.shape[3] != dg \
            or tuple(n_valid.shape) != (b,):
        raise ValueError(f"gate_select_cuda: shapes qg {tuple(qg.shape)}, "
                         f"kg {tuple(kg.shape)}, n_valid {tuple(n_valid.shape)}")
    if not (qg.is_contiguous() and kg.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("gate_select_cuda: inputs must be contiguous")
    nb = kg.shape[2]
    _check_limits("gate_select_cuda", nb, dg)
    k_sel = n_selected(cfg, nb, max_selected)
    out = torch.empty((b, hkv, k_sel), dtype=torch.int32, device=qg.device)
    lib = build.load("gate_select")
    rc = _bind(lib)(
        qg.data_ptr(), kg.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
        b, hkv, nb, dg, k_sel, int(cfg.method == "threshold"),
        float(cfg.threshold), int(cfg.always_first_block),
        int(cfg.always_last_block), 1.0 / math.sqrt(dg), _DTYPES[qg.dtype],
        torch.cuda.current_stream(qg.device).cuda_stream)
    build.check(lib, rc, "gate_select kernel launch")
    gate_select_cuda.launches += 1
    return out


gate_select_cuda.launches = 0


def gate_select_fake(qg: torch.Tensor, kg: torch.Tensor, n_valid: torch.Tensor,
                     cfg: GateConfig, max_selected: Optional[int] = None
                     ) -> torch.Tensor:
    """The dry-run's stand-in for ``gate_select_cuda`` on fake tensors: an
    unwritten id tensor of the kernel's shape and dtype, and one call
    charged to the open ``fake.KernelLedger`` with the bound's work,
    every Kg row visible (a full context; an upper bound on a shorter
    one): q, the Kg rows x Dg, n_valid and the ids; 2 x Dg operations a
    row."""
    b, hkv, dg = qg.shape
    nb = kg.shape[2]
    out = torch.empty((b, hkv, n_selected(cfg, nb, max_selected)), dtype=torch.int32,
                      device=qg.device)
    rows = b * hkv * nb
    fake.charge("gate_select", 2.0 * rows * dg,
                qg.nbytes + rows * dg * kg.element_size() + n_valid.nbytes + out.nbytes)
    return out


def gate_select_paged_cuda(qg: torch.Tensor, kg_pages: torch.Tensor,
                           page_table: torch.Tensor, n_valid: torch.Tensor,
                           cfg: GateConfig, max_selected: Optional[int] = None
                           ) -> torch.Tensor:
    """Launch the CUDA paged gate-select kernel; same result as
    ``gate_select_paged_plain`` (ids equal up to swaps of blocks whose
    fp32 scores tie to rounding; bitwise equal where the scores are exact).
    The list width comes from the page-table width ``npt``, which is at most
    ``MAX_BLOCKS`` (Dg at most ``MAX_DG``): ValueError past them."""
    _check_q("gate_select_paged_cuda", qg, kg_pages, n_valid)
    if page_table.device != qg.device or page_table.dtype != torch.int32:
        raise TypeError("gate_select_paged_cuda: page_table must be int32 on "
                        "qg's device")
    s, hkv, dg = qg.shape
    if kg_pages.dim() != 3 or kg_pages.shape[1:] != (hkv, dg) \
            or page_table.dim() != 2 or page_table.shape[0] != s \
            or tuple(n_valid.shape) != (s,):
        raise ValueError(f"gate_select_paged_cuda: shapes qg {tuple(qg.shape)}, "
                         f"kg_pages {tuple(kg_pages.shape)}, page_table "
                         f"{tuple(page_table.shape)}, n_valid {tuple(n_valid.shape)}")
    if not all(t.is_contiguous() for t in (qg, kg_pages, page_table, n_valid)):
        raise ValueError("gate_select_paged_cuda: inputs must be contiguous")
    npt = page_table.shape[1]
    _check_limits("gate_select_paged_cuda", npt, dg)
    k_sel = n_selected(cfg, npt, max_selected)
    out = torch.empty((s, hkv, k_sel), dtype=torch.int32, device=qg.device)
    lib = build.load("gate_select")
    rc = _bind(lib, paged=True)(
        qg.data_ptr(), kg_pages.data_ptr(), page_table.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), s, hkv, npt, dg, k_sel,
        int(cfg.method == "threshold"), float(cfg.threshold),
        int(cfg.always_first_block), int(cfg.always_last_block),
        1.0 / math.sqrt(dg), _DTYPES[qg.dtype],
        torch.cuda.current_stream(qg.device).cuda_stream)
    build.check(lib, rc, "gate_select_paged kernel launch")
    gate_select_paged_cuda.launches += 1
    return out


gate_select_paged_cuda.launches = 0
