"""Attention layer-core helpers shared by the decode paths (port slice).

The QKV projection, the policy gate and the decode-aux telemetry of the
JAX package's ``models/attn_core.py``. The paged per-layer body arrives
with the paged slice.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kcache as kc
from repro_torch.core import sparsity as sp
from repro_torch.models.common import linear, rms_norm

Params = Dict[str, Any]
LayerAux = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, l, _ = x.shape
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, l, cfg.n_heads, dh)
    k = linear(p["wk"], x).reshape(b, l, cfg.n_kv_heads, dh)
    v = linear(p["wv"], x).reshape(b, l, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _policy_active(policy, p: Params) -> bool:
    """Sparse selection runs unless the policy is dense or requires a gate
    the layer doesn't carry (then dense decode)."""
    return (not policy.dense) and (("gate" in p) or not policy.needs_gate)


def _selection_aux(idx: torch.Tensor, n_valid: torch.Tensor, nb: int) -> LayerAux:
    """Measured per-layer selection telemetry from the ACTUAL selected
    block ids: (sparsity scalar, per-row sparsity [B], mean selected
    blocks [B], visible blocks [B])."""
    b, hkv, _ = idx.shape
    cnt = torch.zeros((b, hkv, nb), dtype=torch.int32, device=idx.device)
    cnt.scatter_add_(2, torch.clamp_min(idx, 0).to(torch.int64),
                     (idx >= 0).to(torch.int32))
    sel_mask = cnt > 0
    rho = sp.sparsity_ratio(sel_mask, n_valid)
    sel_counts = torch.sum(sel_mask, dim=-1).to(torch.float32)     # [B,Hkv]
    tot = torch.clamp_min(n_valid.to(torch.float32), 1.0)
    rho_rows = 1.0 - torch.mean(sel_counts / tot[:, None], dim=1)
    return rho, rho_rows, torch.mean(sel_counts, dim=1), n_valid.to(torch.float32)


def _dense_aux(new_len: torch.Tensor, block_size: int) -> LayerAux:
    """Dense decode reads every visible block: sparsity 0 by definition."""
    nv = kc.visible_blocks(torch.clamp_min(new_len, 1), block_size).to(torch.float32)
    return (torch.zeros((), dtype=torch.float32, device=nv.device),
            torch.zeros_like(nv), nv, nv)


def _zero_layer_aux(batch: int, device) -> LayerAux:
    """Per-layer aux when telemetry is off (measure_sparsity=False)."""
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return torch.zeros((), dtype=torch.float32, device=device), z, z, z


def aggregate_decode_aux(auxs: Sequence[LayerAux]) -> Dict[str, torch.Tensor]:
    """Per-layer (rho, rho_rows [B], sel [B], vis [B]) tuples -> the
    decode-step aux dict, averaged over layers."""
    rho, rho_rows, sel, vis = (torch.stack(list(x)) for x in zip(*auxs))
    return {"sparsity": torch.mean(rho),
            "sparsity_rows": torch.mean(rho_rows, dim=0),
            "sel_blocks": torch.mean(sel, dim=0),
            "vis_blocks": torch.mean(vis, dim=0)}
