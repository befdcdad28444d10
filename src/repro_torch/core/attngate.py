"""SeerAttention-R AttnGate (decode and distillation), PyTorch port.

The gate predicts, for each new query token, a score per KV *block*:

  Q branch (eq. 1a): the ``g`` query heads of a GQA group are concatenated
    and reduced by a per-KV-head learned linear [g*d_head -> d_gate]; RoPE is
    re-applied (the gate consumes *pre-rope* Q).
  K branch (eq. 1b): keys are chunked into non-overlapping blocks of
    ``block_size``; max/min/avg pooling over each block are concatenated
    ([3*d_head]) and mapped by a per-KV-head linear to d_gate; RoPE uses the
    position of the first token of each block (``block_index*block_size``).

All functions are batch-first: Q [B, L, H, Dh], K [B, S, Hkv, Dh].
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.config import GateConfig
from repro_torch.models.common import _randn, apply_rope, torch_dtype

Params = Dict[str, Any]


def init_attngate(gen: torch.Generator, *, n_kv_heads: int, group: int,
                  head_dim: int, cfg: GateConfig, dtype="bfloat16") -> Params:
    """Per-layer gate parameters.

    wq: [Hkv, g*Dh, Dg]   (one set of weights per GQA group)
    wk: [Hkv, 3*Dh, Dg]   (K-branch linear after max/min/avg pool concat)
    """
    dg = cfg.d_gate
    sq = 1.0 / math.sqrt(group * head_dim)
    sk = 1.0 / math.sqrt(3 * head_dim)
    wq = _randn(gen, (n_kv_heads, group * head_dim, dg)) * sq
    wk = _randn(gen, (n_kv_heads, 3 * head_dim, dg)) * sk
    dt = torch_dtype(dtype)
    return {"wq": wq.to(dt), "wk": wk.to(dt)}


def gate_q(params: Params, q_nope: torch.Tensor, positions,
           cfg: GateConfig) -> torch.Tensor:
    """q_nope: [B, L, H, Dh] pre-rope queries -> Qg [B, L, Hkv, Dg]."""
    b, l, h, dh = q_nope.shape
    hkv = params["wq"].shape[0]
    g = h // hkv
    qr = q_nope.reshape(b, l, hkv, g * dh)
    qg = torch.einsum("blhe,hed->blhd", qr, params["wq"])
    if cfg.use_rope:
        qg = apply_rope(qg, positions, cfg.rope_theta)
    return qg


def pool_k_blocks(k_nope: torch.Tensor, block_size: int) -> torch.Tensor:
    """k_nope: [B, S, Hkv, Dh] (S divisible by block_size)
    -> pooled [B, nb, Hkv, 3*Dh] = concat(max, min, avg) over each block.
    Max and min stay in the working dtype; the mean is taken in fp32 and
    cast back."""
    b, s, hkv, dh = k_nope.shape
    nb = s // block_size
    kb = k_nope.reshape(b, nb, block_size, hkv, dh)
    kmax = torch.amax(kb, dim=2)
    kmin = torch.amin(kb, dim=2)
    kavg = torch.mean(kb.to(torch.float32), dim=2).to(k_nope.dtype)
    return torch.cat([kmax, kmin, kavg], dim=-1)


def gate_k(params: Params, k_nope: torch.Tensor, cfg: GateConfig,
           first_block_index=0) -> torch.Tensor:
    """k_nope: [B, S, Hkv, Dh] -> Kg [B, nb, Hkv, Dg].

    ``first_block_index`` offsets the RoPE positions: an int for the whole
    batch, or a [B] tensor, one offset per row (the decode-time finalize of
    one block per row, batched in place of the reference's vmap).
    """
    pooled = pool_k_blocks(k_nope, cfg.block_size)       # [B, nb, Hkv, 3Dh]
    # mixed inputs (fp32 keys dequantized from int8 pools, bf16 weights)
    # promote as jnp.einsum promotes them; equal dtypes are left as they are
    dt = torch.promote_types(pooled.dtype, params["wk"].dtype)
    kg = torch.einsum("bnhe,hed->bnhd", pooled.to(dt), params["wk"].to(dt))
    if cfg.use_rope:
        nb = kg.shape[1]
        ar = torch.arange(nb, device=kg.device)
        if isinstance(first_block_index, torch.Tensor):
            pos = (first_block_index[:, None] + ar[None, :]) * cfg.block_size
        else:
            pos = (first_block_index + ar) * cfg.block_size
        kg = apply_rope(kg, pos, cfg.rope_theta)
    return kg


def gate_logits(qg: torch.Tensor, kg: torch.Tensor) -> torch.Tensor:
    """Qg [B, L, Hkv, Dg] x Kg [B, nb, Hkv, Dg] -> [B, Hkv, L, nb] (fp32)."""
    dg = qg.shape[-1]
    return torch.einsum("blhd,bnhd->bhln", qg.to(torch.float32),
                        kg.to(torch.float32)) / math.sqrt(dg)


def block_causal_mask(q_positions: torch.Tensor, n_blocks: int,
                      block_size: int) -> torch.Tensor:
    """[L, nb] True where block ``j`` contains any position <= q position.

    A block is visible once its FIRST token is in the past (the trailing
    partial block is handled by force-selecting the last block, §3.2).
    """
    starts = torch.arange(n_blocks, device=q_positions.device) * block_size
    return q_positions[:, None] >= starts[None, :]
