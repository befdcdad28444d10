"""Self-distillation of the AttnGate (paper §2.3), PyTorch port.

Ground truth: column-blockwise 1D max-pool of the true attention map,
max-pooled again across each GQA group, renormalised to sum 1; loss = KL.

For a softmax row p = softmax(s), the max over a block of columns J is
exp(max_{j in J} s_j - m) / l, so after renormalising over blocks the
ground truth is the softmax over blocks of the per-block row-max logits.
The attention forward therefore only emits ``blockmax`` [B, H, Lq, nb]
(``kernels/ops.gate_gt_attention``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import NEG_INF


def ground_truth_from_blockmax(blockmax: torch.Tensor, group: int) -> torch.Tensor:
    """blockmax: [B, H, Lq, nb] masked block row-max logits (NEG_INF where a
    block is entirely masked). Returns the GT distribution [B, Hkv, Lq, nb]
    (fp32, rows sum to 1 over visible blocks)."""
    b, h, lq, nb = blockmax.shape
    hkv = h // group
    # max-pool across the GQA group (shared sparsity target, §2.3)
    gm = torch.amax(blockmax.reshape(b, hkv, group, lq, nb), dim=2)
    return torch.softmax(gm, dim=-1)


def gate_kl_loss(gate_logits: torch.Tensor, gt: torch.Tensor,
                 valid_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(gt || softmax(gate_logits)) averaged over valid (b, hkv, row).

    gate_logits: [B, Hkv, Lq, nb] *masked* logits (NEG_INF on future blocks).
    gt:          [B, Hkv, Lq, nb] probabilities.
    valid_rows:  [B, Lq] optional mask (e.g. padded packing slots).
    """
    logp = torch.log_softmax(gate_logits.to(torch.float32), dim=-1)
    # avoid 0 * (-inf): where gt == 0 the contribution is 0
    pos = gt > 0
    safe_loggt = torch.where(pos, torch.log(torch.clamp_min(gt, 1e-30)), 0.0)
    kl = torch.sum(torch.where(pos, gt * (safe_loggt - logp), 0.0), dim=-1)
    if valid_rows is not None:
        w = valid_rows[:, None, :].to(torch.float32)
        return torch.sum(kl * w) / torch.clamp_min(torch.sum(w) * kl.shape[1], 1.0)
    return torch.mean(kl)


def mask_blockmax_causal(blockmax: torch.Tensor, q_positions: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """Ensure blocks whose first token is in the future are NEG_INF."""
    nb = blockmax.shape[-1]
    starts = torch.arange(nb, device=blockmax.device) * block_size
    mask = q_positions[:, None] >= starts[None, :]
    return torch.where(mask[None, None], blockmax, NEG_INF)
