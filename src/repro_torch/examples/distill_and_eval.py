"""End-to-end gate distillation (the paper's training recipe) with
checkpoint/restart, followed by gate-quality evaluation against Quest.
PyTorch port of ``examples/distill_and_eval.py``.

    PYTHONPATH=src python -m repro_torch.examples.distill_and_eval \\
        [--size small|medium|100m] [--steps 200] [--resume] [--device cpu]

The recipe is the paper's (§4.1) at a configurable scale: pack sequences,
emit ground truth from the flash forward (the hand-written
``gate_gt_attention`` kernel on the card), train ONLY the AttnGate with
KL (AdamW, lr 1e-3, cosine), base weights frozen. Checkpoints go to
``repro_distill_<size>_torch`` under the temporary directory, one every
50 steps; the loop restores the latest one there when a step fails.
Without ``--resume`` the directory is cleared first; with it its
checkpoints are kept, as the reference's flag keeps them. Runs on the
CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import ModelConfig, OptimConfig, TrainConfig, reduced
from repro_torch.core import sparsity as sp
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import loop as train_loop

SIZES = {
    # (d_model, layers, heads, kv, d_ff, vocab, seq, batch); "100m" is a
    # ~100M-parameter model: 8*512*... + 2*51200*512 emb ~= 95M
    "small": (64, 2, 4, 2, 128, 256, 512, 4),
    "medium": (256, 4, 8, 4, 512, 8192, 512, 4),
    "100m": (512, 8, 8, 4, 1536, 51200, 512, 2),
}


def build_cfg(size: str) -> Tuple[ModelConfig, int, int]:
    """(config, sequence length, batch) of a SIZES entry."""
    d, nl, h, kv, ff, v, seq, bsz = SIZES[size]
    cfg = reduced(configs.get("qwen3_0_6b"), num_layers=nl, d_model=d, n_heads=h,
                  n_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab_size=v, q_chunk=256)
    cfg = cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=16, d_gate=32,
                                               token_budget=128))
    return cfg, seq, bsz


def default_ckpt_dir(size: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"repro_distill_{size}_torch")


# ---------------------------------------------------------------------------
# gate-quality evaluation (the benchmark harness's helpers, kept here)
# ---------------------------------------------------------------------------

def quest_scores_rows(qr: torch.Tensor, kr: torch.Tensor, block_size: int
                      ) -> torch.Tensor:
    """Group-shared Quest upper-bound scores for every query row.

    qr [B, L, H, Dh], kr [B, S, Hkv, Dh] (post-rope) -> [B, Hkv, L, nb];
    a leading layer axis on both is kept."""
    if qr.dim() == 5:
        return torch.stack([quest_scores_rows(a, b, block_size)
                            for a, b in zip(qr, kr)])
    b, l, h, dh = qr.shape
    s, hkv = kr.shape[1], kr.shape[2]
    g = h // hkv
    nb = s // block_size
    kb = kr.reshape(b, nb, block_size, hkv, dh).to(torch.float32)
    kmin, kmax = kb.amin(dim=2), kb.amax(dim=2)
    qf = qr.reshape(b, l, hkv, g, dh).to(torch.float32)
    ub = (torch.einsum("blhgd,bnhd->bhlgn", torch.clamp_min(qf, 0), kmax)
          + torch.einsum("blhgd,bnhd->bhlgn", torch.clamp_max(qf, 0), kmin))
    return ub.amax(dim=3)


def recall_at(scores: torch.Tensor, gt: torch.Tensor, k: int, rows: np.ndarray) -> float:
    """Mean over (layer, batch, head, row in ``rows``) of the ground-truth
    mass captured by the top-k blocks of ``scores`` (scores/gt [L?, B,
    Hkv, Lq, nb]); ties rank the lower block index first, as
    ``jax.lax.top_k`` does."""
    rows = torch.as_tensor(rows, device=scores.device)
    sc = scores[..., rows, :].to(torch.float32)
    g = gt[..., rows, :].to(torch.float32)
    _, idx = sp.ranked_top_k(sc, min(k, sc.shape[-1]))
    return float(torch.take_along_dim(g, idx, dim=-1).sum(-1).mean())


def gate_recalls(cfg: ModelConfig, ex: Dict[str, torch.Tensor], seq: int
                 ) -> Dict[int, Dict[str, float]]:
    """Token budget -> {"gate", "quest", "oracle"} recall over the rows of
    the second half of the sequence (every 8th), from ``lm_gate_collect``'s
    output ``ex``."""
    rows = np.arange(seq // 2, seq, 8)
    bs = cfg.gate.block_size
    nb = seq // bs
    q_sh = quest_scores_rows(ex["qr"], ex["kr"], bs)
    out = {}
    for k in (nb // 16, nb // 8, nb // 4):
        k = max(1, k)
        out[k * bs] = {"gate": recall_at(ex["glog"], ex["gt"], k, rows),
                       "quest": recall_at(q_sh, ex["gt"], k, rows),
                       "oracle": recall_at(ex["gt"], ex["gt"], k, rows)}
    return out


def distill_and_eval(size: str = "small", *, steps: int = 200, resume: bool = False,
                     ckpt_dir=None, device=None, log=print) -> Dict[str, Any]:
    """Distil the gate of SIZES[size] for ``steps`` steps through
    ``run_training`` (a checkpoint every 50; ``resume`` keeps the
    directory's checkpoints, otherwise it is cleared), then evaluate the
    gate's recall. Returns the state, the history, the parameter counts
    and the recalls by token budget."""
    device = resolve_device(device)
    cfg, seq, bsz = build_cfg(size)
    tcfg = TrainConfig(mode="distill", seq_len=seq, global_batch=bsz, steps=steps,
                       checkpoint_every=50, log_every=10,
                       checkpoint_dir=ckpt_dir or default_ckpt_dir(size),
                       optim=OptimConfig(lr=1e-3, total_steps=steps, warmup_steps=20))
    if not resume:
        shutil.rmtree(tcfg.checkpoint_dir, ignore_errors=True)
    state, hist = train_loop.run_training(cfg, tcfg, device=device, log=log)
    n_params = sum(t.numel() for _, t in train_loop._walk(state.params))
    n_gate = sum(t.numel() for t in state.gate.values())
    log(f"\nmodel {n_params / 1e6:.1f}M params; gate {n_gate / 1e3:.1f}K "
        f"({100 * n_gate / n_params:.3f}% — the paper's 'lightweight plug-in')")
    log(f"distill KL: {hist[0]['kl']:.4f} -> {hist[-1]['kl']:.4f}")

    # gate-quality eval: recall of the true attention block mass vs Quest
    ex = tf.lm_gate_collect(state.params, make_batch(cfg, 2, seq, DataState(99, 0),
                                                     device=device), cfg)
    recalls = gate_recalls(cfg, ex, seq)
    for budget, r in recalls.items():
        log(f"budget {budget:4d} tok: gate recall {r['gate']:.4f}  "
            f"quest {r['quest']:.4f}  oracle {r['oracle']:.4f}")
    return {"state": state, "history": hist, "n_params": n_params, "n_gate": n_gate,
            "recalls": recalls, "checkpoint_dir": tcfg.checkpoint_dir}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    return distill_and_eval(args.size, steps=args.steps, resume=args.resume,
                            device=args.device)


if __name__ == "__main__":
    main()
