"""Sparse-decode serving launcher (PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \\
        [--reduced] [--batch 4] [--prefill 256] [--new 64] [--budget 128] \\
        [--method budget|threshold] [--dense] \\
        [--policy gate|quest|quest_recompute|oracle|sliding_window] \\
        [--device cpu]

Runs prefill + autoregressive decode through the SeerAttention-R engine
(KV cache + K-compression cache + selection policy + block-sparse
attention) and reports throughput and MEASURED achieved sparsity.
``--policy`` swaps the block-selection strategy (``core.policy``);
``--dense`` disables selection entirely for an A/B reference. The weights
are random, from seed 0 on the device. Runs on the CUDA device unless
``--device`` names another; with no card and no ``--device`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict

import torch

from repro_torch import configs
from repro_torch.config import ModelConfig, reduced
from repro_torch.core.policy import DecodeOptions, DensePolicy, get_policy
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import DecodeEngine


def launch_config(arch: str, *, reduced_scale: bool = False, budget=None,
                  method=None) -> ModelConfig:
    """The launcher's config: ``arch``, optionally ``reduced()``, with the
    gate's token budget and method overridden where given."""
    cfg = configs.get(arch)
    if reduced_scale:
        cfg = reduced(cfg)
    gate_kw = {}
    if budget is not None:
        gate_kw["token_budget"] = budget
    if method:
        gate_kw["method"] = method
    if gate_kw:
        cfg = cfg.replace(gate=dataclasses.replace(cfg.gate, **gate_kw))
    return cfg


def launch_batch(cfg: ModelConfig, batch: int, prefill: int, device) -> Dict[str, Any]:
    """The launcher's prompts: ``make_batch``'s tokens at DataState(1, 0);
    a vision model gets zero image embeddings, as the reference's does."""
    out = {"tokens": make_batch(cfg, batch, prefill, DataState(1, 0),
                                device=device)["tokens"]}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.zeros((batch, cfg.n_image_tokens, cfg.d_model),
                                          dtype=getattr(torch, cfg.dtype), device=device)
    return out


def serve_generate(cfg: ModelConfig, params: Any, batch: Dict[str, Any], *, new: int,
                   policy: str = "gate", dense: bool = False, device=None
                   ) -> Dict[str, Any]:
    """One ``DecodeEngine.generate`` of ``new`` tokens over ``batch`` ->
    the numbers the launcher prints: ``policy`` (the one that ran),
    ``prefill_ms``, ``decode_ms``, ``tok_per_s``, and for a sparse run the
    measured ``sparsity`` and ``io_speedup`` of the last step; plus the
    generated ``tokens`` [B, new]."""
    pol = get_policy(policy)
    # non-gate policies (quest/oracle/sliding_window) run without a
    # distilled gate; only GatePolicy needs cfg.gate.enabled
    sparse = (not dense) and cfg.has_attention and cfg.is_decoder \
        and (cfg.gate.enabled or not pol.needs_gate)
    opts = DecodeOptions(policy=pol if sparse else DensePolicy())
    max_len = batch["tokens"].shape[1] + new + 16
    eng = DecodeEngine(cfg, params, max_len=max_len, options=opts, device=device)
    res = eng.generate(batch, new)
    out = {"policy": policy if sparse else "dense",
           "prefill_ms": res["prefill_s"] * 1e3, "decode_ms": res["decode_s"] * 1e3,
           "tok_per_s": res["tok_per_s"], "tokens": res["tokens"]}
    if sparse:
        stats = eng.sparsity_stats()      # measured over the decode above
        out["sparsity"] = stats["sparsity"]
        out["io_speedup"] = stats["io_speedup"]
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=256)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--method", default=None, choices=[None, "budget", "threshold"])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--policy", default="gate",
                    choices=["gate", "quest", "quest_recompute", "oracle",
                             "sliding_window"])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = launch_config(args.arch, reduced_scale=args.reduced, budget=args.budget,
                        method=args.method)
    params = get_api(cfg).init_params(torch.Generator(device=device).manual_seed(0), cfg)
    batch = launch_batch(cfg, args.batch, args.prefill, device)
    res = serve_generate(cfg, params, batch, new=args.new, policy=args.policy,
                         dense=args.dense, device=device)
    print(f"arch={cfg.arch_id} policy={res['policy']} device={device}")
    print(f"prefill: {res['prefill_ms']:.1f} ms | decode: {res['decode_ms']:.1f} ms | "
          f"{res['tok_per_s']:.1f} tok/s")
    if "sparsity" in res:
        print(f"sparsity={res['sparsity']:.3f} io_speedup={res['io_speedup']:.2f}x")
    return res


if __name__ == "__main__":
    main()
