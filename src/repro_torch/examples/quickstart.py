"""Quickstart: distill a SeerAttention-R gate into a tiny model, then run
sparse vs dense decoding and compare. PyTorch port of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

What it shows (the paper's full loop, at a small scale):
  1. pretrain a tiny GQA base LM on packed synthetic data (a stand-in for
     the released reasoning checkpoint; the paper plugs into Qwen3),
  2. self-distill the plug-in AttnGate on the FROZEN base (KL to the
     1D-maxpooled attention ground truth, emitted by the flash forward,
     the hand-written ``gate_gt_attention`` kernel on the card),
  3. serve with the block-sparse decode path under a token budget and
     compare tokens against dense attention, then decode with nucleus
     sampling drawn from a ``torch.Generator`` (JAX's PRNG stream cannot
     be shared; a fixed generator seed reproduces exactly).

Runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.config import ModelConfig, OptimConfig, TrainConfig, reduced
from repro_torch.core.policy import DecodeOptions, DensePolicy
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.train import loop as train_loop

SEQ, BATCH = 512, 4


def quickstart_config() -> ModelConfig:
    """The tiny Qwen3-style config (the paper's model family) with
    16-token gate blocks and a 192-token budget."""
    cfg = reduced(configs.get("qwen3_0_6b"))
    return cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=16, d_gate=16,
                                                token_budget=192))


def pretrain_config(steps: int) -> TrainConfig:
    return TrainConfig(mode="pretrain", seq_len=SEQ, global_batch=BATCH, steps=steps,
                       checkpoint_every=0, log_every=0,
                       optim=OptimConfig(lr=3e-3, total_steps=steps, warmup_steps=10,
                                         weight_decay=0.0))


def distill_config(steps: int) -> TrainConfig:
    return TrainConfig(mode="distill", seq_len=SEQ, global_batch=BATCH, steps=steps,
                       checkpoint_every=0, log_every=20,
                       optim=OptimConfig(lr=2e-3, total_steps=steps, warmup_steps=10))


def quickstart(cfg: Optional[ModelConfig] = None, *, pretrain_steps: int = 150,
               distill_steps: int = 120, pstate: Optional[train_loop.TrainState] = None,
               device=None, log=print) -> Dict[str, Any]:
    """The example's three stages. ``pstate`` is the pretraining state to
    start from (default: ``init_train_state`` from a generator seeded 0 on
    the device). Returns the pretrain CE and distill KL histories, the
    trained state, the sparse, dense and sampled tokens, their agreement
    and the sparse engine's measured ``sparsity_stats``."""
    device = resolve_device(device)
    cfg = cfg if cfg is not None else quickstart_config()
    log(f"arch={cfg.arch_id} layers={cfg.num_layers} d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} gate_block={cfg.gate.block_size}")

    # 1. pretrain the base so its attention has real (sparse) structure
    p_tcfg = pretrain_config(pretrain_steps)
    if pstate is None:
        pstate = train_loop.init_train_state(
            torch.Generator(device=device).manual_seed(0), cfg, p_tcfg)
    pstep = train_loop.make_train_step(cfg, p_tcfg)
    ce = []
    for i in range(pretrain_steps):
        pstate, pm = pstep(pstate, make_batch(cfg, BATCH, SEQ, DataState(11, i),
                                              device=device))
        ce.append(float(pm["ce"]))
    log(f"base pretrain CE after {pretrain_steps} steps: {ce[-1]:.3f}")

    # 2. distill the gate (only the gate's parameters train; the base is frozen)
    tcfg = distill_config(distill_steps)
    gate = train_loop.extract_gate(pstate.params)
    state = train_loop.TrainState(pstate.params, gate, adamw.init(gate, tcfg.optim),
                                  torch.zeros((), dtype=torch.int32, device=device))
    dstep = train_loop.make_train_step(cfg, tcfg)
    kl = []
    for i in range(distill_steps):
        state, m = dstep(state, make_batch(cfg, BATCH, SEQ, DataState(0, i), device=device))
        kl.append(float(m["kl"]))
    log(f"distill KL: {kl[0]:.4f} -> {kl[-1]:.4f}")

    # 3. serve: prefill 256 tokens, decode 32 more, sparse vs dense; the
    # default options are the paper's learned gate, DensePolicy the A/B
    batch = {"tokens": make_batch(cfg, 2, 256, DataState(9, 0), device=device)["tokens"]}
    n_new = 32
    eng_sp = DecodeEngine(cfg, state.params, max_len=512, device=device)
    eng_dn = DecodeEngine(cfg, state.params, max_len=512, device=device,
                          options=DecodeOptions(policy=DensePolicy()))
    out_sp = eng_sp.generate(batch, n_new)["tokens"]
    out_dn = eng_dn.generate(batch, n_new)["tokens"]
    agree = float((out_sp == out_dn).float().mean())
    log(f"sparse vs dense token agreement over {n_new} steps: {agree:.3f}")
    stats = eng_sp.sparsity_stats()        # measured over the decode above
    log(f"measured sparsity {stats['sparsity']:.3f} "
        f"(io_speedup {stats['io_speedup']:.2f}x, "
        f"mean selected blocks {stats['sel_blocks']:.1f})")
    if agree < 0.5:
        log("(low agreement = budget too tight for this tiny model; try a larger budget)")

    # 4. stochastic sampling: nucleus sampling rides in the same options
    # object; a fixed generator seed reproduces exactly
    eng_hot = DecodeEngine(cfg, state.params, max_len=512, device=device, options=DecodeOptions(
        sampling=SamplingParams(temperature=0.8, top_p=0.95)))
    out_hot = eng_hot.generate(batch, n_new,
                               generator=torch.Generator(device=device).manual_seed(7))["tokens"]
    div = float((out_hot != out_sp).float().mean())
    log(f"top-p sampled decode differs from greedy on {div:.0%} of tokens")
    return {"ce": ce, "kl": kl, "state": state, "sparse": out_sp, "dense": out_dn,
            "sampled": out_hot, "agreement": agree, "differs": div, "stats": stats}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    return quickstart(device=args.device)


if __name__ == "__main__":
    main()
