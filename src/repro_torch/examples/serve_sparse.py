"""Serve a small model with batched requests through the sparse decode
engine: the paper's deployment scenario (long decoding of reasoning
models) end to end. PyTorch port of ``examples/serve_sparse.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_sparse \\
        [--arch qwen3_0_6b] [--budget 128] [--method budget|threshold] \\
        [--batch 4] [--new 64] [--policy gate|quest|oracle|sliding_window] \\
        [--temperature 0] [--top-p 1.0] [--paged] [--admission lazy|reserve] \\
        [--pool-pages N] [--eviction] [--quantize int8] [--device cpu]

Default: one uniform batch through ``DecodeEngine.generate``. With
``--paged``, ragged requests (mixed prompt lengths and decode budgets) go
through the continuous-batching paged-KV path (``DecodeEngine.serve``):
iteration-level admission into decode slots, per-request page tables over
a shared page pool, and the gate's K-compression cache paged alongside
the raw KV, plus a per-request override (request 0 runs at half the
token budget, applied as a run-time mask). ``--policy`` swaps the
selection strategy and ``--temperature``/``--top-p`` switch greedy to
stochastic sampling, drawn from a ``torch.Generator`` seeded 0 (it cannot
share JAX's PRNG stream). The model is the arch's ``reduced()`` config
with 16-token gate blocks and random weights from seed 0. Runs on the
CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import ModelConfig, reduced
from repro_torch.core.policy import DecodeOptions, get_policy
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig
from repro_torch.serve.sampling import SamplingParams


def example_config(arch: str = "qwen3_0_6b", *, budget: int = 128, method: str = "budget",
                   threshold: float = 4e-3) -> ModelConfig:
    """The arch's ``reduced()`` config with the example's gate: 16-token
    blocks, d_gate 16, the given method, budget and threshold. An arch
    with no decode gate raises SystemExit."""
    cfg = reduced(configs.get(arch))
    if not (cfg.gate.enabled and cfg.has_attention and cfg.is_decoder):
        raise SystemExit(f"{arch}: no decode gate (family {cfg.family}) "
                         "— pick a gated arch for this example")
    return cfg.replace(gate=dataclasses.replace(
        cfg.gate, block_size=16, d_gate=16, method=method, token_budget=budget,
        threshold=threshold))


def ragged_requests(cfg: ModelConfig, n: int, prefill: int, new: int,
                    budget: int) -> List[Dict[str, Any]]:
    """``n`` requests of prompt lengths in [prefill/4, prefill] and decode
    budgets in [new/4, new] from ``np.random.default_rng(3)``; request 0
    carries half the token budget as its per-request override."""
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(max(prefill // 4, 1), prefill + 1))
        mn = int(rng.integers(max(new // 4, 1), new + 1))
        reqs.append({"rid": i, "max_new_tokens": mn,
                     "tokens": rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int32)})
    reqs[0]["budget"] = max(cfg.gate.block_size, budget // 2)
    return reqs


def run_generate(cfg: ModelConfig, params: Any, *, batch: int, prefill: int, new: int,
                 options: DecodeOptions, device=None) -> Dict[str, Any]:
    """One uniform batch (``make_batch`` at DataState(3, 0)) through
    ``generate``: the result (tokens, prefill_s, decode_s, tok_per_s),
    the wall time and the engine's measured ``sparsity_stats``."""
    device = resolve_device(device)
    toks = make_batch(cfg, batch, prefill, DataState(3, 0), device=device)["tokens"]
    eng = DecodeEngine(cfg, params, max_len=prefill + new + 16, options=options,
                       device=device)
    gen = (None if options.sampling.greedy
           else torch.Generator(device=device).manual_seed(0))
    t0 = time.perf_counter()
    res = eng.generate({"tokens": toks}, new, generator=gen)
    wall = time.perf_counter() - t0
    return {**res, "wall_s": wall, "stats": eng.sparsity_stats()}


def run_paged(cfg: ModelConfig, params: Any, reqs: List[Dict[str, Any]], *,
              max_len: int, options: DecodeOptions, n_slots: int,
              pool_pages: Optional[int] = None, admission: str = "lazy",
              eviction: bool = False, device=None) -> Dict[str, Any]:
    """``reqs`` through ``serve`` (continuous batching over the page pool;
    ``eviction`` turns on RaaS page eviction with its defaults): the
    ServeResult, with the wall time under ``"wall_s"``."""
    eng = DecodeEngine(cfg, params, max_len=max_len, options=options, device=device)
    t0 = time.perf_counter()
    res = eng.serve([dict(r) for r in reqs], n_slots=n_slots, num_pages=pool_pages,
                    admission=admission, eviction=EvictionConfig() if eviction else None)
    res["wall_s"] = time.perf_counter() - t0
    return res


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--budget", type=int, default=128)
    ap.add_argument("--method", default="budget", choices=["budget", "threshold"])
    ap.add_argument("--threshold", type=float, default=4e-3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill", type=int, default=256)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--policy", default="gate",
                    choices=["gate", "quest", "quest_recompute", "oracle",
                             "sliding_window"],
                    help="block-selection policy (core.policy); 'quest' runs off the "
                         "incremental metadata cache, 'quest_recompute' is the O(S) "
                         "reference")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 enables stochastic sampling")
    ap.add_argument("--top-p", type=float, default=1.0, dest="top_p")
    ap.add_argument("--paged", action="store_true",
                    help="ragged requests through the continuous-batching paged-KV "
                         "engine (serve) instead of one uniform batch (generate)")
    ap.add_argument("--admission", default="lazy", choices=["lazy", "reserve"],
                    help="paged admission policy: lazy allocate-on-demand with "
                         "preemption/swap (default) vs upfront full-lifetime reservation")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="page-pool size; undersize it to watch lazy admission "
                         "preempt+swap instead of stalling")
    ap.add_argument("--eviction", action="store_true",
                    help="with --paged and an undersized --pool-pages: evict cold pages "
                         "(RaaS victim model, ghost-row metadata, optimistic replay on "
                         "re-touch) before falling back to whole-request preemption")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="with --paged: int8 K/V page pools with per-(page, head) scales "
                         "and dequant fused into the block-sparse kernels")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = example_config(args.arch, budget=args.budget, method=args.method,
                         threshold=args.threshold)
    params = get_api(cfg).init_params(torch.Generator(device=device).manual_seed(0), cfg)
    max_len = args.prefill + args.new + 16
    if args.quantize and not args.paged:
        raise SystemExit("--quantize needs --paged (pools are paged-only)")
    opts = DecodeOptions(policy=get_policy(args.policy), quantize=args.quantize,
                         sampling=SamplingParams(temperature=args.temperature,
                                                 top_p=args.top_p))

    if args.paged:
        reqs = ragged_requests(cfg, args.batch, args.prefill, args.new, args.budget)
        res = run_paged(cfg, params, reqs, max_len=max_len, options=opts,
                        n_slots=max(2, args.batch // 2), pool_pages=args.pool_pages,
                        admission=args.admission, eviction=args.eviction, device=device)
        st = res["stats"]
        print(f"arch={cfg.arch_id} policy={args.policy} paged serve "
              f"(admission={args.admission}): {len(reqs)} ragged requests, "
              f"{st['generated_tokens']} tokens in {st['decode_steps']} steps "
              f"({st['tok_per_s']:.1f} tok/s, wall {res['wall_s']:.2f}s)")
        print(f"slot utilisation {st['slot_util']:.2f} "
              f"(mean active {st['mean_active_slots']:.2f}), "
              f"page pool {st['num_pages']} x {st['page_size']} tokens "
              f"(peak used {st['peak_pages_used']}), "
              f"admission stalls {st['admission_stalls']}, "
              f"preemptions {st['preemptions']} "
              f"({st['retired_preempted']} requests finished after a swap)")
        if args.eviction:
            print(f"eviction: {st['evictions']} pages evicted, "
                  f"{st['page_restores']} restored on re-touch, "
                  f"{st['replay_steps']} replayed steps, "
                  f"swap peak {st['swap']['peak_host_bytes']} host bytes")
        print("measured sparsity by request (req 0 at half budget): "
              + ", ".join(f"{rid}: {rho:.3f}" for rid, rho in
                          sorted(st["sparsity_by_rid"].items())))
        for r in reqs[:2]:
            print(f"req{r['rid']} ({len(r['tokens'])} prompt tok): {res[r['rid']][:12]}")
        return res

    res = run_generate(cfg, params, batch=args.batch, prefill=args.prefill, new=args.new,
                       options=opts, device=device)
    stats = res["stats"]
    print(f"arch={cfg.arch_id} policy={args.policy} method={args.method} "
          f"budget={args.budget} batch={args.batch}")
    print(f"prefill {args.prefill} tok: {res['prefill_s'] * 1e3:.1f} ms; "
          f"decode {args.new} steps: {res['decode_s'] * 1e3:.1f} ms "
          f"({res['tok_per_s']:.1f} tok/s, wall {res['wall_s']:.2f}s)")
    print(f"achieved block sparsity: {stats['sparsity']:.3f} "
          f"(derived KV I/O speedup {stats['io_speedup']:.2f}x, "
          f"gate overhead {stats['gate_overhead_frac'] * 100:.2f}% of KV read)")
    print(f"generated tokens [req0, first 16]: {res['tokens'][0, :16].tolist()}")
    return res


if __name__ == "__main__":
    main()
