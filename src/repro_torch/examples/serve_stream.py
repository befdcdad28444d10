"""Stream tokens from the open-loop serving frontend under trace-driven
load: two SLO tiers sharing one engine, with per-tier TTFT/TPOT. PyTorch
port of ``examples/serve_stream.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_stream \\
        [--arch qwen3_0_6b] [--requests 8] [--rate 0.5] [--seed 7] \\
        [--slots 2] [--budget 64] [--pool-pages N] [--trace path.jsonl] \\
        [--quiet] [--device cpu]

A seeded Poisson process (``serve.traffic.poisson_trace``, or a replayed
``--trace`` JSONL file through ``load_trace``) emits requests tagged
``latency`` or ``throughput``. ``core.policy.default_tiers`` maps the tags
onto the engine's run-time knobs: the latency tier gets priority
admission, upfront page reservation and a near-dense token budget; the
throughput tier runs lazy, preemptible and aggressively sparse.
``serve.frontend.ServingFrontend`` replays the trace open-loop (requests
join the running batch at their arrival step) and streams every token
through a callback the moment it exists. The closing report shows p50/p99
TTFT and TPOT per tier, on the wall clock and on the deterministic
virtual step clock (undersize ``--pool-pages`` to watch the latency tier
hold its TTFT while throughput requests queue and get preempted). The
model is the arch's ``reduced()`` config with 16-token gate blocks and
random weights from seed 0; runs on the CUDA device unless ``--device``
names another.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, List, Optional

import torch

from repro_torch import configs
from repro_torch.config import ModelConfig, reduced
from repro_torch.core.policy import default_tiers
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.frontend import FrontendResult, ServingFrontend
from repro_torch.serve.traffic import TraceEntry, load_trace, poisson_trace


def stream_config(arch: str = "qwen3_0_6b", *, budget: int = 64) -> ModelConfig:
    """The arch's ``reduced()`` config with 16-token gate blocks, d_gate
    16 and the given token budget; an arch with no decode gate raises
    SystemExit."""
    cfg = reduced(configs.get(arch))
    if not (cfg.gate.enabled and cfg.has_attention and cfg.is_decoder):
        raise SystemExit(f"{arch}: no decode gate (family {cfg.family})")
    return cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=16, d_gate=16,
                                                token_budget=budget))


def example_trace(n_requests: int = 8, rate: float = 0.5, seed: int = 7,
                  path: Optional[str] = None) -> List[TraceEntry]:
    """The trace ``path`` names, or the example's seeded Poisson trace:
    prompts of 16..96 tokens, 16..48 new tokens, 35% latency tier."""
    if path:
        return load_trace(path)
    return poisson_trace(n_requests, rate, seed=seed, prompt_len=(16, 96),
                         output_len=(16, 48), tiers={"latency": 0.35, "throughput": 0.65})


def run_stream(cfg: ModelConfig, params: Any, trace: List[TraceEntry], *, slots: int = 2,
               pool_pages: Optional[int] = None, on_token: Optional[Callable] = None,
               device=None) -> FrontendResult:
    """``trace`` through a ``ServingFrontend`` over a 256-token engine
    with the default tiers: the tokens by rid and ``stats["tiers"]``."""
    eng = DecodeEngine(cfg, params, max_len=256, device=device)
    fr = ServingFrontend(eng, tier_policy=default_tiers(cfg), n_slots=slots,
                         num_pages=pool_pages)
    return fr.run(trace, on_token=on_token)


def main(argv=None) -> FrontendResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.5, help="mean arrivals per decode step")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="page-pool size; undersize to create contention and make the "
                         "tier split visible")
    ap.add_argument("--trace", default=None,
                    help="replay a JSONL trace file instead of generating a Poisson one")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-token stream lines")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = stream_config(args.arch, budget=args.budget)
    trace = example_trace(args.requests, args.rate, args.seed, args.trace)
    print(f"trace: {len(trace)} requests, horizon {trace[-1].arrival:.1f} steps")
    for e in trace:
        print(f"  rid={e.rid} t={e.arrival:6.2f} tier={e.tier:<10} "
              f"prompt={e.prompt_len} out={e.output_len}")

    def on_token(ev):
        if ev.index == 0:
            print(f"[step {ev.step:4d}] rid={ev.rid} ({ev.tier}) FIRST token {ev.token}")
        elif not args.quiet:
            print(f"[step {ev.step:4d}] rid={ev.rid} ({ev.tier}) #{ev.index} -> {ev.token}")

    params = get_api(cfg).init_params(torch.Generator(device=device).manual_seed(0), cfg)
    res = run_stream(cfg, params, trace, slots=args.slots, pool_pages=args.pool_pages,
                     on_token=on_token, device=device)
    st = res["stats"]
    print(f"\n{st['retired']} retired / {st['failed']} failed, "
          f"{st['generated_tokens']} tokens in {st['decode_steps']} steps "
          f"({st['tok_per_s']:.1f} tok/s); preemptions {st['preemptions']}, "
          f"admission stalls {st['admission_stalls']}, "
          f"peak pages {st['peak_pages_used']}/{st['num_pages']}")
    if st["errors"]:
        print(f"errors: {st['errors']}")
    print(f"\n{'tier':<12} {'n':>3} {'TTFT p50/p99 (ms)':>20} "
          f"{'TPOT p50/p99 (ms)':>20} {'TTFT p99 (steps)':>17} {'tok/s':>8}")
    for tier, row in st["tiers"].items():
        print(f"{tier:<12} {int(row['n']):>3} "
              f"{row['ttft_ms_p50']:>9.2f}/{row['ttft_ms_p99']:<10.2f} "
              f"{row['tpot_ms_p50']:>9.2f}/{row['tpot_ms_p99']:<10.2f} "
              f"{row['ttft_steps_p99']:>17.1f} {row['tok_per_s']:>8.1f}")
    return res


if __name__ == "__main__":
    main()
