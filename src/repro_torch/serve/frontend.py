"""Open-loop serving frontend: trace-driven streaming serve with TTFT
and TPOT per tier, PyTorch port.

Port of the JAX package's ``serve/frontend.py``. ``ServingFrontend``
wraps ``DecodeEngine`` and drives ONE engine ``serve()`` call per trace
through the engine's open-loop seams (``arrivals`` / ``on_token``:
requests join the running batch at their trace arrival step; every
generated token streams through a callback when it is appended). The
frontend does NOT duplicate the engine's decode loop: preemption and
swap, page eviction and replay, fault isolation and the never-raises
contract stay in ``DecodeEngine.serve``.

What the frontend adds on top:

  * tier placement — a ``core.policy.TierPolicy`` maps each trace
    entry's tenant tier onto the engine's run-time per-request fields
    (priority, reserve admission, budget, sampling), so every tier shares
    one DecodeOptions;
  * per-token streaming — user callbacks receive ``TokenEvent`` records
    (rid, tier, token, index, virtual step, wall time), exactly once per
    token, in order, including across preempt -> resume;
  * latency accounting — per-request lifecycle stamps (submit -> admit ->
    first token -> retire, on both the deterministic virtual-step clock
    and the wall clock) are aggregated into per-tier p50/p99 TTFT, p50/p99
    TPOT and aggregate tok/s.

Determinism: token streams and every ``*_steps`` stat are pure functions
of (trace, engine options, seeds) — two runs of the same trace are
identical. Wall-clock ``*_ms`` stats are measurements, not control
inputs.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.scheduler import pages_needed
from repro_torch.serve.traffic import StepArrivals, TraceEntry, validate_trace


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token, as seen by a frontend callback."""
    rid: Any
    tier: str
    token: int
    index: int              # position in the request's output stream
    step: int               # virtual decode step it was produced at
    t_wall: float           # wall-clock seconds (perf_counter domain)


class FrontendResult(Dict):
    """rid -> generated token ids; ``res["stats"]`` carries the engine
    stats plus ``stats["tiers"]`` (per-tier latency aggregates) and
    ``res["events"]`` the TokenEvent list when collect_events=True."""
    pass


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": float("nan"), "p99": float("nan")}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


class ServingFrontend:
    def __init__(self, engine, *, tier_policy=None, n_slots: int = 4,
                 num_pages: Optional[int] = None, admission: str = "lazy",
                 watermark: int = 0, eviction=None, swap_config=None,
                 sample_seed: int = 0):
        self.engine = engine
        self.tier_policy = tier_policy
        self.n_slots = n_slots
        self.num_pages = num_pages
        self.admission = admission
        self.watermark = watermark
        self.eviction = eviction
        self.swap_config = swap_config
        self.sample_seed = sample_seed

    # -- sizing --------------------------------------------------------------

    def table_pages(self, trace: Sequence[TraceEntry]) -> int:
        ps = self.engine.cfg.gate.block_size
        return max(pages_needed(e.prompt_len, e.output_len, ps)
                   for e in trace)

    def default_max_steps(self, trace: Sequence[TraceEntry]) -> int:
        """Enough steps to drain the whole trace even fully serialized:
        the arrival horizon, plus every request's decode steps, plus one
        admission iteration each, plus slack (mirrors serve()'s own
        closed-loop watchdog formula)."""
        horizon = int(math.ceil(max(e.arrival for e in trace)))
        return horizon + sum(e.output_len for e in trace) + len(trace) + 16

    # -- the run -------------------------------------------------------------

    def run(self, trace: Sequence[TraceEntry], *,
            max_steps: Optional[int] = None,
            on_token: Optional[Callable[[TokenEvent], None]] = None,
            collect_events: bool = False,
            collect_logits: bool = False, faults=None) -> FrontendResult:
        """Replay ``trace`` through the engine; stream tokens; aggregate
        per-tier latency stats. Never raises post-validation (the
        engine's per-request failure isolation applies to arrivals too).
        """
        validate_trace(trace)
        if not trace:
            return FrontendResult(stats={"tiers": {}})
        arrivals = StepArrivals(trace, self.engine.cfg.vocab_size,
                                tier_policy=self.tier_policy)
        events: List[TokenEvent] = [] if collect_events else None
        sink = on_token

        def stream(req, token, index, step):
            # fired by the scheduler at the append point — exactly once
            # per token, in order; `step` is the virtual clock, wall time
            # is annotation only (never control flow)
            ev = TokenEvent(rid=req.rid, tier=req.tier, token=int(token),
                            index=int(index), step=int(step),
                            t_wall=time.perf_counter())
            if events is not None:
                events.append(ev)
            if sink is not None:
                sink(ev)

        res = self.engine.serve(
            [], arrivals=arrivals,
            on_token=stream if (sink or events is not None) else None,
            table_pages=self.table_pages(trace),
            max_steps=(max_steps if max_steps is not None
                       else self.default_max_steps(trace)),
            n_slots=self.n_slots, num_pages=self.num_pages,
            admission=self.admission, watermark=self.watermark,
            eviction=self.eviction, swap_config=self.swap_config,
            sample_seed=self.sample_seed, collect_logits=collect_logits,
            faults=faults)

        out = FrontendResult()
        for k, v in res.items():
            if k != "stats":
                out[k] = v
        stats = dict(res["stats"])
        stats["tiers"] = tier_latency_stats(stats)
        out["stats"] = stats
        if events is not None:
            out["events"] = events
        return out


def tier_latency_stats(stats: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Aggregate serve() lifecycle stamps into per-tier latency stats.

    TTFT = first token - submit; TPOT = (retire - first) / (n_tokens - 1).
    Wall-clock variants in ms (``*_ms``), virtual-clock variants in decode
    steps (``*_steps`` — deterministic for a fixed trace, what the tests
    assert on). Requests that never reached a stage (errors, truncation)
    are excluded from that stage's percentile and counted in
    ``incomplete``. ``tok_per_s`` is the tier's aggregate generated
    tokens over the whole run's wall time.
    """
    timing = stats.get("timing_by_rid", {})
    tier_of = stats.get("tier_by_rid", {})
    wall = max(float(stats.get("wall_s", 0.0)), 1e-9)
    by_tier: Dict[str, Dict[str, List[float]]] = {}
    for rid, tm in timing.items():
        tier = tier_of.get(rid, "default")
        acc = by_tier.setdefault(tier, {
            "ttft_ms": [], "tpot_ms": [], "ttft_steps": [],
            "tpot_steps": [], "tokens": [], "incomplete": []})
        n = int(tm.get("n_tokens", 0))
        acc["tokens"].append(float(n))
        if tm["first_token_step"] < 0 or tm["retire_step"] < 0:
            acc["incomplete"].append(1.0)
            continue
        acc["ttft_ms"].append((tm["t_first"] - tm["t_submit"]) * 1e3)
        acc["ttft_steps"].append(
            float(tm["first_token_step"] - tm["submit_step"]))
        if n > 1:
            acc["tpot_ms"].append(
                (tm["t_retire"] - tm["t_first"]) * 1e3 / (n - 1))
            acc["tpot_steps"].append(
                (tm["retire_step"] - tm["first_token_step"]) / (n - 1))
    out: Dict[str, Dict[str, float]] = {}
    for tier, acc in sorted(by_tier.items()):
        row: Dict[str, float] = {
            "n": float(len(acc["tokens"])),
            "incomplete": float(len(acc["incomplete"])),
            "tokens": float(sum(acc["tokens"])),
            "tok_per_s": float(sum(acc["tokens"])) / wall,
        }
        for k in ("ttft_ms", "tpot_ms", "ttft_steps", "tpot_steps"):
            pct = _percentiles(acc[k])
            row[f"{k}_p50"] = pct["p50"]
            row[f"{k}_p99"] = pct["p99"]
        out[tier] = row
    return out
