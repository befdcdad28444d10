"""Deterministic, replayable load generation for the serving frontend.

A copy of the JAX package's ``serve/traffic.py`` (pure Python and numpy:
the port keeps its own).

The paper's target workload — many concurrent multi-thousand-token
reasoning generations — is an OPEN-LOOP arrival process: requests show
up on their own clock, not when the server frees a slot. To make that
reproducible, arrivals here live in VIRTUAL time measured in decode-loop
steps:

  * a trace is a list of ``TraceEntry`` (arrival step, prompt length,
    output length, tenant tier, per-request content seed), either
    synthesized from a seeded Poisson process (``poisson_trace``) or
    loaded from a JSONL file (``load_trace`` / ``save_trace``);
  * ``StepArrivals`` adapts a trace to the engine's arrival seam
    (``pull(step) -> request dicts``): an entry becomes due when the
    decode loop's step counter reaches ``ceil(arrival)``.

Because both the schedule and the prompt contents are pure functions of
the trace, a fixed trace replays to identical token streams — wall-clock
time never feeds control flow (it only annotates TTFT/TPOT stats
downstream).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One request's arrival record.

    arrival is in DECODE STEPS (virtual time, float — fractional arrivals
    become due at the next integer step); ``seed`` keys the synthetic
    prompt contents so two traces with the same entry decode identically.
    """
    rid: int
    arrival: float
    prompt_len: int
    output_len: int
    tier: str = "default"
    seed: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TraceEntry":
        return cls(rid=d["rid"], arrival=float(d["arrival"]),
                   prompt_len=int(d["prompt_len"]),
                   output_len=int(d["output_len"]),
                   tier=str(d.get("tier", "default")),
                   seed=int(d.get("seed", 0)))


def validate_trace(trace: Sequence[TraceEntry]) -> None:
    """Fail fast on a malformed trace: duplicate rids, non-positive
    lengths, negative or non-monotone arrival times."""
    rids = [e.rid for e in trace]
    if len(set(rids)) != len(rids):
        dups = sorted({r for r in rids if rids.count(r) > 1})
        raise ValueError(f"trace has duplicate rids: {dups}")
    prev = 0.0
    for e in trace:
        if e.prompt_len < 1:
            raise ValueError(f"trace rid {e.rid}: prompt_len must be >= 1")
        if e.output_len < 1:
            raise ValueError(f"trace rid {e.rid}: output_len must be >= 1")
        if e.arrival < prev:
            raise ValueError(
                f"trace rid {e.rid}: arrivals must be sorted non-decreasing "
                f"({e.arrival} after {prev})")
        prev = e.arrival


def poisson_trace(n_requests: int, rate: float, *, seed: int = 0,
                  prompt_len: tuple = (32, 128),
                  output_len: tuple = (32, 256),
                  tiers: Optional[Dict[str, float]] = None,
                  start: float = 0.0) -> List[TraceEntry]:
    """Seeded Poisson arrival trace with the reasoning-workload shape.

    ``rate`` is requests per DECODE STEP (exponential inter-arrival
    times); prompt/output lengths are uniform over the inclusive ranges
    (long generations relative to prompts is the paper's regime — pick
    ``output_len`` accordingly); ``tiers`` maps tier name -> mix weight
    (default: all "default"). Same arguments => identical trace.
    """
    if n_requests < 0:
        raise ValueError(f"n_requests must be >= 0: {n_requests}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0 requests/step: {rate}")
    rng = np.random.default_rng(seed)
    names = list(tiers) if tiers else ["default"]
    weights = np.asarray([tiers[n] for n in names] if tiers else [1.0],
                         np.float64)
    weights = weights / weights.sum()
    t = float(start)
    out: List[TraceEntry] = []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        out.append(TraceEntry(
            rid=i, arrival=t,
            prompt_len=int(rng.integers(prompt_len[0], prompt_len[1] + 1)),
            output_len=int(rng.integers(output_len[0], output_len[1] + 1)),
            tier=str(rng.choice(names, p=weights)),
            seed=int(rng.integers(0, 2 ** 31 - 1))))
    validate_trace(out)
    return out


def save_trace(trace: Sequence[TraceEntry], path: str) -> None:
    """One JSON object per line — diffable, streamable, appendable."""
    with open(path, "w") as f:
        for e in trace:
            f.write(json.dumps(e.to_json(), sort_keys=True) + "\n")


def load_trace(path: str) -> List[TraceEntry]:
    with open(path) as f:
        trace = [TraceEntry.from_json(json.loads(line))
                 for line in f if line.strip()]
    validate_trace(trace)
    return trace


def synth_prompt(entry: TraceEntry, vocab_size: int) -> np.ndarray:
    """The entry's synthetic prompt tokens — a pure function of
    (entry.seed, entry.prompt_len), so replays are content-identical."""
    rng = np.random.default_rng(entry.seed)
    return rng.integers(0, vocab_size, size=(entry.prompt_len,)) \
              .astype(np.int32)


class StepArrivals:
    """Adapts a trace to the engine's arrival seam.

    ``pull(step)`` returns the request dicts of every not-yet-delivered
    entry whose arrival time has come due (``arrival <= step``), in trace
    order; ``exhausted`` is True once the whole trace has been delivered.
    ``tier_policy`` (core.policy.TierPolicy) maps each entry's tier onto
    engine fields (priority / reserve / budget / sampling); without one,
    the tier rides along as a label only.
    """

    def __init__(self, trace: Sequence[TraceEntry], vocab_size: int, *,
                 tier_policy=None):
        validate_trace(trace)
        self.trace = list(trace)
        self.vocab_size = int(vocab_size)
        self.tier_policy = tier_policy
        self._next = 0

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self.trace)

    def request_dict(self, entry: TraceEntry) -> dict:
        rd = {"rid": entry.rid, "tier": entry.tier,
              "tokens": synth_prompt(entry, self.vocab_size),
              "max_new_tokens": entry.output_len}
        if self.tier_policy is not None:
            rd = self.tier_policy.apply(rd)
        return rd

    def pull(self, step: int) -> List[dict]:
        due: List[dict] = []
        while (self._next < len(self.trace)
               and self.trace[self._next].arrival <= step):
            due.append(self.request_dict(self.trace[self._next]))
            self._next += 1
        return due


def upfront_requests(trace: Iterable[TraceEntry], vocab_size: int, *,
                     tier_policy=None) -> List[dict]:
    """The same trace as a plain request list (arrival times dropped) —
    for closed-loop baselines through the synchronous ``serve()``."""
    arr = StepArrivals([], vocab_size, tier_policy=tier_policy)
    return [arr.request_dict(e) for e in trace]
