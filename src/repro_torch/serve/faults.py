"""Deterministic fault injection for the serving loop.

A copy of the JAX package's ``serve/faults.py`` (pure Python: the port
keeps its own). A ``FaultInjector`` is a host-side seam: call sites in
the scheduler, swap space and engine ask ``fire(site)`` before doing the
real work, and the injector answers "fail this one?" from a
deterministic plan — no randomness, no clocks — so chaos tests are
exactly reproducible and individual faults can be aimed at a single
allocation, swap transfer or decode step.

Plan semantics: ``plan[site]`` is a collection of 0-based *call
indices* that must fail. Every ``fire(site)`` consumes one index,
including retries — so a transient fault is ONE failing index (the
retry succeeds) and a permanent fault is ``retries + 1`` consecutive
indices (every attempt of one logical operation fails).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping


class FaultInjector:
    """Deterministic per-site fault plan with call accounting."""

    SITES = ("page_alloc", "swap_put", "swap_pop", "disk_write",
             "disk_read", "logits")

    def __init__(self, plan: Mapping[str, Iterable[int]]):
        unknown = set(plan) - set(self.SITES)
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {sorted(unknown)}; "
                f"valid sites: {list(self.SITES)}")
        self.plan: Dict[str, frozenset] = {
            site: frozenset(int(i) for i in idxs)
            for site, idxs in plan.items()}
        for site, idxs in self.plan.items():
            if any(i < 0 for i in idxs):
                raise ValueError(f"negative call index for site {site!r}")
        self.calls: Dict[str, int] = {s: 0 for s in self.SITES}
        self.fired: Dict[str, int] = {s: 0 for s in self.SITES}

    def fire(self, site: str) -> bool:
        """Record one call at ``site``; True means "inject a failure"."""
        if site not in self.calls:
            raise ValueError(f"unknown fault site {site!r}")
        i = self.calls[site]
        self.calls[site] = i + 1
        hit = i in self.plan.get(site, ())
        if hit:
            self.fired[site] += 1
        return hit

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {"calls": dict(self.calls), "fired": dict(self.fired)}

    def __repr__(self) -> str:
        planned = {s: sorted(v) for s, v in self.plan.items() if v}
        return f"FaultInjector(plan={planned}, calls={self.calls})"
