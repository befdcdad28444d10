"""RaaS-style page eviction for the paged serving engine, PyTorch port.

Port of the JAX package's ``serve/eviction.py``. Page-granular graceful
degradation under memory pressure: instead of swapping out a WHOLE
request when the pool runs dry (preemption), evict its coldest FULL
pages to the host swap space and keep decoding. Victim selection follows
RaaS (arXiv 2502.11147): per-(slot, block) attention recency/mass kept on
the host in a ``BlockHeat`` twin of the selection-metadata cache, fed by
the ``touched_pages`` telemetry the decode step emits under
``DecodeOptions.track_evictions``.

The mechanism that keeps SELECTION bitwise-identical is the ghost row:
the gate (Kg) and min/max metadata pools carry ``ghost_rows`` extra page
rows beyond the physical pool. Evicting page ``p`` of logical block
``lb``:

  1. copies its K/V (and gate/meta and int8 scale rows, for the swap
     record) to a host ``PageEntry`` keyed ``("page", rid, lb)``,
  2. copies the gate/meta rows ``p -> ghost`` on the card
     (``copy_gate_rows``),
  3. points the page table at the ghost id (``>= num_pages``) and frees
     the physical page.

Selection (gate scores, Quest min-max) reads through the RAW page table,
so an evicted block keeps scoring exactly as before. Only the K/V pools
lack ghost rows: attention reads through a clamped table
(``min(table, P-1)``), so a step that SELECTS an evicted block reads the
wrong K/V. That is detected, never served: the step also reports which
pages each row touched; touched ghost entries are faults, the pages are
restored to fresh physical ids and the step is RE-RUN (optimistic
execution + replay) over the pools the faulted attempt updated in place.
Page writes are idempotent across replays for fp pools — the trailing
append and finalize rewrite the same values at the same positions before
any read — so the replay is bitwise equal to a run that never faulted.

Eligibility guards keep the common case fault-free: never evict the
trailing (partial or force-selected last) block, never block 0 when the
gate force-selects it, never a page touched by the immediately preceding
step, and never a page pinned by the current replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.metacache import BlockHeat
from repro_torch.serve import paging as pg
from repro_torch.serve.offload import PCIE_BW, HostSwapSpace, PageEntry, SwapError
from repro_torch.serve.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class EvictionConfig:
    """Knobs for RaaS page eviction (``DecodeEngine.serve(eviction=...)``).

    max_resident_pages — per-request cap on PHYSICAL pages; the request's
    own coldest eligible pages are evicted before each step to enforce it
    (best-effort: pinned/hot pages can keep it above the cap). None = no
    cap. ema_decay — attention-mass EMA decay per step (RaaS recency
    weighting). max_replays — valve on the optimistic-execution replay
    loop per step; exceeding it fails the thrashing request
    ("restore_thrash") instead of looping forever. ghost_rows — gate/meta
    ghost rows to reserve; None sizes it to one full worst-case sequence
    per slot (every page of every slot evictable at once).
    """
    max_resident_pages: Optional[int] = None
    ema_decay: float = 0.8
    max_replays: int = 8
    ghost_rows: Optional[int] = None


class EvictionManager:
    """Host-side eviction bookkeeping for one ``serve()`` call.

    Owns the ghost-row free list, the rid -> {logical block -> ghost id}
    map of evicted pages, and the ``BlockHeat`` victim model. Device work
    goes through the paging helpers, which update the pools in place.
    """

    def __init__(self, sched: Scheduler, swap: HostSwapSpace, *,
                 num_phys: int, ghost_rows: int, page_size: int,
                 page_bytes: int, always_first_block: bool,
                 config: EvictionConfig):
        self.sched = sched
        self.swap = swap
        self.P = num_phys                  # table ids >= P are ghosts
        self.page_size = page_size
        # cost-of-restore victim model: score = EMA attention mass x the
        # host-link restore cost of the page's ACTUAL bytes
        # (``page_restore_bytes``: int8 pools restore ~4x cheaper). With
        # uniform page geometry within one pool the cost term is constant,
        # so the order is coldest-first.
        self.restore_cost_s = page_bytes / PCIE_BW
        self.always_first_block = always_first_block
        self.config = config
        self.heat = BlockHeat(sched.n_slots, sched.max_pages_per_seq,
                              decay=config.ema_decay)
        self.ghost_free: List[int] = list(range(num_phys, num_phys + ghost_rows))
        self.evicted: Dict[object, Dict[int, int]] = {}   # rid -> lb -> ghost
        # engine-installed: un-dirty restored pages so the Kg sweep does
        # not zero rows that restore_pages just rewrote
        self.mark_clean = lambda ids: None
        self.n_evicted = 0
        self.n_page_restores = 0
        self.n_replays = 0

    @staticmethod
    def page_restore_bytes(pages: pg.PagedPages) -> int:
        """Bytes that cross the host link to restore ONE evicted page: its
        K/V page at the pool's dtype plus every per-page row that rides
        the ``PageEntry`` (Kg, kmin/kmax, int8 scales). Each pool is
        ``[L, rows, ...]`` with the page id on axis 1, so one page's cut
        across all layers is ``nbytes // rows`` (the ghost-extended pools
        divide by their own row count)."""
        return sum(pool.numel() * pool.element_size() // pool.shape[1]
                   for pool in pages if pool is not None)

    # -- victim model -------------------------------------------------------

    def _eligible(self, pinned: Set[Tuple[object, int]],
                  only: Optional[Request] = None
                  ) -> List[Tuple[int, Request, int]]:
        """(slot, req, logical block) triples safe to evict: resident,
        FULL, non-trailing (the trailing block is partial or
        force-selected last), not block 0 under always_first_block, not
        touched by the immediately preceding step, not pinned by the
        current replay."""
        out: List[Tuple[int, Request, int]] = []
        for slot in range(self.sched.n_slots):
            req = self.sched.slots[slot]
            if req is None or not self.sched.active[slot]:
                continue
            if only is not None and req is not only:
                continue
            trailing = int(self.sched.cur_len[slot]) // self.page_size
            start = 1 if self.always_first_block else 0
            for lb in range(start, min(len(req.pages), trailing)):
                if req.pages[lb] >= self.P:
                    continue               # already a ghost
                if (req.rid, lb) in pinned:
                    continue
                if self.heat.last_touch[slot, lb] >= self.heat.step:
                    continue               # read by the last step — hot
                out.append((slot, req, lb))
        return out

    def pick_victims(self, n: int, pinned: Set[Tuple[object, int]] = frozenset(),
                     only: Optional[Request] = None) -> List[Tuple[Request, int]]:
        """Lowest tier priority first (a latency-tier request never loses
        pages while a throughput-tier page is evictable), then coldest by
        score = EMA mass x restore cost; ties break (EMA, last_touch,
        slot, lb) ascending — fully deterministic."""
        cands = self._eligible(pinned, only)
        cands.sort(key=lambda t: (
            t[1].priority,
            float(self.heat.ema[t[0], t[2]]) * self.restore_cost_s,
            float(self.heat.ema[t[0], t[2]]),
            int(self.heat.last_touch[t[0], t[2]]), t[0], t[2]))
        return [(req, lb) for _, req, lb in cands[:n]]

    # -- evict / restore ----------------------------------------------------

    def evict(self, pages: pg.PagedPages, n: int,
              pinned: Set[Tuple[object, int]] = frozenset(),
              only: Optional[Request] = None) -> int:
        """Evict up to ``n`` victim pages; returns the pages freed.

        A victim whose swap put fails (capacity/IO fault) is skipped —
        eviction degrades to freeing fewer pages, and the caller falls
        back to preemption. Freed physical ids go through the scheduler's
        released list so their stale gate rows are zeroed before reuse.
        """
        dev = pages.k_pages.device
        freed = 0
        for req, lb in self.pick_victims(n, pinned, only):
            if not self.ghost_free:
                break
            phys = req.pages[lb]
            k, v, kg, kmin, kmax, k_sc, v_sc = pg.extract_pages(
                pages, pg.pad_page_ids([phys], device=dev))
            entry = PageEntry(k=k, v=v, kg=kg, kmin=kmin, kmax=kmax,
                              k_scale=k_sc, v_scale=v_sc)
            try:
                self.swap.put(("page", req.rid, lb), entry)
            except SwapError:
                continue                   # swap tier full/faulted: skip
            ghost = self.ghost_free.pop()
            pg.copy_gate_rows(pages, pg.pad_page_ids([phys], device=dev),
                              pg.pad_page_ids([ghost], device=dev))
            req.pages[lb] = ghost
            self.sched.page_table[req.slot, lb] = ghost
            self.evicted.setdefault(req.rid, {})[lb] = ghost
            self.sched.allocator.free([phys])
            self.sched.released.append(phys)
            self.n_evicted += 1
            freed += 1
        return freed

    def restore(self, pages: pg.PagedPages, req: Request, lbs: Sequence[int], *,
                pinned: Set[Tuple[object, int]], swap_out) -> bool:
        """Restore evicted logical blocks of ``req`` to fresh physical
        pages (replay path). Returns ok; False means a page could not come
        back — no free page even after evicting/preempting others, or its
        swap entry is permanently unreadable — and the caller must fail
        THIS request (failure isolation), not the batch."""
        dev = pages.k_pages.device
        for lb in sorted(lbs):
            ghost = self.evicted.get(req.rid, {}).get(lb)
            if ghost is None:
                continue                   # raced: already restored
            phys = self._acquire(pages, pinned, req, swap_out)
            if phys is None:
                return False
            try:
                pe = self.swap.pop(("page", req.rid, lb))
            except SwapError:
                self.sched.allocator.free([phys])
                self.sched.released.append(phys)
                return False
            pg.restore_pages(pages, pe.k, pe.v, pe.kg, pg.pad_page_ids([phys], device=dev),
                             pe.kmin, pe.kmax, k_scale=pe.k_scale, v_scale=pe.v_scale)
            req.pages[lb] = phys
            self.sched.page_table[req.slot, lb] = phys
            del self.evicted[req.rid][lb]
            if not self.evicted[req.rid]:
                del self.evicted[req.rid]
            self.ghost_free.append(ghost)
            # restore_pages just rewrote this page's gate rows — pull it
            # out of the dirty/released sweep or they would be zeroed
            self.mark_clean([phys])
            self.n_page_restores += 1
        return True

    def _acquire(self, pages: pg.PagedPages, pinned: Set[Tuple[object, int]],
                 exclude: Request, swap_out) -> Optional[int]:
        """One physical page for a restore: alloc -> evict a colder page
        -> preempt a whole other request -> give up (None)."""
        while True:
            ids = self.sched._alloc(1)
            if ids is not None:
                return ids[0]
            if self.evict(pages, 1, pinned):
                continue
            victim = self.sched._pick_victim(exclude=exclude)
            if victim is None:
                return None
            self.sched._preempt(victim, swap_out)

    def enforce_caps(self, pages: pg.PagedPages) -> None:
        """Pre-step per-request resident-page cap (best-effort)."""
        cap = self.config.max_resident_pages
        if cap is None:
            return
        for slot in range(self.sched.n_slots):
            req = self.sched.slots[slot]
            if req is None or not self.sched.active[slot]:
                continue
            resident = sum(1 for p in req.pages if p < self.P)
            if resident > cap:
                self.evict(pages, resident - cap, only=req)

    # -- lifecycle ----------------------------------------------------------

    def forget(self, req: Request) -> List[int]:
        """Drop every evicted-page record of ``req`` (retire / fail /
        preempt-merge); returns the ghost ids handed back to the free
        list. Idempotent."""
        ghosts: List[int] = []
        blocks = self.evicted.pop(req.rid, None)
        if blocks:
            for lb, ghost in blocks.items():
                self.swap.discard(("page", req.rid, lb))
                ghosts.append(ghost)
            self.ghost_free.extend(ghosts)
        return ghosts

    def stats(self) -> Dict[str, int]:
        return {"evictions": self.n_evicted,
                "page_restores": self.n_page_restores,
                "replay_steps": self.n_replays,
                "pages_evicted_now": sum(len(v) for v in self.evicted.values())}
