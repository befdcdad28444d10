"""Iteration-level continuous-batching scheduler (vLLM-style, simplified).

A copy of the JAX package's ``serve/scheduler.py`` (pure Python: the port
keeps its own), with its RaaS eviction seams (``evict_cb``,
``release_filter``), its fault-injection seam and its streaming
``on_token`` callback.

Host-side bookkeeping for the paged decode engine: a fixed number of
decode SLOTS (rows of the batched step) and a page pool. Each
engine iteration:

  1. ``admissions()`` — pop pending requests FIFO into free slots while
     the allocator can satisfy their ADMISSION page need. Two admission
     policies (the default is lazy):
       * ``"lazy"`` (default): reserve only the pages the request holds
         RIGHT NOW (prompt pages, or the swapped page set on resume);
         further pages are allocated on demand as ``cur_len`` crosses a
         page boundary (``prepare_step``). Admission is governed by
         current occupancy, so the sustained admitted batch is bounded by
         live KV, not worst-case length. A ``watermark`` of free pages can
         be held back from admission as growth headroom.
       * ``"reserve"``: reserve the full lifetime
         budget up-front (ceil((prompt + max_new - 1) / page_size)); a
         running request can never stall, admission control is the single
         backpressure point. Kept as the comparison baseline and for
         latency-critical tenants.
  2. ``prepare_step()`` — lazy mode only: append a page to every active
     slot whose next token write crosses into an unallocated page. When
     the pool is exhausted, PREEMPT the active request with the fewest
     generated tokens (lowest priority first, ties broken by lowest rid —
     deterministic): its pages are swapped out via the engine-provided
     callback, freed, and the request is pushed to the FRONT of the
     pending queue for re-admission with page restore.
  3. run the batched decode step over all slots (inactive rows are
     masked inside the model via ``active``).
  4. ``complete_step()`` — append sampled tokens, advance per-slot
     lengths, retire finished requests and free their pages.

The page table / cur_len / active arrays live here as host numpy and are
shipped to the device each step; their SHAPES are fixed by (n_slots,
max_pages_per_seq).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.paging import NULL_PAGE, PageAllocator

ADMISSION_MODES = ("lazy", "reserve")


def rid_sort_key(rid):
    """Total deterministic order over request ids: ints sort numerically
    among themselves, everything else by its string form — so victim
    tie-breaking never depends on dict/slot/insertion
    order and never TypeErrors on mixed-type rids."""
    if isinstance(rid, int):
        return (0, rid, "")
    return (1, 0, str(rid))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [prompt_len] int32
    max_new_tokens: int
    # SLO tier: ``priority`` orders admission (highest first;
    # FIFO within a class) and INVERSELY orders preemption/eviction victim
    # selection (lowest first — a latency-tier request is never preempted
    # while a throughput-tier victim exists). ``admit_reserve`` gives this
    # request the upfront full-lifetime page reservation (the "reserve"
    # admission policy) even under a lazy scheduler: it can never stall
    # mid-decode on page growth. ``tier`` is a label for telemetry only.
    tier: str = "default"
    priority: int = 0
    admit_reserve: bool = False
    # filled in by the scheduler / engine
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    out_logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    # preemption/swap state (lazy admission): set by ``_preempt``, cleared
    # by the engine once the page contents are restored
    swapped: bool = False
    swap_len: int = 0                # cur_len at preemption
    n_preemptions: int = 0
    # failure isolation: a request that hits an unrecoverable per-request
    # fault (non-finite logits, permanent restore failure, watchdog abort)
    # is retired with status="error" and the reason in ``error``; its
    # partial out_tokens still reach the caller
    status: str = "ok"
    error: Optional[str] = None
    # lifecycle timestamps: ``*_step`` fields count decode-loop
    # iterations (the scheduler's ``now`` clock — deterministic for a
    # fixed trace), ``t_*`` fields are wall-clock seconds
    # (``Scheduler.wall``). admit/first stamp only on the FIRST admission;
    # preempt -> resume does not reset them (TTFT is to the first token
    # the client saw).
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    retire_step: int = -1
    t_submit: float = -1.0
    t_admit: float = -1.0
    t_first: float = -1.0
    t_retire: float = -1.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    def pages_held(self, page_size: int) -> int:
        """Pages needed to hold the request's CURRENT content."""
        length = self.swap_len if self.swapped else self.prompt_len
        return max(1, -(-length // page_size))


def pages_needed(prompt_len: int, max_new_tokens: int, page_size: int) -> int:
    """Full-lifetime page budget. The last generated token is sampled but
    never written back, hence the ``- 1``."""
    total = prompt_len + max(max_new_tokens - 1, 0)
    return max(1, -(-total // page_size))


class Scheduler:
    def __init__(self, n_slots: int, num_pages: int, page_size: int,
                 max_pages_per_seq: int, *, admission: str = "lazy",
                 watermark: int = 0, eviction_enabled: bool = False,
                 faults=None):
        if admission not in ADMISSION_MODES:
            raise ValueError(f"admission {admission!r} not in "
                             f"{ADMISSION_MODES}")
        if watermark < 0:
            raise ValueError(f"watermark must be >= 0: {watermark}")
        self.n_slots = n_slots
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.admission = admission
        self.watermark = watermark
        # eviction seams, wired by the engine when eviction is on:
        #   eviction_enabled — relaxes the full-lifetime admission bound
        #     (growth past the pool is absorbed by page eviction) and makes
        #     _pick_victim skip victims whose resume need can't fit
        #   evict_cb(n) -> pages actually freed — try page-granular eviction
        #     before falling back to whole-request preemption
        #   release_filter(req) -> physical page ids to free — ghost ids of
        #     evicted pages must never reach PageAllocator.free
        self.eviction_enabled = eviction_enabled
        self.evict_cb: Optional[Callable[[int], int]] = None
        self.release_filter: Optional[Callable[[Request], List[int]]] = None
        self.faults = faults
        # seams set by the engine:
        #   now — the decode-loop step counter (virtual clock); lifecycle
        #     ``*_step`` stamps read it, so they are deterministic for a
        #     fixed request list. The engine sets it each iteration.
        #   wall — wall-clock source for the ``t_*`` stamps; NEVER feeds
        #     control flow, only latency stats.
        #   on_token(req, token, index, step) — streaming callback fired
        #     by ``note_token`` exactly once per appended token, in order.
        self.now = 0
        self.wall: Callable[[], float] = time.perf_counter
        self.on_token: Optional[Callable[[Request, int, int, int], None]] = None
        self.allocator = PageAllocator(num_pages)
        self.page_table = np.full((n_slots, max_pages_per_seq), NULL_PAGE,
                                  np.int32)
        self.cur_len = np.zeros((n_slots,), np.int32)
        self.active = np.zeros((n_slots,), bool)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.pending: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        # pages freed since the engine last drained (retire/preempt) —
        # the engine zeroes their Kg rows before the free list re-issues
        # them (one batched device call per release, not per growth)
        self.released: List[int] = []
        # telemetry
        self.n_admitted = 0                # fresh admissions (prefills)
        self.n_resumed = 0                 # swap-in re-admissions
        self.n_retired = 0
        self.n_preemptions = 0
        self.n_failed = 0                  # requests retired with an error
        self.admission_stalls = 0          # steps a head-of-line req waited

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 "
                f"(got {req.max_new_tokens})")
        if req.prompt_len < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        need = pages_needed(req.prompt_len, req.max_new_tokens, self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request {req.rid} needs {need} pages > table width "
                f"{self.max_pages_per_seq}")
        pool = self.allocator.num_pages - 1       # page 0 is the NULL page
        if self.admission == "lazy" and not req.admit_reserve:
            # lazy admission only reserves the pages held RIGHT NOW, but it
            # also holds ``watermark`` pages back as growth headroom — a
            # request whose admission need exceeds (pool - watermark) can
            # NEVER be admitted and would head-of-line-block the queue
            # forever. Fail fast instead of stalling silently.
            adm = req.pages_held(self.page_size)
            if adm > pool - self.watermark:
                raise ValueError(
                    f"request {req.rid} needs {adm} pages at admission but "
                    f"only {pool - self.watermark} can ever be free for "
                    f"admission (pool {pool} minus watermark "
                    f"{self.watermark}) — it would head-of-line-block the "
                    f"queue forever")
        if need > pool and not (self.admission == "lazy"
                                and self.eviction_enabled
                                and not req.admit_reserve):
            # with page eviction on, growth past the pool is absorbed by
            # evicting cold pages, so only the admission need must fit —
            # unless the request demands the full upfront reservation
            # (admit_reserve), whose admission need IS the lifetime need
            raise ValueError(
                f"request {req.rid} needs {need} pages but the pool only has "
                f"{pool} — it can never be admitted")
        req.submit_step = self.now
        req.t_submit = self.wall()
        self.pending.append(req)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate through the fault-injection seam: an injected
        ``page_alloc`` fault reports exhaustion even when pages are free,
        which the callers already survive (admission retries next
        iteration; growth falls back to eviction/preemption)."""
        if self.faults is not None and self.faults.fire("page_alloc"):
            return None
        return self.allocator.alloc(n)

    def has_work(self) -> bool:
        return bool(self.pending) or bool(self.active.any())

    # -- admission ----------------------------------------------------------

    def _admission_need(self, req: Request) -> int:
        if self.admission == "reserve" or req.admit_reserve:
            # per-request reserve (latency tier): the upfront
            # full-lifetime reservation even under a lazy scheduler — on a
            # resume the final length is unchanged, so the lifetime need
            # still covers the swapped content plus remaining growth
            return pages_needed(req.prompt_len, req.max_new_tokens,
                                self.page_size)
        return req.pages_held(self.page_size)

    def admissions(self) -> List[Request]:
        """Admit pending requests into free slots while pages last.

        Admission order is PRIORITY, then FIFO within a priority class
        (``max`` over a deque returns the leftmost maximal element, so all
        same-priority traffic keeps plain FIFO semantics,
        including preempted requests resuming from the queue front).
        Head-of-line blocking applies to the chosen request: a stuck
        high-priority request is not overtaken by lower tiers (latency
        fairness, deterministic tests). Returned requests with
        ``swapped=True`` are RESUMES — the engine must restore their page
        contents instead of prefilling. In lazy mode admission
        additionally keeps ``watermark`` pages free as growth headroom
        for already-running requests.
        """
        out: List[Request] = []
        while self.pending:
            slot = next((i for i in range(self.n_slots)
                         if self.slots[i] is None), -1)
            if slot < 0:
                break
            req = max(self.pending, key=lambda r: r.priority)
            need = self._admission_need(req)
            # the watermark is growth headroom for RUNNING requests; a
            # swap-in resume is itself the continuation of a running
            # request, so it is exempt — otherwise a victim whose content
            # pages exceed (pool - watermark) could never be re-admitted
            # even with the pool fully free (permanent stall). A reserved
            # request is exempt too: its admission need already covers its
            # whole lifetime, so it contributes no growth to headroom for.
            headroom = (self.watermark
                        if self.admission == "lazy" and not req.swapped
                        and not req.admit_reserve
                        else 0)
            ids = (self._alloc(need)
                   if self.allocator.num_free - need >= headroom else None)
            if ids is None:
                self.admission_stalls += 1
                break
            self.pending.remove(req)
            req.slot, req.pages = slot, ids
            self.slots[slot] = req
            self.page_table[slot] = NULL_PAGE
            self.page_table[slot, :need] = np.asarray(ids, np.int32)
            self.cur_len[slot] = (req.swap_len if req.swapped
                                  else req.prompt_len)
            self.active[slot] = True
            if req.swapped:
                self.n_resumed += 1
            else:
                self.n_admitted += 1
            if req.admit_step < 0:       # first admission only, not resumes
                req.admit_step = self.now
                req.t_admit = self.wall()
            out.append(req)
        return out

    # -- lazy growth + preemption -------------------------------------------

    def prepare_step(self, swap_out: Optional[Callable[[Request], None]]
                     = None) -> List[int]:
        """Lazy mode: make every active slot's next token write landable.

        A slot writing at position ``cur_len`` needs page
        ``cur_len // page_size`` allocated; when the free list is empty the
        victim with the fewest generated tokens is preempted (swap_out
        callback fires BEFORE its pages are freed, so the engine can
        capture the device contents). Returns the freshly allocated page
        ids — the engine must zero their Kg rows (recycled pages hold the
        previous tenant's entries). No-op under ``reserve`` admission.
        """
        if self.admission != "lazy":
            return []
        fresh: List[int] = []
        for slot in range(self.n_slots):
            req = self.slots[slot]
            if req is None or not self.active[slot]:
                continue
            needed = int(self.cur_len[slot]) // self.page_size + 1
            while len(req.pages) < needed:
                ids = self._alloc(1)
                if ids is None:
                    # graceful degradation order: evict cold PAGES of
                    # running requests first; only preempt a whole
                    # request when eviction can't free anything
                    if (self.evict_cb is not None
                            and self.evict_cb(1) > 0):
                        continue
                    victim = self._pick_victim()
                    if victim is None:
                        # eviction mode, every victim unresumable and
                        # nothing evictable — fail THIS request rather
                        # than poisoning the batch or stalling forever
                        self.fail(req, "pool_exhausted")
                        break
                    self._preempt(victim, swap_out)
                    if victim is req:
                        break               # the grower itself was preempted
                    continue
                self.page_table[slot, len(req.pages)] = ids[0]
                req.pages.extend(ids)
                fresh.extend(ids)
        return fresh

    def _pick_victim(self, exclude: Optional[Request] = None
                     ) -> Optional[Request]:
        """Lowest-priority victim first (never preempt a latency-tier
        request while a throughput-tier victim exists), then fewest
        generated tokens (least progress lost per page freed), then LOWEST
        rid: victim selection is a pure function of request identity, not
        of slot or admission order.

        Under eviction the admission bound is relaxed, so a long request's
        resume need (ceil(content / page_size)) may exceed the pool — such
        a request is skipped (preempting it would strand it in pending
        forever); returns None when no resumable victim exists. ``exclude``
        protects the request a replay is currently restoring."""
        best: Optional[Request] = None
        best_key = None
        pool = self.allocator.num_pages - 1
        for slot in range(self.n_slots):
            req = self.slots[slot]
            if req is None or not self.active[slot] or req is exclude:
                continue
            if self.eviction_enabled:
                resume = max(1, -(-int(self.cur_len[slot]) // self.page_size))
                if resume > pool:
                    continue
            key = (req.priority, len(req.out_tokens), rid_sort_key(req.rid))
            if best_key is None or key < best_key:
                best, best_key = req, key
        if not self.eviction_enabled:
            assert best is not None, "preemption with no active slots"
        return best

    def _release(self, req: Request) -> None:
        """Free a request's pages and queue them for the engine's Kg-row
        sweep, routing through the engine's ``release_filter`` so ghost
        ids of evicted pages (table aliases, not allocator pages) never
        reach ``PageAllocator.free``."""
        pages = (self.release_filter(req) if self.release_filter is not None
                 else req.pages)
        if pages:
            self.allocator.free(pages)
            self.released.extend(pages)
        req.pages = []

    def _preempt(self, req: Request,
                 swap_out: Optional[Callable[[Request], None]]) -> None:
        slot = req.slot
        req.swap_len = int(self.cur_len[slot])
        if swap_out is not None:
            swap_out(req)                  # capture BEFORE pages are freed
        self._release(req)
        req.swapped = True
        req.n_preemptions += 1
        self.n_preemptions += 1
        self.slots[slot] = None
        self.active[slot] = False
        self.cur_len[slot] = 0
        self.page_table[slot] = NULL_PAGE
        req.slot = -1
        self.pending.appendleft(req)       # resume ahead of fresh arrivals

    # -- step completion ----------------------------------------------------

    def complete_step(self, next_tokens: np.ndarray,
                      logits: Optional[np.ndarray] = None) -> List[Request]:
        """Record one decode step's outputs; returns requests retired now.

        next_tokens [n_slots] int; logits [n_slots, V] (optional, for
        parity testing). Only slots active DURING the step are recorded.
        """
        retired: List[Request] = []
        for slot in np.nonzero(self.active)[0]:
            req = self.slots[slot]
            tok = int(next_tokens[slot])
            req.out_tokens.append(tok)
            self.note_token(req, tok)
            if logits is not None:
                req.out_logits.append(np.asarray(logits[slot]))
            self.cur_len[slot] += 1
            if req.done:
                retired.append(self._retire(int(slot)))
        return retired

    def note_token(self, req: Request, token: int) -> None:
        """Stamp the first-token time once and fire the streaming callback.
        Called exactly once per token APPENDED to ``req.out_tokens`` (the
        engine calls it for the prefill's first token, ``complete_step``
        for every decode step) — never on preempt -> resume restores,
        which re-materialise KV, not tokens. So the streaming callback is
        exactly-once and in order by construction."""
        if req.first_token_step < 0:
            req.first_token_step = self.now
            req.t_first = self.wall()
        if self.on_token is not None:
            self.on_token(req, token, len(req.out_tokens) - 1, self.now)

    def retire_if_done(self, req: Request) -> bool:
        """Retire a just-admitted request that needs no decode steps
        (max_new_tokens == 1: the prefill already produced its token)."""
        if req.done and self.slots[req.slot] is req:
            self._retire(req.slot)
            return True
        return False

    def drain_released(self) -> List[int]:
        out, self.released = self.released, []
        return out

    def _retire(self, slot: int) -> Request:
        req = self.slots[slot]
        self._release(req)
        self.slots[slot] = None
        self.active[slot] = False
        self.cur_len[slot] = 0
        self.page_table[slot] = NULL_PAGE
        req.retire_step = self.now
        req.t_retire = self.wall()
        self.finished[req.rid] = req
        self.n_retired += 1
        return req

    # -- failure isolation ---------------------------------------------------

    def fail(self, req: Request, reason: str) -> None:
        """Retire ONE request with an error status instead of raising.

        Works on a request in any state (active slot, pending queue,
        swapped-out). Its pages are freed, its partial outputs are kept,
        and the rest of the batch is untouched — a poisoned request never
        takes the serving loop down. Failed requests count in ``n_failed``,
        NOT ``n_retired`` (retired means completed cleanly).
        """
        req.status = "error"
        req.error = reason
        slot = req.slot
        if slot >= 0 and self.slots[slot] is req:
            self._release(req)
            self.slots[slot] = None
            self.active[slot] = False
            self.cur_len[slot] = 0
            self.page_table[slot] = NULL_PAGE
            req.slot = -1
        else:
            try:
                self.pending.remove(req)
            except ValueError:
                pass
            self._release(req)
        req.swapped = False
        req.retire_step = self.now
        req.t_retire = self.wall()
        self.finished[req.rid] = req
        self.n_failed += 1
