"""Sparse decode serving engine, PyTorch port.

Two serving paths of the JAX package's engine share the SeerAttention-R
machinery (gate selection, block-sparse decode kernels):

  * ``generate(batch, n)``: the uniform-batch path. One contiguous
    ``DecodeState``; every row decodes in lockstep.
  * ``serve(requests)``: continuous batching over a PAGED KV cache
    (``serve.paging`` + ``serve.scheduler``). Requests are admitted into
    free decode slots each iteration, rows have ragged lengths, pages are
    allocated lazily as decode crosses page boundaries, and a dry pool
    preempts the least-progressed request to host swap space
    (``serve.offload``) instead of stalling. Finished requests retire and
    their pages are recycled at once. Under pressure the engine evicts
    cold PAGES before whole requests (RaaS eviction with ghost rows and
    replay, ``serve.eviction``), bounds the swap space in bytes with a
    disk tier below it, isolates injected or real faults to the request
    they hit, takes open-loop arrivals on a virtual step clock and streams
    every token through a callback (``serve.frontend`` drives a trace).

Decode behaviour is one frozen ``core.policy.DecodeOptions``: the
selection policy (gate, Quest with its metadata cache, Quest recompute,
oracle, sliding window, dense), its SelectionSchedule, the budget and the
sampling. ``serve`` also takes per-request ``"budget"`` caps (masked at
run time) and ``"sampling"`` overrides, each request drawing from its own
seeded stream. The engine runs on CUDA unless the caller passes
``device="cpu"``; with no card and no explicit device it raises.

The recurrent families (the Mamba1 LM, pages-free; the Mamba2 hybrid,
whose shared attention block pages its K/V) carry a per-slot recurrent
state (``serve.slotstate.SlotState``) beside the pools: written at
admission and at resume, captured into the swap entry at preemption, and
replaced by a step's new state only once the step is kept (an eviction
replay re-runs from the same state).

Sharded serving: ``DecodeEngine(..., shard=Shard(group),
options=DecodeOptions(split_k=...))`` on every rank of a
``torch.distributed`` group, each with the same full parameters and
requests; every decoder family takes it. The engine keeps the rank's
block of the parameters, as the reference's per-rank layout cuts them
(``distributed.sharding.decode_params``): each attention's projections
of its KV heads (the gate whole), the dense MLPs' and shared experts'
hidden units, the routed experts, the Mamba mixers, the embedding and
the logits' vocabulary; a module that the world size does not divide
stays whole. ``serve`` then keeps only the rank's KV heads of every page
pool (the prefill writes them, swap moves and restores them) and sums
each layer's partial outputs over the ranks; the Mamba layers run over
the rank's channels (Mamba1) or heads (Mamba2) with their per-slot state
at that size (admission writes, swap captures and restores the rank's
rows), and a MoE block computes the rank's experts and gathers their
outputs. ``generate`` gathers the prefill's caches over the heads and
splits them along the sequence (the Mamba1 LM has none: its state alone
is the rank's). Every rank computes the same logits (the vocabulary
blocks gathered whole), so the replicated scheduler takes the same
decisions everywhere, and the stats a rank returns are the unsharded
run's: the swapped bytes are summed over the ranks, with the
recurrent rows that every rank holds whole (Mamba2's ``B|C`` conv
columns) counted once. Every rank's swap entries are the same size, so a
bounded swap tier demotes, and refuses, alike on every rank; its own
figures (``stats["swap"]``) are what the ranks' tiers held, summed. A
sharded engine takes
GatePolicy or DensePolicy, and ``serve``
on it takes every decode option of the unsharded one: a
SelectionSchedule (the carried plan holds the rank's heads; the gate's
``unify_heads`` max is reduced over ranks), per-request budgets and
sampling, and open-loop arrivals. Sampling reads the replicated logits
and every rank draws from the same seeded generator, so every rank picks
the same token. ``generate``'s sequence-sharded step takes the trivial
schedule only, as the reference's does.

A data axis (``DecodeEngine(..., shard=model, data=data)``, the two
groups of ``distributed.sharding.data_model_shards``; the rank is ``d *
M + m``) reaches ``generate`` only. A batch that the data axis divides
is split by rows (``sharding.data_rows``): each replica prefills and
decodes its rows on its model group, a MoE block routing as the whole
batch would (``moe.moe_mlp(data=)``, each replica computing its share
of the capacity's slots), and the tokens are gathered over the data
group, so every rank returns the whole batch's. Under the EP-major
layout (``cfg.ep_major``) the rows split over data x model instead, each
rank decoding its own with the attention whole and the MoE's experts
exchanged over the model group, and the tokens are gathered over that
world; ``serve`` refuses that layout. A batch it
does not divide (batch 1) stays whole on every replica, and the
sequence-sharded step splits the caches over the whole data x model
world in rank order (the reference's ``dp + ("model",)``,
``Shard.over_sequence``): the weights stay at the model group's layout,
and the per-step q/k/v head gather stays on the model group. Paged
``serve`` takes no data axis: the reference's ``paged_pool_pspecs`` puts
nothing on it, so a data replica of ``serve`` is another engine. On a CUDA
device every layer's selection and sparse attention go through the
hand-written kernels (``kernels/ops.py``), or, for the policies the
reference scores in jnp, through plain PyTorch on the card; on the CPU
through the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.core.policy import (DecodeOptions, DensePolicy, GatePolicy,
                                     default_options)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (Shard, data_rows, decode_params, ep_rows,
                                              ep_view, part, replicated_state_bytes,
                                              seq_shard_state)
from repro_torch.models.registry import get_api
from repro_torch.serve import paging as pg
from repro_torch.serve import sampling as smp
from repro_torch.serve.eviction import EvictionConfig, EvictionManager
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.offload import HostSwapSpace, SwapConfig, SwapEntry, SwapError
from repro_torch.serve.scheduler import Request, Scheduler, pages_needed
from repro_torch.serve.slotstate import SlotState, read_slot, write_slot


class GenerationResult(Dict):
    pass


class ServeResult(Dict):
    """rid -> list of generated token ids, plus ``stats`` (and ``logits``
    when collected), with dict access like GenerationResult."""
    pass


def seq_sharded(cfg: ModelConfig, options: DecodeOptions, shard) -> bool:
    """Whether ``generate`` splits its attention caches along the sequence:
    a shard, a selecting policy (a dense policy reads every cache row on
    every rank, as the reference's unsharded branch does) and a model with
    attention caches (the Mamba1 LM has none)."""
    return (shard is not None and not cfg.ep_major and not options.policy.dense
            and get_api(cfg).paged_attn_layers(cfg) > 0)


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, max_len: int,
                 options: Optional[DecodeOptions] = None, device=None,
                 shard=None, data=None):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.arch_id}: the {cfg.family!r} family is an encoder "
                             "with no decode; it runs through lm_forward only")
        for grp in (shard, data):
            if grp is not None and not isinstance(grp, Shard):
                raise TypeError(f"shard and data must be repro_torch.distributed.sharding."
                                f"Shard, got {type(grp).__name__}")
        if data is not None and shard is None:
            raise ValueError("a data axis needs the model group's Shard too (a one-rank "
                             "group at model parallelism 1): sharding.data_model_shards")
        options = options if options is not None else default_options(cfg)
        if options.split_k > 1 and shard is None:
            raise ValueError("split_k > 1 applies to the paged sharded path only: "
                             "construct DecodeEngine(..., shard=Shard(group))")
        if shard is not None and not isinstance(options.policy, (GatePolicy, DensePolicy)):
            raise ValueError("sharded decoding supports GatePolicy (distributed gate "
                             "top-k) or DensePolicy only")
        if ep_view(shard, cfg) is not shard and cfg.moe.dispatch != "shard_map":
            raise ValueError("the EP-major layout runs the MoE's dispatch='shard_map' only")
        self.shard = shard
        self.data = data
        self._world = None          # the data x model world, built on first use
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = get_api(cfg)
        w = params["embed"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params live on {w.device}, engine device is "
                             f"{self.device}: move them first")
        # the rank's block of every split leaf (the caller's full tree
        # stays as it is)
        self.params = params if shard is None else decode_params(params, cfg, shard)
        self.max_len = max_len
        self.options = options
        self._last_aux = None       # measured selection of the latest step
        self._last_active = None    # serve(): slots active during that step
        # serve(): the power-of-two prefill buckets (in pages) seen so far
        self._prefill_buckets: set = set()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _step(self, params, state, token, generator=None, shard=None, data=None):
        """One decode step: (next token, logits, state, aux). The state's
        caches are updated in place; ``generator`` feeds stochastic
        sampling. ``shard`` (default the engine's) and ``data`` are
        ``generate``'s for this batch."""
        logits, state, aux = self.api.decode_step(
            params, state, token, self.cfg, options=self.options,
            shard=self.shard if shard is None else shard, data=data)
        nxt = smp.sample(logits, self.options.sampling, generator)
        return nxt, logits, state, aux

    def _generator(self, generator):
        """The caller's generator, or seed 0 on the engine's device when
        sampling is stochastic (the reference's PRNGKey(0) default)."""
        if generator is None and not self.options.sampling.greedy:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], generator=None, *, data=None):
        """batch["tokens"] [B, L] (tensor or array) -> (first token [B],
        state); a vision model's ``batch["image_embeds"]`` [B, n_img, d]
        rides along to its cross-attention layers. The options ride along
        too, so a metadata-reading policy gets its metadata cache built
        here. ``data``: the batch is that data replica's rows."""
        inputs = {"tokens": torch.as_tensor(batch["tokens"], device=self.device)}
        if batch.get("image_embeds") is not None:
            inputs["image_embeds"] = torch.as_tensor(batch["image_embeds"],
                                                     device=self.device)
        logits, state = self.api.prefill(self.params, inputs, self.cfg, self.max_len,
                                         options=self.options, shard=self.shard, data=data)
        return smp.sample(logits, self.options.sampling,
                          self._generator(generator)), state

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], n_tokens: int, *,
                 generator: Optional[torch.Generator] = None) -> GenerationResult:
        """Uniform-batch decode of ``n_tokens`` per row (the first comes
        from prefill, then ``n_tokens - 1`` decode steps). ``generator``
        (any device) feeds a stochastic ``options.sampling``, default seed 0
        on the engine's device; greedy decoding consumes no randomness. On
        a sharded engine with a selecting policy the prefill's attention is
        replicated, then each rank keeps its part of the caches along the
        sequence; that step takes the trivial schedule only, and any other
        raises ValueError before the prefill. A recurrent family's state
        comes out of the prefill at the rank's size, and so do the
        attention caches of a dense policy (the rank's KV heads). With a
        data axis the rows split over it where it divides the batch (the
        tokens gathered back over it; ``sparsity_stats`` reads the
        replica's rows), else the sequence splits over the whole world
        (the module docstring)."""
        sharded = seq_sharded(self.cfg, self.options, self.shard)
        if sharded and not self.options.schedule.is_trivial:
            raise ValueError(
                "sharded generate needs the trivial schedule (its selection is "
                "fused into the collectives and carries no plan); serve() takes "
                "schedules on a sharded engine")
        self._last_aux = self._last_active = None   # stats reflect THIS run
        generator = self._generator(generator)
        shard, data, rows, gather = self._axes(len(batch["tokens"]))
        if rows is not None:
            batch = {k: None if v is None else v[rows[0]:rows[0] + rows[1]]
                     for k, v in batch.items()}
        t0 = time.perf_counter()
        token, state = self.prefill(batch, generator, data=data)
        if sharded:
            state = self.seq_shard(state, shard)
        self._sync()
        prefill_s = time.perf_counter() - t0
        toks = [token]
        t1 = time.perf_counter()
        for _ in range(n_tokens - 1):
            token, _, state, aux = self._step(self.params, state, token, generator, shard,
                                              data)
            self._last_aux = aux
            toks.append(token)
        self._sync()
        decode_s = time.perf_counter() - t1
        out, final_len = torch.stack(toks, dim=1), state.cur_len
        if gather is not None:
            out, final_len = (gather.all_gather(t, 0) for t in (out, final_len))
        return GenerationResult(
            tokens=out, prefill_s=prefill_s, decode_s=decode_s,
            tok_per_s=(n_tokens - 1) * out.shape[0] / max(decode_s, 1e-9),
            final_len=final_len)

    def _axes(self, batch_size: int):
        """(the step's shard, the rows' data shard or None, (first row,
        rows) or None, the group the tokens are gathered over or None) of a
        ``generate`` of ``batch_size`` rows: without a data axis the
        engine's shard over every row; rows over the data axis where it
        divides them; else every row, the sequence over the data x model
        world. Under the EP-major layout the rows split over data x model
        (``sharding.ep_rows``; a batch that world does not divide raises)."""
        if ep_view(self.shard, self.cfg) is not self.shard:
            rows = ep_rows(batch_size, self.shard, self.data)
            world = self.shard if self.data is None else self.world_shard()
            return self.shard, self.data, rows, world
        if self.data is None:
            return self.shard, None, None, None
        row0, rows = data_rows(batch_size, self.data)
        if rows * self.data.world == batch_size:
            return self.shard, self.data, (row0, rows), self.data
        return self.shard.over_sequence(self.world_shard()), None, None, None

    def world_shard(self) -> Shard:
        """The data x model world in rank order ``d * M + m``: the default
        process group, which must be exactly those ranks."""
        if self._world is None:
            d, m = self.data, self.shard
            if (dist.get_world_size() != d.world * m.world
                    or dist.get_rank() != d.rank * m.world + m.rank):
                raise ValueError(f"the default group (rank {dist.get_rank()} of "
                                 f"{dist.get_world_size()}) is not data {d.world} x model "
                                 f"{m.world} in rank order d * M + m")
            self._world = Shard()
        return self._world

    def seq_shard(self, state, shard=None):
        """A sharded prefill's state -> the sequence-sharded step's: the
        attention caches gathered over the KV heads (where the world size
        splits them) and cut to the rank's part along the sequence (over
        ``shard``'s ``seq_group``; ``shard`` default the engine's)."""
        shard = self.shard if shard is None else shard
        return seq_shard_state(state, shard, self.cfg.gate.block_size,
                               gather_heads=part(shard, self.cfg.n_kv_heads) is not None)

    # -- continuous batching over paged KV ---------------------------------

    @torch.no_grad()
    def serve(self, requests: Sequence[Dict[str, Any]], *,
              n_slots: int = 4, num_pages: Optional[int] = None,
              collect_logits: bool = False,
              max_steps: Optional[int] = None, sample_seed: int = 0,
              admission: str = "lazy", watermark: int = 0,
              eviction: Optional[EvictionConfig] = None,
              swap_config: Optional[SwapConfig] = None,
              faults: Optional[FaultInjector] = None, arrivals=None, on_token=None,
              table_pages: Optional[int] = None) -> ServeResult:
        """Continuous-batching decode over a paged KV cache.

        requests: each ``{"tokens": 1-D int array, "max_new_tokens": int}``
        plus optional ``"rid"``, the per-request overrides ``"sampling"``
        (SamplingParams replacing ``options.sampling``) and ``"budget"``
        (a token budget, applied as a run-time cap on the slot's selected
        list: rounded UP to whole blocks and floored at the forced
        first/last blocks; a cap past the list's width changes nothing),
        and the SLO-tier fields ``"tier"``,
        ``"priority"`` (orders admission, protects against preemption) and
        ``"reserve"`` (this request reserves its whole lifetime of pages
        up front). Admission is priority-then-FIFO. A stochastic request
        draws its t-th token from a generator seeded by (``sample_seed``,
        its registration index, t), so its trajectory depends neither on
        its slot nor on preemption.

        ``admission="lazy"`` (default) admits on current occupancy (prompt
        pages only), grows each slot's pages on demand, holds
        ``watermark`` free pages back from admission as growth headroom,
        and when the pool runs dry PREEMPTS the active request of lowest
        priority, then fewest generated tokens, then lowest rid: its pages
        go to host swap space and it is re-admitted later with its pages
        restored, resuming bitwise-identically. ``"reserve"`` reserves
        every request's full lifetime at admission (no growth, no
        preemption). ``num_pages`` defaults to every slot holding a
        worst-case sequence, plus the null page.

        Open-loop traffic: ``arrivals`` has ``pull(step) -> list of
        request dicts`` and an ``exhausted`` property
        (``serve.traffic.StepArrivals``); requests join the running batch
        at their arrival step on the VIRTUAL clock (decode-loop
        iterations), so a fixed trace replays to identical token streams.
        With ``arrivals``, ``requests`` may be empty, and ``max_steps`` and
        ``table_pages`` (the page-table width, >= any arriving request's
        lifetime pages) are required. ``on_token(req, token, index,
        step)`` streams every generated token (the prefill's first
        included) exactly once, in order, when it is appended; a
        preempt/resume does not re-fire.

        Memory pressure and failures:

        ``eviction``: an ``EvictionConfig`` (or ``True`` for defaults)
        turns on RaaS PAGE eviction: when the pool runs dry, the coldest
        full pages of running requests are swapped out one by one before
        any whole request is preempted; a step that selects an evicted
        page is caught by its ``track_evictions`` telemetry, the page is
        restored and the step replayed (``serve.eviction``). Needs lazy
        admission and a policy that reads only the selected blocks.

        ``swap_config``: a ``SwapConfig`` bounding the host swap tier in
        bytes, with an optional disk tier below it (LRU demotion).

        ``faults``: a ``serve.faults.FaultInjector`` driving deterministic
        failures through the alloc, swap, disk and logits seams. After
        argument validation, serve() does not raise for per-request
        trouble: a request that hits an unrecoverable fault (an unreadable
        swap entry, non-finite logits, an admission stall, the
        ``max_steps`` watchdog) retires with ``status="error"`` and its
        PARTIAL tokens are still returned; the rest of the batch is
        unaffected. ``stats["errors"]`` maps rid -> reason.

        Returns ``ServeResult``: rid -> generated token ids (length
        ``max_new_tokens``); ``res["stats"]`` holds throughput, scheduler,
        swap-tier, eviction and fault telemetry, the lifecycle stamps and
        the measured sparsity per request; ``res["logits"]`` (rid -> [n, V]
        fp32, prefill token included) when ``collect_logits``. A sharded
        engine takes all of these; its scheduler is replicated and takes
        the same decisions on every rank. A cross-attention (vision) model
        has no paged step, in the reference neither, and raises
        ``NotImplementedError`` before any work; so does an engine at the
        EP-major layout (ValueError), whose rows split over data x model:
        paged serving has no data axis.
        """
        cfg = self.cfg
        ps = cfg.gate.block_size
        dev = self.device
        if cfg.cross_attn_period:
            raise NotImplementedError("paged decode: cross-attn families TBD "
                                      "(serve a vision model through generate)")
        if ep_view(self.shard, cfg) is not self.shard:
            raise ValueError("serve: the EP-major layout splits the rows over data x model; "
                             "paged serving keeps every slot on every rank (build the engine "
                             "without ep_major)")
        if arrivals is not None:
            if max_steps is None:
                raise ValueError(
                    "arrivals requires an explicit max_steps — the engine "
                    "cannot bound the run from an undrained arrival process")
            if table_pages is None:
                raise ValueError(
                    "arrivals requires table_pages (page-table width >= any "
                    "arriving request's lifetime pages) — the engine cannot "
                    "size the table from an undrained arrival process")

        reqs: List[Request] = []
        rho_n: Dict[Any, int] = {}
        sampling_of: Dict[Any, smp.SamplingParams] = {}
        budget_of: Dict[Any, Optional[int]] = {}
        ridx_of: Dict[Any, int] = {}
        rejected_arrivals = 0

        def register(rd: Dict[str, Any]) -> Request:
            """One request dict -> a tracked Request, with its overrides and
            its registration index (which seeds its sampling stream), for
            upfront requests and arrivals alike."""
            req = Request(
                rid=rd.get("rid", len(reqs)),
                prompt=np.asarray(rd["tokens"], np.int32).reshape(-1),
                max_new_tokens=int(rd["max_new_tokens"]),
                tier=str(rd.get("tier", "default")),
                priority=int(rd.get("priority", 0)),
                admit_reserve=bool(rd.get("reserve", False)))
            reqs.append(req)
            rho_n[req.rid] = 0
            sampling_of[req.rid] = rd.get("sampling") or self.options.sampling
            budget_of[req.rid] = rd.get("budget")
            ridx_of[req.rid] = len(ridx_of)
            return req

        for rd in requests:
            register(rd)
        if not reqs and arrivals is None:
            return ServeResult(stats={})
        rids = [r.rid for r in reqs]
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate request ids: {sorted(rids)}")
        clash = set(rids) & {"stats", "logits"}
        if clash:
            raise ValueError(f"request ids collide with reserved result "
                             f"keys: {clash}")
        self._last_aux = self._last_active = None   # stats reflect THIS run

        if eviction is True:
            eviction = EvictionConfig()
        step_options = self.options
        if eviction is not None:
            if admission != "lazy":
                raise ValueError(
                    "eviction requires admission='lazy' (reserve admission "
                    "never runs out of pages mid-flight)")
            # validates the policy and schedule up front (reads_full_kv,
            # dense-staged layers: see DecodeOptions)
            step_options = self.options.replace(track_evictions=True)

        npt = max([pages_needed(r.prompt_len, r.max_new_tokens, ps) for r in reqs]
                  + ([int(table_pages)] if table_pages is not None else []))
        if num_pages is None:
            # enough for every slot to hold a worst-case sequence (+null)
            num_pages = n_slots * npt + 1
        sched = Scheduler(n_slots, num_pages, ps, npt, admission=admission,
                          watermark=watermark, eviction_enabled=eviction is not None,
                          faults=faults)
        sched.on_token = on_token
        # the recurrent families' per-slot state: written at admission and
        # resume, captured at preemption, and replaced by each accepted step
        slot_state = (None if self.api.init_slot_state is None
                      else self.api.init_slot_state(cfg, n_slots, device=dev,
                                                    shard=self.shard))
        swap = HostSwapSpace(config=swap_config, faults=faults)
        # swap entries moved out and back in carrying recurrent rows
        state_swaps = [0, 0]
        for r in reqs:
            sched.submit(r)

        # per-slot caps on the selected list, only when some request sets a
        # budget (otherwise no mask exists at all). Slots without one get a
        # cap that never binds; a cap rounds UP to whole blocks (as
        # DecodeOptions.max_selected does) and keeps the forced first/last
        # blocks, which rank ahead of every scored block. With arrivals the
        # mask exists from the start: a later arrival may carry a budget
        no_cap = 2 ** 30
        floor = max(1, int(cfg.gate.always_first_block) + int(cfg.gate.always_last_block))
        use_budget = (arrivals is not None
                      or any(b is not None for b in budget_of.values()))
        budget_blocks = np.full((n_slots,), no_cap, np.int32) if use_budget else None

        def slot_cap(rid) -> int:
            b = budget_of[rid]
            return no_cap if b is None else max(floor, -(-int(b) // ps))

        def sample_slot(req: Request, row: torch.Tensor) -> int:
            """One slot's next token with the request's sampling params; a
            stochastic draw uses the request's own seeded stream."""
            params_s = sampling_of[req.rid]
            if params_s.greedy:
                return int(torch.argmax(row))
            seed = np.random.SeedSequence(
                [sample_seed, ridx_of[req.rid], len(req.out_tokens)]).generate_state(1)[0]
            gen = torch.Generator().manual_seed(int(seed))
            return int(smp.sample(row, params_s, gen))

        kv_heads = (self.shard.local_heads(cfg.n_kv_heads)
                    if self.shard is not None and self.api.paged_attn_layers(cfg) else None)
        ghosts = 0
        if eviction is not None:
            ghosts = (eviction.ghost_rows if eviction.ghost_rows is not None
                      else n_slots * npt)
        # min/max metadata pools only for the policy that reads them
        pages = pg.init_pages(cfg, num_pages, self.api.paged_attn_layers(cfg),
                              with_meta=self.options.policy.needs_meta,
                              ghost_rows=ghosts, quantize=self.options.quantize,
                              device=dev, kv_heads=kv_heads)
        evmgr = None
        if eviction is not None:
            evmgr = EvictionManager(
                sched, swap, num_phys=num_pages, ghost_rows=ghosts, page_size=ps,
                page_bytes=EvictionManager.page_restore_bytes(pages),
                always_first_block=cfg.gate.always_first_block, config=eviction)
        token_buf = np.zeros((n_slots,), np.int32)
        # per-step selection telemetry stays on the device until the run
        # ends: (sparsity rows [S], sel rows [S], {slot: rid} of live rows)
        telemetry: List[Any] = []
        active_sum = active_max = idle_spins = 0
        n_steps = 0
        t0 = time.perf_counter()
        limit = max_steps if max_steps is not None else sum(
            r.max_new_tokens for r in reqs) + len(reqs) + 8

        # requests whose swap-out hit a permanent fault inside a scheduler
        # callback (where failing in place would corrupt the preemption
        # bookkeeping): failed right after the callback chain unwinds,
        # before the next step runs
        pending_failures: List[Any] = []

        def fail_req(req: Request, reason: str) -> None:
            sched.fail(req, reason)
            swap.discard(req.rid)

        def flush_failures() -> None:
            while pending_failures:
                req, reason = pending_failures.pop()
                if req.rid not in sched.finished:
                    fail_req(req, reason)

        def swap_out(req: Request) -> None:
            """Preemption callback: copy the victim's CONTENT pages (in
            logical order, padded as the reference pads them) and its
            pending token to host swap space BEFORE the scheduler frees
            the pages. A growth page allocated for the not-yet-written
            next token is dropped; re-admission re-grows it.

            Blocks of the victim that page eviction already moved to the
            host are stitched back into the one SwapEntry from their
            PageEntries (a ghost id holds no K/V, so it is extracted
            through the trash page and overwritten), and the resume takes
            the whole-request restore path. A recurrent family's slot rows
            ride along. A permanent swap fault marks the victim failed
            instead of raising through the scheduler."""
            n_content = max(1, -(-req.swap_len // ps))
            content = [p if p < num_pages else pg.NULL_PAGE
                       for p in req.pages[:n_content]]
            k, v, kg, kmin, kmax, k_sc, v_sc = pg.extract_pages(
                pages, pg.pad_page_ids(content, device=dev))
            reason = None
            if evmgr is not None:
                blocks = evmgr.evicted.pop(req.rid, None) or {}
                for lb, ghost in sorted(blocks.items()):
                    evmgr.ghost_free.append(ghost)
                    try:
                        pe = swap.pop(("page", req.rid, lb))
                    except SwapError:
                        reason = "restore_failed"
                        continue
                    for full, part in ((k, pe.k), (v, pe.v), (kg, pe.kg), (kmin, pe.kmin),
                                       (kmax, pe.kmax), (k_sc, pe.k_scale),
                                       (v_sc, pe.v_scale)):
                        if full is not None and part is not None:
                            full[:, lb] = part[:, 0]
            row = (SlotState(None, None) if slot_state is None
                   else SlotState(*(t.cpu() for t in read_slot(slot_state, req.slot))))
            if reason is None:
                try:
                    swap.put(req.rid, SwapEntry(k=k, v=v, kg=kg,
                                                token=int(token_buf[req.slot]),
                                                cur_len=req.swap_len, kmin=kmin, kmax=kmax,
                                                k_scale=k_sc, v_scale=v_sc,
                                                state_conv=row.conv, state_h=row.h))
                    if slot_state is not None:
                        state_swaps[0] += 1
                except SwapError:
                    reason = "swap_put_failed"
            if reason is not None:
                pending_failures.append((req, reason))

        # a recycled page may hold a previous tenant's Kg, metadata (and
        # int8 scale) rows, and a partial trailing page must read ZERO rows. Freed
        # pages are collected in ``dirty`` and zeroed in one batched call
        # per iteration; admission reuse is cleaned by scatter_prefill/
        # restore anyway, so growth only re-zeroes a page freed in the same
        # iteration.
        dirty: set = set()
        # reserve admission never grows: every reuse goes through
        # scatter_prefill, which zeroes the Kg rows itself
        gate_paged = admission == "lazy" and (
            pages.kg_pages is not None or pages.kmin_pages is not None
            or pages.k_scale_pages is not None)

        def sweep_dirty(ids) -> None:
            if ids and gate_paged:
                pg.reset_kg_rows(pages, pg.pad_page_ids(sorted(ids), device=dev))
            dirty.difference_update(ids)

        def mark_live(ids) -> None:
            """Pages just (re)written with live content leave both
            pending-zero queues, so a later sweep cannot clobber them (a
            page can be freed and reused within one iteration: retirement
            at admission, eviction, a replay's restore)."""
            live = set(ids)
            dirty.difference_update(live)
            sched.released = [p for p in sched.released if p not in live]

        if evmgr is not None:
            def evict_cb(n: int) -> int:
                return evmgr.evict(pages, n)

            def release_filter(req: Request):
                # heat rows are per-slot state; the slot is being vacated
                if req.slot >= 0 and sched.slots[req.slot] is req:
                    evmgr.heat.reset_row(req.slot)
                evmgr.forget(req)    # drop host entries, reclaim ghosts
                return [p for p in req.pages if p < num_pages]

            sched.evict_cb = evict_cb
            sched.release_filter = release_filter
            evmgr.mark_clean = mark_live

        def fail_unfinished(reason: str) -> None:
            for r in reqs:
                if r.rid not in sched.finished:
                    fail_req(r, reason)

        while sched.has_work() or (arrivals is not None and not arrivals.exhausted):
            # the virtual clock: lifecycle ``*_step`` stamps and the
            # arrival schedule read the decode-loop iteration counter,
            # never wall time
            sched.now = n_steps
            if arrivals is not None:
                for rd in arrivals.pull(n_steps):
                    rid = rd.get("rid", len(reqs))
                    if rid in ridx_of or rid in ("stats", "logits"):
                        # a malformed trace entry is dropped: the running
                        # batch must not pay for it
                        rejected_arrivals += 1
                        continue
                    req = register(rd)
                    try:
                        sched.submit(req)
                    except ValueError as e:
                        # an arrival the pool or table can never hold
                        # fails ALONE, with the reason, mid-run
                        sched.fail(req, f"submit_rejected: {e}")
            for req in sched.admissions():
                if req.swapped:            # resume: restore, don't prefill
                    try:
                        entry = swap.pop(req.rid)
                    except SwapError:
                        # a permanently unreadable swap entry: the request's
                        # KV is gone. Fail IT, keep serving the others
                        fail_req(req, "restore_failed")
                        continue
                    n_content = max(1, -(-entry.cur_len // ps))
                    pg.restore_pages(pages, entry.k, entry.v, entry.kg,
                                     pg.pad_page_ids(req.pages[:n_content],
                                                     device=dev),
                                     entry.kmin, entry.kmax,
                                     k_scale=entry.k_scale, v_scale=entry.v_scale)
                    if slot_state is not None:
                        state_swaps[1] += 1
                        slot_state = write_slot(
                            slot_state, SlotState(entry.state_conv, entry.state_h), req.slot)
                    token_buf[req.slot] = entry.token
                    req.swapped = False
                else:
                    slot_state, row = self._paged_prefill(pages, slot_state, req, ps)
                    first = sample_slot(req, row)
                    lg = row.float().cpu().numpy() if collect_logits else None
                    req.out_tokens.append(first)
                    sched.note_token(req, first)   # first-token stamp + stream
                    if collect_logits:
                        req.out_logits.append(lg)
                    token_buf[req.slot] = first
                mark_live(req.pages)                 # content written
                if budget_blocks is not None:
                    budget_blocks[req.slot] = slot_cap(req.rid)
                sched.retire_if_done(req)
            if evmgr is not None:
                evmgr.enforce_caps(pages)
            fresh = sched.prepare_step(swap_out)   # lazy growth + preemption
            flush_failures()
            dirty.update(sched.drain_released())
            sweep_dirty([p for p in fresh if p in dirty])
            if not sched.active.any():
                if not sched.pending:
                    if arrivals is not None and not arrivals.exhausted:
                        # an open-loop gap: nothing to decode yet, but the
                        # trace has more arrivals. Tick the virtual clock
                        # forward so they come due (bounded by max_steps)
                        n_steps += 1
                        if n_steps > limit:
                            fail_unfinished("step_limit")
                            break
                        continue
                    break
                # preemption may have just vacated every slot while freeing
                # its pages: loop back through admissions once before
                # declaring a stall
                idle_spins += 1
                if idle_spins > 1:
                    # no-progress watchdog: fail the request admission keeps
                    # choosing, which unblocks the queue by one
                    fail_req(max(sched.pending, key=lambda r: r.priority),
                             "admission_stall")
                    idle_spins = 0
                continue
            idle_spins = 0
            active_now = int(sched.active.sum())
            active_sum += active_now
            active_max = max(active_max, active_now)
            replays = 0
            while True:
                # the step returns a NEW recurrent state and never writes
                # its input: a replayed attempt re-runs from the same
                # slot_state, which is adopted only once the step is kept
                logits, pages, slot_state_out, aux = self.api.decode_step_paged(
                    self.params, pages, slot_state,
                    torch.as_tensor(token_buf, device=dev),
                    torch.as_tensor(sched.page_table, device=dev),
                    torch.as_tensor(sched.cur_len, device=dev),
                    torch.as_tensor(sched.active, device=dev), cfg,
                    options=step_options,
                    budget_blocks=(None if budget_blocks is None
                                   else torch.as_tensor(budget_blocks, device=dev)),
                    shard=self.shard)
                if evmgr is None:
                    break
                touched = aux["touched_pages"].cpu().numpy()
                faulted = (touched & (sched.page_table >= num_pages)
                           & sched.active[:, None])
                if not faulted.any():
                    # the victim model feeds on fault-free steps only (a
                    # replay's reads are restore traffic, not attention heat)
                    evmgr.heat.observe(touched, sched.active)
                    break
                # optimistic execution faulted: a row selected a block whose
                # K/V is evicted (its gate/meta ghost rows scored it as
                # usual). Restore the pages and RE-RUN the step over the
                # pools this attempt updated in place (its page writes are
                # rewritten with the same values before any read)
                evmgr.n_replays += 1
                replays += 1
                if replays > evmgr.config.max_replays:
                    # evict/restore thrash: fail the faulted requests; the
                    # surviving rows never read a ghost, so their logits
                    # stand as they are
                    for slot in np.nonzero(faulted.any(axis=1))[0]:
                        if sched.slots[slot] is not None:
                            fail_req(sched.slots[slot], "restore_thrash")
                    break
                # pin every page ANY active row touched (and each trailing
                # block): restoring row A must not evict what row B's
                # replay reads, or the replays could ping-pong forever
                pinned = set()
                for slot in np.nonzero(sched.active)[0]:
                    r = sched.slots[slot]
                    for lb in np.nonzero(touched[slot])[0]:
                        pinned.add((r.rid, int(lb)))
                    pinned.add((r.rid, int(sched.cur_len[slot]) // ps))
                for slot in np.nonzero(faulted.any(axis=1))[0]:
                    r = sched.slots[slot]
                    if r is None or not sched.active[slot]:
                        continue    # preempted while restoring another row
                    lbs = [int(x) for x in np.nonzero(faulted[slot])[0]]
                    if not evmgr.restore(pages, r, lbs, pinned=pinned, swap_out=swap_out):
                        fail_req(r, "restore_failed")
                flush_failures()
                dirty.update(sched.drain_released())
                if not sched.active.any():
                    break
            # the attempt that ended the loop is the accepted one (fault-
            # free, or its surviving rows are valid); slots that failed or
            # were preempted get their rows rewritten before anything
            # reads them
            slot_state = slot_state_out
            if not sched.active.any():
                # every row failed or was preempted mid-replay: count the
                # spin against the step limit so fault storms terminate
                n_steps += 1
                if n_steps > limit:
                    fail_unfinished("step_limit")
                    break
                continue
            self._last_aux = aux
            # idle slots decode garbage rows: remember who was live, so
            # sparsity_stats() averages active rows only
            self._last_active = sched.active.copy()
            slot_reqs = list(sched.slots)   # before retirement mutates it
            # the argmax stays on the device; a row whose logits are not all
            # finite comes back as -1, so one transfer of n_slots ints
            # carries both
            nxt_dev = torch.where(torch.isfinite(logits).all(dim=-1),
                                  torch.argmax(logits, dim=-1), -1)
            if self.options.measure_sparsity:
                telemetry.append((aux["sparsity_rows"], aux["sel_blocks"],
                                  {int(s): slot_reqs[s].rid
                                   for s in np.nonzero(sched.active)[0]}))
            lg_np = (logits.float().cpu().numpy() if collect_logits else None)
            nxt = nxt_dev.to(torch.int32).cpu().numpy()
            if faults is not None and faults.fire("logits"):
                # an injected non-finite row: the first active slot's
                act = np.nonzero(sched.active)[0]
                if act.size:
                    nxt[act[0]] = -1
            for slot in np.nonzero((nxt < 0) & sched.active)[0]:
                fail_req(sched.slots[slot], "non_finite_logits")
            # stochastic requests draw on the device from their own stream
            for slot in np.nonzero(sched.active)[0]:
                if not sampling_of[slot_reqs[slot].rid].greedy:
                    nxt[slot] = sample_slot(slot_reqs[slot], logits[slot])
            sched.complete_step(nxt, lg_np)
            dirty.update(sched.drain_released())   # retirements this step
            sweep_dirty(set(dirty))
            token_buf = np.where(sched.active, nxt, 0).astype(np.int32)
            n_steps += 1
            if n_steps > limit:
                # step-limit watchdog: fail whatever is unfinished, keeping
                # the finished requests' outputs
                fail_unfinished("step_limit")
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

        rho_sum: Dict[Any, float] = {rid: 0.0 for rid in rho_n}
        sel_sum: Dict[Any, float] = {rid: 0.0 for rid in rho_n}
        if telemetry:
            rho_all = torch.stack([t[0] for t in telemetry]).float().cpu().numpy()
            sel_all = torch.stack([t[1] for t in telemetry]).float().cpu().numpy()
            for i, (_, _, live) in enumerate(telemetry):
                for slot, rid in live.items():
                    rho_sum[rid] += float(rho_all[i, slot])
                    sel_sum[rid] += float(sel_all[i, slot])
                    rho_n[rid] += 1

        out = ServeResult()
        for r in reqs:
            out[r.rid] = r.out_tokens
        if collect_logits:
            out["logits"] = {r.rid: np.stack(r.out_logits)
                             for r in reqs if r.out_logits}
        gen_toks = sum(len(r.out_tokens) for r in reqs)
        # slot_util over DECODE-step tokens only (each admission's first
        # token comes from prefill, not from a decode slot)
        decode_toks = gen_toks - sched.n_admitted
        retired_preempted = sum(1 for r in sched.finished.values()
                                if r.n_preemptions > 0)
        swap_stats = swap.stats()
        bytes_out, bytes_in = swap.bytes_out, swap.bytes_in
        if self.shard is not None:
            # each rank swapped its heads and channels: the bytes are the
            # sum, less the recurrent rows every rank holds whole, counted
            # once as the unsharded engine counts them. The tiers' own
            # figures stay what the ranks' hosts and disks held
            keys = ("host_bytes", "disk_bytes", "peak_host_bytes", "peak_disk_bytes")
            summed = self.shard.sum_ints([bytes_out, bytes_in] + [swap_stats[k] for k in keys])
            extra = 0 if slot_state is None else (self.shard.world - 1) * \
                replicated_state_bytes(cfg, self.shard.world, slot_state)
            bytes_out, bytes_in = (b - extra * n for b, n in zip(summed[:2], state_swaps))
            swap_stats.update(zip(keys, summed[2:]))
        out["stats"] = {
            "wall_s": wall, "decode_steps": n_steps,
            "generated_tokens": gen_toks,
            "tok_per_s": gen_toks / max(wall, 1e-9),
            "slot_util": decode_toks / max(n_steps * n_slots, 1),
            "admitted": sched.n_admitted, "retired": sched.n_retired,
            "retired_clean": sched.n_retired - retired_preempted,
            "retired_preempted": retired_preempted,
            "admission_stalls": sched.admission_stalls,
            "admission": admission, "watermark": watermark,
            "preemptions": sched.n_preemptions,
            "resumed": sched.n_resumed,
            "swapped_out_bytes": bytes_out,
            "swapped_in_bytes": bytes_in,
            # failure isolation and memory-pressure telemetry
            "failed": sched.n_failed,
            "errors": {r.rid: r.error for r in sched.finished.values()
                       if r.status != "ok"},
            "swap": swap_stats,
            "faults": None if faults is None else faults.stats(),
            "evictions": 0 if evmgr is None else evmgr.n_evicted,
            "page_restores": 0 if evmgr is None else evmgr.n_page_restores,
            "replay_steps": 0 if evmgr is None else evmgr.n_replays,
            "mean_active_slots": active_sum / max(n_steps, 1),
            "max_active_slots": active_max,
            "peak_pages_used": (sched.allocator.num_pages - 1
                                - sched.allocator.min_free),
            "num_pages": num_pages, "page_size": ps,
            "prefill_buckets_pages": sorted(self._prefill_buckets),
            # measured per-request selection telemetry (decode steps only;
            # empty when telemetry is off)
            "sparsity_by_rid": {rid: rho_sum[rid] / rho_n[rid]
                                for rid in rho_sum if rho_n[rid]},
            "sel_blocks_by_rid": {rid: sel_sum[rid] / rho_n[rid]
                                  for rid in sel_sum if rho_n[rid]},
            # per-request lifecycle: ``*_step`` on the decode-loop clock,
            # ``t_*`` wall-clock seconds, -1 where never reached
            "timing_by_rid": {r.rid: {
                "submit_step": r.submit_step,
                "admit_step": r.admit_step,
                "first_token_step": r.first_token_step,
                "retire_step": r.retire_step,
                "t_submit": r.t_submit, "t_admit": r.t_admit,
                "t_first": r.t_first, "t_retire": r.t_retire,
                "n_tokens": len(r.out_tokens)} for r in reqs},
            "tier_by_rid": {r.rid: r.tier for r in reqs},
            "rejected_arrivals": rejected_arrivals,
        }
        return out

    def _paged_prefill(self, pages: pg.PagedPages, slot_state: Optional[SlotState],
                       req: Request, ps: int):
        """Contiguous prefill of one request, scattered into its pages.

        The prompt is right-padded to a power-of-two number of pages (the
        reference's bucketing, which bounds its jit cache; kept here so
        both packages run the same prefill arithmetic) and its true length
        rides along as ``batch["lengths"]``: causality keeps real positions
        blind to the pad tokens, the logits come from the last real token,
        and ``scatter_prefill`` zeroes the Kg and metadata rows past the
        complete blocks. The family's ``state_view`` names what goes where:
        the attention caches into the pools (nothing for a pages-free
        family) and the recurrent rows into ``slot_state`` at the request's
        slot. Returns (slot_state, the logits row [V] on the device); the
        caller samples."""
        plen = req.prompt_len
        n_prompt = -(-plen // ps)
        bucket = 1 << (n_prompt - 1).bit_length()       # pages, power of 2
        self._prefill_buckets.add(bucket)
        toks = torch.zeros((1, bucket * ps), dtype=torch.int32, device=self.device)
        toks[0, :plen] = torch.as_tensor(req.prompt, device=self.device)
        lengths = torch.tensor([plen], dtype=torch.int32, device=self.device)
        logits, cstate = self.api.prefill(self.params,
                                          {"tokens": toks, "lengths": lengths},
                                          self.cfg, bucket * ps,
                                          options=self.options, shard=self.shard)
        view = self.api.state_view(cstate)
        if view.k_cache is not None:              # a sharded prefill's: the rank's heads
            pg.scatter_prefill(pages, view.k_cache, view.v_cache, view.kg_cache, plen,
                               pg.pad_page_ids(req.pages, device=self.device), ps,
                               kmin_cache=view.meta_kmin, kmax_cache=view.meta_kmax)
        if view.slot is not None:
            slot_state = write_slot(slot_state, view.slot, req.slot)
        return slot_state, logits[0]

    def sparsity_stats(self) -> Dict[str, Any]:
        """Measured selection economics of the LATEST decode step, from
        the step's ACTUAL selected block mask (averaged over layers); after
        ``serve()``, over the slots that were active in that step only.
        The derived I/O terms follow the paper's Fig. 6 model. Before any
        step has run: the same keys, neutral values and
        ``measured=False``."""
        cfg = self.cfg
        if self._last_aux is None or not self.options.measure_sparsity:
            sel = vis = rho = 0.0
            rows = np.zeros((0,), np.float32)
            measured = False
        else:
            aux = {k: v.detach().cpu().numpy() for k, v in self._last_aux.items()}
            rows = np.asarray(aux["sparsity_rows"], np.float32)
            sel_rows = np.asarray(aux["sel_blocks"], np.float32)
            vis_rows = np.asarray(aux["vis_blocks"], np.float32)
            if self._last_active is not None:   # paged: skip idle slots
                act = np.asarray(self._last_active, bool)
                rows, sel_rows, vis_rows = rows[act], sel_rows[act], vis_rows[act]
            sel = float(np.mean(sel_rows))
            vis = float(np.mean(vis_rows))
            rho = float(np.mean(rows))
            measured = True
        return {
            "sparsity": rho, "sparsity_rows": rows,
            "sel_blocks": sel, "vis_blocks": vis,
            "io_speedup": (vis / sel) if sel > 0 else 1.0,
            "kv_bytes_read": sel * cfg.gate.block_size
            * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * 2,
            "gate_overhead_frac": (cfg.gate.d_gate / cfg.gate.block_size)
            / (2 * cfg.resolved_head_dim),
            "measured": measured,
        }
