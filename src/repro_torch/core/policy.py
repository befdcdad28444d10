"""Block-selection policies + the ``DecodeOptions`` decode API, PyTorch port.

Port of the JAX package's ``core/policy.py``: the policies, the
``DecodeOptions`` that carry them, and the SLO tiers (``TierSpec``,
``TierPolicy``, ``default_tiers``) that map a tenant tier onto the
serving engine's per-request fields.

  GatePolicy            the paper's learned gate: gate query -> fused gate
                        score + top-k over the K-compression cache
                        (kernels/gate_select)
  QuestPolicy           training-free query-aware selection from per-block
                        key min/max, kept by the incremental metadata
                        cache (core/quest.py, core/metacache.py)
  QuestRecomputePolicy  the same bound with the min/max rebuilt from the
                        whole K cache every step: the bitwise reference
                        of QuestPolicy
  OraclePolicy          exact top-k over the true attention block scores
                        (core/oracle.py), the quality ceiling
  DensePolicy           no selection; full dense decode attention
  SlidingWindowPolicy   sink blocks + the trailing local window

Every policy is a frozen (hashable) dataclass riding inside the frozen
``DecodeOptions``, which is threaded engine -> model -> kernels. A policy
turns ``SelectionInputs`` into selected LOGICAL block ids ``[B, Hkv, k]``
int32 with -1 padding, the contract of the block-sparse decode kernels.
Policies other than the gate rank with plain top-k
(``sparsity.budget_select``). Their scoring is plain PyTorch on the
engine's device, as it is plain jnp in the reference; their selections
decode through the same kernels as the gate's.

Kernel choice is NOT an option here: the kernel wrappers dispatch on the
device of the tensors they are given (``kernels/ops.py``). The
reference's ``kernel_impl="sharded"`` is no option either: an engine
built with a ``shard`` takes the sharded paths, and ``DecodeEngine``
checks ``split_k``, the policy and the schedule against it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kcache as kc
from repro_torch.core import sparsity as sp
from repro_torch.serve.sampling import GREEDY, SamplingParams

# per-layer staging of a SelectionSchedule
STAGE_DENSE, STAGE_SELECT, STAGE_REUSE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class SelectionSchedule:
    """Step-level selection plan across the layer stack.

      dense_first_n      leading layers run DENSE decode attention
      select_layer       the layer that computes the step's plan (the
                         ``[B, Hkv, k]`` index list carried through the
                         layer loop). None = every sparse layer selects for
                         itself
      correction_layers  later layers that RE-select, refreshing the plan
      unify_heads        max-reduce selection scores across KV heads so one
                         block list drives every head; the gate then scores
                         in plain PyTorch (its fused kernel scores per head)

    Layers in ``[dense_first_n, select_layer)`` run dense as well (no plan
    exists yet). The default schedule is trivial: every layer selects,
    per head, on the unstaged code path.
    """
    dense_first_n: int = 0
    select_layer: Optional[int] = None
    correction_layers: Tuple[int, ...] = ()
    unify_heads: bool = False

    def __post_init__(self):
        if self.dense_first_n < 0:
            raise ValueError(
                f"dense_first_n must be >= 0: {self.dense_first_n}")
        if self.select_layer is None:
            if self.correction_layers:
                raise ValueError("correction_layers require a select_layer "
                                 "(no plan exists to correct)")
            return
        if self.select_layer < self.dense_first_n:
            raise ValueError(
                f"select_layer {self.select_layer} lies inside the dense "
                f"prefix (dense_first_n={self.dense_first_n})")
        cl = tuple(self.correction_layers)
        if list(cl) != sorted(set(cl)):
            raise ValueError(
                f"correction_layers must be sorted and unique: {cl}")
        if cl and cl[0] <= self.select_layer:
            raise ValueError(
                f"correction_layers must come after select_layer "
                f"{self.select_layer}: {cl}")

    @property
    def is_trivial(self) -> bool:
        """Every layer selects for itself, per head."""
        return (self.dense_first_n == 0 and self.select_layer is None
                and not self.unify_heads)

    @property
    def needs_plan(self) -> bool:
        """A plan is carried through the layer loop (some layer runs dense
        or reuses); ``unify_heads`` alone needs none."""
        return self.dense_first_n > 0 or self.select_layer is not None

    def layer_stages(self, n_layers: int) -> Tuple[int, ...]:
        """Per-layer stage (STAGE_DENSE/SELECT/REUSE) of an
        ``n_layers``-deep stack."""
        if self.dense_first_n >= n_layers and self.select_layer is None \
                and self.dense_first_n > 0:
            raise ValueError(
                f"dense_first_n={self.dense_first_n} covers the whole "
                f"{n_layers}-layer stack; use DensePolicy instead")
        if self.select_layer is not None and self.select_layer >= n_layers:
            raise ValueError(
                f"select_layer {self.select_layer} out of range for "
                f"{n_layers} layers")
        if self.correction_layers and \
                self.correction_layers[-1] >= n_layers:
            raise ValueError(
                f"correction_layers {self.correction_layers} out of range "
                f"for {n_layers} layers")
        stages = []
        for layer in range(n_layers):
            if layer < self.dense_first_n:
                stages.append(STAGE_DENSE)
            elif self.select_layer is None:
                stages.append(STAGE_SELECT)
            elif layer == self.select_layer \
                    or layer in self.correction_layers:
                stages.append(STAGE_SELECT)
            elif layer < self.select_layer:
                stages.append(STAGE_DENSE)     # no plan exists yet
            else:
                stages.append(STAGE_REUSE)
        return tuple(stages)


class SelectionInputs(NamedTuple):
    """Everything a selection policy may consume for ONE decode step.
    Contiguous and paged decode fill different cache views (the unused
    ones stay None); all caches HEAD-MAJOR."""
    q_nope: torch.Tensor                 # [B, 1, H, Dh] pre-rope queries
    qr: torch.Tensor                     # [B, 1, H, Dh] post-rope queries
    pos: torch.Tensor                    # [B, 1] query positions
    new_len: torch.Tensor                # [B] kv length incl. the new token
    gate_params: Optional[Dict[str, Any]] = None   # per-layer gate or None
    # contiguous views
    kg: Optional[torch.Tensor] = None           # [B, Hkv, nb, Dg]
    k_cache: Optional[torch.Tensor] = None      # [B, Hkv, S, Dh] post-rope
    # paged views
    kg_pages: Optional[torch.Tensor] = None     # [P, Hkv, Dg]
    k_pages: Optional[torch.Tensor] = None      # [P, Hkv, ps, Dh] post-rope
    page_table: Optional[torch.Tensor] = None   # [B, npt] int32
    # selection-metadata views (policies with ``needs_meta``): the
    # contiguous incremental min/max, or the paged pools
    meta_kmin: Optional[torch.Tensor] = None    # [B, Hkv, nb, Dh] float32
    meta_kmax: Optional[torch.Tensor] = None    # [B, Hkv, nb, Dh] float32
    kmin_pages: Optional[torch.Tensor] = None   # [P, Hkv, Dh] float32
    kmax_pages: Optional[torch.Tensor] = None   # [P, Hkv, Dh] float32
    # int8 K pool scales: a policy that reads raw ``k_pages`` dequantizes
    # first, so selection sees what attention reads
    k_scale_pages: Optional[torch.Tensor] = None  # [P, Hkv, 1] float32
    # the head-sharded paged step: the views hold this rank's KV heads,
    # and the gate's cross-head reduction (``unify_heads``) spans the
    # ranks (the engine shards GatePolicy and DensePolicy only)
    shard: Optional[Any] = None

    @property
    def n_kv_heads(self) -> int:
        """Hkv from whichever cache view is present (heads on axis 1)."""
        for view in (self.kg, self.kg_pages, self.k_cache, self.k_pages):
            if view is not None:
                return view.shape[1]
        raise ValueError("SelectionInputs carries no cache view")

    def n_blocks(self, block_size: int) -> int:
        """Logical-block count of this step's view."""
        if self.kg is not None:
            return self.kg.shape[2]
        if self.page_table is not None:
            return self.page_table.shape[1]
        return self.k_cache.shape[2] // block_size


def _n_valid(inp: SelectionInputs, block_size: int) -> torch.Tensor:
    return kc.visible_blocks(torch.clamp_min(inp.new_len, 1),
                             block_size).to(torch.int32)


def _gathered_k(inp: SelectionInputs) -> torch.Tensor:
    """Per-row head-major K view for the reference policies
    (QuestRecompute/Oracle): the contiguous cache as-is, or the paged
    gather (a cache-sized copy; neither the gate nor the cached Quest
    takes it)."""
    if inp.k_cache is not None:
        return inp.k_cache
    from repro_torch.serve import paging as pg
    return pg.gather_kv(inp.k_pages, inp.page_table, inp.k_scale_pages)


def _grouped_q(inp: SelectionInputs) -> torch.Tensor:
    """Post-rope query regrouped [B, Hkv, g, Dh]."""
    b, _, h, dh = inp.qr.shape
    hkv = inp.n_kv_heads
    return inp.qr[:, 0].reshape(b, hkv, h // hkv, dh)


def _unify_scores(scores: torch.Tensor, shard=None) -> torch.Tensor:
    """[B, Hkv, nb] -> [B, 1, nb]: the cross-head max; with a ``shard``
    the scores hold this rank's heads, and their max is reduced over the
    ranks too (exact: every rank gets the unsharded max)."""
    m = torch.amax(scores, dim=1, keepdim=True)
    return m if shard is None else shard.all_max(m)


def _broadcast_heads(idx: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, 1, k] unified selection -> [B, Hkv, k] (contiguous, as the
    kernels want it)."""
    return idx.expand(idx.shape[0], hkv, idx.shape[-1]).contiguous()


def _budget_ids(scores: torch.Tensor, n_valid: torch.Tensor, cfg: ModelConfig,
                max_selected: Optional[int], unify_heads: bool,
                hkv: int) -> torch.Tensor:
    if unify_heads:
        idx, _ = sp.budget_select(_unify_scores(scores), n_valid, cfg.gate,
                                  max_selected)
        return _broadcast_heads(idx, hkv)
    idx, _ = sp.budget_select(scores, n_valid, cfg.gate, max_selected)
    return idx


@dataclasses.dataclass(frozen=True)
class GatePolicy:
    """The paper's learned AttnGate (default): the gate query scores the
    Kg cache (contiguous) or the Kg page pool through the page table
    (paged) with the fused gate-select kernels; under ``unify_heads`` the
    scores are plain PyTorch, max-reduced over heads before ranking."""
    dense = False
    needs_gate = True
    needs_meta = False
    reads_full_kv = False

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None,
               unify_heads: bool = False) -> torch.Tensor:
        """-> selected logical block ids [B, Hkv, k] int32, -1 padding."""
        from repro_torch.core import attngate as ag
        from repro_torch.kernels import ops
        qg = ag.gate_q(inp.gate_params, inp.q_nope, inp.pos, cfg.gate)[:, 0]
        n_valid = _n_valid(inp, cfg.gate.block_size)
        if unify_heads:
            from repro_torch.kernels import gate_select as gs
            if inp.kg is not None:
                kg = inp.kg
            else:
                from repro_torch.serve import paging as pg
                kg = pg.gather_kg(inp.kg_pages, inp.page_table)
            # the masked fp32 scores, max-reduced over heads BEFORE the
            # threshold method's softmax
            scores = _unify_scores(gs.gate_scores_plain(
                qg, kg, n_valid, dataclasses.replace(cfg.gate, method="budget")),
                inp.shard)
            if cfg.gate.method == "threshold":
                scores = torch.softmax(scores, dim=-1)
            idx, _ = sp.select_blocks(scores, n_valid, cfg.gate, max_selected)
            return _broadcast_heads(idx, inp.n_kv_heads)
        if inp.kg is not None:
            return ops.gate_select(qg, inp.kg, n_valid, cfg.gate, max_selected)
        return ops.gate_select_paged(qg, inp.kg_pages, inp.page_table, n_valid,
                                     cfg.gate, max_selected)


@dataclasses.dataclass(frozen=True)
class QuestPolicy:
    """Training-free Quest selection (Tang et al., 2024): rank blocks by
    the q.k upper bound from per-block key min/max. Completed blocks come
    from the incremental metadata cache (contiguous ``meta_kmin/kmax``, or
    the paged pools through the page table); only the trailing block is
    recomputed per step, from its one block-sized slice or page. Its
    selections are bitwise ``QuestRecomputePolicy``'s. GQA-group-shared
    (max-pooled bound), so it drives the shared-sparsity kernel."""
    dense = False
    needs_gate = False
    needs_meta = True
    reads_full_kv = False

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None,
               unify_heads: bool = False) -> torch.Tensor:
        from repro_torch.core import metacache as mc
        from repro_torch.core import quest
        bs = cfg.gate.block_size
        if inp.meta_kmin is not None and inp.k_cache is not None:
            tmin, tmax, t_idx = mc.trailing_meta(inp.k_cache, inp.new_len, bs)
            kmin, kmax = mc.overlay_trailing(inp.meta_kmin, inp.meta_kmax,
                                             tmin, tmax, t_idx)
        elif inp.kmin_pages is not None and inp.k_pages is not None:
            # a metadata-sized gather through the page table (npt rows a
            # slot, block_size times smaller than the K cache)
            pt = inp.page_table.long()
            kmin = inp.kmin_pages[pt].transpose(1, 2)
            kmax = inp.kmax_pages[pt].transpose(1, 2)
            tmin, tmax, t_idx = mc.trailing_meta_paged(
                inp.k_pages, inp.page_table, inp.new_len, bs,
                k_scale=inp.k_scale_pages)
            kmin, kmax = mc.overlay_trailing(kmin, kmax, tmin, tmax, t_idx)
        else:
            raise ValueError(
                "QuestPolicy needs the selection-metadata cache: build the "
                "decode state with options (prefill(..., options=...)) so "
                "meta_kmin/meta_kmax (or the paged kmin/kmax pools) are "
                "threaded; QuestRecomputePolicy is the cache-free O(S) "
                "reference")
        n_valid = _n_valid(inp, bs)
        scores = quest.quest_scores_grouped(_grouped_q(inp), kmin, kmax, n_valid)
        return _budget_ids(scores, n_valid, cfg, max_selected, unify_heads,
                           inp.n_kv_heads)


@dataclasses.dataclass(frozen=True)
class QuestRecomputePolicy:
    """Quest with the per-block key min/max REBUILT from the whole
    (post-rope) K cache every step, an O(S) read (plus a cache-sized
    gather on the paged path): the bitwise reference of ``QuestPolicy``
    and what Quest costs without a metadata cache. Not a serving policy."""
    dense = False
    needs_gate = False
    needs_meta = False
    reads_full_kv = True

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None,
               unify_heads: bool = False) -> torch.Tensor:
        from repro_torch.core import quest
        bs = cfg.gate.block_size
        kmin, kmax = quest.quest_meta_decode(_gathered_k(inp), inp.new_len, bs)
        n_valid = _n_valid(inp, bs)
        scores = quest.quest_scores_grouped(_grouped_q(inp), kmin, kmax, n_valid)
        return _budget_ids(scores, n_valid, cfg, max_selected, unify_heads,
                           inp.n_kv_heads)


@dataclasses.dataclass(frozen=True)
class OraclePolicy:
    """Exact top-k over the true block row-max attention scores
    (core.oracle, paper §4.2): attention scores computed twice, once dense
    to rank and once block-sparse. The accuracy ceiling of any selector;
    at a budget of every block, dense attention's token set."""
    dense = False
    needs_gate = False
    needs_meta = False
    reads_full_kv = True

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None,
               unify_heads: bool = False) -> torch.Tensor:
        from repro_torch.core import oracle
        bs = cfg.gate.block_size
        scores = oracle.oracle_scores_headmajor(_grouped_q(inp), _gathered_k(inp),
                                                inp.new_len, bs)
        return _budget_ids(scores, _n_valid(inp, bs), cfg, max_selected,
                           unify_heads, inp.n_kv_heads)


@dataclasses.dataclass(frozen=True)
class DensePolicy:
    """No selection: full dense decode attention."""
    dense = True
    needs_gate = False
    needs_meta = False
    reads_full_kv = True

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None,
               unify_heads: bool = False) -> torch.Tensor:
        raise NotImplementedError("DensePolicy performs no block selection")


@dataclasses.dataclass(frozen=True)
class SlidingWindowPolicy:
    """StreamingLM-style static pattern: ``sink_blocks`` leading blocks
    plus the trailing local window, no scoring and no extra state. The
    window is the selection budget minus the sinks.

    Slot ORDER: the trailing (current-token) block comes FIRST, then the
    sinks, then the rest of the window backwards, so a runtime budget mask
    (which cuts the list's tail) never drops the trailing block. Sink
    slots that duplicate the trailing block, and window slots that fall
    into the sinks, are -1: the list has holes in the middle."""
    sink_blocks: int = 1
    dense = False
    needs_gate = False
    needs_meta = False
    reads_full_kv = False

    def __post_init__(self):
        if self.sink_blocks < 0:
            raise ValueError(f"sink_blocks must be >= 0: {self.sink_blocks}")

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None,
               unify_heads: bool = False) -> torch.Tensor:
        # unify_heads is a no-op: the pattern depends on positions only
        bs = cfg.gate.block_size
        nb = inp.n_blocks(bs)
        k = min(sp.resolve_max_selected(cfg.gate, max_selected), nb)
        # visible blocks (a ceil) clamped to the view's nb (a floor of the
        # cache length), as quest.build_quest_meta clamps
        n_valid = torch.clamp_max(_n_valid(inp, bs), nb)             # [B]
        sink = min(self.sink_blocks, max(k - 1, 0))
        ar = torch.arange(k, device=n_valid.device)[None, :]          # [1, k]
        last = n_valid[:, None] - 1
        # slot 0: trailing block; slots [1, sink]: the sinks; the rest: the
        # window continuing backwards from last - 1
        idx = torch.where(ar == 0, last,
                          torch.where(ar <= sink, ar - 1, last - (ar - sink)))
        valid = (idx >= 0) & (idx < n_valid[:, None])
        valid &= ~((ar >= 1) & (ar <= sink) & (idx == last))
        valid &= ~((ar > sink) & (idx < sink))
        idx = torch.where(valid, idx, -1).to(torch.int32)
        return idx[:, None, :].expand(idx.shape[0], inp.n_kv_heads, k).contiguous()


def selection_width(policy, cfg: ModelConfig, nb: int,
                    max_selected: Optional[int] = None) -> int:
    """Width k of the [B, Hkv, k] list ``policy.select`` returns for an
    ``nb``-block view: the plan width a SelectionSchedule carries.
      * SlidingWindowPolicy, and GatePolicy under method='threshold':
        min(budget, nb);
      * everything else: min(max(budget, forced-block floor), nb)."""
    k = sp.resolve_max_selected(cfg.gate, max_selected)
    if isinstance(policy, SlidingWindowPolicy):
        return min(k, nb)
    if isinstance(policy, GatePolicy) and cfg.gate.method == "threshold":
        return min(k, nb)
    min_k = int(cfg.gate.always_last_block) + int(cfg.gate.always_first_block)
    return min(max(k, min_k), nb)


POLICIES: Dict[str, Any] = {
    "gate": GatePolicy,
    "quest": QuestPolicy,                     # incremental metadata cache
    "quest_cached": QuestPolicy,              # explicit alias
    "quest_recompute": QuestRecomputePolicy,  # O(S) parity/cost reference
    "oracle": OraclePolicy,
    "dense": DensePolicy,
    "sliding_window": SlidingWindowPolicy,
}


def get_policy(name: str, **kw):
    """Policy by registry name."""
    try:
        return POLICIES[name](**kw)
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; have {sorted(POLICIES)}") from None


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Frozen decode-time options, threaded engine -> model -> kernels.

    policy:           block-selection strategy (see the module docstring)
    sampling:         SamplingParams (default greedy)
    budget_override:  token budget replacing ``cfg.gate.token_budget``
                      (None = config budget); ``serve`` also takes cheaper
                      per-request budgets, masked at run time
    measure_sparsity: compute the measured selection telemetry (aux) in
                      every decode step
    quantize:         paged decode only: page-pool storage. None keeps the
                      working dtype and the fp code path; "int8" allocates
                      int8 K/V pools with per-page per-head f32 scale rows,
                      dequantized inside the block-sparse decode kernel.
                      ``generate`` ignores it, as the reference's does.
    split_k:          paged decode on a sharded engine (``DecodeEngine(
                      shard=...)``, the reference's ``kernel_impl="sharded"``):
                      reduce each rank's selected list in ``split_k`` flash
                      partials (``ops.paged_sparse_decode_splitk``); 1 = the
                      single-pass kernel, bitwise the unsharded step. The
                      engine refuses ``split_k > 1`` without a shard
    schedule:         step-level SelectionSchedule (cross-layer plan reuse,
                      cross-head unification); the default selects in
                      every layer per head
    track_evictions:  paged decode only: emit a per-step ``touched_pages``
                      [n_slots, npt] bool aux (which logical blocks any
                      layer or head attended) and read K/V through the page
                      table clamped into the physical pool, so the serving
                      engine can run RaaS page eviction with optimistic
                      execution + replay. Off by default
    """
    policy: Any = GatePolicy()
    sampling: SamplingParams = GREEDY
    budget_override: Optional[int] = None
    measure_sparsity: bool = True
    quantize: Optional[str] = None
    split_k: int = 1
    schedule: SelectionSchedule = SelectionSchedule()
    track_evictions: bool = False

    def __post_init__(self):
        if self.quantize not in (None, "int8"):
            raise ValueError(
                f"quantize must be None or 'int8': {self.quantize!r}")
        if self.split_k < 1:
            raise ValueError(f"split_k must be >= 1: {self.split_k}")
        if self.budget_override is not None and self.budget_override <= 0:
            raise ValueError(
                f"budget_override must be positive: {self.budget_override}")
        if not self.schedule.is_trivial and self.policy.dense:
            raise ValueError("a non-trivial SelectionSchedule is "
                             "meaningless under DensePolicy (no selection "
                             "to schedule)")
        if self.track_evictions and getattr(self.policy, "reads_full_kv", True):
            raise ValueError(
                "track_evictions (RaaS page eviction) requires a policy "
                "that only reads SELECTED blocks' K/V "
                f"(reads_full_kv=False); {type(self.policy).__name__} "
                "reads the full cache, so evicted pages would be silently "
                "read as garbage")
        if self.track_evictions and (
                self.schedule.dense_first_n > 0
                or (self.schedule.select_layer or 0) > 0):
            raise ValueError(
                "track_evictions cannot run with a schedule that stages "
                "any layer DENSE (dense_first_n > 0 or select_layer > 0): "
                "DENSE-staged layers read every visible block, so every "
                "evicted page would fault every step (evict/restore "
                "thrash)")

    def max_selected(self, cfg: ModelConfig) -> Optional[int]:
        """Selected-list width override in BLOCKS (None = config budget).
        CEIL division: an override that is not a multiple of the block
        size rounds UP, so a request never gets fewer tokens of attention
        than it asked for (the config budget keeps the paper's floor)."""
        if self.budget_override is None:
            return None
        return max(1, -(-self.budget_override // cfg.gate.block_size))

    def replace(self, **kw) -> "DecodeOptions":
        return dataclasses.replace(self, **kw)


def default_options(cfg: ModelConfig) -> DecodeOptions:
    """GatePolicy when the config carries a gate, dense otherwise.
    ``cfg.gate.dense_first_layers`` (the paper's §5.2 hybrid dense layers)
    maps onto the schedule's dense prefix; 0 keeps the trivial schedule."""
    gate_on = cfg.gate.enabled and cfg.has_attention and cfg.is_decoder
    if not gate_on:
        return DecodeOptions(policy=DensePolicy())
    return DecodeOptions(policy=GatePolicy(), schedule=SelectionSchedule(
        dense_first_n=cfg.gate.dense_first_layers))


DENSE_OPTIONS = DecodeOptions(policy=DensePolicy())


# -- SLO tiers ---------------------------------------------------------------
#
# A tenant tier maps onto the serving engine's RUN-TIME knobs only: the
# per-request token budget (a per-slot cap on the selected-block list),
# per-request SamplingParams, per-request reserve admission and scheduler
# priority. Anything that would change the step's program (policy class,
# schedule) deliberately has no per-tier field, so every tier shares one
# DecodeOptions per serve() call.

@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One tenant tier's serving contract.

    priority:  admission order (higher first; FIFO within a tier) AND
               preemption/eviction protection (victims are picked lowest
               priority first — a latency-tier request is never preempted
               or page-evicted while a throughput-tier victim exists).
    admission: "reserve" pins the request's full-lifetime page budget at
               admission (it can never stall mid-decode; the latency
               contract), "lazy" admits on current occupancy and grows
               on demand (the throughput contract — more concurrency,
               preemptible).
    budget:    per-request token budget override (run-time cap; None =
               the engine options' budget). Latency tiers typically run
               dense-ish (large budget), throughput tiers aggressively
               sparse (small budget).
    sampling:  per-request SamplingParams (None = engine default).
    """
    name: str = "default"
    priority: int = 0
    admission: str = "lazy"
    budget: Optional[int] = None
    sampling: Optional[SamplingParams] = None

    def __post_init__(self):
        if self.admission not in ("lazy", "reserve"):
            raise ValueError(f"tier {self.name!r}: admission "
                             f"{self.admission!r} not in ('lazy', 'reserve')")
        if self.budget is not None and self.budget <= 0:
            raise ValueError(f"tier {self.name!r}: budget must be positive: "
                             f"{self.budget}")

    def request_fields(self) -> dict:
        """The per-request dict fields the serving engine understands —
        merge into a request dict to place it in this tier."""
        out = {"tier": self.name, "priority": self.priority,
               "reserve": self.admission == "reserve"}
        if self.budget is not None:
            out["budget"] = self.budget
        if self.sampling is not None:
            out["sampling"] = self.sampling
        return out


class TierPolicy:
    """tier name -> TierSpec registry with a default fallback.

    ``apply(request_dict, tier)`` returns a NEW request dict carrying the
    tier's engine fields; explicit per-request overrides in the input
    dict win over the tier (a caller can still hand-tune one request).
    """

    def __init__(self, tiers: Sequence[TierSpec] = (),
                 default: Optional[TierSpec] = None):
        self.default = default if default is not None else TierSpec()
        self.tiers: Dict[str, TierSpec] = {t.name: t for t in tiers}
        if len(self.tiers) != len(tiers):
            names = [t.name for t in tiers]
            raise ValueError(f"duplicate tier names: {sorted(names)}")

    def get(self, name: Optional[str]) -> TierSpec:
        if name is None:
            return self.default
        try:
            return self.tiers[name]
        except KeyError:
            raise ValueError(f"unknown tier {name!r}; have "
                             f"{sorted(self.tiers)}") from None

    def apply(self, request: dict, tier: Optional[str] = None) -> dict:
        spec = self.get(tier if tier is not None else request.get("tier"))
        merged = dict(spec.request_fields())
        merged.update({k: v for k, v in request.items() if k != "tier"})
        merged["tier"] = spec.name
        return merged


def default_tiers(cfg: ModelConfig) -> TierPolicy:
    """The two-tier split of a reasoning server: a latency-critical tier
    (reserved pages, priority, near-dense budget) and a best-effort
    throughput tier (lazy admission, preemptible, aggressive sparsity).
    Budgets scale with the config's token budget, so the tiers stay
    meaningful at reduced test configs."""
    base = max(cfg.gate.token_budget, cfg.gate.block_size)
    return TierPolicy(tiers=(
        TierSpec(name="latency", priority=10, admission="reserve",
                 budget=4 * base),
        TierSpec(name="throughput", priority=0, admission="lazy",
                 budget=base),
    ), default=TierSpec())
