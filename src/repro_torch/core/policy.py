"""Block-selection policies + the ``DecodeOptions`` decode API (port slice).

The JAX package's ``core/policy.py``, reduced to what the gated decode
paths (contiguous and paged) need:

  GatePolicy     the paper's learned gate: gate query -> fused gate score +
                 top-k over the K-compression cache (kernels/gate_select)
  DensePolicy    no selection; full dense decode attention

``DecodeOptions`` is frozen (hashable) and threaded engine -> model ->
kernels, as in the reference. Kernel choice is NOT an option here: the
kernel wrappers dispatch on the device of the tensors they are given
(``kernels/ops.py``). The reference's ``kernel_impl="sharded"`` is no
option either: an engine built with a ``shard`` takes the sharded paths,
and ``DecodeEngine`` checks ``split_k`` and the policy against it. The
schedule and eviction fields of the reference arrive with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kcache as kc
from repro_torch.serve.sampling import GREEDY, SamplingParams


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


@dataclasses.dataclass(frozen=True)
class GatePolicy:
    """The paper's learned AttnGate (default): the gate query scores the
    Kg cache (contiguous) or the Kg page pool through the page table
    (paged) with the fused gate-select kernels."""
    dense = False
    needs_gate = True

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None) -> torch.Tensor:
        """-> selected logical block ids [B, Hkv, k] int32, -1 padding."""
        from repro_torch.core import attngate as ag
        from repro_torch.kernels import ops
        qg = ag.gate_q(inp.gate_params, inp.q_nope, inp.pos, cfg.gate)[:, 0]
        n_valid = kc.visible_blocks(torch.clamp_min(inp.new_len, 1),
                                    cfg.gate.block_size)
        n_valid = n_valid.to(torch.int32)
        if inp.kg is not None:
            return ops.gate_select(qg, inp.kg, n_valid, cfg.gate, max_selected)
        return ops.gate_select_paged(qg, inp.kg_pages, inp.page_table, n_valid,
                                     cfg.gate, max_selected)


@dataclasses.dataclass(frozen=True)
class DensePolicy:
    """No selection: full dense decode attention."""
    dense = True
    needs_gate = False

    def select(self, inp: SelectionInputs, cfg: ModelConfig, *,
               max_selected: Optional[int] = None) -> torch.Tensor:
        raise NotImplementedError("DensePolicy performs no block selection")


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Frozen decode-time options, threaded engine -> model -> kernels.

    policy:           block-selection strategy (GatePolicy or DensePolicy)
    sampling:         SamplingParams (greedy in this slice)
    budget_override:  token budget replacing ``cfg.gate.token_budget``
                      (None = config budget)
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
    """
    policy: Any = GatePolicy()
    sampling: SamplingParams = GREEDY
    budget_override: Optional[int] = None
    measure_sparsity: bool = True
    quantize: Optional[str] = None
    split_k: int = 1

    def __post_init__(self):
        if self.quantize not in (None, "int8"):
            raise ValueError(
                f"quantize must be None or 'int8': {self.quantize!r}")
        if self.split_k < 1:
            raise ValueError(f"split_k must be >= 1: {self.split_k}")
        if self.budget_override is not None and self.budget_override <= 0:
            raise ValueError(
                f"budget_override must be positive: {self.budget_override}")

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
    """GatePolicy when the config carries a gate, dense otherwise."""
    gate_on = cfg.gate.enabled and cfg.has_attention and cfg.is_decoder
    if not gate_on:
        return DecodeOptions(policy=DensePolicy())
    if cfg.gate.dense_first_layers:
        raise NotImplementedError(
            "gate.dense_first_layers maps onto a SelectionSchedule, which "
            "is not ported yet")
    return DecodeOptions(policy=GatePolicy())
