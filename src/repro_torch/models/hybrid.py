"""Zamba2-style hybrid, PyTorch: a Mamba2 backbone and ONE weight-shared
attention block run after every ``hybrid_period`` Mamba2 layers, each run
with its own KV cache. The shared block carries the SeerAttention-R gate:
the paper's technique applies there.

Port of the JAX package's ``models/hybrid.py``: the training forward in
both modes (``lm_forward``: pretraining, and the distillation of the
shared block's gate, whose target comes from kernel 6 on the card;
tensor-parallel under a ``Shard``) and the serving half (under a sharded
engine's ``Shard`` the Mamba2 layers over the rank's heads, the shared
block's weights at the rank's block, its attention over its KV heads or,
in ``generate``'s step, its part of the sequence, and the embedding and
logits over the rank's vocabulary). Layer plan at
num_layers=38, period=6: 6 units of (6 Mamba2 layers + the shared
block), then 2 trailing Mamba2 layers.

``params["units"]`` is a list of units, each a list of per-layer
``{"ln", "mixer"}`` dicts; ``params["tail"]`` the trailing layers;
``params["shared_attn"]`` a transformer block (``transformer.init_block``).
The shared block's prefill is ``transformer.prefill_block``, its decode
``transformer.block_decode`` (contiguous) or
``attn_core.block_decode_paged`` (paged), once a unit, over that unit's
cache or pool slice. The attention caches are updated in place, as the
transformer's; the recurrent state is returned anew by every step.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.policy import default_options
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (attn_kv_heads, check_shard, local_shape,
                                              state_layouts)
from repro_torch.models import mamba
from repro_torch.models import transformer as tf
from repro_torch.models.attn_core import aggregate_decode_aux, block_decode_paged
from repro_torch.models.common import _randn, init_linear, init_rmsnorm, torch_dtype
from repro_torch.serve.slotstate import SlotState

Params = Dict[str, Any]


def _plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(units, Mamba2 layers a unit, trailing Mamba2 layers)."""
    period = cfg.hybrid_period
    n_units = cfg.num_layers // period
    return n_units, period, cfg.num_layers - n_units * period


class HybridDecodeState(NamedTuple):
    conv: torch.Tensor                  # [L_m, B, K-1, di+2n]
    h: torch.Tensor                     # [L_m, B, nh, hd, n] float32
    k_cache: torch.Tensor               # [n_units, B, Hkv, S, Dh] (head-major)
    v_cache: torch.Tensor
    kg_cache: Optional[torch.Tensor]    # [n_units, B, Hkv, nb, Dg]
    kg_n: Optional[torch.Tensor]        # [n_units, B] int32
    cur_len: torch.Tensor               # [B] int32


def _mblock(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {"ln": init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
            "mixer": mamba.init_mamba2(gen, cfg)}


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    n_units, period, rem = _plan(cfg)
    dev = gen.device
    p: Params = {
        "embed": {"w": (_randn(gen, (cfg.vocab_size, cfg.d_model)) * 0.02)
                  .to(torch_dtype(cfg.dtype))},
        "units": [[_mblock(gen, cfg) for _ in range(period)] for _ in range(n_units)],
        "shared_attn": tf.init_block(gen, cfg, with_gate=cfg.gate.enabled),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.dtype, dev),
    }
    if rem:
        p["tail"] = [_mblock(gen, cfg) for _ in range(rem)]
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, cfg.dtype)
    return p


def lm_forward(params: Params, batch, cfg: ModelConfig, *, mode: str = "pretrain",
               shard=None, data=None):
    """The reference's forward. Each unit runs its Mamba2 layers, then the
    shared block through ``transformer.block_fwd_full`` (the same
    parameters every unit), then the tail.

    mode 'pretrain' -> (ce, {"ce"}): everything differentiable, a
    checkpoint a layer under the config's ``remat``; the shared block's
    gradient sums over the units. mode 'distill' -> (kl, {"kl"}): the
    Mamba2 layers run without autograd, the shared block frozen with its
    gate differentiable; the gate KL is summed over the units and divided
    by their number. ``batch`` is the packed LM batch (``positions`` and
    ``segment_ids`` reach the shared block's attention only). Under a
    ``shard`` (a ``distributed.sharding.Shard``; anything else raises
    TypeError) the training is tensor-parallel over its group: the
    Mamba2 mixers by heads, the shared block as the transformer's (in
    distillation kernel 6 and the gate on the rank's heads), the
    embedding and the logits by vocabulary. ``data`` (the data axis):
    ``batch`` is this replica's rows, and the loss is the global
    batch's."""
    if mode not in ("pretrain", "distill"):
        raise ValueError(f"lm_forward: unknown mode {mode!r}")
    check_shard(shard)
    check_shard(data)
    n_units = _plan(cfg)[0]
    distill = mode == "distill"
    tokens = batch["tokens"]
    b, l = tokens.shape
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(l, device=tokens.device)[None, :].expand(b, l)
    seg = batch.get("segment_ids")
    shared = params["shared_attn"]
    shared_fwd = tf._pretrain_block(cfg, pos, seg, None, shard)
    kl = torch.zeros((), dtype=torch.float32, device=tokens.device)
    with tf._base_grad(distill):
        x = tf.embed(params, tokens, cfg, shard)
    for unit in params["units"]:
        with tf._base_grad(distill):
            x = mamba.stack_train(unit, x, cfg, mamba.mamba2_full, shard)
        if distill:
            x, l_kl, _, _ = tf.block_fwd_full(shared, x, cfg, rope_positions=pos,
                                              segment_ids=seg, distill=True, shard=shard)
            kl = kl + l_kl
        else:
            x, _ = shared_fwd(shared, x)
    with tf._base_grad(distill):
        x = mamba.stack_train(params.get("tail", []), x, cfg, mamba.mamba2_full, shard)
    if distill:
        kl = tf.global_kl(kl, cfg, shard, data) / max(n_units, 1)
        return kl, {"kl": kl.detach()}
    ce = tf.lm_loss(params, x, batch, cfg, shard, data)
    return ce, {"ce": ce.detach()}


def _recurrent_zeros(cfg: ModelConfig, batch: int, dtype: torch.dtype, device,
                     shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (conv [L_m, B, K-1, di + 2n], h [L_m, B, nh, hd, n] f32), at a
    serving ``shard``'s heads (``sharding.state_layouts``)."""
    n_units, period, rem = _plan(cfg)
    di, hd, nh, n = mamba._m2_dims(cfg)
    lm = n_units * period + rem
    world = 1 if shard is None else shard.world
    conv_l, h_l = state_layouts(cfg, world)
    return (torch.zeros(local_shape((lm, batch, cfg.ssm.conv_dim - 1, di + 2 * n), conv_l,
                                    world), dtype=dtype, device=device),
            torch.zeros(local_shape((lm, batch, nh, hd, n), h_l, world), dtype=torch.float32,
                        device=device))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: Optional[torch.dtype] = None, options=None, *,
                      device=None, shard=None,
                      kv_heads: Optional[int] = None) -> HybridDecodeState:
    """Zeroed state on ``device`` (``None`` = CUDA, which raises without a
    card), the recurrent part at a serving ``shard``'s heads, the shared
    block's caches at ``kv_heads`` KV heads (all of them by default). The
    hybrid keeps no selection-metadata cache, so ``options`` allocates
    nothing (a QuestPolicy step raises, as in the reference)."""
    device = resolve_device(device)
    n_units = _plan(cfg)[0]
    dt = dtype or torch_dtype(cfg.dtype)
    dh = cfg.resolved_head_dim
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    nb_max = max_len // cfg.gate.block_size
    kg = kg_n = None
    if cfg.gate.enabled:
        kg = torch.zeros((n_units, batch, hkv, nb_max, cfg.gate.d_gate), dtype=dt,
                         device=device)
        kg_n = torch.zeros((n_units, batch), dtype=torch.int32, device=device)
    conv, h = _recurrent_zeros(cfg, batch, dt, device, shard)
    return HybridDecodeState(
        conv=conv, h=h,
        k_cache=torch.zeros((n_units, batch, hkv, max_len, dh), dtype=dt, device=device),
        v_cache=torch.zeros((n_units, batch, hkv, max_len, dh), dtype=dt, device=device),
        kg_cache=kg, kg_n=kg_n,
        cur_len=torch.zeros((batch,), dtype=torch.int32, device=device))


def _mamba_blocks(params: Params):
    """The Mamba2 layers in execution order: each unit's, then the tail."""
    return [bp for unit in params["units"] for bp in unit] + params.get("tail", [])


def lm_prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               max_len: int, options=None, shard=None, data=None):
    """Full forward filling the shared block's per-unit K/V/Kg caches
    (head-major, written once by ``transformer.prefill_block``) and
    collecting every Mamba2 layer's final (conv, h). Returns (last logits
    [B, V], HybridDecodeState).

    ``batch["lengths"]`` [B] (optional): the true lengths of right-padded
    prompts. Causality keeps the attention rows exact, pad tokens are an
    exact identity on the Mamba2 recurrences, the Kg rows of blocks that
    touch a pad token are zero and the logits row is taken at ``lengths -
    1``. ``options`` is taken for the ``ModelApi``'s uniformity: the
    hybrid builds no selection-metadata cache. Under a serving ``shard``
    (``params`` cut by ``sharding.decode_params``) each Mamba2 mixer runs
    over the rank's heads and the state holds them; the shared block runs
    on its rank's block (``transformer.prefill_block``), its caches at the
    rank's KV heads; the embedding and logits on the rank's vocabulary,
    the last logits gathered whole."""
    tokens = batch["tokens"]
    b, l = tokens.shape
    if l > max_len:
        raise ValueError(f"prompt length {l} > max_len {max_len}")
    lengths = batch.get("lengths")
    dev = params["embed"]["w"].device
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    state = init_decode_state(cfg, b, max_len, device=dev, shard=shard,
                              kv_heads=attn_kv_heads(cfg, shard))
    pos = torch.arange(l, device=dev)[None, :].expand(b, l)
    x = tf.embed(params, tokens, cfg, shard)
    convs, hs = [], []
    for u, unit in enumerate(params["units"]):
        x, c, h = mamba.stack_full(unit, x, cfg, mamba.mamba2_full, lengths, shard)
        convs += c
        hs += h
        x = tf.prefill_block(params["shared_attn"], x, cfg, pos, state.k_cache[u],
                             state.v_cache[u],
                             None if state.kg_cache is None else state.kg_cache[u], shard)
    x, c, h = mamba.stack_full(params.get("tail", []), x, cfg, mamba.mamba2_full, lengths,
                               shard)
    convs += c
    hs += h
    last = tf.finish_prefill(state, x, lengths, cfg.gate.block_size)
    del x
    state = state._replace(conv=torch.stack(convs).to(state.conv.dtype),
                           h=torch.stack(hs))
    return tf.serve_logits(params, last, cfg, shard), state


def lm_decode_step(params: Params, state: HybridDecodeState, token: torch.Tensor,
                   cfg: ModelConfig, *, options=None, shard=None, data=None):
    """token [B] -> (logits [B, V], state, aux), as
    ``transformer.lm_decode_step``: the shared block's caches are updated
    in place, the returned state holds new conv/h tensors and ``cur_len +
    1``. The shared block selects afresh in every unit (no metadata cache,
    no carried plan: a plan-carrying schedule runs as per-layer selection
    here, as in the reference). Under a serving ``shard`` the Mamba2 steps
    run over the rank's heads and the shared block takes the
    sequence-sharded step (``transformer.attention_decode``) on the
    rank's part of its caches (``sharding.seq_shard_state``), or with a
    dense policy attends its KV heads; the embedding and logits run on
    the rank's vocabulary."""
    options = options if options is not None else default_options(cfg)
    x1 = tf.embed(params, token[:, None], cfg, shard)
    convs, hs, auxs = [], [], []
    li = 0
    for u, unit in enumerate(params["units"]):
        x1, c, h = mamba.stack_step(unit, x1, cfg, mamba.mamba2_step,
                                    state.conv[li:li + len(unit)], state.h[li:li + len(unit)],
                                    shard)
        li += len(unit)
        convs += c
        hs += h
        layer_state = (state.k_cache[u], state.v_cache[u],
                       None if state.kg_cache is None else state.kg_cache[u],
                       None if state.kg_n is None else state.kg_n[u], None, None, None)
        x1, new_state, aux = tf.block_decode(params["shared_attn"], x1, cfg, layer_state,
                                             state.cur_len, options=options, shard=shard)
        if state.kg_n is not None and new_state[3] is not state.kg_n[u]:
            state.kg_n[u] = new_state[3]
        auxs.append(aux)
    x1, c, h = mamba.stack_step(params.get("tail", []), x1, cfg, mamba.mamba2_step,
                                state.conv[li:], state.h[li:], shard)
    convs += c
    hs += h
    new = state._replace(conv=torch.stack(convs).to(state.conv.dtype), h=torch.stack(hs),
                         cur_len=state.cur_len + 1)
    return tf.serve_logits(params, x1, cfg, shard)[:, 0], new, aggregate_decode_aux(auxs)


def init_slot_state(cfg: ModelConfig, n_slots: int, *, device=None,
                    shard=None) -> SlotState:
    """Zeroed per-slot recurrent state for the paged serving engine, at a
    ``shard``'s heads."""
    return SlotState(*_recurrent_zeros(cfg, n_slots, torch_dtype(cfg.dtype),
                                       resolve_device(device), shard))


def lm_decode_step_paged(params: Params, pages, slot_state: SlotState,
                         token: torch.Tensor, page_table: torch.Tensor,
                         cur_len: torch.Tensor, active: torch.Tensor,
                         cfg: ModelConfig, *, options=None, budget_blocks=None,
                         shard=None):
    """Continuous-batching decode step. ``attn_core.block_decode_paged``
    runs once a unit with the SHARED weights over that unit's slice of the
    page pools ([n_units, P, Hkv, ps, Dh], updated in place); the Mamba2
    steps read ``slot_state`` and return a NEW SlotState (inactive slots'
    rows are garbage, rewritten by the engine at admission or restore).
    Returns (logits [S, V], pages, SlotState, aux). A plan-carrying
    schedule raises, as in the reference: the one shared block re-selects
    in every unit. Under a ``shard`` the Mamba2 steps and the slot state
    hold the rank's heads, the shared block's weights its block and its
    pools its KV heads, and the embedding and logits its vocabulary."""
    options = options if options is not None else default_options(cfg)
    if options.schedule.needs_plan:
        raise NotImplementedError(
            "step-level selection plans assume a uniform self-attn stack; "
            "the hybrid family's single shared attention block re-selects "
            "every unit (schedule=SelectionSchedule())")
    x1 = tf.embed(params, token[:, None], cfg, shard)
    convs, hs, auxs = [], [], []
    li = 0
    for u, unit in enumerate(params["units"]):
        x1, c, h = mamba.stack_step(unit, x1, cfg, mamba.mamba2_step,
                                    slot_state.conv[li:li + len(unit)],
                                    slot_state.h[li:li + len(unit)], shard)
        li += len(unit)
        convs += c
        hs += h
        layer_pages = tuple(None if pool is None else pool[u] for pool in pages)
        x1, aux = block_decode_paged(params["shared_attn"], x1, cfg, layer_pages,
                                     page_table, cur_len, active, options=options,
                                     budget_blocks=budget_blocks, shard=shard)
        auxs.append(aux)
    x1, c, h = mamba.stack_step(params.get("tail", []), x1, cfg, mamba.mamba2_step,
                                slot_state.conv[li:], slot_state.h[li:], shard)
    convs += c
    hs += h
    new = SlotState(conv=torch.stack(convs).to(slot_state.conv.dtype), h=torch.stack(hs))
    return tf.serve_logits(params, x1, cfg, shard)[:, 0], pages, new, aggregate_decode_aux(auxs)
