"""Attention-free Mamba1 LM (the falcon-mamba-7b family), PyTorch.

Port of the JAX package's ``models/ssm_lm.py``: the pretraining forward
(``lm_forward``, autograd through the Mamba1 layers, a checkpoint a layer
under the config's ``remat``; tensor-parallel under a ``Shard``) and the
serving half (under a sharded engine's ``Shard`` over the rank's
channels, the embedding and logits over its vocabulary). SeerAttention-R
does
not apply (no attention), so no kernel runs on this family's paths;
decode carries an O(1) recurrent state per layer. A Python loop over the
layers replaces ``lax.scan``; ``params["blocks"]`` is a list of per-layer
``{"ln", "mixer"}`` dicts.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import check_shard, local_shape, state_layouts
from repro_torch.models import mamba
from repro_torch.models.attn_core import zero_decode_aux
from repro_torch.models.common import _randn, init_linear, init_rmsnorm, torch_dtype
from repro_torch.models.transformer import embed, lm_loss, serve_logits
from repro_torch.serve.slotstate import SlotState

Params = Dict[str, Any]


class SSMDecodeState(NamedTuple):
    conv: torch.Tensor      # [L, B, K-1, di]
    h: torch.Tensor         # [L, B, di, n] float32
    cur_len: torch.Tensor   # [B] int32


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters drawn from ``gen`` on ``gen.device``."""
    dev = gen.device
    p: Params = {
        "embed": {"w": (_randn(gen, (cfg.vocab_size, cfg.d_model)) * 0.02)
                  .to(torch_dtype(cfg.dtype))},
        "blocks": [{"ln": init_rmsnorm(cfg.d_model, cfg.dtype, dev),
                    "mixer": mamba.init_mamba1(gen, cfg)}
                   for _ in range(cfg.num_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, cfg.dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, cfg.dtype)
    return p


def lm_forward(params: Params, batch, cfg: ModelConfig, *, mode: str = "pretrain",
               shard=None, data=None):
    """The reference's forward, pretraining in either ``mode`` (the model
    has no gate to distill): the Mamba1 layers over ``batch["tokens"]``
    [B, L] (positions and segment ids are not read: the recurrence runs
    across packed documents, as in the reference), the final norm, the
    logits and the fp32 cross-entropy of ``batch["labels"]`` under its
    ``loss_mask``. Returns (ce, {"ce"}). Under a ``shard`` (a
    ``distributed.sharding.Shard``; anything else raises TypeError) the
    training is tensor-parallel over its group: the embedding and the
    logits split by vocabulary, each Mamba1 mixer over ``d_inner``.
    ``data`` (the data axis): ``batch`` is this replica's rows, and the
    loss is the global batch's."""
    check_shard(shard)
    check_shard(data)
    x = embed(params, batch["tokens"], cfg, shard)
    x = mamba.stack_train(params["blocks"], x, cfg, mamba.mamba1_full, shard)
    ce = lm_loss(params, x, batch, cfg, shard, data)
    return ce, {"ce": ce.detach()}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int = 0,
                      dtype: Optional[torch.dtype] = None, options=None, *,
                      device=None, shard=None) -> SSMDecodeState:
    """Zeroed recurrent state on ``device`` (``None`` = CUDA, which raises
    without a card), at a serving ``shard``'s channels
    (``sharding.state_layouts``); ``max_len`` and ``options`` are taken
    for the ``ModelApi``'s uniformity."""
    device = resolve_device(device)
    di = cfg.ssm.expand * cfg.d_model
    world = 1 if shard is None else shard.world
    conv_l, h_l = state_layouts(cfg, world)
    return SSMDecodeState(
        conv=torch.zeros(local_shape((cfg.num_layers, batch, cfg.ssm.conv_dim - 1, di),
                                     conv_l, world),
                         dtype=dtype or torch_dtype(cfg.dtype), device=device),
        h=torch.zeros(local_shape((cfg.num_layers, batch, di, cfg.ssm.state_dim), h_l, world),
                      dtype=torch.float32, device=device),
        cur_len=torch.zeros((batch,), dtype=torch.int32, device=device))


def lm_prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               max_len: int = 0, options=None, shard=None, data=None):
    """Full forward collecting every layer's final (conv, h). Returns (last
    logits [B, V], SSMDecodeState). ``batch["lengths"]`` [B] (optional):
    the true lengths of right-padded prompts; pad tokens are an exact
    identity on the recurrent state (``mamba._mask_dt``), ``cur_len`` is
    the true length and the logits row is taken at ``lengths - 1``.
    ``options`` is taken for the ``ModelApi``'s uniformity. Under a
    serving ``shard`` (``params`` cut by ``sharding.decode_params``) each
    mixer runs over the rank's channels and the state holds them; the
    embedding and logits run on the rank's vocabulary, the last logits
    gathered whole."""
    tokens = batch["tokens"]
    b, l = tokens.shape
    lengths = batch.get("lengths")
    dev = params["embed"]["w"].device
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev)
    x = embed(params, tokens, cfg, shard)
    x, convs, hs = mamba.stack_full(params["blocks"], x, cfg, mamba.mamba1_full, lengths,
                                    shard)
    if lengths is None:
        cur_len = torch.full((b,), l, dtype=torch.int32, device=dev)
        last = x[:, -1]
    else:
        cur_len = lengths.to(torch.int32)
        last = x[torch.arange(b, device=dev), torch.clamp_min(cur_len - 1, 0).long()]
    del x
    state = SSMDecodeState(conv=torch.stack(convs).to(torch_dtype(cfg.dtype)),
                           h=torch.stack(hs), cur_len=cur_len)
    return serve_logits(params, last, cfg, shard), state


def lm_decode_step(params: Params, state: SSMDecodeState, token: torch.Tensor,
                   cfg: ModelConfig, *, options=None, shard=None, data=None):
    """token [B] -> (logits [B, V], new SSMDecodeState, aux). The input
    state is not written; ``options`` is taken for the ``ModelApi``'s
    uniformity (only its sampling matters, applied by the engine) and the
    aux reports that nothing was selected. Under a serving ``shard`` the
    state and the mixers hold the rank's channels, and the embedding and
    logits run on the rank's vocabulary."""
    x1 = embed(params, token[:, None], cfg, shard)
    x1, convs, hs = mamba.stack_step(params["blocks"], x1, cfg, mamba.mamba1_step,
                                     state.conv, state.h, shard)
    new = SSMDecodeState(torch.stack(convs).to(state.conv.dtype), torch.stack(hs),
                         state.cur_len + 1)
    return (serve_logits(params, x1, cfg, shard)[:, 0], new,
            zero_decode_aux(token.shape[0], x1.device))


def init_slot_state(cfg: ModelConfig, n_slots: int, *, device=None,
                    shard=None) -> SlotState:
    """Zeroed per-slot recurrent state for the paged serving engine, at a
    ``shard``'s channels."""
    st = init_decode_state(cfg, n_slots, device=device, shard=shard)
    return SlotState(conv=st.conv, h=st.h)


def lm_decode_step_paged(params: Params, pages, slot_state: SlotState,
                         token: torch.Tensor, page_table: torch.Tensor,
                         cur_len: torch.Tensor, active: torch.Tensor,
                         cfg: ModelConfig, *, options=None, budget_blocks=None,
                         shard=None):
    """Pages-free paged decode step. The page pools (zero layers, zero
    size), ``page_table``, ``cur_len`` and ``budget_blocks`` pass through
    untouched; the recurrent state rides in ``slot_state``, so the engine's
    slot lifecycle (admission, preemption swap, eviction replay) covers
    this family too. Returns (logits [S, V], pages, a NEW SlotState, aux);
    inactive slots get garbage rows, rewritten by the engine at their
    next admission or restore. Under a ``shard`` the slot state and the
    mixers hold the rank's channels, and the embedding and logits run on
    the rank's vocabulary."""
    del page_table, cur_len, active, budget_blocks
    x1 = embed(params, token[:, None], cfg, shard)
    x1, convs, hs = mamba.stack_step(params["blocks"], x1, cfg, mamba.mamba1_step,
                                     slot_state.conv, slot_state.h, shard)
    new = SlotState(conv=torch.stack(convs).to(slot_state.conv.dtype), h=torch.stack(hs))
    return (serve_logits(params, x1, cfg, shard)[:, 0], pages, new,
            zero_decode_aux(token.shape[0], x1.device))
