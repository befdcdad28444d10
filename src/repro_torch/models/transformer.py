"""Decoder (and encoder) transformer LM with SeerAttention-R gates, PyTorch.

Port of the JAX package's ``models/transformer.py`` for its four
families: dense, MoE (``"moe"`` blocks in place of ``"mlp"``,
``models/moe.py``), the vision backbone (``cross_attn_period``: units
of ``period - 1`` gated self layers and one ungated cross-attention layer
into the batch's ``image_embeds``) and the audio encoder (``in_proj`` of
the batch's frame ``features``, non-causal attention, no gate, no
decode). Ported: the full-sequence forward in both training modes
(``attention_full`` / ``cross_attention_full`` -> ``block_fwd_full`` ->
``lm_backbone`` -> ``lm_forward(mode="pretrain" | "distill")``) and
``lm_gate_collect``, and the serving half: ``init_lm``,
``DecodeState``/``init_decode_state``, ``lm_prefill`` (with right-padded
``lengths``), the contiguous decode step (``attention_decode`` ->
``block_decode`` / ``cross_block_decode`` -> ``lm_decode_step``) and the
paged one (``lm_decode_step_paged`` over ``attn_core.block_decode_paged``;
not for cross-attention models, which the reference refuses too), each
with the staged branch of a plan-carrying SelectionSchedule and Quest's
metadata cache, unsharded, or sharded (a sharded engine's parameters
at the rank's block: attention by KV heads, the MLPs by hidden units,
the routed experts by expert, the embedding and logits by vocabulary;
``distributed/sharding.py``): the contiguous caches split along the
sequence (``serve/sharded.py``; gate or dense, trivial schedule), the
page pools over the KV heads (any schedule, budget caps). Training
takes a ``Shard`` too:
``lm_forward(..., shard=)`` is tensor-parallel over its group (whole KV
head groups, the MLP's hidden units, the vocabulary, expert parallelism;
``distributed/sharding.py``), kernel 6 running on the rank's heads.

Differences of idiom, not of result:
  * parameters are a dict whose ``"blocks"`` entry is a LIST of per-layer
    dicts (for a cross-attention model the self layers in execution
    order, unit-major, and ``"cross_blocks"`` a list of one block a
    unit), and a Python loop over layers replaces ``lax.scan``: a layer's
    stage is a Python branch, not a ``lax.cond``, and the plan a value
    passed from layer to layer;
  * the decode state's caches are updated IN PLACE (the reference returns
    new arrays and donates the old state); ``lm_decode_step`` returns a
    ``DecodeState`` holding the same cache tensors and the advanced
    ``cur_len``;
  * prefill writes each layer's K/V/Kg straight into the preallocated
    head-major state instead of stacking all layers and padding after;
  * the distillation forward runs the base model under ``torch.no_grad``
    (the reference's ``stop_gradient`` on the attention target and the
    gate's inputs): only the gate's own einsums build an autograd graph;
  * pretraining differentiates the whole tree through the plain
    ``chunked_attention`` (the reference's ``jax.grad`` through its jnp
    attention; no kernel), each layer under ``common.remat`` for the
    config's ``remat``. The gate is not read there: the train loop gives
    it, and any leaf autograd leaves out, a zero gradient.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import attngate as ag
from repro_torch.core import kcache as kc
from repro_torch.core import metacache as mc
from repro_torch.core.distill import gate_kl_loss, ground_truth_from_blockmax
from repro_torch.core.policy import (STAGE_DENSE, STAGE_SELECT, DecodeOptions,
                                     SelectionInputs, default_options,
                                     selection_width)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (attn_kv_heads, check_shard, copy_to_model,
                                              ep_view, gather_rows, part, reduce_from_model,
                                              vocab_parallel_embed)
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models.attn_core import (_dense_aux, _policy_active, _qkv,
                                          _selection_aux, _zero_layer_aux,
                                          aggregate_decode_aux,
                                          block_decode_paged, ffn, rank_gate)
from repro_torch.models.common import (NEG_INF, _randn, apply_rope, chunked_attention,
                                       cross_entropy_loss, decode_attention,
                                       init_linear, init_mlp, init_rmsnorm, linear,
                                       mlp, remat, rms_norm, torch_dtype)
from repro_torch.serve.sharded import sharded_sparse_decode

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, *,
                   with_gate: bool, cross: bool = False) -> Params:
    dh = cfg.resolved_head_dim
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p: Params = {
        "wq": init_linear(gen, d, h * dh, cfg.dtype),
        "wk": init_linear(gen, d, hkv * dh, cfg.dtype),
        "wv": init_linear(gen, d, hkv * dh, cfg.dtype),
        "wo": init_linear(gen, h * dh, d, cfg.dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, cfg.dtype, gen.device)
        p["k_norm"] = init_rmsnorm(dh, cfg.dtype, gen.device)
    if with_gate and not cross:
        p["gate"] = ag.init_attngate(
            gen, n_kv_heads=hkv, group=cfg.gqa_group, head_dim=dh,
            cfg=cfg.gate, dtype=cfg.dtype)
    return p


def init_block(gen: torch.Generator, cfg: ModelConfig, *,
               with_gate: bool, cross: bool = False) -> Params:
    p: Params = {
        "ln1": init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
        "ln2": init_rmsnorm(cfg.d_model, cfg.dtype, gen.device),
        "attn": init_attention(gen, cfg, with_gate=with_gate, cross=cross),
    }
    if cfg.family == "moe" and not cross:
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, cfg.activation,
                                    cfg.dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, cfg.dtype)
    return p


def _check_family(cfg: ModelConfig, *, decode: bool = False) -> None:
    """The transformer runs the dense, moe, vlm and audio families; with
    ``decode`` (prefill and the decode steps) not the audio encoder, which
    has no decode, in the reference neither."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"family {cfg.family!r} runs through models/ssm_lm.py or "
                         "models/hybrid.py (registry.get_api), not the transformer")
    if cfg.family not in ("dense", "moe", "vlm", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if decode and not cfg.is_decoder:
        raise ValueError(f"{cfg.arch_id}: the {cfg.family!r} family is an encoder "
                         "(lm_forward only): it has no prefill or decode")


def _units(cfg: ModelConfig) -> Tuple[int, int]:
    """(units, self layers a unit) of a cross-attention model."""
    return cfg.num_layers // cfg.cross_attn_period, cfg.cross_attn_period - 1


def layer_order(cfg: ModelConfig):
    """The layers in execution order: ``("self", i)`` for self layer i (its
    index into ``params["blocks"]`` and the caches) and, after each unit's
    self layers, ``("cross", u)`` for unit u's cross-attention block."""
    if not cfg.cross_attn_period:
        return [("self", i) for i in range(cfg.num_layers)]
    n_units, n_self = _units(cfg)
    order = []
    for u in range(n_units):
        order += [("self", u * n_self + j) for j in range(n_self)]
        order.append(("cross", u))
    return order


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters drawn from ``gen`` on ``gen.device`` (the
    reference's ``init_lm(key, cfg)`` with a torch Generator for the key;
    the numbers differ from JAX's, the shapes and scales do not)."""
    _check_family(cfg)
    gate_on = cfg.gate.enabled and cfg.has_attention and cfg.is_decoder
    p: Params = {}
    if cfg.family == "audio":
        # the frame features' projection; the encoder never reads "embed"
        # (the reference keeps it all the same: it trains to zero gradient)
        p["in_proj"] = init_linear(gen, cfg.n_audio_features, cfg.d_model, cfg.dtype)
    p["embed"] = {"w": (_randn(gen, (cfg.vocab_size, cfg.d_model))
                        * 0.02).to(torch_dtype(cfg.dtype))}
    p["blocks"] = [init_block(gen, cfg, with_gate=gate_on)
                   for _ in range(n_self_layers(cfg))]
    if cfg.cross_attn_period:
        p["cross_blocks"] = [init_block(gen, cfg, with_gate=False, cross=True)
                             for _ in range(_units(cfg)[0])]
    p["final_norm"] = init_rmsnorm(cfg.d_model, cfg.dtype, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, cfg.dtype)
    return p


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig, shard=None) -> torch.Tensor:
    """The final norm and the tied or untied logits; under a ``shard``
    that splits the vocabulary the rank's vocabulary block [..., V /
    world]."""
    x = copy_to_model(rms_norm(params["final_norm"], x, cfg.norm_eps), shard)
    if cfg.tie_embeddings:
        return x @ params["embed"]["w"].T
    return linear(params["lm_head"], x)


def _ep_vocab(shard, cfg: ModelConfig):
    """Under an EP-major ``shard``, the shard ``lm_head/w`` splits its
    columns over (None where it stays whole: tied, or a vocabulary the
    world does not divide); None otherwise."""
    if shard is None or not shard.ep_major or cfg.tie_embeddings \
            or cfg.vocab_size % shard.world:
        return None
    return shard


def serve_logits(params: Params, x: torch.Tensor, cfg: ModelConfig, shard=None
                 ) -> torch.Tensor:
    """The serving paths' logits [..., V], whole on every rank: under a
    sharded engine's ``shard`` that splits the vocabulary, the rank's
    block gathered exactly over the ranks (the replicated samplers and
    schedulers read the full row, the same on every rank). Under the
    EP-major layout, whose model ranks hold other rows, each rank's rows
    are gathered first, the rank's vocabulary block computed for all of
    them and gathered, and the rank keeps its own rows."""
    ev = _ep_vocab(shard, cfg)
    if ev is not None:
        n = x.shape[0]
        out = _logits(params, ev.all_gather(x, 0), cfg)
        return ev.all_gather(out, out.dim() - 1).narrow(0, ev.rank * n, n)
    vs = part(shard, cfg.vocab_size)
    out = _logits(params, x, cfg, vs)
    return out if vs is None else vs.all_gather(out, out.dim() - 1)


# ---------------------------------------------------------------------------
# full-sequence forward (pretraining and gate distillation)
# ---------------------------------------------------------------------------

def _base_grad(distill: bool):
    """The context the base model runs in: no autograd in distillation,
    the caller's otherwise (pretraining)."""
    return torch.no_grad() if distill else contextlib.nullcontext()


def attention_full(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   rope_positions: torch.Tensor,
                   segment_ids: Optional[torch.Tensor],
                   distill: bool, collect_gate: bool = False, shard=None):
    """Returns (out, kl_loss, extras|None).

    Under a training ``shard`` that splits the KV heads ``p`` holds the
    rank's heads (``distributed.sharding``): q/k/v, the attention, kernel
    6 and the gate run on them, ``out`` is summed over ranks and
    ``kl_loss`` is the rank's mean (``_global_kl`` combines the ranks').

    In distill mode the base attention runs without autograd, and on a
    gated layer its output and the distillation target come from one
    ``ops.gate_gt_attention`` call (the TPU kernel #6 path); the gate
    reads the pre-rope q/k, which carry no gradient, so only the gate's
    parameters are differentiated. Otherwise (pretraining) the attention
    is the plain, differentiable ``chunked_attention`` (causal or not as
    the config says).
    ``collect_gate`` (requires distill): extras = {"glog", "gt", "qr",
    "kr"} for gate-quality evaluation.
    """
    b, l, _ = x.shape
    gate_on = distill and "gate" in p
    shard = part(shard, cfg.n_kv_heads)
    with _base_grad(distill):
        q, k, v = _qkv(p, copy_to_model(x, shard), cfg, shard)
        qr = apply_rope(q, rope_positions, cfg.rope_theta)
        kr = apply_rope(k, rope_positions, cfg.rope_theta)
        if gate_on:
            o, bm = ops.gate_gt_attention(
                qr, kr, v, block_size=cfg.gate.block_size, q_chunk=cfg.q_chunk,
                segment_ids=segment_ids, logit_softcap=cfg.attn_logit_softcap)
            gt = ground_truth_from_blockmax(bm, cfg.gqa_group)
            del bm
        else:
            o = chunked_attention(qr, kr, v, causal=cfg.causal, q_chunk=cfg.q_chunk,
                                  logit_softcap=cfg.attn_logit_softcap,
                                  segment_ids=segment_ids)
        out = reduce_from_model(linear(p["wo"], o.reshape(b, l, -1)), shard)
    kl = torch.zeros((), dtype=torch.float32, device=x.device)
    extras = None
    if gate_on:
        qg = ag.gate_q(p["gate"], q, rope_positions, cfg.gate)
        kg = ag.gate_k(p["gate"], k, cfg.gate)
        glog = ag.gate_logits(qg, kg)                          # [B,Hkv,L,nb]
        mask = ag.block_causal_mask(torch.arange(l, device=x.device), kg.shape[1],
                                    cfg.gate.block_size)
        glog = torch.where(mask[None, None], glog, NEG_INF)
        kl = gate_kl_loss(glog, gt)
        if collect_gate:
            extras = {"glog": glog, "gt": gt, "qr": qr, "kr": kr}
    return out, kl, extras


def cross_attention_full(p: Params, x: torch.Tensor, kv, cfg: ModelConfig,
                         shard=None) -> torch.Tensor:
    """Cross-attention into a fixed context, the image embeddings, whose
    K/V ``kv`` come from ``_cross_kv``: position-free, no RoPE on either
    side, no mask. Under a training ``shard`` on the rank's heads, the
    output summed over ranks."""
    b, l, _ = x.shape
    dh = cfg.resolved_head_dim
    shard = part(shard, cfg.n_kv_heads)
    q = linear(p["wq"], copy_to_model(x, shard)).reshape(b, l, -1, dh)
    k, v = kv
    if cfg.qk_norm:
        q = rms_norm({"scale": copy_to_model(p["q_norm"]["scale"], shard)}, q, cfg.norm_eps)
    o = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk)
    return reduce_from_model(linear(p["wo"], o.reshape(b, l, -1)), shard)


def _cross_kv(p: Params, ctx: torch.Tensor, cfg: ModelConfig, shard=None):
    """The context's K/V, seq-major [B, n_img, Hkv, Dh] (k normed under
    ``qk_norm``), of the heads whose columns ``p`` holds."""
    b, n = ctx.shape[:2]
    dh = cfg.resolved_head_dim
    shard = part(shard, cfg.n_kv_heads)
    ctx = copy_to_model(ctx, shard)
    k = linear(p["wk"], ctx).reshape(b, n, -1, dh)
    v = linear(p["wv"], ctx).reshape(b, n, -1, dh)
    if cfg.qk_norm:
        k = rms_norm({"scale": copy_to_model(p["k_norm"]["scale"], shard)}, k, cfg.norm_eps)
    return k, v


def block_fwd_full(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   rope_positions, segment_ids, distill: bool,
                   collect_gate: bool = False, cross_ctx=None, shard=None, data=None):
    """One layer. ``distill`` runs the residual stream without autograd
    (the gate's own einsums aside); otherwise the whole block is
    differentiable (pretraining). A given ``cross_ctx`` makes it a
    cross-attention block (no gate). Under a training ``shard`` the
    attention and the feed-forward run tensor-parallel; the residual
    stream is replicated. Rows split over a ``data`` shard keep the MoE
    routing of the global rows. Returns (x, kl, MoE router loss or None,
    extras|None)."""
    with _base_grad(distill):
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
    if cross_ctx is not None:
        with _base_grad(distill):
            attn_out = cross_attention_full(
                p["attn"], h, _cross_kv(p["attn"], cross_ctx, cfg, shard), cfg, shard)
        kl, extras = torch.zeros((), dtype=torch.float32, device=x.device), None
    else:
        attn_out, kl, extras = attention_full(
            p["attn"], h, cfg, rope_positions=rope_positions,
            segment_ids=segment_ids, distill=distill, collect_gate=collect_gate,
            shard=shard)
    with _base_grad(distill):
        x = x + attn_out
        y, aux = ffn(p, rms_norm(p["ln2"], x, cfg.norm_eps), cfg, shard, data=data)
    return x + y, kl, aux, extras


def _pretrain_block(cfg: ModelConfig, rope_positions, segment_ids, cross_ctx, shard=None,
                    data=None):
    """A block of the pretraining forward as a function of (params, x) ->
    (x, MoE router loss), for ``common.remat``: every tensor it returns
    is one the backward can reach."""
    def fwd(lp, x):
        y, _, aux, _ = block_fwd_full(lp, x, cfg, rope_positions=rope_positions,
                                      segment_ids=segment_ids, distill=False,
                                      cross_ctx=cross_ctx, shard=shard, data=data)
        return y, (torch.zeros((), dtype=torch.float32, device=x.device)
                   if aux is None else aux)
    return remat(fwd, cfg)


def lm_backbone(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                rope_positions, segment_ids, distill: bool,
                collect_gate: bool = False, cross_ctx=None, shard=None, data=None):
    """Runs the layers in ``layer_order`` (a Python loop in place of
    ``lax.scan``). Returns (x, kl_sum, aux_sum, extras|None): the gate KL
    and the MoE router loss summed over layers; extras stack each key over
    the self layers, [L, ...]. ``distill`` freezes the base (every layer,
    the cross-attention ones too); otherwise each layer is differentiable
    and runs under the config's ``remat``."""
    kl = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.cross_attn_period and cross_ctx is None:
        raise ValueError("a cross-attention model needs batch['image_embeds']")
    if not distill:
        self_fwd = _pretrain_block(cfg, rope_positions, segment_ids, None, shard, data)
        cross_fwd = _pretrain_block(cfg, rope_positions, segment_ids, cross_ctx, shard, data)
        for kind, i in layer_order(cfg):
            if kind == "self":
                x, l_aux = self_fwd(params["blocks"][i], x)
            else:
                x, l_aux = cross_fwd(params["cross_blocks"][i], x)
            aux = aux + l_aux
        return x, kl, aux, None
    per_layer = []
    for kind, i in layer_order(cfg):
        lp = params["blocks"][i] if kind == "self" else params["cross_blocks"][i]
        x, l_kl, l_aux, extras = block_fwd_full(
            lp, x, cfg, rope_positions=rope_positions, segment_ids=segment_ids,
            distill=True, collect_gate=collect_gate,
            cross_ctx=cross_ctx if kind == "cross" else None, shard=shard, data=data)
        kl = kl + l_kl
        if l_aux is not None:
            aux = aux + l_aux
        if kind == "self":
            per_layer.append(extras)
    stacked = None
    if collect_gate and per_layer and per_layer[0] is not None:
        stacked = {key: torch.stack([e[key] for e in per_layer]) for key in per_layer[0]}
    return x, kl, aux, stacked


def _n_gate_layers(cfg: ModelConfig) -> int:
    if not (cfg.gate.enabled and cfg.has_attention and cfg.is_decoder):
        return 0
    return n_self_layers(cfg)


def _full_inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 distill: bool = True, shard=None):
    """(x, positions, segment ids, image context) of a full-sequence
    forward: the token embeddings (vocabulary-parallel under a training
    ``shard``), or the audio encoder's ``in_proj`` of
    ``batch["features"]`` [B, L, n_audio_features]; without autograd in
    distill mode."""
    _check_family(cfg)
    with _base_grad(distill):
        if cfg.family == "audio":
            x = linear(params["in_proj"], batch["features"])
        else:
            x = embed(params, batch["tokens"], cfg, shard)
    b, l = x.shape[:2]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(l, device=x.device)[None, :].expand(b, l)
    return x, pos, batch.get("segment_ids"), _image_ctx(batch, x.dtype)


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig, shard=None
          ) -> torch.Tensor:
    """The token embeddings [..., d]: the table's rows, or under a
    ``shard`` (training's or a sharded engine's) that splits the
    vocabulary the sum over ranks of each rank's rows
    (``sharding.vocab_parallel_embed``)."""
    shard = part(shard, cfg.vocab_size)
    if shard is None:
        return params["embed"]["w"][tokens]
    return vocab_parallel_embed(params["embed"]["w"], tokens, shard)


def lm_loss(params: Params, x: torch.Tensor, batch, cfg: ModelConfig, shard=None,
            data=None) -> torch.Tensor:
    """The fp32 cross-entropy of ``batch["labels"]`` under its
    ``loss_mask`` from the last hidden states x (vocabulary-parallel
    under a training ``shard`` that splits the vocabulary); over a
    ``data`` shard the global batch's (``common.cross_entropy_loss``)."""
    ev = _ep_vocab(shard, cfg)
    if ev is not None:
        # EP-major: the model group's rows gathered (each rank's gradient
        # of them summed back to its own), then the vocabulary-parallel CE
        # over the group's rows, the same on every rank of it
        x = copy_to_model(gather_rows(x, ev), ev)
        mask = batch.get("loss_mask")
        return cross_entropy_loss(_logits(params, x, cfg), ev.all_gather(batch["labels"], 0),
                                  None if mask is None else ev.all_gather(mask, 0), ev, data)
    shard = part(shard, cfg.vocab_size)
    return cross_entropy_loss(_logits(params, x, cfg, shard), batch["labels"],
                              batch.get("loss_mask"), shard, data)


def global_kl(kl: torch.Tensor, cfg: ModelConfig, shard=None, data=None) -> torch.Tensor:
    """The gate KL over all KV heads from a rank's mean over its own (the
    same number of rows on every rank): their mean over ranks. The
    rank's value itself where the attention stays replicated. Over a
    ``data`` shard, whose replicas hold equal shares of the rows, the
    mean over the data ranks as well (the global batch's)."""
    ash = part(shard, cfg.n_kv_heads)
    if ash is None and shard is not None and shard.ep_major:
        ash = shard                     # EP-major: each model rank its own rows
    if ash is not None:
        kl = reduce_from_model(kl, ash) / ash.world
    return kl if data is None else reduce_from_model(kl, data) / data.world


def _image_ctx(batch: Dict[str, torch.Tensor], dtype: torch.dtype):
    """The batch's image embeddings in the working dtype, or None."""
    ctx = batch.get("image_embeds")
    return None if ctx is None else torch.as_tensor(ctx).to(dtype)


def lm_forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
               mode: str = "pretrain", shard=None, data=None):
    """mode 'pretrain' -> (ce + router loss, {"ce", "aux"}): the final
    norm, the tied or untied logits and the fp32 cross-entropy of
    ``batch["labels"]`` under its ``loss_mask``, plus the MoE router loss
    summed over layers; differentiable with respect to every leaf the
    forward reads (the gate is not read: its gradient is zero). mode
    'distill' -> (kl_loss + 0 * router loss, {"kl"}): the gate KL summed
    over the gated layers and divided by their number, differentiable
    with respect to the gate parameters only (the MoE router loss enters
    with weight 0, as in the reference). ``batch`` holds tokens [B, L]
    and, from the data pipeline, the per-document ``positions`` (RoPE)
    and the packing ``segment_ids`` (attention mask); the causal masks use
    the global index; a vision model's batch also carries
    ``image_embeds`` [B, n_img, d]; the audio encoder's holds
    ``features`` [B, L, n_audio_features] and ``labels`` (positions
    ``arange``, no segments, non-causal attention).

    ``shard`` (a ``distributed.sharding.Shard``; anything else raises
    TypeError): tensor-parallel training over its group, ``params`` this
    rank's blocks (``sharding.shard_params``), the batch the same on
    every rank; the loss and metrics are the whole model's on every
    rank. ``data`` (a second ``Shard``, the data axis): ``batch`` is this
    replica's rows of the global batch, and the loss, the metrics and the
    MoE routing are the global batch's."""
    if mode not in ("pretrain", "distill"):
        raise ValueError(f"lm_forward: unknown mode {mode!r}")
    check_shard(shard)
    check_shard(data)
    shard = ep_view(shard, cfg)
    distill = mode == "distill"
    x, pos, seg, ctx = _full_inputs(params, batch, cfg, distill, shard)
    x, kl, aux, _ = lm_backbone(params, x, cfg, rope_positions=pos, segment_ids=seg,
                                distill=distill, cross_ctx=ctx, shard=shard, data=data)
    if distill:
        kl = global_kl(kl, cfg, shard, data) / max(_n_gate_layers(cfg), 1)
        return kl + aux * 0.0, {"kl": kl.detach()}
    ce = lm_loss(params, x, batch, cfg, shard, data)
    return ce + aux, {"ce": ce.detach(), "aux": aux.detach()}


def lm_gate_collect(params: Params, batch: Dict[str, torch.Tensor],
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Gate-quality evaluation pass: the distill forward collecting, per
    self layer, glog/gt [L, B, Hkv, Lq, nb] and the post-rope qr [L, B,
    Lq, H, Dh] / kr [L, B, Lq, Hkv, Dh]."""
    x, pos, seg, ctx = _full_inputs(params, batch, cfg)
    with torch.no_grad():
        _, _, _, extras = lm_backbone(params, x, cfg, rope_positions=pos,
                                      segment_ids=seg, distill=True,
                                      collect_gate=True, cross_ctx=ctx)
    return extras


# ---------------------------------------------------------------------------
# serving state
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """All caches are HEAD-MAJOR; decode reads and writes them in place.
    The caches of the gate, the K/V and the metadata hold the SELF layers
    only; ``cross_k``/``cross_v`` hold each cross-attention unit's image
    K/V, written at prefill and read, never written, by every step.
    ``meta_*`` is the incremental selection-metadata cache (core.metacache)
    of a policy that reads it (QuestPolicy): allocated and built at
    prefill only when the prefill ``options`` carry such a policy, None
    otherwise, and advanced per step only for that policy."""
    k_cache: torch.Tensor                   # [L, B, Hkv, S_max, Dh] (post-rope)
    v_cache: torch.Tensor                   # [L, B, Hkv, S_max, Dh]
    kg_cache: Optional[torch.Tensor]        # [L, B, Hkv, nb_max, Dg]
    kg_n: Optional[torch.Tensor]            # [L, B] int32
    cur_len: torch.Tensor                   # [B] int32
    cross_k: Optional[torch.Tensor] = None      # [n_units, B, Hkv, n_img, Dh]
    cross_v: Optional[torch.Tensor] = None      # [n_units, B, Hkv, n_img, Dh]
    meta_kmin: Optional[torch.Tensor] = None    # [L, B, Hkv, nb_max, Dh] f32
    meta_kmax: Optional[torch.Tensor] = None    # [L, B, Hkv, nb_max, Dh] f32
    meta_n: Optional[torch.Tensor] = None       # [L, B] int32


def n_self_layers(cfg: ModelConfig) -> int:
    """The layers with a KV cache: all of them, or a cross-attention
    model's self layers."""
    if cfg.cross_attn_period:
        n_units, n_self = _units(cfg)
        return n_units * n_self
    return cfg.num_layers


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: Optional[torch.dtype] = None,
                      options: Optional[DecodeOptions] = None, *,
                      device: torch.device | str | None = None,
                      kv_heads: Optional[int] = None) -> DecodeState:
    """Zeroed caches on ``device`` (``None`` = CUDA, which raises without
    a card) at ``kv_heads`` KV heads (all of them by default; a sharded
    engine's prefill: its rank's); the metadata cache only for a
    ``needs_meta`` policy."""
    device = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)
    dh = cfg.resolved_head_dim
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    nl = n_self_layers(cfg)
    nb_max = max_len // cfg.gate.block_size
    kg = kg_n = None
    if cfg.gate.enabled:
        kg = torch.zeros((nl, batch, hkv, nb_max, cfg.gate.d_gate), dtype=dt,
                         device=device)
        kg_n = torch.zeros((nl, batch), dtype=torch.int32, device=device)
    meta_kmin = meta_kmax = meta_n = None
    if options is not None and options.policy.needs_meta:
        meta_kmin, meta_kmax = (torch.zeros((nl, batch, hkv, nb_max, dh),
                                            dtype=torch.float32, device=device)
                                for _ in range(2))
        meta_n = torch.zeros((nl, batch), dtype=torch.int32, device=device)
    cross_k = cross_v = None
    if cfg.cross_attn_period:
        cross_k, cross_v = (torch.zeros((_units(cfg)[0], batch, hkv, cfg.n_image_tokens,
                                         dh), dtype=dt, device=device) for _ in range(2))
    return DecodeState(
        k_cache=torch.zeros((nl, batch, hkv, max_len, dh), dtype=dt, device=device),
        v_cache=torch.zeros((nl, batch, hkv, max_len, dh), dtype=dt, device=device),
        kg_cache=kg, kg_n=kg_n,
        cur_len=torch.zeros((batch,), dtype=torch.int32, device=device),
        cross_k=cross_k, cross_v=cross_v,
        meta_kmin=meta_kmin, meta_kmax=meta_kmax, meta_n=meta_n)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def lm_prefill(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, max_len: int,
               options: Optional[DecodeOptions] = None, shard=None, data=None
               ) -> Tuple[torch.Tensor, DecodeState]:
    """Full forward filling the caches. Returns (last logits [B, V], state).

    ``batch["tokens"]`` [B, L] on the parameters' device. Only COMPLETE
    blocks enter the K-compression cache (the trailing partial block stays
    a zero row until decode completes it). ``batch["lengths"]`` (optional,
    [B] int) holds the TRUE prompt lengths of right-padded rows (the
    serve path's power-of-two buckets): causality keeps real positions
    blind to the pad tokens, the logits are taken at ``lengths - 1``,
    ``cur_len``/``kg_n`` are the true lengths, and the Kg rows of blocks
    that touch a pad token are zero. ``options`` (those the decode steps
    will run with) also builds the selection-metadata cache when its
    policy reads one: the one O(S) pass that makes every QuestPolicy
    step O(block_size). A cross-attention model's ``batch["image_embeds"]``
    [B, n_img, d] fills ``cross_k``/``cross_v`` (head-major), the
    context every decode step attends. Under a sharded engine's ``shard``
    (``params`` cut by ``sharding.decode_params``) every block runs on the
    rank's block of its weights, the embedding and logits on the rank's
    vocabulary (the last logits gathered whole), and the caches, the
    cross ones too, hold the rank's KV heads. ``data``: the rows are a
    data replica's share of the batch, and a MoE block routes as the
    whole batch would (``moe.moe_mlp(data=)``)."""
    _check_family(cfg, decode=True)
    shard = ep_view(shard, cfg)
    tokens = batch["tokens"]
    b, l = tokens.shape
    if l > max_len:
        raise ValueError(f"prompt length {l} > max_len {max_len}")
    dev = params["embed"]["w"].device
    state = init_decode_state(cfg, b, max_len, options=options, device=dev,
                              kv_heads=attn_kv_heads(cfg, shard))
    bs = cfg.gate.block_size
    pos = torch.arange(l, device=dev)[None, :].expand(b, l)
    x = embed(params, tokens, cfg, shard)
    ctx = _image_ctx(batch, x.dtype)
    if cfg.cross_attn_period and ctx is None:
        raise ValueError("a cross-attention model needs batch['image_embeds']")
    for kind, i in layer_order(cfg):
        if kind == "cross":
            cp = params["cross_blocks"][i]
            ck, cv = _cross_kv(cp["attn"], ctx, cfg, shard)
            state.cross_k[i] = ck.transpose(1, 2)
            state.cross_v[i] = cv.transpose(1, 2)
            x = x + cross_attention_full(cp["attn"], rms_norm(cp["ln1"], x, cfg.norm_eps),
                                         (ck, cv), cfg, shard)
            x = x + mlp(cp["mlp"], rms_norm(cp["ln2"], x, cfg.norm_eps), cfg.activation,
                        part(shard, cfg.d_ff))
            continue
        x = prefill_block(params["blocks"][i], x, cfg, pos, state.k_cache[i],
                          state.v_cache[i], None if state.kg_cache is None
                          else state.kg_cache[i], shard, data)
    last = finish_prefill(state, x, batch.get("lengths"), bs)
    if state.meta_kmin is not None:
        # kv_len masking keeps pad and beyond-length tokens out of min/max
        for i in range(state.meta_kmin.shape[0]):
            meta = mc.prefill_metacache(
                mc.SelectionMetaCache(state.meta_kmin[i], state.meta_kmax[i],
                                      state.meta_n[i]),
                state.k_cache[i], state.cur_len, bs)
            state.meta_n[i] = meta.n_complete
    return serve_logits(params, last, cfg, shard), state


def prefill_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  kg_cache: Optional[torch.Tensor], shard=None, data=None) -> torch.Tensor:
    """One self-attention block over the prompt x [B, L, d], writing its
    caches in place: the post-rope K and the V into ``k_cache``/``v_cache``
    [B, Hkv, S_max, Dh] (the ONE-TIME layout conversion, seq-major to
    head-major) and the Kg rows of the complete blocks into ``kg_cache``
    [B, Hkv, nb_max, Dg] when given and the layer is gated. Returns x.
    The transformer's layers and the hybrid's shared block take it. Under
    a sharded engine's ``shard`` ``lp`` is the rank's block: the attention
    runs on its KV heads (the caches hold them; the whole gate is
    head-sliced), its ``wo`` rows give a partial output summed over the
    ranks, and the feed-forward splits as ``attn_core.ffn(decode=True)``
    splits it."""
    b, l, _ = x.shape
    bs = cfg.gate.block_size
    nb = l // bs
    p = lp["attn"]
    ash = part(shard, cfg.n_kv_heads)
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    qr = apply_rope(q, pos, cfg.rope_theta)
    kr = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(qr, kr, v, causal=cfg.causal, q_chunk=cfg.q_chunk,
                          logit_softcap=cfg.attn_logit_softcap)
    k_cache[:, :, :l] = kr.transpose(1, 2)
    v_cache[:, :, :l] = v.transpose(1, 2)
    if kg_cache is not None and "gate" in p and nb:
        kg = ag.gate_k(rank_gate(p["gate"], ash), k[:, :nb * bs], cfg.gate)  # [B,nb,Hkv,Dg]
        kg_cache[:, :, :nb] = kg.transpose(1, 2).to(kg_cache.dtype)
    x = x + reduce_from_model(linear(p["wo"], o.reshape(b, l, -1)), ash)
    del q, k, v, qr, kr, o
    return x + ffn(lp, rms_norm(lp["ln2"], x, cfg.norm_eps), cfg, shard, decode=True,
                   data=data)[0]


def finish_prefill(state, x: torch.Tensor, lengths, block_size: int) -> torch.Tensor:
    """Sets ``state.cur_len`` (and ``kg_n`` [L, B] where the state has a
    gate cache) from the prompt's (or right-padded rows' true) lengths,
    zeroes the Kg rows of blocks that touch a pad token, and returns the
    last real position's hidden state [B, d]."""
    b, l = x.shape[:2]
    dev = x.device
    if lengths is None:
        state.cur_len.fill_(l)
        last = x[:, -1]
    else:
        state.cur_len.copy_(torch.as_tensor(lengths, device=dev))
        last = x[torch.arange(b, device=dev), torch.clamp_min(state.cur_len - 1, 0).long()]
    if state.kg_n is not None:
        state.kg_n.copy_((state.cur_len // block_size)[None].expand_as(state.kg_n))
        if lengths is not None:
            # blocks touching pad tokens hold garbage Kg rows: zero them
            # (rows >= lengths // bs), so a partial trailing block reads zero
            row_ok = (torch.arange(state.kg_cache.shape[3], device=dev)[None, :]
                      < (state.cur_len // block_size)[:, None])
            state.kg_cache.masked_fill_(~row_ok[None, :, None, :, None], 0)
    return last


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def attention_decode(p: Params, x1: torch.Tensor, cfg: ModelConfig, *,
                     k_cache, v_cache, kg_cache, kg_n, cur_len,
                     options: DecodeOptions, meta_kmin=None, meta_kmax=None,
                     meta_n=None, shard=None, stage=None, plan=None):
    """One token. x1 [B,1,d]; caches for ONE layer HEAD-MAJOR [B,Hkv,S,Dh].
    Returns (out, (k_cache, v_cache, kg_cache, kg_n, meta_kmin, meta_kmax,
    meta_n), selection_aux), and the next layer's plan as a 4th element
    when ``stage`` is given.

    Writes the new K/V at ``cur_len`` and advances the Kg and metadata
    caches with ``new_len = cur_len + 1`` (in place, each only for the
    policy that reads it); selects with ``n_valid =
    visible_blocks(max(new_len, 1))`` and decodes with ``kv_len = new_len``.

    ``stage``/``plan`` (a plan-carrying SelectionSchedule): STAGE_DENSE
    runs dense attention, STAGE_SELECT computes a fresh selection,
    STAGE_REUSE attends the carried ``plan`` [B, Hkv, k] as it is; the
    Python layer loop makes the stage a branch. Only a selecting layer
    advances its Kg and metadata caches: a dense or reusing layer never
    reads them.

    With a ``shard`` (``p`` the rank's block of a sharded engine: the
    projections of its KV heads, the gate whole) and GatePolicy on a gated
    layer the step is the sequence-sharded one
    (``serve.sharded.sharded_sparse_decode``): the caches are this rank's
    part along the sequence, at every head, so the rank's new q/k/v heads
    are gathered over the ranks first (one packed collective) and the
    gate query comes from the whole q and the whole gate; the rank's
    heads of the combined output take its ``wo`` rows and one sum. The
    measured sparsity comes from the selection counts summed over ranks.
    Its selection is fused into the collectives, so it carries no plan
    and no cross-head reduction: a shard with any other selecting layer
    or a non-trivial schedule raises, as the reference refuses a plan
    there (``serve`` takes schedules on a sharded engine). A dense policy
    attends the rank's KV heads of the caches (a sharded prefill's), then
    the same ``wo`` rows and sum. An attention that the world size does
    not split (MQA) runs whole on every rank, with no collective but the
    sequence-sharded step's own. The sequence is split over
    ``shard.seq_group``: the shard's own group, or for a batch the data
    axis does not divide the data x model world (``Shard.over_sequence``),
    whose candidate gather and combine then span every rank while the
    head gather and the ``wo`` sum stay on the model group.
    """
    b = x1.shape[0]
    dh, hkv, g = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.gqa_group
    bs = cfg.gate.block_size
    policy = options.policy
    sparse_on = _policy_active(policy, p)
    ash = part(shard, hkv)
    q, k, v = _qkv(p, x1, cfg)                             # the heads p holds
    pos = cur_len[:, None]                                 # [B,1]

    if shard is not None and not shard.ep_major and not policy.dense:
        if not (sparse_on and policy.needs_gate and "gate" in p) \
                or not options.schedule.is_trivial:
            raise ValueError(
                "sharded decoding on the contiguous path needs GatePolicy on a "
                "gated layer and the trivial schedule (its selection is fused "
                "into the collectives and carries no plan); serve() takes "
                "schedules on a sharded engine")
        if ash is not None:                  # every head, from the ranks' blocks
            q, k, v = ash.all_gather_packed([q.reshape(b, 1, k.shape[2], -1), k, v], 2)
            q = q.reshape(b, 1, -1, dh)
        qr = apply_rope(q, pos, cfg.rope_theta)
        kr = apply_rope(k, pos, cfg.rope_theta)
        qg = ag.gate_q(p["gate"], q, pos, cfg.gate)[:, 0]         # [B,Hkv,Dg]
        o, n_sel = sharded_sparse_decode(
            qg, qr[:, 0].reshape(b, hkv, g, dh), kr[:, 0], v[:, 0], k_cache, v_cache,
            kg_cache, cur_len, p["gate"]["wk"], shard=shard.seq_group, cfg=cfg.gate,
            rope_theta=cfg.rope_theta, max_selected=options.max_selected(cfg))
        new_len = cur_len + 1
        kg_n = torch.where((new_len % bs) == 0, new_len // bs, kg_n).to(torch.int32)
        if ash is not None:
            o = ash.head_slice(o, 1)
        out = reduce_from_model(linear(p["wo"], o.reshape(b, 1, -1)), ash)
        if options.measure_sparsity:
            n_valid = kc.visible_blocks(torch.clamp_min(new_len, 1), bs).to(torch.float32)
            frac = n_sel.to(torch.float32) / torch.clamp_min(n_valid[:, None], 1.0)
            rho_rows = 1.0 - torch.mean(frac, dim=1)
            aux = (torch.mean(rho_rows), rho_rows,
                   torch.mean(n_sel.to(torch.float32), dim=1), n_valid)
        else:
            aux = _zero_layer_aux(b, x1.device)
        return out, (k_cache, v_cache, kg_cache, kg_n, meta_kmin, meta_kmax,
                     meta_n), aux

    q_nope = q
    qr = apply_rope(q, pos, cfg.rope_theta)
    kr = apply_rope(k, pos, cfg.rope_theta)
    bidx = torch.arange(b, device=x1.device)
    k_cache[bidx, :, cur_len] = kr[:, 0]
    v_cache[bidx, :, cur_len] = v[:, 0]
    new_len = cur_len + 1
    dense = not sparse_on or stage == STAGE_DENSE
    idx = plan

    if sparse_on and stage in (None, STAGE_SELECT):
        # the Kg and metadata caches advance (in place) only for the
        # policy that reads them, and only at a selecting layer
        if policy.needs_gate and "gate" in p and kg_cache is not None:
            kg_n = kc.update_kcache(
                kc.KCompressionCache(kg_cache, kg_n), p["gate"], k_cache, new_len,
                cfg.gate, cache_is_roped=True, rope_theta=cfg.rope_theta).n_complete
        if policy.needs_meta and meta_kmin is not None:
            meta_n = mc.update_metacache(
                mc.SelectionMetaCache(meta_kmin, meta_kmax, meta_n), k_cache,
                new_len, bs).n_complete
        inp = SelectionInputs(q_nope=q_nope, qr=qr, pos=pos, new_len=new_len,
                              gate_params=p.get("gate"), kg=kg_cache,
                              k_cache=k_cache, meta_kmin=meta_kmin,
                              meta_kmax=meta_kmax)
        idx = policy.select(inp, cfg, max_selected=options.max_selected(cfg),
                            unify_heads=options.schedule.unify_heads)
    if dense:
        o = decode_attention(qr, k_cache, v_cache, new_len,
                             logit_softcap=cfg.attn_logit_softcap)
        aux = (_dense_aux(new_len, bs) if options.measure_sparsity
               else _zero_layer_aux(b, x1.device))
    else:
        qgrp = qr[:, 0].reshape(b, -1, g, dh)
        o = ops.sparse_decode(qgrp, k_cache, v_cache, idx, new_len, block_size=bs)
        aux = (_selection_aux(idx, kc.visible_blocks(
                   torch.clamp_min(new_len, 1), bs), k_cache.shape[2] // bs)
               if options.measure_sparsity else _zero_layer_aux(b, x1.device))
    out = reduce_from_model(linear(p["wo"], o.reshape(b, 1, -1)), ash)
    ret = (out, (k_cache, v_cache, kg_cache, kg_n, meta_kmin, meta_kmax, meta_n), aux)
    # a dense layer (or an ungated one) passes the plan through untouched
    return ret + (idx,) if stage is not None else ret


def block_decode(p: Params, x1: torch.Tensor, cfg: ModelConfig, layer_state,
                 cur_len: torch.Tensor, *, options: DecodeOptions, shard=None,
                 stage=None, plan=None, data=None):
    """One transformer block; ``layer_state`` is the layer's (k_cache,
    v_cache, kg_cache, kg_n, meta_kmin, meta_kmax, meta_n). Returns (x1,
    new layer state, aux), plus the plan when ``stage`` is given."""
    k_cache, v_cache, kg_cache, kg_n, meta_kmin, meta_kmax, meta_n = layer_state
    h = rms_norm(p["ln1"], x1, cfg.norm_eps)
    ret = attention_decode(
        p["attn"], h, cfg, k_cache=k_cache, v_cache=v_cache,
        kg_cache=kg_cache, kg_n=kg_n, cur_len=cur_len, options=options,
        meta_kmin=meta_kmin, meta_kmax=meta_kmax, meta_n=meta_n,
        shard=shard, stage=stage, plan=plan)
    attn_out, new_state, aux = ret[:3]
    x1 = x1 + attn_out
    h2 = rms_norm(p["ln2"], x1, cfg.norm_eps)
    return (x1 + ffn(p, h2, cfg, shard, decode=True, data=data)[0], new_state,
            aux) + ret[3:]


def cross_block_decode(p: Params, x1: torch.Tensor, cfg: ModelConfig,
                       ck: torch.Tensor, cv: torch.Tensor, shard=None) -> torch.Tensor:
    """A cross-attention block at decode: dense ``decode_attention`` of
    the token over its unit's image K/V [B, Hkv, n_img, Dh] (precomputed
    at prefill; no RoPE). Under a sharded engine's ``shard`` ``p`` is the
    rank's block and the image K/V the rank's heads (``lm_prefill``): the
    attention is local, its ``wo`` rows and the MLP's hidden units each
    give a partial output, summed over the ranks."""
    b = x1.shape[0]
    h = rms_norm(p["ln1"], x1, cfg.norm_eps)
    q = linear(p["attn"]["wq"], h).reshape(b, 1, -1, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = rms_norm(p["attn"]["q_norm"], q, cfg.norm_eps)
    n_img = torch.full((b,), ck.shape[2], dtype=torch.int32, device=x1.device)
    o = decode_attention(q, ck, cv, n_img)
    x1 = x1 + reduce_from_model(linear(p["attn"]["wo"], o.reshape(b, 1, -1)),
                                part(shard, cfg.n_kv_heads))
    return x1 + mlp(p["mlp"], rms_norm(p["ln2"], x1, cfg.norm_eps), cfg.activation,
                    part(shard, cfg.d_ff))


def _plan0(options: DecodeOptions, cfg: ModelConfig, batch: int, nb: int, device,
           hkv: Optional[int] = None):
    """The layer stages and the empty plan [B, hkv, width] of a
    plan-carrying schedule, or (None, None); ``hkv`` defaults to every KV
    head (a head-sharded step carries its rank's)."""
    if not options.schedule.needs_plan:
        return None, None
    stages = options.schedule.layer_stages(n_self_layers(cfg))
    width = selection_width(options.policy, cfg, nb, options.max_selected(cfg))
    hkv = cfg.n_kv_heads if hkv is None else hkv
    return stages, torch.full((batch, hkv, width), -1, dtype=torch.int32, device=device)


def lm_decode_step(params: Params, state: DecodeState, token: torch.Tensor,
                   cfg: ModelConfig, *,
                   options: Optional[DecodeOptions] = None, shard=None, data=None):
    """token [B] -> (logits [B, V], DecodeState, aux dict).

    The caches in ``state`` are updated in place; the returned state holds
    the same cache tensors and ``cur_len + 1``. ``aux`` reports the
    MEASURED selection of this step (sparsity/sel_blocks/vis_blocks),
    averaged over layers. A plan-carrying ``options.schedule`` stages each
    layer and carries the plan from layer to layer, its width from
    ``selection_width``. With a ``shard`` (``params`` a sharded engine's)
    and a selecting policy the caches are this rank's part along the
    sequence (``distributed.sharding.seq_shard_state``), with a dense one
    its KV heads; the embedding and the logits run on the rank's
    vocabulary, the logits gathered whole. A cross-attention model
    runs its units' cross blocks over ``cross_k``/``cross_v`` between the
    self layers and refuses a plan-carrying schedule, as the reference
    does. ``data``: the rows are a data replica's share of the batch, and
    a MoE block routes as the whole batch would."""
    options = options if options is not None else default_options(cfg)
    if options.schedule.needs_plan and cfg.cross_attn_period:
        raise NotImplementedError(
            "SelectionSchedule plans assume a uniform self-attn stack; "
            "cross-attn unit families keep per-layer selection "
            "(schedule=SelectionSchedule())")
    shard = ep_view(shard, cfg)
    x1 = embed(params, token[:, None], cfg, shard)
    stages, plan = _plan0(options, cfg, token.shape[0],
                          state.k_cache.shape[3] // cfg.gate.block_size, x1.device)
    auxs = []

    def row(t, i):
        return None if t is None else t[i]

    for kind, i in layer_order(cfg):
        if kind == "cross":
            x1 = cross_block_decode(params["cross_blocks"][i], x1, cfg,
                                    state.cross_k[i], state.cross_v[i], shard)
            continue
        lp = params["blocks"][i]
        layer_state = (state.k_cache[i], state.v_cache[i], row(state.kg_cache, i),
                       row(state.kg_n, i), row(state.meta_kmin, i),
                       row(state.meta_kmax, i), row(state.meta_n, i))
        ret = block_decode(lp, x1, cfg, layer_state, state.cur_len, options=options,
                           shard=shard, stage=None if stages is None else stages[i],
                           plan=plan, data=data)
        x1, new_state, aux = ret[:3]
        if stages is not None:
            plan = ret[3]
        for counts, new in ((state.kg_n, new_state[3]), (state.meta_n, new_state[6])):
            if counts is not None and new is not counts[i]:
                counts[i] = new
        auxs.append(aux)
    logits = serve_logits(params, x1, cfg, shard)
    new_state = state._replace(cur_len=state.cur_len + 1)
    return logits[:, 0], new_state, aggregate_decode_aux(auxs)


# ---------------------------------------------------------------------------
# paged decode (continuous batching): per-row ragged lengths + page pools
# ---------------------------------------------------------------------------

def lm_decode_step_paged(params: Params, pages, slot_state,
                         token: torch.Tensor, page_table: torch.Tensor,
                         cur_len: torch.Tensor, active: torch.Tensor,
                         cfg: ModelConfig, *,
                         options: Optional[DecodeOptions] = None,
                         budget_blocks: Optional[torch.Tensor] = None, shard=None):
    """Continuous-batching decode step. token/cur_len/active [n_slots];
    ``pages`` a ``serve.paging.PagedPages`` (layer-stacked pools, updated
    IN PLACE); page_table [n_slots, npt] int32; ``budget_blocks``
    [n_slots] (optional) per-slot selected-block caps of per-request
    budgets. Returns (logits [n_slots, V], pages, slot_state, aux dict).

    ``slot_state`` is the reference's per-slot recurrent-state seam; the
    transformer is pages-only and passes ``None`` through. Inactive rows
    produce garbage logits (the engine ignores them) but neither touch
    live pages nor advance. A plan-carrying ``options.schedule`` stages
    the layers as ``lm_decode_step`` does, the plan's width from the page
    table's logical-block count. With a ``shard`` (``params`` a sharded
    engine's) the pools hold this rank's KV heads
    (``attn_core.attention_decode_paged``), and so does the carried plan;
    the embedding and the logits run on the rank's vocabulary, the
    logits gathered whole. A cross-attention model has no paged step (the
    reference refuses it)."""
    _check_family(cfg, decode=True)
    if cfg.cross_attn_period:
        raise NotImplementedError("paged decode: cross-attn families TBD")
    options = options if options is not None else default_options(cfg)
    x1 = embed(params, token[:, None], cfg, shard)
    stages, plan = _plan0(options, cfg, token.shape[0], page_table.shape[1], x1.device,
                          None if shard is None else shard.local_heads(cfg.n_kv_heads))
    auxs = []
    for i, lp in enumerate(params["blocks"]):
        layer_pages = tuple(None if pool is None else pool[i] for pool in pages)
        ret = block_decode_paged(
            lp, x1, cfg, layer_pages, page_table, cur_len, active, options=options,
            budget_blocks=budget_blocks, shard=shard,
            stage=None if stages is None else stages[i], plan=plan)
        x1, aux = ret[:2]
        if stages is not None:
            plan = ret[2]
        auxs.append(aux)
    logits = serve_logits(params, x1, cfg, shard)
    return logits[:, 0], pages, slot_state, aggregate_decode_aux(auxs)
