"""Attention layer-core shared by the decode paths (port slice).

The QKV projection, the policy gate, the decode-aux telemetry and the
paged per-layer decode body (``attention_decode_paged`` ->
``block_decode_paged``) of the JAX package's ``models/attn_core.py``:
the unstaged and the staged (SelectionSchedule) branch with per-request
budget caps, unsharded or over a rank's KV heads, over fp or int8 page
pools, with the metadata pools of Quest, the
block's feed-forward (dense or MoE, ``ffn``), and the
RaaS eviction telemetry (``DecodeOptions.track_evictions``: the
touched-pages mask and the clamped K/V table).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kcache as kc
from repro_torch.core import sparsity as sp
from repro_torch.distributed.sharding import copy_to_model, part, reduce_from_model
from repro_torch.core.policy import (STAGE_DENSE, STAGE_SELECT, DecodeOptions,
                                     SelectionInputs)
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (apply_rope, decode_attention, linear,
                                       mlp, rms_norm)
from repro_torch.serve import paging as pg

Params = Dict[str, Any]
LayerAux = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, shard=None):
    """q [B, L, H, Dh], k, v [B, L, Hkv, Dh] of the heads whose columns
    ``p`` holds (all of them, or a rank's: a sharded engine's block, or
    training's, whose ``shard`` also sums the replicated
    ``q_norm``/``k_norm`` gradients over the ranks)."""
    b, l, _ = x.shape
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, l, -1, dh)
    k = linear(p["wk"], x).reshape(b, l, -1, dh)
    v = linear(p["wv"], x).reshape(b, l, -1, dh)
    if cfg.qk_norm:
        q = rms_norm({"scale": copy_to_model(p["q_norm"]["scale"], shard)}, q, cfg.norm_eps)
        k = rms_norm({"scale": copy_to_model(p["k_norm"]["scale"], shard)}, k, cfg.norm_eps)
    return q, k, v


def ffn(p: Params, h2: torch.Tensor, cfg: ModelConfig, shard=None, *,
        decode: bool = False, data=None):
    """A block's feed-forward over h2 [..., d]: (y, the MoE router loss or
    None). A ``"moe"`` block routes all of h2's rows in one call, so at
    decode every row of the step (each slot, active or not) competes for
    the experts' capacity, as in the reference. Under a ``shard``
    (training's, or a sharded engine's at ``decode``: its prefill and
    decode bodies) a dense MLP and a MoE block's shared experts split
    their hidden units with one sum (``distributed.sharding``), and the
    routed experts are expert-parallel: summed in training, gathered
    exactly at ``decode`` (``moe.moe_mlp(gather=True)``). Rows split over
    a ``data`` shard keep the MoE routing of the global rows, their
    capacity's slots split over data, or take the reference's
    ``moe_mlp_sharded`` bodies under ``dispatch="shard_map"``; under an
    EP-major ``shard`` (each rank its own rows) the routed experts
    exchange their rows over the model group by all-to-all."""
    if "moe" in p:
        y, aux = moe_mod.moe_mlp(p["moe"], h2.reshape(-1, h2.shape[-1]), cfg.moe,
                                 cfg.activation, shard=shard, gather=decode, data=data)
        return y.reshape(h2.shape), aux
    return mlp(p["mlp"], h2, cfg.activation, part(shard, cfg.d_ff)), None


def rank_gate(gate, shard):
    """The whole gate's ``wq``/``wk`` [Hkv, ., Dg] at a sharded engine's
    rank's KV heads (the gate itself without a shard, None without a
    gate)."""
    if gate is None or shard is None:
        return gate
    return {name: shard.head_slice(w, 0) for name, w in gate.items()}


def _policy_active(policy, p: Params) -> bool:
    """Sparse selection runs unless the policy is dense or requires a gate
    the layer doesn't carry (then dense decode)."""
    return (not policy.dense) and (("gate" in p) or not policy.needs_gate)


def _selection_aux(idx: torch.Tensor, n_valid: torch.Tensor, nb: int) -> LayerAux:
    """Measured per-layer selection telemetry from the ACTUAL selected
    block ids: (sparsity scalar, per-row sparsity [B], mean selected
    blocks [B], visible blocks [B])."""
    b, hkv, _ = idx.shape
    cnt = torch.zeros((b, hkv, nb), dtype=torch.int32, device=idx.device)
    cnt.scatter_add_(2, torch.clamp_min(idx, 0).to(torch.int64),
                     (idx >= 0).to(torch.int32))
    sel_mask = cnt > 0
    rho = sp.sparsity_ratio(sel_mask, n_valid)
    sel_counts = torch.sum(sel_mask, dim=-1).to(torch.float32)     # [B,Hkv]
    tot = torch.clamp_min(n_valid.to(torch.float32), 1.0)
    rho_rows = 1.0 - torch.mean(sel_counts / tot[:, None], dim=1)
    return rho, rho_rows, torch.mean(sel_counts, dim=1), n_valid.to(torch.float32)


def _dense_aux(new_len: torch.Tensor, block_size: int) -> LayerAux:
    """Dense decode reads every visible block: sparsity 0 by definition."""
    nv = kc.visible_blocks(torch.clamp_min(new_len, 1), block_size).to(torch.float32)
    return (torch.zeros((), dtype=torch.float32, device=nv.device),
            torch.zeros_like(nv), nv, nv)


def _zero_layer_aux(batch: int, device) -> LayerAux:
    """Per-layer aux when telemetry is off (measure_sparsity=False)."""
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return torch.zeros((), dtype=torch.float32, device=device), z, z, z


def _touched_pages(idx: torch.Tensor, nb: int) -> torch.Tensor:
    """Selected block ids [B, Hkv, k] -> touched mask [B, nb] bool: which
    logical blocks ANY head read this layer. The RaaS eviction signal
    (``DecodeOptions.track_evictions``): the serving engine intersects it
    with its evicted-page mask to detect a selected-but-evicted block
    (fault -> restore -> replay) and feeds it to the ``BlockHeat`` recency
    model."""
    b = idx.shape[0]
    cnt = torch.zeros((b, nb), dtype=torch.int32, device=idx.device)
    cnt.scatter_add_(1, torch.clamp_min(idx, 0).reshape(b, -1).to(torch.int64),
                     (idx >= 0).reshape(b, -1).to(torch.int32))
    return cnt > 0


def _dense_touched(new_len: torch.Tensor, block_size: int, nb: int) -> torch.Tensor:
    """Dense decode touches every visible block."""
    vis = kc.visible_blocks(torch.clamp_min(new_len, 1), block_size)   # [B]
    return torch.arange(nb, device=new_len.device)[None, :] < vis[:, None]


def aggregate_decode_aux(auxs: Sequence[LayerAux]) -> Dict[str, torch.Tensor]:
    """Per-layer (rho, rho_rows [B], sel [B], vis [B]) tuples -> the
    decode-step aux dict, averaged over layers. A fifth element (the
    touched-pages mask [B, nb] under ``track_evictions``) ORs over layers:
    a block is touched if ANY layer's selection read it."""
    rho, rho_rows, sel, vis = (torch.stack(list(x)) for x in list(zip(*auxs))[:4])
    out = {"sparsity": torch.mean(rho),
           "sparsity_rows": torch.mean(rho_rows, dim=0),
           "sel_blocks": torch.mean(sel, dim=0),
           "vis_blocks": torch.mean(vis, dim=0)}
    if len(auxs[0]) > 4:
        out["touched_pages"] = torch.stack([a[4] for a in auxs]).any(dim=0)
    return out


def zero_decode_aux(batch: int, device) -> Dict[str, torch.Tensor]:
    """The decode-step aux of an attention-free path (the Mamba1 LM):
    nothing is selected."""
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return {"sparsity": torch.zeros((), dtype=torch.float32, device=device),
            "sparsity_rows": z, "sel_blocks": z, "vis_blocks": z}


def _cap_budget(idx: torch.Tensor, budget_blocks) -> torch.Tensor:
    """Per-slot runtime caps of per-request budgets: slot positions at or
    past ``budget_blocks[slot]`` become -1 (forced blocks rank first, so a
    cap at or above the forced count keeps them; re-masking a carried,
    already-capped plan changes nothing)."""
    if budget_blocks is None:
        return idx
    keep = (torch.arange(idx.shape[-1], device=idx.device)[None, None, :]
            < budget_blocks.to(idx.device)[:, None, None])
    return torch.where(keep, idx, -1)


def attention_decode_paged(p: Params, x1: torch.Tensor, cfg: ModelConfig, *,
                           k_pages, v_pages, kg_pages, page_table, cur_len,
                           active, options: DecodeOptions, budget_blocks=None,
                           kmin_pages=None, kmax_pages=None, k_scale=None,
                           v_scale=None, shard=None, stage=None, plan=None):
    """One token over paged KV. x1 [S,1,d]; pools for ONE layer head-major
    [P, Hkv, ps, Dh] (updated in place); page_table [S, npt] int32;
    cur_len/active [S]. Returns (out [S,1,d], selection aux), plus the
    next layer's plan when ``stage`` is given.

    The new K/V are appended to each slot's trailing page; the Kg row and
    the min/max metadata rows of a just-completed page are finalized, each
    for the policy that reads it; inactive rows write to the null page and
    do not advance. The policy then selects (the gate scores ``kg_pages``
    through the page table; Quest reads the metadata pools and the
    trailing page), ``budget_blocks`` [S] caps each slot's list at run
    time (``_cap_budget``), and the block-sparse decode reads only the
    selected physical pages, in ``options.split_k`` flash partials
    (``ops.paged_sparse_decode_splitk``; 1 = the single-pass kernel). A
    dense policy, or a layer without a gate, takes the dense fallback:
    ``gather_kv`` of the whole table, then dense decode attention.
    ``k_scale``/``v_scale`` [P, Hkv, 1] mark int8 pools: the append
    requantizes the trailing page, every later reader (the metadata
    finalize, Quest's trailing page, the kernel, the fallback) dequantizes
    with the scale rows the append wrote.

    ``stage``/``plan``: a plan-carrying SelectionSchedule, as in
    ``transformer.attention_decode``. Only a selecting layer finalizes its
    Kg and metadata rows; a reusing layer attends the carried plan, a
    dense one the whole table.

    With a ``shard`` (``distributed.sharding.Shard``) ``p`` holds the
    rank's block of the projections (``sharding.decode_params``: the
    ``wq``/``wk``/``wv`` columns and the ``wo`` rows of its KV heads; the
    gate whole, head-sliced here) and the pools and scale rows hold this
    rank's KV heads only: the step runs the same math on the rank's heads
    with no collective inside the attention, the rank's ``wo`` rows give
    its partial output, and one sum over the ranks the layer's. The
    selected ids are gathered over the ranks (one collective) only where
    the telemetry (``measure_sparsity``) or eviction's touched-pages mask
    reads them; the dense fallback gathers nothing. Attention is
    independent per KV head, so at world size 1 and ``split_k=1`` the
    step is bitwise the unsharded one; at more ranks the sum after ``wo``
    reorders the fp32 additions. A carried ``plan`` is then this rank's
    KV heads' ids [S, Hkv/world, k]: a reusing layer attends it with no
    collective, a dense layer passes it through, and ``budget_blocks``
    (replicated) caps the local lists. ``unify_heads`` max-reduces the
    gate scores over the rank's heads and then over ranks (one
    ``all_max`` a selecting layer), so every rank ranks the scores of
    the same max.

    ``options.track_evictions`` (RaaS page eviction): the page table may
    hold GHOST ids (>= the K/V pool size) for evicted blocks. They are
    valid rows of the extended Kg and metadata pools, so SELECTION reads
    them through the raw table unchanged; every K/V reader (the kernel,
    the dense fallback) reads through the table clamped into the pool, and
    the aux grows a fifth element, the touched-pages mask [S, npt] of this
    layer (from the ids gathered over ranks on the sharded body), by which
    the engine catches a selected evicted block and replays the step. The
    append and the trailing-page reads use the raw table: the trailing
    block is never evicted."""
    b = x1.shape[0]
    dh, g = cfg.resolved_head_dim, cfg.gqa_group
    ps = cfg.gate.block_size
    policy = options.policy
    sparse_on = _policy_active(policy, p)
    q, k, v = _qkv(p, x1, cfg)                             # the heads p holds
    pos = cur_len[:, None]                                 # [S,1]
    qr = apply_rope(q, pos, cfg.rope_theta)
    kr = apply_rope(k, pos, cfg.rope_theta)
    npt = page_table.shape[1]
    pt_kv = (torch.clamp_max(page_table, k_pages.shape[0] - 1)
             if options.track_evictions else page_table)
    gate = rank_gate(p.get("gate"), shard)
    hl = kr.shape[2]
    selecting = sparse_on and stage in (None, STAGE_SELECT)

    # the Kg page rows only advance for the policy that reads them, and
    # under a schedule only at a selecting layer
    gate_for_append = gate if policy.needs_gate and selecting else None
    if k_scale is not None:
        pg.append_token_paged_quant(k_pages, v_pages, kg_pages, k_scale, v_scale,
                                    kr[:, 0], v[:, 0], page_table, cur_len, active,
                                    gate_for_append, cfg.gate,
                                    rope_theta=cfg.rope_theta)
    else:
        pg.append_token_paged(k_pages, v_pages, kg_pages, kr[:, 0], v[:, 0],
                              page_table, cur_len, active, gate_for_append,
                              cfg.gate, rope_theta=cfg.rope_theta)
    # ... and the min/max rows only for the policy that reads THEM
    if policy.needs_meta and kmin_pages is not None and selecting:
        pg.append_meta_paged(kmin_pages, kmax_pages, k_pages, page_table, cur_len,
                             active, ps, k_scale=k_scale)
    new_len = cur_len + active.to(cur_len.dtype)

    idx = plan
    if selecting:
        inp = SelectionInputs(q_nope=q, qr=qr, pos=pos, new_len=new_len,
                              gate_params=gate, kg_pages=kg_pages,
                              k_pages=k_pages, page_table=page_table,
                              kmin_pages=kmin_pages, kmax_pages=kmax_pages,
                              k_scale_pages=k_scale, shard=shard)
        idx = policy.select(inp, cfg, max_selected=options.max_selected(cfg),
                            unify_heads=options.schedule.unify_heads)
    if sparse_on and stage != STAGE_DENSE:
        idx = _cap_budget(idx, budget_blocks)
        qgrp = qr[:, 0].reshape(b, hl, g, dh).contiguous()
        o = ops.paged_sparse_decode_splitk(qgrp, k_pages, v_pages, idx, pt_kv,
                                           new_len, block_size=ps,
                                           num_splits=options.split_k,
                                           k_scales=k_scale, v_scales=v_scale)
        sel = idx
        if shard is not None and (options.measure_sparsity or options.track_evictions):
            sel = shard.all_gather(idx, 1)
        aux = (_selection_aux(sel, kc.visible_blocks(
                   torch.clamp_min(new_len, 1), ps), npt)
               if options.measure_sparsity else _zero_layer_aux(b, x1.device))
        if options.track_evictions:
            aux = aux + (_touched_pages(sel, npt),)
    else:
        k_ct = pg.gather_kv(k_pages, pt_kv, k_scale)       # [S,Hkv,npt*ps,Dh]
        v_ct = pg.gather_kv(v_pages, pt_kv, v_scale)
        o = decode_attention(qr, k_ct, v_ct, new_len,
                             logit_softcap=cfg.attn_logit_softcap)
        aux = (_dense_aux(new_len, ps) if options.measure_sparsity
               else _zero_layer_aux(b, x1.device))
        if options.track_evictions:
            aux = aux + (_dense_touched(new_len, ps, npt),)
    out = reduce_from_model(linear(p["wo"], o.reshape(b, 1, hl * g * dh)), shard)
    # a dense (or ungated) layer passes the plan through untouched
    return (out, aux, idx) if stage is not None else (out, aux)


def block_decode_paged(p: Params, x1: torch.Tensor, cfg: ModelConfig,
                       layer_pages, page_table, cur_len, active, *,
                       options: DecodeOptions, budget_blocks=None, shard=None,
                       stage=None, plan=None):
    """One transformer block over paged KV; ``layer_pages`` is the layer's
    (k_pages, v_pages, kg_pages, kmin_pages, kmax_pages, k_scale, v_scale)
    in ``PagedPages`` order, None where a pool is not allocated (this
    rank's KV heads with a ``shard``, under which ``p`` is the rank's
    block: the attention on its heads, the feed-forward on its hidden
    units and experts, ``ffn(decode=True)``). Returns (x1, selection
    aux), plus the plan when ``stage`` is given."""
    k_pages, v_pages, kg_pages, kmin_pages, kmax_pages, k_scale, v_scale = layer_pages
    h = rms_norm(p["ln1"], x1, cfg.norm_eps)
    ret = attention_decode_paged(
        p["attn"], h, cfg, k_pages=k_pages, v_pages=v_pages,
        kg_pages=kg_pages, page_table=page_table, cur_len=cur_len,
        active=active, options=options, budget_blocks=budget_blocks,
        kmin_pages=kmin_pages, kmax_pages=kmax_pages, k_scale=k_scale,
        v_scale=v_scale, shard=shard, stage=stage, plan=plan)
    x1 = x1 + ret[0]
    h2 = rms_norm(p["ln2"], x1, cfg.norm_eps)
    return (x1 + ffn(p, h2, cfg, shard, decode=True)[0],) + ret[1:]
