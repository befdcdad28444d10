"""Family dispatch: a uniform functional API over the ported model families.

The transformer's families (dense, moe, vlm, the vision backbone, and
audio, the encoder, which has a forward and no decode: its prefill and
decode steps raise) share its ``ModelApi``; the recurrent families have
their own: ssm (the Mamba1 LM, pages-free: its whole decode state rides
in the per-slot recurrent state) and hybrid (Mamba2 with a shared
attention block, whose units page their K/V).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import hybrid, ssm_lm
from repro_torch.models import transformer as tf
from repro_torch.serve.slotstate import CacheView, SlotState


class ModelApi(NamedTuple):
    """Decode-time behavior is carried by one frozen
    ``core.policy.DecodeOptions``; the decode steps return a
    measured-selection ``aux`` dict for serving telemetry."""
    init_params: Callable          # (generator, cfg) -> params
    forward: Callable              # (params, batch, cfg, *, mode, shard, data)
    #                                 -> (loss, metrics); mode="pretrain" (CE) or "distill"
    #                                 (gate KL, base frozen); data: the data axis's Shard
    #                                 (batch a replica's rows, the loss the global one)
    init_decode_state: Callable    # (cfg, batch_size, max_len, dtype, options, *, device)
    #                                 -> state
    prefill: Callable              # (params, batch, cfg, max_len, options, shard, data)
    #                                 -> (logits, state); batch may carry "lengths"
    #                                 (right-padded rows)
    decode_step: Callable          # (params, state, token, cfg, *, options, shard, data)
    #                                 -> (logits, state, aux)
    # (prefill's and decode_step's ``data``: the rows are a data replica's
    # share; a MoE block routes as the whole batch would, and the other
    # families' rows are independent, so they read nothing of it)
    # continuous-batching paged decode (serve.paging):
    # (params, pages, slot_state, token, page_table, cur_len, active, cfg,
    #  *, options, budget_blocks, shard) -> (logits, pages, slot_state, aux)
    decode_step_paged: Any = None
    # how many layer slices the page pools carry (cfg) -> int
    paged_attn_layers: Callable = None
    # (cfg, n_slots, *, device, shard) -> per-slot recurrent state
    # (serve.slotstate.SlotState, at the shard's channels or heads), None
    # for pages-only families
    init_slot_state: Any = None
    # (prefill state) -> CacheView: what paged admission scatters into pools
    state_view: Any = None


def _tf_view(st) -> CacheView:
    return CacheView(st.k_cache, st.v_cache, st.kg_cache, st.meta_kmin, st.meta_kmax,
                     None)


def _hybrid_view(st) -> CacheView:
    return CacheView(st.k_cache, st.v_cache, st.kg_cache, None, None,
                     SlotState(conv=st.conv[:, 0], h=st.h[:, 0]))


def _ssm_view(st) -> CacheView:
    return CacheView(None, None, None, None, None,
                     SlotState(conv=st.conv[:, 0], h=st.h[:, 0]))


_TF_API = ModelApi(tf.init_lm, tf.lm_forward, tf.init_decode_state, tf.lm_prefill,
                   tf.lm_decode_step,
                   decode_step_paged=tf.lm_decode_step_paged,
                   paged_attn_layers=tf.n_self_layers,
                   init_slot_state=None,
                   state_view=_tf_view)
_SSM_API = ModelApi(ssm_lm.init_lm, ssm_lm.lm_forward, ssm_lm.init_decode_state,
                    ssm_lm.lm_prefill, ssm_lm.lm_decode_step,
                    decode_step_paged=ssm_lm.lm_decode_step_paged,
                    paged_attn_layers=lambda cfg: 0,
                    init_slot_state=ssm_lm.init_slot_state,
                    state_view=_ssm_view)
_HYBRID_API = ModelApi(hybrid.init_lm, hybrid.lm_forward, hybrid.init_decode_state,
                       hybrid.lm_prefill, hybrid.lm_decode_step,
                       decode_step_paged=hybrid.lm_decode_step_paged,
                       paged_attn_layers=lambda cfg: hybrid._plan(cfg)[0],
                       init_slot_state=hybrid.init_slot_state,
                       state_view=_hybrid_view)


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return _TF_API
    if cfg.family == "ssm":
        return _SSM_API
    if cfg.family == "hybrid":
        return _HYBRID_API
    raise ValueError(f"unknown family {cfg.family}")
