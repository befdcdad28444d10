"""Family dispatch: a uniform functional API over the ported model families.

The transformer's families are ported: dense, moe and vlm (the vision
backbone) share its ``ModelApi``; the recurrent families (ssm, hybrid) and
the audio encoder arrive with their slices.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serve.slotstate import CacheView


class ModelApi(NamedTuple):
    """Decode-time behavior is carried by one frozen
    ``core.policy.DecodeOptions``; the decode steps return a
    measured-selection ``aux`` dict for serving telemetry."""
    init_params: Callable          # (generator, cfg) -> params
    forward: Callable              # (params, batch, cfg, *, mode, shard) -> (loss, metrics);
    #                                 mode="distill" only (gate KL, base frozen)
    init_decode_state: Callable    # (cfg, batch_size, max_len, dtype, options, *, device)
    #                                 -> state
    prefill: Callable              # (params, batch, cfg, max_len, options) -> (logits, state);
    #                                 batch may carry "lengths" (right-padded rows)
    decode_step: Callable          # (params, state, token, cfg, *, options, shard)
    #                                 -> (logits, state, aux)
    # continuous-batching paged decode (serve.paging):
    # (params, pages, slot_state, token, page_table, cur_len, active, cfg,
    #  *, options, budget_blocks, shard) -> (logits, pages, slot_state, aux)
    decode_step_paged: Any = None
    # how many layer slices the page pools carry (cfg) -> int
    paged_attn_layers: Callable = None
    # (cfg, n_slots) -> per-slot recurrent state, None for pages-only families
    init_slot_state: Any = None
    # (prefill state) -> CacheView: what paged admission scatters into pools
    state_view: Any = None


def _tf_view(st) -> CacheView:
    return CacheView(st.k_cache, st.v_cache, st.kg_cache, st.meta_kmin, st.meta_kmax,
                     None)


_TF_API = ModelApi(tf.init_lm, tf.lm_forward, tf.init_decode_state, tf.lm_prefill,
                   tf.lm_decode_step,
                   decode_step_paged=tf.lm_decode_step_paged,
                   paged_attn_layers=tf.n_self_layers,
                   init_slot_state=None,
                   state_view=_tf_view)


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm"):
        return _TF_API
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the recurrent families (ROADMAP Queue A item 9, "
            "recurrent half) are not ported")
    if cfg.family == "audio":
        raise NotImplementedError(
            "family 'audio': the audio encoder (ROADMAP Queue A item 10) is not ported")
    raise ValueError(f"unknown family {cfg.family}")
