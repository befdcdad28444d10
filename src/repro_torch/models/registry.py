"""Family dispatch: a uniform functional API over the ported model families.

Only the dense transformer is ported; the other families of the JAX
package's registry arrive with their slices.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tf


class ModelApi(NamedTuple):
    """Decode-time behavior is carried by one frozen
    ``core.policy.DecodeOptions``; ``decode_step`` returns a
    measured-selection ``aux`` dict for serving telemetry."""
    init_params: Callable          # (generator, cfg) -> params
    init_decode_state: Callable    # (cfg, batch_size, max_len, *, device) -> state
    prefill: Callable              # (params, batch, cfg, max_len, options) -> (logits, state)
    decode_step: Callable          # (params, state, token, cfg, *, options)
    #                                 -> (logits, state, aux)


_TF_API = ModelApi(tf.init_lm, tf.init_decode_state, tf.lm_prefill,
                   tf.lm_decode_step)


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "dense":
        return _TF_API
    raise ValueError(f"family {cfg.family!r} is not ported (dense only)")
