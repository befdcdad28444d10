"""Architecture registry of the port: one module per ported architecture.

``get(arch_id)`` returns the full-size ModelConfig. All ten configs of
the JAX package are ported: the four dense configs (qwen3_0_6b,
gemma_2b, granite_20b, deepseek_coder_33b), the two MoE configs
(deepseek_moe_16b, kimi_k2_1t_a32b), the vision backbone
(llama_3_2_vision_11b), the two recurrent configs (falcon_mamba_7b, the
Mamba1 LM, and zamba2_1_2b, the Mamba2 hybrid) and the audio encoder
(hubert_xlarge, pretraining only).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = [
    "qwen3_0_6b",
    "gemma_2b",
    "granite_20b",
    "deepseek_coder_33b",
    "deepseek_moe_16b",
    "kimi_k2_1t_a32b",
    "llama_3_2_vision_11b",
    "falcon_mamba_7b",
    "zamba2_1_2b",
    "hubert_xlarge",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def canon(arch_id: str) -> str:
    return _ALIASES.get(arch_id, arch_id)


def get(arch_id: str) -> ModelConfig:
    name = canon(arch_id)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown or unported arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def shapes_for(arch_id: str) -> List[ShapeConfig]:
    """The dry-run's input shapes of an architecture (the JAX package's
    rule): training and prefill for every config, decode for a decoder,
    ``long_500k`` only where decode is sub-quadratic (the SSM and hybrid
    families natively, an attention model through the gate's sparse
    decode; a full-attention decode with the gate disabled does not
    qualify)."""
    cfg = get(arch_id)
    names = ["train_4k", "prefill_32k"]
    if cfg.is_decoder:
        names += ["decode_32k", "long_500k"]
    if cfg.is_decoder and cfg.has_attention and not cfg.gate.enabled:
        names.remove("long_500k")
    return [SHAPES[n] for n in names]
