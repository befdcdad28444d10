"""Qwen3 0.6B (hf:Qwen/Qwen3-8B family; hf). qk_norm, GQA, head_dim=128.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, tied embeddings.
The paper's own model family; the main path of the port's first slice.
"""
from repro_torch.config import GateConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3_0_6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
