"""Gemma 2B (arXiv:2403.08295; hf).

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU,
head_dim=256, tied embeddings. Extreme-vocab + MQA cell: the gate's
group reduce is 8*256 -> d_gate with a single shared gate head.
"""
from repro_torch.config import GateConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma_2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
