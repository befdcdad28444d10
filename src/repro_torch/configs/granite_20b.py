"""Granite 20B code (arXiv:2405.04324; hf). llama-arch, MQA.

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
g=48 group reduce: 48*128 -> d_gate (largest gate fan-in of the pool).
"""
from repro_torch.config import GateConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
