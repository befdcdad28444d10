"""Falcon-Mamba 7B (arXiv:2410.05355; unverified). Pure Mamba1, attn-free.

64L d_model=4096 (d_inner=8192), ssm_state=16, vocab=65024.
SeerAttention-R inapplicable (no attention): the family decodes with an
O(1) recurrent state and launches no attention kernel.
"""
from repro_torch.config import GateConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon_mamba_7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2, version=1,
                  chunk_size=256),
    gate=GateConfig(enabled=False),
)
