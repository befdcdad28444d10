"""Zamba2 1.2B (arXiv:2411.15242; hf). Mamba2 backbone + shared attn block.

38 mamba2 layers, d_model=2048, ssm_state=64; one weight-shared attention
block (32H MHA, d_ff=8192 MLP) invoked every 6 SSM layers. The
SeerAttention-R gate lives on the shared attention block.
"""
from repro_torch.config import GateConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2_1_2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    hybrid_period=6,
    ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, version=2,
                  chunk_size=256),
    gate=GateConfig(enabled=True, block_size=64, d_gate=64,
                    token_budget=4096),
)
