"""Kimi K2 — trillion-param MoE (arXiv:2501.kimi2; paper-table, unverified).

61L d_model=7168 64H (GQA kv=8) routed-expert d_ff=2048 vocab=163840,
MoE 384 routed experts top-8 + 1 shared expert. head_dim pinned to 128
(64*128 projection width, the common large-model choice).
"""
from repro_torch.config import GateConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi_k2_1t_a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, n_shared_experts=1,
                  expert_d_ff=2048, capacity_factor=1.25),
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
