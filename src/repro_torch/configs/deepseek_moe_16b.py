"""DeepSeekMoE 16B (arXiv:2401.06066; hf).

28L d_model=2048 16H (MHA: kv=16) expert d_ff=1408 vocab=102400,
2 shared + 64 routed experts, top-6 fine-grained routing.
GQA group g=1 -> the gate's Q reduction is a per-head linear.
"""
from repro_torch.config import GateConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek_moe_16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2,
                  expert_d_ff=1408, capacity_factor=1.25),
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
