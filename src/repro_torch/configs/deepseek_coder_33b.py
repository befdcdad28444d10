"""DeepSeek-Coder 33B (arXiv:2401.14196; hf). llama-arch.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256, head_dim=128.
"""
from repro_torch.config import GateConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek_coder_33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
