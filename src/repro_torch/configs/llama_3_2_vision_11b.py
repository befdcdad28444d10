"""Llama 3.2 Vision 11B backbone (hf:meta-llama/Llama-3.2-11B-Vision;
unverified). 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256;
every 5th layer is a cross-attention layer into stubbed image patch
embeddings (1601 tokens; the vision frontend is not modelled: batches
carry random embeddings). Self-attn layers carry the gate; cross-attn
stays dense.
"""
from repro_torch.config import GateConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama_3_2_vision_11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    n_image_tokens=1601,
    gate=GateConfig(enabled=True, block_size=64, d_gate=128,
                    token_budget=4096),
)
