"""HuBERT X-Large (arXiv:2106.07447; unverified). Encoder-only audio.

48L d_model=1280 16H (MHA kv=16) head_dim=80 d_ff=5120, GELU MLP,
non-causal attention, vocab=504 (the cluster targets). The frontend is a
stub: batches carry precomputed 512-d frame features (conv-feature
stand-ins), projected by ``in_proj``. No decode phase, so no gate:
SeerAttention-R does not apply; the model trains by pretraining only.
"""
from repro_torch.config import GateConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert_xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    activation="gelu",
    n_audio_features=512,
    gate=GateConfig(enabled=False),
)
