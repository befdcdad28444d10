"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``GateConfig``/``ModelConfig`` (with the
``MoEConfig``/``SSMConfig`` sub-configs that ``ModelConfig`` carries), of
the dry-run's input shapes ``ShapeConfig``/``SHAPES``, of
``OptimConfig``/``TrainConfig`` and of ``reduced``: the port imports
nothing of the JAX package, so it keeps its own copy. The fields, defaults and the ``reduced`` rule are identical,
so a config built on either side compares equal field by field (the
parity tests check that).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class GateConfig:
    """SeerAttention-R AttnGate configuration (the paper's core knob set)."""
    enabled: bool = True
    block_size: int = 64          # sparse attention block size b (paper default 64)
    d_gate: int = 128             # gate head dim d_gate
    # sparsification: exactly one of token_budget / threshold is active.
    method: str = "budget"        # "budget" | "threshold"
    token_budget: int = 4096      # translated to block budget = budget // block_size
    threshold: float = 4e-3       # paper Fig.9 sweeps 2e-3..6e-3
    rope_theta: float = 10000.0   # gate re-applies RoPE on pre-rope inputs
    use_rope: bool = True         # ablation: gate positional embedding on/off
    # hybrid dense layers (paper §5.2): first N layers stay dense.
    dense_first_layers: int = 0
    # always activate the trailing (possibly partial) block (paper §3.2)
    always_last_block: bool = True
    # always keep block 0 (a cheap safety used by the serving engine)
    always_first_block: bool = True
    # sequence-parallel decode: a shard may own at most
    # ceil(k/nshards * local_cap_factor) selected blocks (sharded slice)
    local_cap_factor: float = 2.0


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0          # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    dispatch: str = "gspmd"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # N
    conv_dim: int = 4
    expand: int = 2               # d_inner = expand * d_model
    version: int = 1              # 1 = mamba1 selective scan, 2 = mamba2 / SSD
    n_ssm_heads: int = 0          # mamba2 heads (0 -> derived)
    chunk_size: int = 256         # SSD / scan chunking along sequence


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # attention details
    qk_norm: bool = False
    causal: bool = True           # False for encoder-only
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0
    # activation: "swiglu" | "geglu" | "gelu"
    activation: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    gate: GateConfig = field(default_factory=GateConfig)
    hybrid_period: int = 0
    cross_attn_period: int = 0
    n_image_tokens: int = 0
    n_audio_features: int = 0
    # numerics / execution
    dtype: str = "bfloat16"       # activation/param compute dtype
    remat: str = "nothing_saveable"
    scan_layers: bool = True
    ep_major: bool = False
    use_pallas: bool = False
    q_chunk: int = 1024           # q-chunking for memory-bound attention fwd

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def gqa_group(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_decoder(self) -> bool:
        return self.family != "audio"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 1e-3              # paper: 1e-3 for gate distillation
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "cosine"      # paper: cosine decay
    warmup_steps: int = 40
    total_steps: int = 800        # paper: 800 steps
    # distributed-optimization knobs
    grad_compression: str = "none"   # none | bf16 | topk_ef
    topk_ratio: float = 0.05


@dataclass(frozen=True)
class TrainConfig:
    mode: str = "distill"         # "distill" (paper) | "pretrain"
    seq_len: int = 32768          # paper packs to 32k
    global_batch: int = 16        # paper global batch 16
    steps: int = 800
    seed: int = 0
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the JAX package's rule)."""
    kw: dict[str, Any] = dict(
        num_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        q_chunk=32,
        remat="none",
    )
    if cfg.family == "moe" and cfg.moe.n_experts:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=2,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            expert_d_ff=64, capacity_factor=2.0)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8, conv_dim=4, chunk_size=16)
    if cfg.hybrid_period:
        kw["hybrid_period"] = 2
    if cfg.cross_attn_period:
        kw["cross_attn_period"] = 2
        kw["n_image_tokens"] = 16
    if cfg.n_audio_features:
        kw["n_audio_features"] = 32
    if cfg.gate.enabled:
        kw["gate"] = dataclasses.replace(
            cfg.gate, block_size=8, d_gate=16, token_budget=32)
    kw.update(overrides)
    return cfg.replace(**kw)
