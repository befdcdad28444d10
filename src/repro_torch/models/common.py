"""Shared model building blocks: norms, RoPE, linears, attention, MLPs.

PyTorch port of the JAX package's ``models/common.py``. Parameters are
plain dicts of tensors, as in the reference; initialisers take an explicit
``torch.Generator`` and draw on its device. Every function keeps the
reference's layouts (``[B, L, H, Dh]`` activations, head-major decode
caches ``[B, Hkv, S, Dh]``) and its numerics: fp32 inside the norm,
RoPE, softmax and attention arithmetic, and a cast back to the working
dtype at the end.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.sharding import (copy_to_model, reduce_from_model,
                                              vocab_parallel_nll)

Params = Dict[str, Any]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype="bfloat16", scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = _randn(gen, (in_dim, out_dim)) * scale
    return {"w": w.to(torch_dtype(dtype))}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the working dtype. For bf16 the matrix unit accumulates
    in fp32 and rounds the result back, as XLA does for the reference."""
    return x @ p["w"]


def init_rmsnorm(d: int, dtype: str, device: torch.device | str) -> Params:
    return {"scale": torch.ones((d,), dtype=torch_dtype(dtype), device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6, shard=None) -> torch.Tensor:
    """RMSNorm over the last axis; under a ``shard`` that axis is split
    over the ranks (each holds the same share of it and of ``scale``) and
    the mean square is the mean over ranks of each rank's."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    if shard is not None:
        var = copy_to_model(reduce_from_model(var, shard), shard) / shard.world
    out = x * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(dt)


def remat(fn: Callable, cfg) -> Callable:
    """``fn`` under the config's rematerialisation, the reference's
    ``jax.checkpoint`` of a layer body: ``"nothing_saveable"`` and
    ``"dots_saveable"`` map to ``torch.utils.checkpoint`` (non-reentrant;
    the layer's activations are recomputed in the backward, none saved),
    ``"none"`` and ``"full"`` (everything saved) to ``fn`` itself. Values
    are the same either way; only memory and time differ. Under a shard
    the backward re-runs the layer's collectives, in the same order on
    every rank (the autograd graph is the same on each)."""
    if cfg.remat not in ("nothing_saveable", "dots_saveable"):
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return run


# ---------------------------------------------------------------------------
# RoPE (split-halves convention: the first and second halves of the head
# dim form the rotated pairs, not interleaved neighbours)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor | int,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)                 # [hd/2]
    positions = torch.as_tensor(positions, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs          # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                            # [..., seq, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / MLP
# ---------------------------------------------------------------------------

def init_glu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                 dtype="bfloat16") -> Params:
    return {
        "wi_gate": init_linear(gen, d_model, d_ff, dtype),
        "wi_up": init_linear(gen, d_model, d_ff, dtype),
        "wo": init_linear(gen, d_ff, d_model, dtype),
    }


def glu_mlp(p: Params, x: torch.Tensor, activation: str = "swiglu",
            shard=None) -> torch.Tensor:
    """The (gated) MLP; under a ``shard`` the rank holds a block of the
    hidden units (``wi_*`` columns, ``wo`` rows) and the output is the sum
    over ranks."""
    x = copy_to_model(x, shard)
    g = linear(p["wi_gate"], x)
    if activation == "swiglu":
        g = F.silu(g)
    elif activation == "geglu":
        g = F.gelu(g, approximate="tanh")
    elif activation == "gelu":
        return reduce_from_model(linear(p["wo"], F.gelu(g, approximate="tanh")), shard)
    else:
        raise ValueError(activation)
    return reduce_from_model(linear(p["wo"], g * linear(p["wi_up"], x)), shard)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype="bfloat16") -> Params:
    if activation in ("swiglu", "geglu"):
        return init_glu_mlp(gen, d_model, d_ff, dtype)
    return {"wi_gate": init_linear(gen, d_model, d_ff, dtype),
            "wo": init_linear(gen, d_ff, d_model, dtype)}


def mlp(p: Params, x: torch.Tensor, activation: str, shard=None) -> torch.Tensor:
    return glu_mlp(p, x, activation, shard)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*g, D] by repeating each kv head g times."""
    if group == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, group, d).reshape(b, s, h * group, d)


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(s / cap) * cap if cap > 0 else s


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      q_chunk: int = 1024,
                      logit_softcap: float = 0.0,
                      gt_block_size: int = 0,
                      segment_ids: Optional[torch.Tensor] = None):
    """Memory-bounded attention forward, plain matmul + softmax in fp32.

    q: [B, Lq, H, D]; k, v: [B, Lk, Hkv, D] (GQA expanded internally)
    -> o [B, Lq, H, D] in q's dtype. A Python loop over q-chunks bounds the
    materialised scores to [B, H, q_chunk, Lk]. With the default positions
    and ``causal``, a chunk reads only the keys up to its last query: the
    keys it skips are the ones the mask would zero (exp(NEG_INF - m) == 0),
    so the result is the reference's up to summation order.

    Differentiable: where autograd records (grad enabled and q, k or v
    requiring grad) the masking and the softmax run out of place, the
    reference's pretrain path (``jax.grad`` through its jnp attention);
    otherwise in place on the score chunk, with the same values and no
    extra chunk-sized buffers.

    ``segment_ids`` [B, L] (packed documents, Lq == Lk) masks every score
    across documents. With ``gt_block_size`` > 0 the call returns
    ``(o, blockmax)``: blockmax [B, H, Lq, Lk // gt_block_size] fp32 is the
    max masked score of each (row, key block), exactly NEG_INF where the
    whole block is masked, including the blocks the causal shortcut never
    reads (the distillation target of the reference's
    ``chunked_attention(gt_block_size=)``). Otherwise it returns o alone.
    """
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    default_pos = q_positions is None and kv_positions is None
    if q_positions is None:
        q_positions = torch.arange(lq, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(lk, device=q.device)
    scale = 1.0 / math.sqrt(d)

    qt = q.transpose(1, 2)                                   # [B, H, Lq, D]
    kt = repeat_kv(k, group).transpose(1, 2).to(torch.float32)   # [B, H, Lk, D]
    vt = repeat_kv(v, group).transpose(1, 2).to(torch.float32)

    gbs = gt_block_size
    nb = lk // gbs if gbs else 0
    bm = (torch.full((b, h, lq, nb), NEG_INF, dtype=torch.float32, device=q.device)
          if gbs else None)
    q_chunk = max(1, min(q_chunk, lq))
    inplace = not (torch.is_grad_enabled()
                   and (q.requires_grad or k.requires_grad or v.requires_grad))
    out = torch.empty((b, h, lq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, lq, q_chunk):
        c1 = min(c0 + q_chunk, lq)
        kend = min(c1, lk) if (causal and default_pos) else lk
        qp = q_positions[c0:c1]
        s = torch.matmul(qt[:, :, c0:c1].to(torch.float32),
                         kt[:, :, :kend].transpose(-1, -2)) * scale
        s = _softcap(s, logit_softcap)
        if causal:
            mask = qp[:, None] >= kv_positions[None, :kend]
            s = s.masked_fill_(~mask, NEG_INF) if inplace else s.masked_fill(~mask, NEG_INF)
        if segment_ids is not None:
            smask = (segment_ids[:, c0:c1, None] == segment_ids[:, None, :kend])[:, None]
            s = s.masked_fill_(~smask, NEG_INF) if inplace else s.masked_fill(~smask, NEG_INF)
        if gbs:
            # the blocks the chunk reads; the tail of a partial last block
            # lies past kend, masked for every row of the chunk
            nbk = -(-kend // gbs)
            sp = F.pad(s, (0, nbk * gbs - kend), value=NEG_INF)
            bm[:, :, c0:c1, :nbk] = torch.amax(
                sp.reshape(b, h, c1 - c0, nbk, gbs), dim=-1)
        m = torch.amax(s, dim=-1, keepdim=True)
        p = s.sub_(m).exp_() if inplace else torch.exp(s - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        out[:, :, c0:c1] = torch.matmul(p, vt[:, :, :kend]) / torch.clamp_min(l, 1e-30)
    o = out.transpose(1, 2).to(q.dtype)
    return (o, bm) if gbs else o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """Single-token dense decode attention.

    q: [B, 1, H, D]; caches: [B, Hkv, S, D] HEAD-MAJOR (consumed directly,
    no transpose); kv_len: [B] valid lengths.
    """
    b, _, h, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    qg = q[:, 0].reshape(b, hkv, group, d)                       # [B,Hkv,g,D]
    s = torch.einsum("bhgd,bhsd->bhgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) / math.sqrt(d)
    s = _softcap(s, logit_softcap)
    valid = torch.arange(s_max, device=q.device)[None, :] < kv_len[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(b, 1, h, d).to(q.dtype)


def masked_sums(values: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(values * mask), sum(mask)): the numerator and denominator of a
    masked mean, which a data axis sums over its replicas before the
    division."""
    mask = mask.to(values.dtype)
    return torch.sum(values * mask), torch.sum(mask)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, shard=None,
                       data=None) -> torch.Tensor:
    """logits [B, L, V] -> the mean fp32 negative log-likelihood of
    ``labels`` [B, L], over the positions where ``mask`` [B, L] (optional)
    is nonzero: sum(nll * mask) / max(sum(mask), 1). Under a ``shard`` the
    logits are the rank's vocabulary block [B, L, V / world]
    (``sharding.vocab_parallel_nll``). Over a ``data`` shard the rows are
    the replica's share of the global batch and the mean is the global
    one: the numerator summed over the data group forward (its gradient
    each replica's own, ``reduce_from_model``), the denominator summed;
    without a mask the replicas' equal-sized means averaged."""
    if shard is not None:
        nll = vocab_parallel_nll(logits, labels, shard)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        num, den = masked_sums(nll, mask)
        if data is not None:
            num, den = reduce_from_model(num, data), data.all_sum(den)
        return num / torch.clamp_min(den, 1.0)
    mean = torch.mean(nll)
    return mean if data is None else reduce_from_model(mean, data) / data.world
