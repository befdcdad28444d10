"""Token sampling for the decode engine, PyTorch port.

``SamplingParams`` is a frozen dataclass, as in the JAX package, so it
rides inside the frozen ``DecodeOptions``. Filter order follows the
reference (the vLLM/HF convention): temperature scale -> top-k cut ->
top-p (nucleus) cut -> categorical draw. ``temperature == 0`` is greedy
argmax, the lower token id winning ties (``torch.argmax`` returns the
first maximal index, as ``jnp.argmax`` does), and consumes no randomness.

Randomness comes from an explicit ``torch.Generator`` the caller owns, so
a fixed seed reproduces a trajectory. JAX's key chain cannot be shared,
so the draw is split out: ``categorical(logits, uniforms)`` is a plain
function of the filtered logits and the uniforms (Gumbel-max, as
``jax.random.categorical`` computes it), and a test can feed it JAX's
uniforms.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = float("-inf")
TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature=0 -> greedy; top_k=0 and top_p=1 disable those filters."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def _desc_rank(logits: torch.Tensor) -> torch.Tensor:
    """Rank of every token in descending-logit order, ties broken by the
    lower token id (two stable argsorts), so the filters keep an EXACT
    count instead of a value cutoff that would leak tied tokens."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    return torch.where(_desc_rank(logits) < k, logits, NEG_INF)


def _filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    with cumulative mass > p (the argmax token always survives); exactly
    the nucleus COUNT per row, so tokens tied with the last kept logit do
    not leak in."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a token is kept while the mass BEFORE it is still < p
    n_keep = torch.sum((cum - probs) < p, dim=-1, keepdim=True)    # >= 1
    return torch.where(_desc_rank(logits) < n_keep, logits, NEG_INF)


def filtered_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """fp32 logits scaled by the temperature, then cut by top-k and top-p:
    what the categorical draw ranks (stochastic params only)."""
    lg = logits.to(torch.float32) / params.temperature
    if params.top_k:
        lg = _filter_top_k(lg, min(params.top_k, lg.shape[-1]))
    if params.top_p < 1.0:
        lg = _filter_top_p(lg, params.top_p)
    return lg


def categorical(logits: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw: argmax(logits - log(-log(u))) along the last axis,
    with ``uniforms`` in [tiny, 1) of the logits' shape -> int32 ids."""
    gumbel = -torch.log(-torch.log(uniforms.to(logits.device, torch.float32)))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [..., V] -> token ids [...] int32 on the logits' device.
    ``generator`` (any device) is required unless greedy."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    lg = filtered_logits(logits, params)
    # fp32 uniforms in [tiny, 1), drawn on the generator's device
    u = torch.rand(lg.shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return categorical(lg, torch.clamp_min(u, TINY))
