"""Token sampling for the decode engine.

``SamplingParams`` is a frozen dataclass, as in the JAX package, so it
rides inside the frozen ``DecodeOptions``. This slice ports greedy
decoding only: ``temperature == 0`` is argmax, the lower token id winning
ties (``torch.argmax`` returns the first maximal index, as ``jnp.argmax``
does). Temperature/top-k/top-p sampling arrives with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


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


def sample(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """logits [..., V] -> token ids [...] int32."""
    if not params.greedy:
        raise NotImplementedError(
            "stochastic sampling is not ported yet; use greedy "
            "(SamplingParams(temperature=0))")
    return torch.argmax(logits, dim=-1).to(torch.int32)
