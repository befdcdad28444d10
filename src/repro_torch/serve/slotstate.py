"""The family-agnostic view of a prefill state for paged admission.

Port of ``CacheView`` from the JAX package's ``serve/slotstate.py``: which
fields of a family's prefill state ``paging.scatter_prefill`` copies into
the page pools, and which row seeds the request's slot of the per-slot
recurrent state. The dense transformer is pages-only (``slot`` is None);
``SlotState`` and its read/write helpers arrive with the recurrent
families.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


class CacheView(NamedTuple):
    """Head-major ``[L, 1, ...]`` caches of a one-request prefill state
    (all None for a pages-free family; the metadata caches None unless the
    policy reads them), plus the request's recurrent rows (None for
    pages-only families)."""
    k_cache: Optional[torch.Tensor]
    v_cache: Optional[torch.Tensor]
    kg_cache: Optional[torch.Tensor]
    meta_kmin: Optional[torch.Tensor]
    meta_kmax: Optional[torch.Tensor]
    slot: Optional[Any]
