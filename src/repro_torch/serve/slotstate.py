"""Per-slot recurrent state and the family-agnostic view of a prefill
state for paged admission.

Port of the JAX package's ``serve/slotstate.py``. KV pages cover what
ATTENTION needs to resume a request, but the recurrent families (the
Mamba1 LM, the Mamba2 hybrid) carry O(1) state per layer, the depthwise
conv window and the SSM hidden state, outside the page pools.
``SlotState`` is that state batched over decode SLOTS (axis 1, as the
``[L, B, ...]`` contiguous layout), so the engine treats it as the page
pools' lifecycle twin: written at admission (from the prefill state),
captured at preemption into the ``SwapEntry``, restored bitwise at
resume, and carried through, never overwritten in place by, the decode
step: eviction replay re-runs a step from the SAME input state, and a
recurrent update is not idempotent, so the pre-step tensors must
survive the first attempt.

``CacheView`` says which fields of a family's prefill state
``paging.scatter_prefill`` copies into the page pools (None for a
pages-free family) and which rows seed the request's slot (None for the
pages-only transformer).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SlotState(NamedTuple):
    """Recurrent per-slot state, slot axis at position 1.

    conv: [L_rec, n_slots, K-1, d_conv]  depthwise-conv windows
    h:    [L_rec, n_slots, ...]          SSM hidden state (f32)
    """
    conv: torch.Tensor
    h: torch.Tensor


class CacheView(NamedTuple):
    """Head-major ``[L, 1, ...]`` caches of a one-request prefill state
    (all None for a pages-free family; the metadata caches None unless the
    policy reads them), plus the request's recurrent rows as a
    ``SlotState`` WITHOUT the slot axis (``[L_rec, ...]``; None for
    pages-only families)."""
    k_cache: Optional[torch.Tensor]
    v_cache: Optional[torch.Tensor]
    kg_cache: Optional[torch.Tensor]
    meta_kmin: Optional[torch.Tensor]
    meta_kmax: Optional[torch.Tensor]
    slot: Optional[SlotState]


def write_slot(state: SlotState, row: SlotState, slot: int) -> SlotState:
    """A new state with one request's rows at ``slot`` (admission, swap
    restore). The buffers are copied, not written in place: the caller may
    still hold the pre-write state, as the reference's un-donated jitted
    write allows."""
    def put(buf, r):
        out = buf.clone()
        out[:, slot] = r.to(out.device, out.dtype)
        return out
    return SlotState(*(put(b, r) for b, r in zip(state, row)))


def read_slot(state: SlotState, slot: int) -> SlotState:
    """One request's rows at ``slot`` (preemption capture), ``[L_rec,
    ...]`` with the slot axis gathered away, as copies."""
    return SlotState(*(buf[:, slot].clone() for buf in state))
