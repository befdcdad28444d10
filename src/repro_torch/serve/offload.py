"""Host swap space for preempted requests, PyTorch port.

Port of ``SwapEntry`` and ``HostSwapSpace`` from the JAX package's
``serve/offload.py``: the host-memory buffer the paged serving engine
swaps a preempted request's pages into (page contents K/V/Kg, the Quest
metadata rows, the int8 pools' scale rows, the request's last sampled
token and its length, keyed by request id), with
byte counters for the serving stats. The reference's byte-bounded host
tier, its disk tier, single evicted pages (``PageEntry``) and transfer
retries arrive with the pressure-path slice; this store is unbounded.
"""
from __future__ import annotations

from typing import Dict, Hashable, NamedTuple, Optional

import torch


class SwapEntry(NamedTuple):
    """One preempted request's host-resident state: page contents in
    LOGICAL page order (CPU tensors) plus what decode resumes from, in the
    reference's field order. ``kmin``/``kmax`` are the selection-metadata
    page rows (metadata-reading policies only), so a resumed Quest decode
    selects exactly what an unpreempted one would. Int8 pools keep their
    raw bytes and carry the scale rows beside them. The byte counters
    include every tensor of the entry."""
    k: torch.Tensor                 # [L, n_pages, Hkv, ps, Dh] (int8 if quant)
    v: torch.Tensor                 # [L, n_pages, Hkv, ps, Dh] (int8 if quant)
    kg: Optional[torch.Tensor]      # [L, n_pages, Hkv, Dg] | None
    token: int                      # last sampled token (re-fed on resume)
    cur_len: int                    # sequence length at preemption
    kmin: Optional[torch.Tensor] = None      # [L, n_pages, Hkv, Dh] | None
    kmax: Optional[torch.Tensor] = None      # [L, n_pages, Hkv, Dh] | None
    k_scale: Optional[torch.Tensor] = None   # [L, n_pages, Hkv, 1] | None
    v_scale: Optional[torch.Tensor] = None   # [L, n_pages, Hkv, 1] | None


class SwapLookupError(KeyError):
    """No entry under the requested key."""


class HostSwapSpace:
    """Unbounded host buffer for preempted requests. ``put`` at
    preemption, ``pop`` at re-admission; ``bytes_out``/``bytes_in`` count
    the tensor bytes moved each way."""

    def __init__(self):
        self._host: Dict[Hashable, SwapEntry] = {}
        self.bytes_out = 0
        self.bytes_in = 0
        self.host_bytes = 0
        self.peak_host_bytes = 0

    def __contains__(self, key) -> bool:
        return key in self._host

    def keys(self):
        return list(self._host)

    @staticmethod
    def _nbytes(e: SwapEntry) -> int:
        return sum(v.numel() * v.element_size() for v in e
                   if isinstance(v, torch.Tensor))

    def put(self, key, entry: SwapEntry) -> None:
        if key in self:
            raise ValueError(f"swap entry {key!r} already resident; held keys: "
                             f"{sorted(map(repr, self.keys()))}")
        for t in entry:
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                raise ValueError(f"swap entry {key!r}: tensors must be on the host")
        nb = self._nbytes(entry)
        self._host[key] = entry
        self.host_bytes += nb
        self.peak_host_bytes = max(self.peak_host_bytes, self.host_bytes)
        self.bytes_out += nb

    def pop(self, key) -> SwapEntry:
        if key not in self:
            raise SwapLookupError(f"no swap entry for key {key!r}; resident keys: "
                                  f"{sorted(map(repr, self.keys()))}")
        entry = self._host.pop(key)
        nb = self._nbytes(entry)
        self.host_bytes -= nb
        self.bytes_in += nb
        return entry

    def discard(self, key) -> None:
        """Drop an entry without restoring it (failed request); a missing
        key is a no-op."""
        entry = self._host.pop(key, None)
        if entry is not None:
            self.host_bytes -= self._nbytes(entry)

    def stats(self) -> Dict[str, int]:
        """The reference's swap stats; the disk-tier counters stay 0 here."""
        return {
            "host_entries": len(self._host),
            "disk_entries": 0,
            "host_bytes": self.host_bytes,
            "disk_bytes": 0,
            "peak_host_bytes": self.peak_host_bytes,
            "peak_disk_bytes": 0,
            "demotions": 0,
            "promotions": 0,
            "retries_used": 0,
        }
