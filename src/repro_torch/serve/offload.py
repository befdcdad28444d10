"""KV-cache offload economics + the tiered host swap space, PyTorch port.

Port of the JAX package's ``serve/offload.py``.

The K-compression cache is <1% of the KV cache (b=64, d_gate=128), so it
can stay in HBM while the full KV cache lives in host memory: per decode
step only the gate runs on the card and only the SELECTED blocks cross
the host link. ``offload_step_model`` is the derived cost model (the
decision surface for when offload wins) and ``OffloadedKV`` a functional
simulator of the fetch. The constants are the H100's: ``HBM_BW`` the
3.35 TB/s of H100 SXM HBM3 (the figure the kernels' bounds use) and
``PCIE_BW`` the host link of an H100 SXM, PCIe Gen5 x16, per direction.

``HostSwapSpace`` is the host-side buffer the paged serving engine swaps
into: a preempted request's pages (``SwapEntry``: K/V/Kg, the Quest
metadata rows, the int8 pools' scale rows, a recurrent family's
per-layer state rows, its last sampled token and its length, keyed by
request id) and single evicted pages
(``PageEntry``, keyed ``("page", rid, logical_block)``) share one store.
It is TIERED and BOUNDED: ``SwapConfig.host_capacity_bytes`` caps the
in-memory tier, with LRU demotion to an on-disk ``.npz`` tier
(``disk_dir``) and promotion back on ``pop``, so preemption under heavy
traffic cannot exhaust host memory. Transfers retry with bounded backoff
through an optional ``FaultInjector``. Entries hold CPU tensors; a bf16
tensor goes to disk as its 16-bit pattern, so the round trip is bitwise.

Derived model per token (one layer, one sequence):
  on-card   : kv_read = 2*budget*Hkv*Dh*bytes     @ HBM_BW
  offloaded : fetch   = 2*budget*Hkv*Dh*bytes     @ PCIE_BW (<< HBM_BW)
              gate    = (S/b)*Hkv*Dg*bytes        @ HBM_BW (Kg stays on the card)
  offload frees 2*S*Hkv*Dh*bytes of HBM per layer -> larger batch/context.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Dict, Hashable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.serve.faults import FaultInjector

HBM_BW = 3.35e12        # H100 SXM HBM3, bytes/s
PCIE_BW = 64e9          # H100 SXM host link: PCIe Gen5 x16, bytes/s each way


def offload_step_model(cfg: ModelConfig, seq_len: int, *,
                       bytes_per=2) -> Dict[str, float]:
    """Per-token per-layer time (s) and HBM savings of KV offload."""
    g = cfg.gate
    hkv, dh, dg, b = cfg.n_kv_heads, cfg.resolved_head_dim, g.d_gate, g.block_size
    budget = min(g.token_budget, seq_len)
    nb = -(-seq_len // b)
    kv_sel_bytes = 2 * budget * hkv * dh * bytes_per
    kg_bytes = nb * hkv * dg * bytes_per
    t_oncard = (2 * seq_len * hkv * dh * bytes_per) / HBM_BW      # dense read
    t_sparse = kv_sel_bytes / HBM_BW + kg_bytes / HBM_BW          # sparse, HBM
    t_offload = kv_sel_bytes / PCIE_BW + kg_bytes / HBM_BW        # sparse, host
    return {
        "t_dense_hbm_s": t_oncard,
        "t_sparse_hbm_s": t_sparse,
        "t_sparse_offload_s": t_offload,
        "hbm_freed_bytes": 2 * seq_len * hkv * dh * bytes_per,
        "kg_resident_bytes": kg_bytes,
        "kg_over_kv": kg_bytes / (2 * seq_len * hkv * dh * bytes_per),
        # offload still beats DENSE on the card when budget/PCIE < S/HBM:
        "offload_beats_dense": t_offload < t_oncard,
    }


class OffloadedKV(NamedTuple):
    """Functional simulator: 'host' tensors + the on-card Kg cache.
    ``fetch`` returns only the selected blocks, the serving engine's
    contract. Head-major layouts throughout, as the decode caches."""
    host_k: torch.Tensor    # [B, Hkv, S, Dh]  (host-resident stand-in)
    host_v: torch.Tensor
    kg: torch.Tensor        # [B, Hkv, nb, Dg] (HBM-resident)
    block_size: int
    fetched_blocks: int = 0

    def fetch(self, block_indices: torch.Tensor):
        """block_indices [B, Hkv, nsel] -> (k_sel, v_sel, store) with the
        gathered blocks [B, Hkv, nsel*b, Dh] (the only KV bytes that cross
        the host link); -1 padding reads block 0."""
        b, hkv, _, dh = self.host_k.shape
        bs = self.block_size
        idx = torch.clamp_min(block_indices.long(), 0)
        pos = (idx[..., None] * bs + torch.arange(bs, device=idx.device)).reshape(b, hkv, -1)
        gather = pos[..., None].expand(-1, -1, -1, dh)
        k_sel = torch.gather(self.host_k, 2, gather)
        v_sel = torch.gather(self.host_v, 2, gather)
        n = int(block_indices.shape[-1])
        return k_sel, v_sel, self._replace(fetched_blocks=self.fetched_blocks + n)


class SwapEntry(NamedTuple):
    """One preempted request's host-resident state: page contents in
    LOGICAL page order (CPU tensors) plus what decode resumes from, in the
    reference's field order. ``kmin``/``kmax`` are the selection-metadata
    page rows (metadata-reading policies only), so a resumed Quest decode
    selects exactly what an unpreempted one would. Int8 pools keep their
    raw bytes and carry the scale rows beside them. ``state_conv``/
    ``state_h`` (the recurrent families) carry the request's per-layer
    recurrent rows without the slot axis (``serve.slotstate.read_slot``),
    restored bitwise into whatever slot the request lands in on resume.
    The byte counters and the disk tier include every tensor of the
    entry."""
    k: torch.Tensor                 # [L, n_pages, Hkv, ps, Dh] (int8 if quant)
    v: torch.Tensor                 # [L, n_pages, Hkv, ps, Dh] (int8 if quant)
    kg: Optional[torch.Tensor]      # [L, n_pages, Hkv, Dg] | None
    token: int                      # last sampled token (re-fed on resume)
    cur_len: int                    # sequence length at preemption
    kmin: Optional[torch.Tensor] = None      # [L, n_pages, Hkv, Dh] | None
    kmax: Optional[torch.Tensor] = None      # [L, n_pages, Hkv, Dh] | None
    k_scale: Optional[torch.Tensor] = None   # [L, n_pages, Hkv, 1] | None
    v_scale: Optional[torch.Tensor] = None   # [L, n_pages, Hkv, 1] | None
    state_conv: Optional[torch.Tensor] = None    # [L_rec, K-1, d_conv] | None
    state_h: Optional[torch.Tensor] = None       # [L_rec, ...] f32 | None


class PageEntry(NamedTuple):
    """One EVICTED page of a still-running request (RaaS eviction):
    single-page K/V content plus its gate/metadata rows and, for int8
    pools, its scale rows, so an evict -> restore round trip is bitwise,
    like whole-request preemption. Keyed ``("page", rid, logical_block)``."""
    k: torch.Tensor                 # [L, 1, Hkv, ps, Dh] (int8 if quant)
    v: torch.Tensor                 # [L, 1, Hkv, ps, Dh] (int8 if quant)
    kg: Optional[torch.Tensor] = None        # [L, 1, Hkv, Dg] | None
    kmin: Optional[torch.Tensor] = None      # [L, 1, Hkv, Dh] | None
    kmax: Optional[torch.Tensor] = None      # [L, 1, Hkv, Dh] | None
    k_scale: Optional[torch.Tensor] = None   # [L, 1, Hkv, 1] | None
    v_scale: Optional[torch.Tensor] = None   # [L, 1, Hkv, 1] | None


@dataclasses.dataclass(frozen=True)
class SwapConfig:
    """Capacity bounds + retry policy for ``HostSwapSpace``.

    ``host_capacity_bytes=None`` keeps an unbounded in-memory store. With
    a bound set, inserts that would exceed it LRU-demote the oldest host
    entries to ``disk_dir`` (which must then be configured — exceeding the
    host bound with no disk tier is a ``SwapCapacityError``);
    ``disk_capacity_bytes`` optionally bounds the disk tier too. Transfers
    retry up to ``retries`` extra attempts with exponential backoff
    starting at ``backoff_s``."""
    host_capacity_bytes: Optional[int] = None
    disk_dir: Optional[str] = None
    disk_capacity_bytes: Optional[int] = None
    retries: int = 3
    backoff_s: float = 0.0


class SwapError(RuntimeError):
    """Base class for swap-space failures (after retries exhausted)."""


class SwapIOError(SwapError):
    """A (possibly injected) transfer error that outlived every retry."""


class SwapCapacityError(SwapError):
    """Entry does not fit within the configured tier capacity bounds."""


class SwapLookupError(SwapError, KeyError):
    """Descriptive missing-key error (a KeyError too)."""


# .npz round trip: entry type name -> NamedTuple class
_ENTRY_KINDS = {"SwapEntry": SwapEntry, "PageEntry": PageEntry}


def _pack_entry(entry) -> Dict[str, np.ndarray]:
    """NumPy arrays for ``np.savez``. numpy has no bfloat16, so a bf16
    tensor is stored as its int16 bit pattern beside a 0-d dtype tag."""
    out = {"__kind__": np.asarray(type(entry).__name__)}
    for name, val in zip(entry._fields, entry):
        if val is None:
            continue
        if isinstance(val, torch.Tensor):
            if val.dtype == torch.bfloat16:
                out[f"__bf16__{name}"] = np.asarray(True)
                val = val.view(torch.int16)
            val = val.numpy()
        out[name] = np.asarray(val)
    return out


def _unpack_entry(data):
    kind = _ENTRY_KINDS[str(data["__kind__"])]
    kw = {}
    for f in kind._fields:
        if f not in data.files:
            continue
        if f in ("token", "cur_len"):          # 0-d arrays back to python ints
            kw[f] = int(data[f])
            continue
        t = torch.from_numpy(np.array(data[f]))
        kw[f] = t.view(torch.bfloat16) if f"__bf16__{f}" in data.files else t
    return kind(**kw)


class HostSwapSpace:
    """Tiered host buffer for preempted requests and evicted pages.

    The serving engine ``put``s a SwapEntry at preemption or a PageEntry
    at page eviction (CPU tensors), and ``pop``s it at re-admission or
    restore-on-re-touch. Two tiers: a host-memory OrderedDict (LRU order =
    insertion order) bounded by ``SwapConfig.host_capacity_bytes``, and an
    on-disk ``.npz`` tier below it. Byte/operation counters per tier feed
    the swap telemetry of ``DecodeEngine.serve()``.
    """

    def __init__(self, config: Optional[SwapConfig] = None,
                 faults: Optional[FaultInjector] = None):
        self.config = config if config is not None else SwapConfig()
        self.faults = faults
        self._host: "OrderedDict[Hashable, NamedTuple]" = OrderedDict()
        self._disk: Dict[Hashable, str] = {}
        self._disk_seq = 0
        # whole-store traffic, any tier
        self.swapped_out = 0
        self.swapped_in = 0
        self.bytes_out = 0
        self.bytes_in = 0
        # per-tier accounting
        self.host_bytes = 0
        self.disk_bytes = 0
        self.peak_host_bytes = 0
        self.peak_disk_bytes = 0
        self.demotions = 0
        self.promotions = 0
        self.retries_used = 0

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def __contains__(self, key) -> bool:
        return key in self._host or key in self._disk

    def keys(self):
        return list(self._host) + list(self._disk)

    @staticmethod
    def _nbytes(e) -> int:
        return sum(v.numel() * v.element_size() for v in e
                   if isinstance(v, torch.Tensor))

    def _attempt(self, site: str) -> None:
        """One logical transfer: retry injected failures with backoff;
        raise SwapIOError once the budget is spent. Each attempt consumes
        one FaultInjector call index at ``site``."""
        if self.faults is None:
            return
        for attempt in range(self.config.retries + 1):
            if not self.faults.fire(site):
                return
            if attempt < self.config.retries:
                self.retries_used += 1
                if self.config.backoff_s > 0:
                    time.sleep(self.config.backoff_s * (2 ** attempt))
        raise SwapIOError(
            f"swap {site} failed after {self.config.retries + 1} attempts")

    # -- disk tier ---------------------------------------------------------

    def _write_disk(self, key, entry, nb: int) -> None:
        cfg = self.config
        if cfg.disk_dir is None:
            raise SwapCapacityError(
                f"host swap capacity {cfg.host_capacity_bytes} bytes "
                f"exceeded by entry {key!r} ({nb} bytes) and no disk tier "
                "is configured (SwapConfig.disk_dir)")
        if (cfg.disk_capacity_bytes is not None
                and self.disk_bytes + nb > cfg.disk_capacity_bytes):
            raise SwapCapacityError(
                f"disk swap tier full: {self.disk_bytes} + {nb} bytes "
                f"exceeds bound {cfg.disk_capacity_bytes} (entry {key!r})")
        self._attempt("disk_write")
        os.makedirs(cfg.disk_dir, exist_ok=True)
        # the process id keeps the ranks of a sharded engine that share a
        # disk tier from writing the same files
        path = os.path.join(cfg.disk_dir, f"swap_{os.getpid()}_{self._disk_seq}.npz")
        self._disk_seq += 1
        np.savez(path, **_pack_entry(entry))
        self._disk[key] = path
        self.disk_bytes += nb
        self.peak_disk_bytes = max(self.peak_disk_bytes, self.disk_bytes)

    def _read_disk(self, key):
        self._attempt("disk_read")
        path = self._disk.pop(key)
        with np.load(path) as data:
            entry = _unpack_entry(data)
        os.remove(path)
        self.disk_bytes -= self._nbytes(entry)
        self.promotions += 1
        return entry

    def _demote_oldest(self) -> None:
        key, entry = self._host.popitem(last=False)       # LRU = oldest put
        nb = self._nbytes(entry)
        try:
            self._write_disk(key, entry, nb)
        except SwapError:
            self._host[key] = entry                       # undo, re-raise
            self._host.move_to_end(key, last=False)
            raise
        self.host_bytes -= nb
        self.demotions += 1

    # -- public API --------------------------------------------------------

    def put(self, key, entry) -> None:
        if key in self:
            raise ValueError(
                f"swap entry {key!r} already resident; held keys: "
                f"{sorted(map(repr, self.keys()))}")
        for t in entry:
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                raise ValueError(f"swap entry {key!r}: tensors must be on the host")
        self._attempt("swap_put")
        nb = self._nbytes(entry)
        cap = self.config.host_capacity_bytes
        if cap is not None and nb > cap:
            self._write_disk(key, entry, nb)              # never fits in host
        else:
            # demote BEFORE insert so host_bytes never exceeds the bound
            while cap is not None and self._host and self.host_bytes + nb > cap:
                self._demote_oldest()
            self._host[key] = entry
            self.host_bytes += nb
            self.peak_host_bytes = max(self.peak_host_bytes, self.host_bytes)
        self.swapped_out += 1
        self.bytes_out += nb

    def pop(self, key):
        if key not in self:
            raise SwapLookupError(
                f"no swap entry for key {key!r}; resident keys: "
                f"{sorted(map(repr, self.keys()))}")
        self._attempt("swap_pop")
        if key in self._host:
            entry = self._host.pop(key)
            self.host_bytes -= self._nbytes(entry)
        else:
            entry = self._read_disk(key)                  # promotion
        self.swapped_in += 1
        self.bytes_in += self._nbytes(entry)
        return entry

    def discard(self, key) -> None:
        """Drop an entry without restoring it (failed/aborted request).
        A missing key is a no-op: discard is cleanup, not lookup."""
        if key in self._host:
            entry = self._host.pop(key)
            self.host_bytes -= self._nbytes(entry)
        elif key in self._disk:
            path = self._disk.pop(key)
            try:
                with np.load(path) as data:
                    # 0-d entries (kind and dtype tags, token, cur_len) are
                    # metadata, not accounted bytes
                    self.disk_bytes -= sum(data[f].nbytes for f in data.files
                                           if data[f].ndim > 0)
                os.remove(path)
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        return {
            "host_entries": len(self._host),
            "disk_entries": len(self._disk),
            "host_bytes": self.host_bytes,
            "disk_bytes": self.disk_bytes,
            "peak_host_bytes": self.peak_host_bytes,
            "peak_disk_bytes": self.peak_disk_bytes,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "retries_used": self.retries_used,
        }
