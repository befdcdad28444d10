"""Synthetic data pipeline, PyTorch port.

A copy of the JAX package's ``data/pipeline.py``. For the token families:
deterministic, checkpointable batches of documents packed to a fixed
sequence length, with segment ids and per-document positions (varlen
attention), and planted long-range motif copies so that attention is
sparse but not local. The numpy draws are the reference's, in the same
order, so the same ``(seed, step)`` gives bitwise the same tokens,
labels, segment ids, positions and loss mask; only the last step differs:
the arrays become torch tensors on ``device``.

A vision model's batch also carries ``image_embeds`` [B, n_image_tokens,
d_model] (standard normals in the working dtype, times 0.02, as the
reference's). JAX's PRNG stream cannot be drawn without JAX, so these
come from the port's own numpy generator, seeded by (seed, step) apart
from the token draws; tests hand the same array to both packages.

The audio encoder's batch (``make_audio_batch``) is frame features [B,
L, n_audio_features] in ``cfg.dtype`` (standard normals) and cluster
labels [B, L], the reference's layout; its values come from the port's
own numpy stream seeded by (seed, step), for the same reason.

Iterator state == (seed, step): restoring a checkpoint resumes the exact
stream.
"""
from __future__ import annotations

from typing import Dict, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device


class DataState(NamedTuple):
    seed: int
    step: int


def _doc_lengths(rng: np.random.Generator, total: int, mean_len: int) -> np.ndarray:
    lens = []
    left = total
    while left > 0:
        n = int(np.clip(rng.geometric(1.0 / mean_len), 16, left))
        lens.append(n)
        left -= n
    return np.asarray(lens)


def make_lm_batch(cfg: ModelConfig, batch: int, seq_len: int, state: DataState, *,
                  mean_doc_len: int = 2048, motif_len: int = 16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Packed LM batch on ``device`` (None = CUDA): tokens, labels,
    segment_ids, positions (int32) and loss_mask (float32), each [B, L];
    for a vision model also ``image_embeds`` [B, n_image_tokens, d_model]
    in ``cfg.dtype``."""
    device = resolve_device(device)
    rng = np.random.default_rng((state.seed * 1_000_003 + state.step) & 0x7FFFFFFF)
    v = cfg.vocab_size
    toks = rng.integers(0, v, size=(batch, seq_len), dtype=np.int32)
    seg = np.zeros((batch, seq_len), np.int32)
    pos = np.zeros((batch, seq_len), np.int32)
    for b in range(batch):
        lens = _doc_lengths(rng, seq_len, min(mean_doc_len, seq_len))
        off = 0
        for d, n in enumerate(lens):
            seg[b, off:off + n] = d
            pos[b, off:off + n] = np.arange(n)
            # a motif written early reappears later in the document: the
            # source span is the "important block" the gate must find
            if n > 4 * motif_len:
                src = off + rng.integers(0, n // 4)
                n_copies = 1 + int(rng.integers(0, 3))
                for _ in range(n_copies):
                    dst = off + rng.integers(n // 2, n - motif_len)
                    toks[b, dst:dst + motif_len] = toks[b, src:src + motif_len]
            off += n
    labels = np.roll(toks, -1, axis=1)
    loss_mask = (seg == np.roll(seg, -1, axis=1)).astype(np.float32)
    arrays = {"tokens": toks, "labels": labels, "segment_ids": seg, "positions": pos,
              "loss_mask": loss_mask}
    out = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    if cfg.family == "vlm":
        out["image_embeds"] = image_embeds(cfg, batch, state, device=device)
    return out


def image_embeds(cfg: ModelConfig, batch: int, state: DataState, *,
                 device=None) -> torch.Tensor:
    """Stub image patch embeddings [B, n_image_tokens, d_model] in
    ``cfg.dtype`` on ``device`` (None = CUDA), from a numpy stream of their
    own seeded by (seed, step)."""
    rng = np.random.default_rng([state.seed, state.step, 1])
    z = rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_model), np.float32)
    dt = getattr(torch, cfg.dtype)
    return (torch.from_numpy(z).to(device=resolve_device(device), dtype=dt) * 0.02)


def make_audio_batch(cfg: ModelConfig, batch: int, seq_len: int, state: DataState, *,
                     device=None) -> Dict[str, torch.Tensor]:
    """The audio encoder's batch on ``device`` (None = CUDA): ``features``
    [B, L, n_audio_features] standard normals in ``cfg.dtype`` and
    ``labels`` [B, L] uniform over the vocabulary (int32), from a numpy
    stream seeded by (seed, step)."""
    rng = np.random.default_rng([state.seed, state.step, 2])
    feats = rng.standard_normal((batch, seq_len, cfg.n_audio_features), np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(batch, seq_len), dtype=np.int32)
    device = resolve_device(device)
    return {"features": torch.from_numpy(feats).to(device=device,
                                                   dtype=getattr(torch, cfg.dtype)),
            "labels": torch.from_numpy(labels).to(device)}


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, state: DataState, *,
               device=None, **kw) -> Dict[str, torch.Tensor]:
    if cfg.family == "audio":
        return make_audio_batch(cfg, batch, seq_len, state, device=device)
    return make_lm_batch(cfg, batch, seq_len, state, device=device, **kw)


def data_iterator(cfg: ModelConfig, batch: int, seq_len: int, state: DataState, *,
                  device=None) -> Iterator:
    """Resumable iterator; yields (batch_dict, DataState-after)."""
    step = state.step
    while True:
        st = DataState(state.seed, step)
        yield (make_batch(cfg, batch, seq_len, st, device=device),
               DataState(state.seed, step + 1))
        step += 1
