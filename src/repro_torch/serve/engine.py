"""Sparse decode serving engine (contiguous path), PyTorch port.

``DecodeEngine.generate(batch, n)`` is the uniform-batch path of the JAX
package's engine: one contiguous ``DecodeState``, every row decodes in
lockstep, gated block-sparse attention in every layer. Decode behaviour
is one frozen ``core.policy.DecodeOptions``. The paged ``serve()`` path
arrives with the next slice.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with
no card and no explicit device it raises. On a CUDA device every layer's
selection and sparse attention go through the hand-written kernels
(``kernels/ops.py``); on the CPU through their plain PyTorch versions.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.policy import DecodeOptions, default_options
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_api
from repro_torch.serve import sampling as smp


class GenerationResult(Dict):
    pass


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params: Any, *, max_len: int,
                 options: Optional[DecodeOptions] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = get_api(cfg)
        w = params["embed"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params live on {w.device}, engine device is "
                             f"{self.device}: move them first")
        self.params = params
        self.max_len = max_len
        self.options = options if options is not None else default_options(cfg)
        self._last_aux = None       # measured selection of the latest step

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _step(self, params, state, token):
        """One decode step: (next token, logits, state, aux). The state's
        caches are updated in place."""
        logits, state, aux = self.api.decode_step(
            params, state, token, self.cfg, options=self.options)
        nxt = smp.sample(logits, self.options.sampling)
        return nxt, logits, state, aux

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any]):
        """batch["tokens"] [B, L] (tensor or array) -> (first token [B], state)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        logits, state = self.api.prefill(self.params, {"tokens": tokens},
                                         self.cfg, self.max_len,
                                         options=self.options)
        return smp.sample(logits, self.options.sampling), state

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], n_tokens: int) -> GenerationResult:
        """Uniform-batch greedy decode of ``n_tokens`` per row (the first
        comes from prefill, then ``n_tokens - 1`` decode steps)."""
        self._last_aux = None
        t0 = time.perf_counter()
        token, state = self.prefill(batch)
        self._sync()
        prefill_s = time.perf_counter() - t0
        toks = [token]
        t1 = time.perf_counter()
        for _ in range(n_tokens - 1):
            token, _, state, aux = self._step(self.params, state, token)
            self._last_aux = aux
            toks.append(token)
        self._sync()
        decode_s = time.perf_counter() - t1
        out = torch.stack(toks, dim=1)
        return GenerationResult(
            tokens=out, prefill_s=prefill_s, decode_s=decode_s,
            tok_per_s=(n_tokens - 1) * out.shape[0] / max(decode_s, 1e-9),
            final_len=state.cur_len)

    def sparsity_stats(self) -> Dict[str, Any]:
        """Measured selection economics of the LATEST decode step, from
        the step's ACTUAL selected block mask (averaged over layers).
        Before any step has run: the same keys, neutral values and
        ``measured=False``."""
        if self._last_aux is None or not self.options.measure_sparsity:
            sel = vis = rho = 0.0
            rows = np.zeros((0,), np.float32)
            measured = False
        else:
            aux = {k: v.detach().cpu().numpy() for k, v in self._last_aux.items()}
            rows = np.asarray(aux["sparsity_rows"], np.float32)
            sel = float(np.mean(aux["sel_blocks"]))
            vis = float(np.mean(aux["vis_blocks"]))
            rho = float(np.mean(rows))
            measured = True
        return {
            "sparsity": rho, "sparsity_rows": rows,
            "sel_blocks": sel, "vis_blocks": vis,
            "measured": measured,
        }
