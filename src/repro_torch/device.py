"""Device resolution for the port's entry points.

Every entry point that places tensors (the engine, the weight loader, the
decode-state allocator) runs on CUDA unless the caller names another
device. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA. Raises when CUDA is asked for and absent: the CPU
    runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the port runs on the GPU by default; "
            "pass device='cpu' explicitly for the plain PyTorch path")
    return dev
