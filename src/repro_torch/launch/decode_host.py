"""Host time of the fp decode wrappers (#2 ``sparse_decode_cuda``, #4
``sparse_decode_paged_cuda``) at the main path's layer shape.

    python3 src/repro_torch/launch/decode_host.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's), so the same script times another tree's
wrappers on the same inputs: run it by path, once per tree, in one
process each, in the order A, B, B, A, and compare within one machine.

Inputs (random, from seed 0): bf16 q [4, 8, 2, 128]; contiguous caches
[4, 8, 257 * 64, 128] and the same values paged into a pool of 4 * 257 + 1
pages of 64 under a shuffled table; 64 distinct selected blocks per (b,
kv-head), the partial last one among them; kv_len 256 * 64 + 1. The
wrappers run at their defaults, as the model calls them.

For each wrapper it prints, as one JSON line: the host's enqueue of one
call onto an idle card (perf_counter around the call, the card
synchronised before it and after it, not inside; median, 10th and 90th
percentile of ``--runs`` calls) and the time from CUDA events around one
call onto an idle card (``chip_smoke.time_ms``'s method; median of 30),
which counts the host's part where it is the longer; and, for scale, the
host time of a few pieces every wrapper of the port runs. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def host_ms(fn, runs: int):
    import torch
    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return [float(np.percentile(times, p)) for p in (50, 10, 90)]


def event_ms(fn, runs: int = 30):
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--runs", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.kernels import block_sparse_decode as bsd

    if not torch.cuda.is_available():
        sys.exit("decode_host.py needs a CUDA card")
    dev = torch.device("cuda")
    b, hkv, g, dh, nb, bs, nsel = 4, 8, 2, 128, 257, 64, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, hkv, g, dh, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, hkv, nb * bs, dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, hkv, nb * bs, dh, generator=gen, device=dev).to(torch.bfloat16)
    r = np.random.default_rng(0)
    idx = np.stack([np.concatenate([[0, nb - 1], r.choice(np.arange(1, nb - 1), nsel - 2,
                                                          replace=False)])
                    for _ in range(b * hkv)])
    idx = torch.tensor(np.stack([r.permutation(x) for x in idx]).reshape(b, hkv, nsel),
                       dtype=torch.int32, device=dev)
    kv_len = torch.full((b,), (nb - 1) * bs + 1, dtype=torch.int32, device=dev)
    perm = torch.tensor(1 + r.permutation(b * nb), dtype=torch.int64, device=dev)
    pt = perm.reshape(b, nb).to(torch.int32)
    kp = torch.zeros(b * nb + 1, hkv, bs, dh, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    kp[perm] = k.reshape(b, hkv, nb, bs, dh).permute(0, 2, 1, 3, 4).reshape(-1, hkv, bs, dh)
    vp[perm] = v.reshape(b, hkv, nb, bs, dh).permute(0, 2, 1, 3, 4).reshape(-1, hkv, bs, dh)

    calls = {
        "block_sparse_decode": lambda: bsd.sparse_decode_cuda(q, k, v, idx, kv_len,
                                                              block_size=bs),
        "block_sparse_decode_paged": lambda: bsd.sparse_decode_paged_cuda(
            q, kp, vp, idx, pt, kv_len, block_size=bs),
    }
    o = calls["block_sparse_decode"]()
    if not torch.equal(o, calls["block_sparse_decode_paged"]()):
        sys.exit("the contiguous and the paged wrapper disagree on the same values")
    out = {"label": args.label or args.src, "torch": torch.__version__,
           "device": torch.cuda.get_device_name(0)}
    for name, fn in calls.items():
        med, p10, p90 = host_ms(fn, args.runs)
        out[name] = dict(host_ms=med, host_p10_ms=p10, host_p90_ms=p90,
                         event_ms=event_ms(fn))
    # host pieces every wrapper of the port has, for scale (the same in
    # every tree): its input checks, an output allocation, an f32 workspace
    # of the split plan's size, the current stream's handle
    pieces = {
        "check": lambda: bsd._check("x", q, k, v, (idx, kv_len)),
        "empty_like": lambda: torch.empty_like(q),
        "empty_f32_workspace": lambda: torch.empty(b * hkv * 8 * (g * dh + 2 * g),
                                                   dtype=torch.float32, device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    out["pieces_host_ms"] = {n: host_ms(fn, args.runs)[0] for n, fn in pieces.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
