"""Where a gate select call's device time goes, phase by phase.

    python3 src/repro_torch/launch/gate_phases.py [--threads 512 256] [--runs 50]

No kernel profiler runs on the card's machine, so this builds a copy of
``kernels/csrc/gate_select.cu`` with ``clock64()`` stamps at its phase
boundaries (thread 0 of each CTA writes them to a device array) at each
CTA size of ``--threads`` (``-DGATE_SELECT_THREADS``), into the ignored
``kernels/_build/``. The phases: stage (q and the table row), score (the
Kg rows), keys (ranked values as keys, pass 0's histogram), radix (the
select's passes), walk (the ballot walk that lists or places survivors),
rank (the listed survivors' slots). A stamp waits for nothing but its
own thread, so a phase that ends at a barrier holds the wait for the
slowest warp.

Inputs: the main path's layer-0 shapes, random normal from seed 0: bf16
qg [4, 8, 128] and Kg [4, 8, 257, 128], the same rows in a pool of 1029
pages under a shuffled table, n_valid 257, the budget gate of
qwen3_0_6b (k 64, both blocks pinned). For each CTA size and entry point
it prints one JSON line: the card, the mean cycles of each phase over
the CTAs and ``--runs`` calls, and the device time of a call launched
back to back (CUDA events around 200 calls enqueued behind a spin
kernel, so the host's enqueue is hidden). The ids of each instrumented
build must equal the built kernel's. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

PHASES = ("stage", "score", "keys", "radix", "walk", "rank")
# (anchor in gate_select.cu, code put before it, code put after it)
STAMPS = (
    ("namespace {\n", "__device__ long long g_stamps[4096][8];\n", ""),
    ("  int* orow = out + (size_t)bh * k_sel;\n", "", "  long long t_[7];\n  t_[0] = clock64();\n"),
    ("hist[i >> 8][i & 255] = 0;\n  __syncthreads();\n", "", "  t_[1] = clock64();\n"),
    ("score_rows<T, false, Paged>(q, kg, tbl, s, b, h, H, nb, nv, dg, scale);\n"
     "  __syncthreads();\n", "", "  t_[2] = clock64();\n"),
    ("  // radix select:", "  t_[3] = clock64();\n", ""),
    ("  // place: each warp walks", "  t_[4] = clock64();\n", ""),
    ("  // P adjacent lanes", "  t_[5] = clock64();\n", ""),
    ("    if (i < g && part == 0) orow[slot] = out_id((uint32_t)(me >> 32), (int)(uint32_t)me,"
     " cut);\n  }\n", "",
     "  t_[6] = clock64();\n  if (tid == 0)\n    for (int i = 0; i < 7; ++i) g_stamps[blockIdx.x][i] = t_[i];\n"),
    ('extern "C" {\n', "",
     "int gate_read_stamps(void* h, int n) {\n  return (int)cudaMemcpyFromSymbol(h, g_stamps, "
     "(size_t)n * 8 * sizeof(long long));\n}\n"),
)


def instrumented_source(src: str) -> str:
    for anchor, before, after in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"gate_select.cu no longer holds the phase anchor {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[512, 256])
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    import torch

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import gate_select as gs

    if not torch.cuda.is_available():
        print("gate_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "gate_select_phases.cu"
    cu.write_text(instrumented_source((build.CSRC / "gate_select.cu").read_text()))
    procs = {n: (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, f"-DGATE_SELECT_THREADS={n}",
                                   "-o", str(build.BUILD_DIR / f"gate_select_phases{n}.so"),
                                   str(cu)]),
                 build.BUILD_DIR / f"gate_select_phases{n}.so") for n in args.threads}
    libs = {}
    for n, (proc, so) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the instrumented gate_select.cu at {n} threads")
        lib = ctypes.CDLL(str(so))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[n] = lib

    cfg = configs.get("qwen3_0_6b").gate
    b, h, nb, dg, n_pages = 4, 8, 257, 128, 1029
    g = torch.Generator(device="cuda").manual_seed(0)
    qg = torch.randn(b, h, dg, generator=g, device="cuda").bfloat16()
    kg = torch.randn(b, h, nb, dg, generator=g, device="cuda").bfloat16()
    nv = torch.full((b,), nb, dtype=torch.int32, device="cuda")
    pages = 1 + torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(0))[:b * nb]
    table = pages.reshape(b, nb).int().cuda()
    pool = torch.zeros(n_pages, h, dg, dtype=qg.dtype, device="cuda")
    pool[table.long()] = kg.transpose(1, 2)
    calls = {"gate_select": lambda: gs.gate_select_cuda(qg, kg, nv, cfg),
             "gate_select_paged": lambda: gs.gate_select_paged_cuda(qg, pool, table, nv, cfg)}
    want = {name: fn() for name, fn in calls.items()}
    real = build.load
    stamps = (ctypes.c_longlong * (b * h * 8))()
    try:
        for n, lib in libs.items():
            build.load = lambda name, lib=lib: lib
            for name, fn in calls.items():
                if not torch.equal(fn(), want[name]):
                    raise RuntimeError(f"{name} at {n} threads: ids differ from the built kernel's")
                cycles = torch.zeros(len(PHASES), dtype=torch.float64)
                for _ in range(args.runs):
                    fn()
                    torch.cuda.synchronize()
                    build.check(lib, lib.gate_read_stamps(stamps, b * h), "reading the stamps")
                    t = torch.tensor(list(stamps), dtype=torch.float64).reshape(b * h, 8)[:, :7]
                    cycles += (t[:, 1:] - t[:, :-1]).mean(0)
                cycles /= args.runs
                torch.cuda._sleep(20_000_000)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(200):
                    fn()
                e1.record()
                e1.synchronize()
                print(json.dumps({"card": card, "kernel": name, "cta_threads": n,
                                  "us_a_call_back_to_back": e0.elapsed_time(e1) / 200 * 1e3,
                                  "cycles": dict(zip(PHASES, cycles.tolist())),
                                  "cycles_total": float(cycles.sum())}))
    finally:
        build.load = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
