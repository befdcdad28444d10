"""The host cost that torch.profiler leaves behind, with CUPTI's teardown
off and on: ``chip_smoke.py``'s qwen3_0_6b generate (its first host-time
line), its profiled window (the step before, under and after it) and the
ample serve after it, each variant in its own process, in the order off,
on, off. Kineto reads ``TEARDOWN_CUPTI`` when torch is imported;
``chip_smoke.py`` sets it to 1 unless the environment already sets it.

Run from the root of the repo on a machine with one CUDA card:

    python3 tools/cupti_teardown_ab.py
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BODY = r'''
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
C.phase_build()
cfg = C.configs.get("qwen3_0_6b")
bs = cfg.gate.block_size
params = C.init_lm(torch.Generator(device="cuda").manual_seed(C.SEED), cfg)
toks = np.random.default_rng(C.SEED).integers(
    0, cfg.vocab_size, (C.BATCH, C.PROMPT_LEN)).astype(np.int32)
eng = C.DecodeEngine(cfg, params, max_len=-(-(C.PROMPT_LEN + C.NEW_TOKENS) // bs) * bs)
C.phase_end_to_end(eng, {"tokens": toks}, C.NEW_TOKENS, cfg.num_layers)
C.phase_profile(eng, {"tokens": toks})
del eng
torch.cuda.empty_cache()
reqs = C.serve_requests(cfg.vocab_size)
eng = C.DecodeEngine(cfg, params,
                     max_len=max(r["tokens"].size + r["max_new_tokens"] for r in reqs))
C.run_serve(eng, reqs, None, cfg.num_layers)
print(f"host after: {C.host_launch_us():.2f} µs to enqueue a tiny CUDA op")
'''


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rc = 0
    for val in ("0", "1", "0"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", BODY, ROOT], timeout=600,
                           env=dict(os.environ, TEARDOWN_CUPTI=val),
                           capture_output=True, text=True)
        rc = rc or r.returncode
        keep = [line for line in r.stdout.splitlines()
                if line.startswith(("host", "profile:", "serve (pool", "end to end"))]
        print(f"== TEARDOWN_CUPTI={val}: rc {r.returncode}, "
              f"{time.perf_counter() - t0:.1f} s")
        print("\n".join(keep) if keep else r.stderr[-3000:], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
