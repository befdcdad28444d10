"""Training launcher (PyTorch port of ``repro.launch.train``): gate
distillation or pretraining.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        [--mode distill|pretrain] [--steps 100] [--batch 16] [--seq 4096] \\
        [--reduced] [--device cpu] [--ckpt-dir DIR] [--ckpt-every 50]

``--mode distill`` (the default) trains the SeerAttention-R gate of a
model that has one and exits with a message for a model that has none
(falcon_mamba_7b, hubert_xlarge). ``--mode pretrain`` trains every
parameter of any config, e.g.
``--arch hubert_xlarge --mode pretrain --reduced --device cpu``.

Without ``--ckpt-dir`` the checkpoints go to a new directory under the
temporary directory (``TMPDIR``), so two runs never restore each other's
state; the directory is printed.

Runs on the CUDA device unless ``--device`` names another. One process,
one device: there is no multi-host initialisation. The loop carries the
reference's fault-tolerance path: atomic async checkpoints,
restore-on-failure, deterministic data resume and a straggler watchdog
(``repro_torch.train.loop``).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch import configs
from repro_torch.config import OptimConfig, TrainConfig, reduced
from repro_torch.train import loop as train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--mode", default="distill", choices=["distill", "pretrain"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke scale (tiny same-family config)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new directory under TMPDIR")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.mode == "distill" and not (cfg.gate.enabled and cfg.has_attention
                                       and cfg.is_decoder):
        raise SystemExit(f"{args.arch}: no gate to distill (family {cfg.family}); "
                         "use --mode pretrain")
    seq = args.seq or (512 if args.reduced else 4096)
    bsz = args.batch or (4 if args.reduced else 16)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    tcfg = TrainConfig(
        mode=args.mode, seq_len=seq, global_batch=bsz, steps=args.steps,
        checkpoint_every=args.ckpt_every, checkpoint_dir=ckpt_dir, log_every=10,
        optim=OptimConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1)))
    print(f"train: arch={cfg.arch_id} mode={args.mode} steps={args.steps} "
          f"batch={bsz} seq={seq} device={args.device or 'cuda'} ckpt_dir={ckpt_dir}")
    _, hist = train_loop.run_training(cfg, tcfg, device=args.device)
    key = "kl" if args.mode == "distill" else "ce"
    print(f"done. {key}: {hist[0][key]:.4f} -> {hist[-1][key]:.4f}")
    return hist


if __name__ == "__main__":
    main()
