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

Runs on the CUDA device unless ``--device`` names another. Under
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``) it is the port's counterpart of the
reference's ``maybe_init_distributed``: every process joins one
``torch.distributed`` group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) and trains tensor-parallel over it
(``run_training(shard=)``; the checkpoints are the full tree, written by
rank 0, which alone prints). Two CPU ranks:

    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \
        --arch qwen3_0_6b --reduced --device cpu --steps 4

Without that environment it runs one process on one device. The loop
carries the reference's fault-tolerance path: atomic async checkpoints,
restore-on-failure, deterministic data resume and a straggler watchdog
(``repro_torch.train.loop``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.config import OptimConfig, TrainConfig, reduced
from repro_torch.distributed.sharding import Shard
from repro_torch.train import loop as train_loop

_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_init_distributed(device):
    """(Shard, device) under torchrun's environment, after joining its
    group: NCCL on ``cuda:LOCAL_RANK`` unless ``device`` is ``"cpu"``
    (gloo). (None, device) without that environment."""
    if not all(k in os.environ for k in _TORCHRUN):
        return None, device
    if device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
    else:
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
        dist.init_process_group("nccl", init_method="env://")
    return Shard(), device


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
    shard, device = maybe_init_distributed(args.device)
    try:
        return _train(args, cfg, shard, device)
    finally:
        if shard is not None:
            dist.destroy_process_group()


def _train(args, cfg, shard, device):
    seq = args.seq or (512 if args.reduced else 4096)
    bsz = args.batch or (4 if args.reduced else 16)
    ckpt_dir = args.ckpt_dir or _shared_ckpt_dir(shard)
    tcfg = TrainConfig(
        mode=args.mode, seq_len=seq, global_batch=bsz, steps=args.steps,
        checkpoint_every=args.ckpt_every, checkpoint_dir=ckpt_dir, log_every=10,
        optim=OptimConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1)))
    lead = shard is None or shard.rank == 0
    say = print if lead else (lambda *a, **k: None)
    ranks = "" if shard is None else f" ranks={shard.world} (tensor-parallel)"
    say(f"train: arch={cfg.arch_id} mode={args.mode} steps={args.steps} "
        f"batch={bsz} seq={seq} device={device or 'cuda'}{ranks} ckpt_dir={ckpt_dir}")
    _, hist = train_loop.run_training(cfg, tcfg, device=device, shard=shard, log=say)
    key = "kl" if args.mode == "distill" else "ce"
    say(f"done. {key}: {hist[0][key]:.4f} -> {hist[-1][key]:.4f}")
    return hist


def _shared_ckpt_dir(shard) -> str:
    """A new directory under TMPDIR, rank 0's name on every rank."""
    path = tempfile.mkdtemp(prefix="repro_torch_ckpt_") if shard is None or shard.rank == 0 \
        else None
    if shard is None:
        return path
    box = [path]
    dist.broadcast_object_list(box, src=0, group=shard.group)
    return box[0]


if __name__ == "__main__":
    main()
