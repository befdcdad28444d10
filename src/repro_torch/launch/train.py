"""Training launcher (PyTorch port of ``repro.launch.train``): gate
distillation or pretraining.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
        [--mode distill|pretrain] [--steps 100] [--batch 16] [--seq 4096] \\
        [--reduced] [--device cpu] [--ckpt-dir DIR] [--ckpt-every 50] \\
        [--model-parallel M]

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

``--model-parallel M`` (default: the world size, so the model axis is
every rank) splits the world into a data axis of ``WORLD_SIZE / M``
replicas and a model axis of ``M`` ranks, rank ``d * M + m``, the
reference's ``("data", "model")`` mesh (``sharding.data_model_shards``):
each data replica trains on its rows of the global batch, the gradient is
all-reduced over the data axis, and pretraining holds ZeRO-1 moments
(``run_training(shard=, data=)``). An ``M`` that does not divide the
world size raises. Four CPU ranks as data 2 x model 2:

    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch qwen3_0_6b --reduced --device cpu --steps 4 --model-parallel 2

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
from repro_torch.distributed.sharding import Shard, data_model_shards
from repro_torch.train import loop as train_loop

_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def axis_sizes(world: int, model_parallel=None):
    """(data, model) axis sizes of a ``world``-rank job: the model axis
    ``model_parallel`` (default: every rank), the data axis the rest. A
    model axis that does not divide the world raises ValueError."""
    m = world if model_parallel is None else model_parallel
    if m < 1 or world % m:
        raise ValueError(f"--model-parallel {m} does not divide the world size {world}")
    return world // m, m


def maybe_init_distributed(device, model_parallel=None):
    """(model Shard, data Shard or None, device) under torchrun's
    environment, after joining its group: NCCL on ``cuda:LOCAL_RANK``
    unless ``device`` is ``"cpu"`` (gloo). The model axis is every rank
    (no data axis) unless ``model_parallel`` is smaller than the world
    size. (None, None, device) without that environment."""
    if not all(k in os.environ for k in _TORCHRUN):
        return None, None, device
    d, m = axis_sizes(int(os.environ["WORLD_SIZE"]), model_parallel)
    if device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
    else:
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
        dist.init_process_group("nccl", init_method="env://")
    if d == 1:
        return Shard(), None, device
    return data_model_shards(d, m) + (device,)


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
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="model axis size M under torchrun (default: the world size); "
                         "the data axis is WORLD_SIZE / M")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.mode == "distill" and not (cfg.gate.enabled and cfg.has_attention
                                       and cfg.is_decoder):
        raise SystemExit(f"{args.arch}: no gate to distill (family {cfg.family}); "
                         "use --mode pretrain")
    shard, data, device = maybe_init_distributed(args.device, args.model_parallel)
    try:
        return _train(args, cfg, shard, device, data)
    finally:
        if shard is not None:
            dist.destroy_process_group()


def _train(args, cfg, shard, device, data=None):
    seq = args.seq or (512 if args.reduced else 4096)
    bsz = args.batch or (4 if args.reduced else 16)
    ckpt_dir = args.ckpt_dir or _shared_ckpt_dir(shard)
    tcfg = TrainConfig(
        mode=args.mode, seq_len=seq, global_batch=bsz, steps=args.steps,
        checkpoint_every=args.ckpt_every, checkpoint_dir=ckpt_dir, log_every=10,
        optim=OptimConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1)))
    lead = all(g is None or g.rank == 0 for g in (shard, data))
    say = print if lead else (lambda *a, **k: None)
    n_data = 1 if data is None else data.world
    ranks = "" if shard is None else (f" ranks={shard.world * n_data} (data {n_data} x "
                                      f"model {shard.world})")
    say(f"train: arch={cfg.arch_id} mode={args.mode} steps={args.steps} "
        f"batch={bsz} seq={seq} device={device or 'cuda'}{ranks} ckpt_dir={ckpt_dir}")
    _, hist = train_loop.run_training(cfg, tcfg, device=device, shard=shard, data=data,
                                      log=say)
    key = "kl" if args.mode == "distill" else "ce"
    say(f"done. {key}: {hist[0][key]:.4f} -> {hist[-1][key]:.4f}")
    return hist


def _shared_ckpt_dir(shard) -> str:
    """A new directory under TMPDIR, rank 0's name on every rank."""
    path = tempfile.mkdtemp(prefix="repro_torch_ckpt_") \
        if shard is None or dist.get_rank() == 0 else None
    if shard is None:
        return path
    box = [path]
    dist.broadcast_object_list(box, src=0)
    return box[0]


if __name__ == "__main__":
    main()
