"""One rank's inputs and step for each dry-run cell, as fake tensors.

The port's counterpart of the JAX package's ``launch/specs.py``. There,
``cell_fn_and_specs`` returns a step and ``ShapeDtypeStruct`` arguments
carrying their shardings, and ``jax.jit(...).lower`` compiles the
per-device program. Here every function builds rank 0's arguments as
``FakeTensor``s, so it must run under the caller's
``torch._subclasses.fake_tensor.FakeTensorMode`` (it raises otherwise:
at full size the real tensors would not fit), and the step is the
port's own, which the caller runs once under that mode:

  * train: ``train.loop.make_train_step(cfg, tcfg, shard=)`` on the state
    of ``init_train_state`` at full size cut by ``shard_state``;
  * prefill: ``api.prefill(..., shard=)`` on the parameters cut by
    ``sharding.decode_params``, as a sharded ``DecodeEngine`` holds them:
    every leaf at the rank's block of ``param_layout`` (attention by KV
    heads, MLPs and shared experts by hidden units, routed experts,
    mixers, vocabulary), the gate whole (the audio encoder:
    ``forward(mode="pretrain")`` on the training layout,
    ``shard_params``);
  * decode: ``api.decode_step(..., shard=)`` with telemetry off (the
    reference's ``measure_sparsity=False``) on the same parameters, on
    the decode state of ``init_decode_state`` at full size, its attention
    caches cut along the sequence by ``seq_shard_state`` (as
    ``DecodeEngine.generate`` holds them after its prefill, every head)
    or, for a dense policy, at the rank's KV heads, and a recurrent
    family's state at the rank's channels or heads.

The model axis is an ``AbstractShard(0, mesh.model)`` (``None`` on a
model axis of 1: the local mesh runs the unsharded program, as
``DecodeEngine`` and ``run_training`` do without a shard); the
data-parallel axes (pod x data, one ``AbstractShard(0, D, "data")``)
divide the batch (``mesh.batch_per_rank``) and carry, as the reference's
do:
  * in training, the gradient all-reduce over the data axis, the global
    losses' sums and the MoE's global routing (its top-k ids gathered);
    in pretraining the AdamW moments at rank 0's ZeRO-1 slice
    (``sharding.zero1_slices``, the reference's ``zero1_param_pspecs``)
    and the updated parameters' all-gather; distillation's gate moments
    whole;
  * in prefill and decode, the MoE's global routing of the rows over
    data;
  * at a batch the data axes do not divide (``long_500k``, batch 1), the
    contiguous caches' sequence split over pod x data x model (an
    ``AbstractShard(0, W, "world")`` as the model shard's
    ``over_sequence``), the reference's ``decode_state_pspecs``.
The tensors live on the CPU: this build of PyTorch cannot move a fake
tensor to CUDA, and ``init_params`` places its leaves on the generator's
device. Nothing in the model code branches on the device except the
kernels' routing (``kernels/ops.py``), where a fake tensor takes the
kernel's ``*_fake`` stand-in, so the traced program is the card's.

Where the port's per-rank program differs from the reference's (each
difference is also in every dry-run record's ``notes``): the parameters
follow the port's Megatron layout (``sharding.param_layout``, ROADMAP
10c) and not ``param_pspecs``; an attention whose KV heads the model axis
does not divide stays whole on every rank (``cell_notes`` names each
such cell).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.policy import DecodeOptions, default_options
from repro_torch.distributed.sharding import (AbstractShard, attn_kv_heads, decode_params,
                                              ep_rows, ep_view, part, seq_shard_state,
                                              shard_params)
from repro_torch.launch.mesh import MeshSpec, batch_per_rank
from repro_torch.models.common import torch_dtype
from repro_torch.models.registry import get_api
from repro_torch.serve.engine import seq_sharded
from repro_torch.train import loop as train_loop

SEED = 0
DEVICE = "cpu"


def _need_fake_mode() -> None:
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise RuntimeError("launch.specs builds full-size state: call it under "
                           "torch._subclasses.fake_tensor.FakeTensorMode")


def _gen() -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(SEED)


def cell_shard(mesh: MeshSpec) -> Optional[AbstractShard]:
    """Rank 0 of the mesh's model axis, or None on a model axis of 1."""
    return None if mesh.model == 1 else AbstractShard(0, mesh.model)


def cell_data(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec
              ) -> Optional[AbstractShard]:
    """Rank 0 of the data replicas the cell's batch splits over (pod x
    data, or data alone: ``mesh.batch_per_rank``), or None where the batch
    stays whole (or one replica takes it). Under ``cfg.ep_major``, where
    the batch splits over data x model too, the data axes alone: the
    model axis's share of the rows is the EP-major view's
    (``sharding.ep_rows``)."""
    per = batch_per_rank(shape.global_batch, mesh, cfg.ep_major)
    n = shape.global_batch // per
    if cfg.ep_major and mesh.model > 1 and per * mesh.size == shape.global_batch:
        n = mesh.pod * mesh.data
    return AbstractShard(0, n, "data") if n > 1 else None


def cell_seq(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec,
             shard: Optional[AbstractShard]) -> Optional[AbstractShard]:
    """The model shard of a decode cell whose batch the data axes do not
    divide, its sequence split over the whole pod x data x model world
    (``Shard.over_sequence``); else ``shard``."""
    if (shard is None or shape.kind != "decode" or mesh.pod * mesh.data == 1
            or batch_per_rank(shape.global_batch, mesh, cfg.ep_major) != shape.global_batch):
        return shard
    return shard.over_sequence(AbstractShard(0, mesh.size, "world"))


def abstract_batch(cfg: ModelConfig, bsz: int, slen: int) -> Dict[str, torch.Tensor]:
    """A training batch of ``bsz`` rows: the keys, shapes and dtypes of
    ``data.pipeline.make_batch``, unwritten."""
    e = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=DEVICE)  # noqa: E731
    if cfg.family == "audio":
        return {"features": e(bsz, slen, cfg.n_audio_features, dtype=torch_dtype(cfg.dtype)),
                "labels": e(bsz, slen)}
    out = {"tokens": e(bsz, slen), "labels": e(bsz, slen), "segment_ids": e(bsz, slen),
           "positions": e(bsz, slen), "loss_mask": e(bsz, slen, dtype=torch.float32)}
    if cfg.family == "vlm":
        out["image_embeds"] = e(bsz, cfg.n_image_tokens, cfg.d_model,
                                dtype=torch_dtype(cfg.dtype))
    return out


def abstract_params(cfg: ModelConfig, shard: Optional[AbstractShard] = None,
                    layout: str = "decode") -> Any:
    """The full parameters of ``init_params``, cut to the rank's:
    ``decode_params`` (what a sharded engine holds) or, for ``layout``
    "train", ``shard_params``."""
    _need_fake_mode()
    params = get_api(cfg).init_params(_gen(), cfg)
    if shard is None:
        return params
    return (shard_params if layout == "train" else decode_params)(params, cfg, shard)


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                         shard: Optional[AbstractShard] = None,
                         data: Optional[AbstractShard] = None) -> train_loop.TrainState:
    """``init_train_state`` at full size, cut by ``shard_state`` (the
    pretraining moments at the ``data`` rank's ZeRO-1 slice)."""
    _need_fake_mode()
    state = train_loop.init_train_state(_gen(), cfg, tcfg)
    if shard is None and data is None:
        return state
    return train_loop.shard_state(state, cfg, shard, data)


def decode_options(cfg: ModelConfig) -> DecodeOptions:
    """The engine's default options with telemetry off."""
    return dataclasses.replace(default_options(cfg), measure_sparsity=False)


def abstract_decode_state(cfg: ModelConfig, bsz: int, max_len: int, options: DecodeOptions,
                          shard: Optional[AbstractShard] = None):
    """``init_decode_state`` at full size (a recurrent family's state at the
    rank's channels or heads), its attention caches then cut along the
    sequence where the engine's ``generate`` cuts them (every head; over
    ``shard.seq_group``), or else at the rank's KV heads, as a sharded
    prefill leaves them."""
    _need_fake_mode()
    seq = seq_sharded(cfg, options, shard)
    kw = {"shard": shard} if cfg.family in ("ssm", "hybrid") else {}
    if cfg.family != "ssm" and not seq:
        kw["kv_heads"] = attn_kv_heads(cfg, shard)
    state = get_api(cfg).init_decode_state(cfg, bsz, max_len, None, options, device=DEVICE,
                                           **kw)
    if seq:
        state = seq_shard_state(state, shard, cfg.gate.block_size)
    return state


def default_train_cfg(cfg: ModelConfig) -> TrainConfig:
    gate_on = cfg.gate.enabled and cfg.has_attention and cfg.is_decoder
    return TrainConfig(mode="distill" if gate_on else "pretrain")


def cell_notes(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec) -> List[str]:
    """What the port's per-rank program of this cell does differently from
    the reference's, and what its numbers bound."""
    notes = [f"model axis {mesh.model}: the port's Shard (tensor parallelism in the Megatron "
             "layout of ROADMAP 10c, not param_pspecs)"]
    data = cell_data(cfg, shape, mesh)
    seq = cell_seq(cfg, shape, mesh, cell_shard(mesh))
    if data is not None:
        what = {"train": "the gradient all-reduce, the global losses and the MoE routing"
                         + (", ZeRO-1 moments and the parameters' all-gather"
                            if default_train_cfg(cfg).mode == "pretrain" else ""),
                "prefill": "the MoE routing", "decode": "the MoE routing"}[shape.kind]
        notes.append(f"data axis {data.world}: each replica's rows of the batch; over it "
                     f"{what} (a dense model's prefill and decode need no data collective)")
    if mesh.size > 1:
        notes.append("collective term at NVLink's rate for every rank: a model axis past 8 "
                     "cards, and any data axis, spans NVLink domains, so it is a lower bound")
    if (shape.kind in ("prefill", "decode") and cfg.is_decoder and cfg.has_attention
            and part(cell_shard(mesh), cfg.n_kv_heads) is None and mesh.model > 1):
        notes.append(f"attention whole on every rank: the model axis ({mesh.model}) does not "
                     f"divide the {cfg.n_kv_heads} KV heads (sharding.decode_params keeps the "
                     "block whole, as training does; the reference splits its heads' columns)")
    if shape.kind == "decode":
        if seq_sharded(cfg, decode_options(cfg), cell_shard(mesh)):
            notes.append("sequence-sharded decode (serve/sharded.py): plain PyTorch, no kernel")
            if seq is not None and seq.seq is not None:
                notes.append(f"the sequence split over pod x data x model ({seq.seq.world} "
                             "ranks), as the reference's decode_state_pspecs")
        notes.append("kernel costs count every selected block valid (a full context): an "
                     "upper bound")
    return notes


def cell_fn_and_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec
                      ) -> Tuple[Callable, Tuple, Optional[AbstractShard]]:
    """(step, rank 0's arguments, the cell's model-axis AbstractShard or
    None); call ``step(*args)`` under the same FakeTensorMode."""
    fn, args, axes = cell_fn_specs_axes(cfg, shape, mesh)
    return fn, args, axes[0]


def cell_fn_specs_axes(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec
                       ) -> Tuple[Callable, Tuple, List[Optional[AbstractShard]]]:
    """(step, rank 0's arguments, [model, data, world] AbstractShards, each
    or None), every collective the step makes logged in one of them."""
    _need_fake_mode()
    api = get_api(cfg)
    shard = cell_shard(mesh)
    data = cell_data(cfg, shape, mesh)
    bsz = batch_per_rank(shape.global_batch, mesh, cfg.ep_major)
    if ep_view(shard, cfg) is not shard:        # the rows over data x model, or it raises
        ep_rows(shape.global_batch, shard, AbstractShard(0, mesh.pod * mesh.data, "data"))

    if shape.kind == "train":
        tcfg = default_train_cfg(cfg)
        step = train_loop.make_train_step(cfg, tcfg, shard=shard, data=data)
        return step, (abstract_train_state(cfg, tcfg, shard, data),
                      abstract_batch(cfg, bsz, shape.seq_len)), [shard, data, None]

    if shape.kind == "prefill":
        batch = abstract_batch(cfg, bsz, shape.seq_len)
        if not cfg.is_decoder:
            # encoder-only (hubert): "prefill" is the full encoder forward
            @torch.no_grad()
            def encoder_step(params, batch):
                return api.forward(params, batch, cfg, mode="pretrain", shard=shard)
            return encoder_step, (abstract_params(cfg, shard, "train"), batch), \
                [shard, None, None]
        batch = {k: v for k, v in batch.items() if k in ("tokens", "image_embeds")}
        options = default_options(cfg)

        @torch.no_grad()
        def prefill_step(params, batch):
            return api.prefill(params, batch, cfg, shape.seq_len, options=options,
                               shard=shard, data=data)
        return prefill_step, (abstract_params(cfg, shard), batch), [shard, data, None]

    if shape.kind == "decode":
        options = decode_options(cfg)
        step_shard = cell_seq(cfg, shape, mesh, shard)
        world = None if step_shard is None else step_shard.seq

        @torch.no_grad()
        def serve_step(params, state, token):
            return api.decode_step(params, state, token, cfg, options=options,
                                   shard=step_shard, data=data)
        token = torch.empty((bsz,), dtype=torch.int32, device=DEVICE)
        return serve_step, (abstract_params(cfg, shard),
                            abstract_decode_state(cfg, bsz, shape.seq_len, options,
                                                  step_shard),
                            token), [shard, data, world]

    raise ValueError(shape.kind)
