"""Training loop: gate distillation and pretraining, with checkpoint/restart
fault tolerance and deterministic data resume (PyTorch port of the JAX
package's ``train/loop.py``).

Distillation trains ONLY the AttnGate parameters (paper §2.3): the gate
leaves are extracted into a flat ``{path: tensor}`` dict, gradients are
taken with respect to that dict alone, and the base model stays frozen
byte for byte (it never requires grad; the forward runs it without
autograd).

Pretraining trains the whole tree: every leaf, flattened to ``{path:
tensor}`` by ``_walk`` (``blocks/<i>/attn/wq/w``, ``units/<u>/<j>/...``,
``shared_attn/...``), is differentiated, and AdamW's moments are kept
over the same paths. A leaf the loss does not read (the gate, the audio
encoder's ``embed``) gets a zero gradient, as ``jax.value_and_grad``
gives it, and AdamW still decays it. The checkpoints hold the moments
nested like the parameters (``checkpoint_tree``), the reference's
layout.

Fault tolerance (``run_training``):
  * async checkpoints every ``checkpoint_every`` steps, published
    atomically, carrying (params, gate, optimizer state) and the data
    position;
  * on any step failure: restore the latest checkpoint, resume the data
    stream at its position, continue (bounded retries). An in-flight save
    of this process is finished first, so a failure right after a save
    restores that save;
  * a step-time watchdog logs straggler steps (> ``watchdog_factor`` x
    median).

Under a ``Shard`` (``make_train_step(shard=)``, ``run_training(shard=)``)
the training is tensor-parallel over its group (``distributed.sharding``):
every rank holds its blocks of the parameters, of the distilled gate and
of the AdamW moments, reads the same batch and gets the same loss. A
checkpoint is always the full tree in the reference's layout: every rank
gathers it, rank 0 writes it, and a restore reads it on every rank and
slices it.

Over a data axis as well (``data=``, a second ``Shard``: the reference's
``("data", "model")`` mesh, ``sharding.data_model_shards``) every data
replica takes its rows of the same global batch (``sharding.data_rows``;
the data pipeline is unchanged, so a resume stays deterministic), the
losses are the global batch's (numerators and denominators summed over
the data group; the MoE routing and its router loss global), and the
gradient is all-reduced over the data group before the update. In
pretraining the AdamW moments hold the data rank's ZeRO-1 slice of each
large leaf (``sharding.zero1_slices``, the reference's
``zero1_param_pspecs``); distillation's gate moments stay whole. Rank 0
of the world writes the full checkpoint; a restore slices both axes
again.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (Shard, check_shard, data_rows, gather_trees,
                                              param_layout, shard_params, zero1_gather,
                                              zero1_pieces, zero1_slices)
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# param partitioning (distill: train the gate only)
# ---------------------------------------------------------------------------

def _walk(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a dict / per-layer list tree, paths joined by
    '/' (``blocks/<i>/attn/gate/wq``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def is_gate_path(path: str) -> bool:
    return "/gate/" in path or path.endswith("/gate") or path.startswith("gate/")


def extract_gate(params: Any) -> Dict[str, torch.Tensor]:
    return {p: leaf for p, leaf in _walk(params) if is_gate_path(p)}


def merge_gate(params: Any, gate: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """A new tree with the leaves at the paths of ``gate`` (the gate's, or
    any ``{path: tensor}`` of ``_walk`` paths) replaced; every other leaf
    is the same tensor object."""
    if isinstance(params, dict):
        return {k: merge_gate(v, gate, f"{prefix}{k}/") for k, v in params.items()}
    if isinstance(params, list):
        return [merge_gate(v, gate, f"{prefix}{i}/") for i, v in enumerate(params)]
    return gate.get(prefix[:-1], params)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any                        # full model params, incl. the CURRENT gate
    # distill: the trainable subtree (authoritative); None in pretrain
    gate: Optional[Dict[str, torch.Tensor]]
    opt: adamw.AdamWState              # over ``gate``, or over every ``_walk`` path
    step: torch.Tensor                 # int32 scalar


def _check_mode(tcfg: TrainConfig) -> None:
    if tcfg.mode not in ("distill", "pretrain"):
        raise ValueError(f"unknown training mode {tcfg.mode!r}")


def init_train_state(gen: torch.Generator, cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """Random parameters from ``gen`` on its device and a zero AdamW state:
    over the extracted gate (distill; a model without one raises), or
    over every leaf of the tree (pretrain; ``gate`` None)."""
    _check_mode(tcfg)
    params = get_api(cfg).init_params(gen, cfg)
    step = torch.zeros((), dtype=torch.int32, device=gen.device)
    if tcfg.mode == "pretrain":
        return TrainState(params, None, adamw.init(dict(_walk(params)), tcfg.optim), step)
    gate = extract_gate(params)
    if not gate:
        raise ValueError(f"{cfg.arch_id}: distill mode but no gate params")
    return TrainState(params, gate, adamw.init(gate, tcfg.optim), step)


def _layouts(tree: Dict[str, torch.Tensor], cfg: ModelConfig, shard) -> Callable:
    """path -> the ``Layout`` of a rank's leaf of ``tree`` (a flat dict),
    for ``adamw.apply``."""
    out = {k: param_layout(k, tuple(t.shape), cfg, shard.world, local=True)
           for k, t in tree.items()}
    return out.get


def _opt_kw(tree, cfg: ModelConfig, shard, data=None, zero1=None) -> Dict[str, Any]:
    kw = {} if shard is None else {"shard": shard, "layout": _layouts(tree, cfg, shard)}
    if data is not None:
        kw.update(data=data, zero1=zero1)
    return kw


def zero1_map(params: Any, cfg: ModelConfig, shard, data) -> Dict[str, Any]:
    """path -> ``sharding.Zero1`` of every leaf of a rank's (model-local)
    parameters whose pretraining moments hold the data rank's ZeRO-1
    slice; empty without a data shard."""
    if data is None:
        return {}
    return zero1_slices(dict(_walk(params)), cfg, data, 1 if shard is None else shard.world)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, shard=None, data=None) -> Callable:
    """(state, batch) -> (state, metrics: {"loss", "kl", "lr", "grad_norm"}
    in distill mode, {"loss", the forward's metrics ("ce", and "aux" for
    the transformer), "lr", "grad_norm"} in pretrain; scalar tensors on
    the device). Under a ``shard`` (``distributed.sharding.Shard``) the
    state is this rank's (``shard_state``) and the step tensor-parallel;
    the metrics are the whole model's on every rank. Under a ``data``
    shard as well the batch is the data rank's rows (``data_rows``), the
    metrics are the global batch's and the gradient is all-reduced over
    the data group (pretraining's moments at the rank's ZeRO-1 slice)."""
    _check_mode(tcfg)
    check_shard(shard)
    check_shard(data)
    if tcfg.mode == "pretrain":
        return _pretrain_step(cfg, tcfg, shard, data)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = distill_value_and_grad(state.params, state.gate, batch, cfg,
                                                      shard, data)
        with torch.no_grad():
            gate, opt, om = adamw.apply(state.gate, grads, state.opt,
                                        tcfg.optim, **_opt_kw(state.gate, cfg, shard, data))
        return (TrainState(merge_gate(state.params, gate), gate, opt, state.step + 1),
                {"loss": loss, **metrics, **om})
    return step


def distill_value_and_grad(params: Any, gate: Dict[str, torch.Tensor], batch,
                           cfg: ModelConfig, shard=None, data=None):
    """The distillation loss of ``params`` with the gate leaves ``gate`` on
    ``batch`` and its gradient with respect to those leaves alone: (loss,
    metrics, {path: grad}); under a ``shard`` the rank's blocks, over a
    ``data`` shard the global loss and this replica's rows' gradient."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in gate.items()}
    with torch.enable_grad():
        loss, metrics = get_api(cfg).forward(merge_gate(params, leaves), batch, cfg,
                                             mode="distill", shard=shard, data=data)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


def pretrain_value_and_grad(params: Any, batch, cfg: ModelConfig, shard=None, data=None):
    """The pretraining loss of ``params`` on ``batch`` and its gradient
    with respect to every leaf: (loss, metrics, {path: grad}) over the
    ``_walk`` paths, a leaf the loss does not read holding zeros (autograd
    gives None, ``jax.value_and_grad`` zeros). Under a ``shard`` the
    parameters and the gradients are the rank's blocks; over a ``data``
    shard the loss is the global batch's and the gradient this replica's
    rows' share of it."""
    flat = dict(_walk(params))
    leaves = {k: t.detach().requires_grad_(True) for k, t in flat.items()}
    with torch.enable_grad():
        loss, metrics = get_api(cfg).forward(merge_gate(params, leaves), batch, cfg,
                                             mode="pretrain", shard=shard, data=data)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), metrics, {k: torch.zeros_like(flat[k]) if g is None else g
                                    for k, g in zip(leaves, grads)}


def _pretrain_step(cfg: ModelConfig, tcfg: TrainConfig, shard, data) -> Callable:
    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = pretrain_value_and_grad(state.params, batch, cfg, shard, data)
        flat = dict(_walk(state.params))
        zero1 = zero1_map(state.params, cfg, shard, data)
        with torch.no_grad():
            new, opt, om = adamw.apply(flat, grads, state.opt, tcfg.optim,
                                       **_opt_kw(flat, cfg, shard, data, zero1))
        return (TrainState(merge_gate(state.params, new), None, opt, state.step + 1),
                {"loss": loss, **metrics, **om})
    return step


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """The tree a checkpoint holds, {"params", "gate", "opt"}, as the
    reference's loop saves it: in pretrain the AdamW moments (and the
    error-feedback residual) nested like the parameters, in distill the
    gate's flat dicts as they are."""
    opt = state.opt
    if state.gate is None:
        nest = lambda d: None if d is None else merge_gate(state.params, d)  # noqa: E731
        opt = opt._replace(m=nest(opt.m), v=nest(opt.v), ef=nest(opt.ef))
    return {"params": state.params, "gate": state.gate, "opt": opt}


def shard_state(state: TrainState, cfg: ModelConfig, shard: Optional[Shard],
                data: Optional[Shard] = None) -> TrainState:
    """A full state -> this rank's (``sharding.shard_params`` of the
    parameters, the gate and the moments over ``shard``; pretraining's
    moments then at the ``data`` rank's ZeRO-1 slice; the counters as
    they are)."""
    params = state.params if shard is None else shard_params(state.params, cfg, shard)
    opt = state.opt
    m, v, ef = opt.m, opt.v, opt.ef
    if shard is not None:
        m, v, ef = (None if d is None else shard_params(d, cfg, shard) for d in (m, v, ef))
    if state.gate is None and data is not None:
        z = zero1_map(params, cfg, shard, data)
        m, v, ef = (zero1_pieces(t, z, data) for t in (m, v, ef))
    return TrainState(params, None if state.gate is None else extract_gate(params),
                      opt._replace(m=m, v=v, ef=ef), state.step)


def gather_state(state: TrainState, cfg: ModelConfig, shard: Optional[Shard],
                 data: Optional[Shard] = None) -> TrainState:
    """The inverse of ``shard_state`` on every rank (a collective): the
    full state, exactly."""
    opt = state.opt
    m, v, ef = opt.m, opt.v, opt.ef
    if state.gate is None and data is not None:
        z = zero1_map(state.params, cfg, shard, data)
        m, v, ef = (None if t is None else zero1_gather(t, z, data) for t in (m, v, ef))
    params = state.params
    if shard is not None:
        params, m, v, ef = gather_trees([params, m, v, ef], cfg, shard)
    return TrainState(params, None if state.gate is None else extract_gate(params),
                      opt._replace(m=m, v=v, ef=ef), state.step)


def _full_like(state: TrainState, cfg: ModelConfig, shard: Optional[Shard]) -> TrainState:
    """A rank's state with every leaf a meta tensor of its full shape (the
    ``like`` tree of a restore); a moment takes its parameter's shape,
    whatever slice of it the rank holds."""
    world = 1 if shard is None else shard.world

    def full(path, t):
        lay = param_layout(path, tuple(t.shape), cfg, world, local=True) if world > 1 \
            else None
        shape = list(t.shape)
        if lay is not None:
            shape[lay.axis] = sum(n for n, _ in lay.parts)
        return torch.empty(shape, dtype=t.dtype, device="meta")

    shapes = {p: full(p, x) for p, x in _walk(state.params)}

    def tree(t):
        if t is None:
            return None
        return merge_gate(t, {p: torch.empty(shapes[p].shape, dtype=x.dtype, device="meta")
                              for p, x in _walk(t)})
    params, opt = tree(state.params), state.opt
    return TrainState(params, None if state.gate is None else extract_gate(params),
                      opt._replace(m=tree(opt.m), v=tree(opt.v), ef=tree(opt.ef)),
                      state.step)


def state_from_checkpoint_tree(tree: Dict[str, Any], step: torch.Tensor) -> TrainState:
    """The inverse of ``checkpoint_tree``: a TrainState at ``step``."""
    opt = tree["opt"]
    if tree["gate"] is None:
        flat = lambda t: None if t is None else dict(_walk(t))  # noqa: E731
        opt = opt._replace(m=flat(opt.m), v=flat(opt.v), ef=flat(opt.ef))
    return TrainState(tree["params"], tree["gate"], opt, step)


# ---------------------------------------------------------------------------
# outer loop with fault tolerance
# ---------------------------------------------------------------------------

def run_training(cfg: ModelConfig, tcfg: TrainConfig, *,
                 steps: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 seq_len: Optional[int] = None,
                 fail_at: Optional[Callable[[int], None]] = None,
                 max_retries: int = 3,
                 watchdog_factor: float = 5.0,
                 log: Callable[[str], None] = print,
                 device=None, shard=None, data=None) -> Tuple[TrainState, List[Dict]]:
    """Returns (final state, metrics history). The parameters come from a
    torch Generator seeded with ``tcfg.seed`` on ``device`` (None = CUDA).
    ``fail_at(i)`` is called before step ``i`` (fault injection).

    ``shard`` (a ``distributed.sharding.Shard``, every rank of its group
    calling with the same arguments) trains tensor-parallel: the port's
    counterpart of the reference's multi-process run, whose processes
    ``launch.train.maybe_init_distributed`` joins into one mesh (the
    reference's ``run_training`` itself takes no mesh). Every rank
    initialises the same full state and keeps its blocks; the returned
    state is the rank's. A checkpoint is gathered on every rank and
    written by rank 0 in the unsharded layout; a failure (raised on
    every rank at the same step) restores every rank from the same
    step, after rank 0's writes are published and a barrier.

    ``data`` (a second ``Shard``, the data axis; ``sharding.
    data_model_shards`` builds both) trains data-parallel as well: each
    data rank takes its rows of every global batch (the data axis must
    divide it), the moments of a pretraining state hold its ZeRO-1
    slice, and rank 0 of the world (data rank 0, model rank 0) writes the
    checkpoints. A MoE model routes the global batch in every replica
    (``moe.moe_mlp(data=)``), whose expert buffer holds the global
    capacity: D data replicas compute D times the expert rows of one
    unsharded step (slot ranges over data, ROADMAP A2, are the fix)."""
    device = resolve_device(device)
    for grp in (shard, data):
        if grp is not None:
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            if device != grp.device:
                raise ValueError(f"run_training: device {device} is not the shard's "
                                 f"{grp.device}")
    steps = steps if steps is not None else tcfg.steps
    bsz = batch_size or tcfg.global_batch
    slen = seq_len or tcfg.seq_len
    row0, rows = data_rows(bsz, data)
    if data is not None and data.world > 1 and rows == bsz:
        raise ValueError(f"run_training: the data axis ({data.world}) does not divide the "
                         f"global batch {bsz}")
    writer = all(g is None or g.rank == 0 for g in (shard, data))
    split = shard is not None or data is not None

    def fresh() -> TrainState:
        state = init_train_state(torch.Generator(device=device).manual_seed(tcfg.seed),
                                 cfg, tcfg)
        return shard_state(state, cfg, shard, data) if split else state

    state = fresh()
    data_state = DataState(tcfg.seed, 0)
    step_fn = make_train_step(cfg, tcfg, shard, data)
    saver = ckpt.AsyncCheckpointer(tcfg.checkpoint_dir, cfg=cfg)
    history: List[Dict] = []
    retries = 0
    step_times: List[float] = []

    def save(state, data_state):
        full = gather_state(state, cfg, shard, data) if split else state
        if writer:
            saver.save(int(state.step), checkpoint_tree(full),
                       meta={"data_step": data_state.step, "seed": data_state.seed})

    def published():
        """Rank 0's writes finished, every rank past them."""
        saver.wait()
        for grp in (shard, data):        # the model group, then the data group
            if grp is not None:
                grp.barrier()

    i = int(state.step)
    while i < steps:
        try:
            batch = make_batch(cfg, bsz, slen, DataState(data_state.seed, i), device=device)
            if rows != bsz:
                batch = {k: v[row0:row0 + rows] for k, v in batch.items()}
            if fail_at is not None:
                fail_at(i)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # synchronises
            dt = time.perf_counter() - t0
            step_times.append(dt)
            med = sorted(step_times)[len(step_times) // 2]
            if len(step_times) > 4 and dt > watchdog_factor * med:
                log(f"[watchdog] straggler step {i}: {dt:.2f}s vs median {med:.2f}s")
            history.append({"step": i, **metrics})
            if tcfg.log_every and i % tcfg.log_every == 0:
                log(f"step {i}: " + " ".join(f"{k}={v:.4g}" for k, v in metrics.items()))
            i = int(state.step)
            if tcfg.checkpoint_every and i % tcfg.checkpoint_every == 0:
                save(state, DataState(data_state.seed, i))
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 - node-failure recovery path
            retries += 1
            if retries > max_retries:
                raise
            published()
            last = ckpt.latest_step(tcfg.checkpoint_dir)
            log(f"[recover] step {i} failed ({type(e).__name__}: {e}); "
                f"restoring step {last}")
            if last is None:
                state = fresh()
                i = 0
                continue
            like = _full_like(state, cfg, shard) if split else state
            tree, meta = ckpt.restore(tcfg.checkpoint_dir, last, checkpoint_tree(like),
                                      cfg=cfg, device=device)
            state = state_from_checkpoint_tree(
                tree, torch.tensor(last, dtype=torch.int32, device=device))
            if split:
                state = shard_state(state, cfg, shard, data)
            i = int(meta["data_step"])
    published()
    return state, history
