"""Sharding over ``torch.distributed``: serving and training (port slice).

The JAX package shards with a device mesh whose ``model`` axis carries the
KV heads of the paged pools (``paged_pool_pspecs``) or the sequence axis
of the contiguous caches (``decode_partition``), and, in training, the
parameters by its ``param_pspecs`` rules; GSPMD and ``shard_map`` insert
the collectives. Here a ``Shard`` built from a process group plays that
``model`` axis: every rank is one shard, holds only its part of the
state, and the collectives are explicit calls on the group.

The data axis (the reference's ``("data", "model")`` mesh, or
``("pod", "data", "model")`` with pod x data as one axis) is a second
``Shard``: ``data_model_shards(D, M)`` cuts a world of ``W = D x M``
ranks, rank ``d*M + m`` (model the minor axis, as in
``jax.make_mesh((D, M), ("data", "model"))``), into the model group of
each ``d`` (the ``shard=`` of every call below, unchanged) and the data
group of each ``m`` (a new ``data=`` argument). ``data=None``, or a data
group of one rank, is the model-only program bitwise. What the data axis
carries:
  * training (``train.loop``, ``optim.adamw``): each data rank takes its
    rows of the global batch (``data_rows``, the reference's
    ``batch_pspecs`` rule); the losses are the global batch's (the masked
    means' numerators and denominators summed over the data group,
    ``reduce_from_model(x, data)``); the gradient is all-reduced over the
    data group in fp32 before the optimizer compresses, clips and
    applies it, so every replica steps on the reference's global
    gradient; in pretraining the AdamW moments (and the error-feedback
    residual) hold the rank's ZeRO-1 slice (``zero1_dim``, the
    reference's ``zero1_param_pspecs`` rule; distillation's gate moments
    stay whole, as the reference's ``P()``), the update runs on that
    slice and the parameter is all-gathered over the data group;
  * the MoE routing stays global (``models/moe.py``): the router's top-k
    ids are gathered over the data group, so the capacity and each
    assignment's rank within its expert, hence the drops, are those of
    the whole batch in one call; each replica then computes its rows;
  * ``generate`` (``serve/engine.py``): a batch that ``D`` divides is
    split by rows, each replica decoding its own; a batch it does not
    divide (batch 1) keeps every row on every replica and splits the
    contiguous caches' sequence over the whole world in rank order (the
    reference's ``dp + ("model",)`` of ``decode_partition``): the model
    shard's ``seq`` (``Shard.over_sequence``) is that world group;
  * paged ``serve``: nothing. The reference's ``paged_pool_pspecs`` puts
    nothing on the data axis, so a data replica of ``serve`` is another
    engine.

The group's backend is the caller's (gloo for CPU tensors, NCCL for CUDA
ones); ``Shard.device`` is where the collectives' tensors live. Every
collective goes through the group, also at world size 1.
``AbstractShard`` is the dry-run's ``Shard`` (``launch/specs.py``): no
group, fake tensors only, each collective logged in place of being run.

Serving. What is sliced, and where (each rank keeps block ``rank`` of
``world``):
  * paged pools: axis 2, the KV heads, of every 5-dim leaf
    ``[L, P, Hkv, ps, Dh]`` and 4-dim leaf ``[L, P, Hkv, Dg]`` or
    ``[L, P, Hkv, 1]`` (the int8 scale rows), allocated at
    ``local_heads`` heads (``serve.paging.init_pages(kv_heads=)``);
  * the gate weights ``wq``/``wk [Hkv, ., Dg]`` on their head axis, and
    any head-major per-step operand (``head_slice``);
  * contiguous decode caches (``decode_partition``, ``seq_shard_state``):
    rank r holds tokens ``[r*S/w, (r+1)*S/w)`` of ``[L, B, Hkv, S, Dh]``
    and the matching Kg blocks of ``[L, B, Hkv, nb, Dg]``;
  * the parameters (``decode_params``, ``decode_layout``): the engine
    takes the full tree and keeps the rank's block of every leaf that
    training splits (``param_layout``, below), but the gate's ``wq``/``wk``,
    which stay whole, as the reference's ``param_pspecs`` has them, and
    are head-sliced at each step. So attention runs on the rank's KV
    heads (``wq``/``wk``/``wv`` columns, ``wo`` rows, one sum after
    ``wo``), a dense MLP and a MoE block's shared experts on the rank's
    hidden units (one sum), the embedding and the logits on the rank's
    vocabulary (a sum after the lookup; the logits gathered exactly, so
    that every rank samples from the same full row). A module whose split
    size the world size does not divide stays whole, as in training
    (MQA's attention, and with it its caches and pools: the paged pools
    then raise, see ``local_heads``);
  * the prefill's caches come out at the rank's KV heads; ``generate``'s
    sequence-sharded step gathers them over the heads once, layer by
    layer, and keeps the rank's part along the sequence
    (``seq_shard_state(gather_heads=True)``); its step gathers the rank's
    new q/k/v heads (one packed gather a layer), since the sequence split
    needs every head on every rank, and applies the rank's ``wo`` rows to
    the rank's heads of the combined output;
  * the recurrent state (``state_layouts``): the per-slot state and a
    prefill's recurrent rows split as their mixer's parameters, Mamba1
    conv windows ``[L, S, K-1, di]`` and hidden states ``[L, S, di, n]``
    by channel, Mamba2 conv windows ``[L, S, K-1, di + 2n]`` in the
    ``[x | B | C]`` parts of its conv weights (x split, ``B|C`` whole) and
    hidden states ``[L, S, nh, hd, n]`` by head. The one-token steps
    (``mamba1_step``/``mamba2_step`` with ``shard=``) are the training
    split's: Mamba1 sums ``x_proj``'s output and ``out_proj``'s, Mamba2
    the gated norm's mean square and ``out_proj``'s, two ``all_sum`` a
    layer;
  * the routed experts at decode (``moe_mlp(..., gather=True)``): the
    router, the capacity and the drops replicated, each rank computes its
    ``E / w`` experts' rows and ``all_gather`` collects the
    ``[E, C, d]`` outputs exactly; the weighting and the sum over top-k
    are then the unsharded call's.
The collectives of a paged decode step: one sum for the embedding, a
layer one sum after ``wo``, one gather of the selected ids where the
telemetry or eviction's touched pages read them (a selecting or reusing
layer; the dense fallback gathers nothing), the ``unify_heads`` max of a
selecting layer, one sum for a dense MLP, and for a MoE block one expert
gather and one sum for its shared experts; two sums a Mamba layer; one
gather of the logits. A row-split ``wo`` or MLP sums its partials over
the ranks in another order than the unsharded matmul, so a sharded run
agrees with the unsharded one to fp32 rounding, as the reference's own
sharded reduce does; at world size 1 every sum is an identity and the
run is bitwise the unsharded one.

Training (``lm_forward(..., shard=)``, ``train.loop``): tensor parallelism,
Megatron-style. The batch is replicated: every rank reads the same batch,
holds block ``rank`` of each split parameter (``param_layout``,
``shard_params``) and computes the same loss. Two differentiable
collectives carry the layers: ``copy_to_model`` (forward identity,
backward sum over ranks) where a replicated tensor enters a split
computation, ``reduce_from_model`` (forward sum over ranks, backward
identity) where a split computation's partial sums leave it. A module
whose split size the world size does not divide stays replicated on every
rank and runs without collectives (the counterpart of ``sanitize_spec``'s
fallback to replication). The scheme:
  * attention: whole KV-head groups. A rank holds ``Hkv / w`` KV heads,
    their ``G`` query heads and the gate's ``wq``/``wk [Hkv, ., Dg]`` for
    them: ``wq``/``wk``/``wv`` split by columns, ``wo`` by rows, a sum
    after ``wo``. The gate KL is the global mean over (b, kv head, row):
    every rank's mean over the same number of rows, summed over ranks and
    divided by ``w``. A world size that does not divide ``Hkv`` (MQA)
    keeps the block and its gate replicated: a KV head's query group is
    never split (``gate_q`` and the ground truth's max over the group
    need all of it on one rank). The vision cross blocks split the same
    way; ``q_norm``/``k_norm`` stay replicated, their gradient summed
    over ranks;
  * dense MLP: ``wi_gate``/``wi_up`` by columns, ``wo`` by rows, a sum
    after;
  * embedding and logits by vocabulary (``embed/w`` rows, ``lm_head/w``
    columns): the lookup gives each rank's range and zeros elsewhere,
    then a sum; the cross-entropy is vocabulary-parallel
    (``vocab_parallel_nll``: the max and the sum of exponentials over
    ranks, the label's logit from the rank that owns it). A vocabulary
    that ``w`` does not divide stays replicated; so does the audio
    ``in_proj``;
  * MoE: expert parallelism. The router stays replicated: the routing,
    the capacity and each assignment's rank within its expert are
    computed alike on every rank, so the drops are the unsharded ones. A
    rank holds ``E / w`` experts and computes only their rows; a sum
    combines. The shared experts split like a dense MLP. This is the
    reference's decode-size ``moe_mlp_sharded`` scheme (rows replicated,
    each shard its experts, a psum), whatever ``dispatch`` says;
  * Mamba1: ``in_proj``'s x and z halves each split on ``d_inner``;
    ``conv_w``/``conv_b``, ``dt_proj`` (columns), ``dt_bias``, ``A_log``
    and ``D`` on ``d_inner``; ``x_proj`` by rows with a sum before the
    ``[dt | B | C]`` split; ``out_proj`` by rows with a sum after. The
    scan is per channel and runs locally;
  * Mamba2: ``z``, ``x`` and ``dt`` split by heads; ``B`` and ``C`` (one
    group) replicated with their ``in_proj`` columns and conv channels,
    whose gradients are summed over ranks (``sync_grad_parts``); the
    gated RMSNorm over all of ``d_inner`` takes its mean square over
    ranks; ``out_proj`` by rows;
  * norms and other scalars stay replicated.
A replicated leaf's gradient is the full one on every rank; a split
leaf's is the gradient of its block.

Deviations from the reference's per-leaf layout (``param_pspecs``), each
a split that computes the same function; the checkpoint layout is the
reference's, always full:
  * the gate's ``wq``/``wk`` split on their KV-head axis in training,
    where the reference replicates them (the gate runs on the rank's
    heads); serving keeps them whole, as the reference does;
  * Mamba1 ``in_proj`` split per half (the reference cuts the
    concatenated ``[x | z]`` columns in one block), Mamba2 ``in_proj``
    per part of ``[z | x | B | C | dt]`` with ``B``/``C`` replicated
    (the reference cuts it in one block), Mamba2 ``conv_w``/``conv_b``
    likewise per ``[x | B | C]``, and Mamba2 ``norm/scale`` split on
    ``d_inner`` (the reference replicates it);
  * the experts split whether or not ``ep_major`` is set; the MoE buffer
    is never resplit (no all-to-all: the rows are replicated);
  * serving's recurrent state splits with its mixer's parameters, where
    the reference's ``decode_state_pspecs`` puts the ``model`` axis on
    each state's widest trailing dim (Mamba2's conv windows whole on
    ``di + 2n``); the same function, each rank's state the rows its own
    channels and heads read and write;
  * serving combines the routed experts by an exact gather where the
    reference's ``moe_mlp_sharded`` sums over its shards.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import copy
import math

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor


class Shard:
    """One rank of the ``model`` axis: ``rank``, ``world`` and ``group``.
    ``group=None`` is the default (world) group, which must be
    initialised."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        if not dist.is_initialized():
            raise RuntimeError("Shard needs an initialised torch.distributed process "
                               "group (init_process_group)")
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        backend = str(dist.get_backend(self.group)).lower()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "nccl" else torch.device("cpu"))
        self.seq: Optional["Shard"] = None

    def __repr__(self) -> str:
        return f"Shard(rank={self.rank}, world={self.world}, device={self.device})"

    def over_sequence(self, seq: "Shard") -> "Shard":
        """A copy of this model-axis shard whose sequence-sharded decode
        splits the contiguous caches over ``seq``'s ranks (the data x model
        world of a batch the data axis does not divide) instead of its
        own; the weights, the head gathers and every other collective stay
        on this shard's group."""
        out = copy.copy(self)
        out.seq = seq
        return out

    @property
    def seq_group(self) -> "Shard":
        """The shard a sequence-sharded decode splits the caches over."""
        return self if self.seq is None else self.seq

    # -- head axis ---------------------------------------------------------

    def local_heads(self, n_kv_heads: int) -> int:
        """KV heads per rank; a world size that does not divide them raises
        (the reference's paged sharded decode does the same)."""
        if n_kv_heads % self.world:
            raise ValueError(f"sharded decode: n_kv_heads={n_kv_heads} not divisible by "
                             f"the shard's world size {self.world}")
        return n_kv_heads // self.world

    def head_slice(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``axis`` (a view)."""
        n = self.local_heads(x.shape[axis])
        return x.narrow(axis, self.rank * n, n)

    def all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``axis`` in rank order: an
        exact gather (no arithmetic), through the group at any size, into
        one buffer (a view of it at world size 1)."""
        x = x.contiguous()
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        self._all_gather_into(out, x)
        shape = x.shape[:axis] + (self.world * x.shape[axis],) + x.shape[axis + 1:]
        return out.view((self.world,) + tuple(x.shape)).movedim(0, axis).reshape(shape)

    def all_gather_packed(self, xs: Sequence[torch.Tensor], axis: int) -> List[torch.Tensor]:
        """``all_gather`` of each of ``xs`` along ``axis`` in ONE collective:
        a collective costs the host far more than a copy, so their bytes
        are packed side by side per index of the axes up to ``axis`` (every
        x has the same shape there), gathered, and unpacked. Exact."""
        lead = tuple(xs[0].shape[:axis + 1])
        raw = [x.contiguous().view(torch.uint8).reshape(lead + (-1,)) for x in xs]
        got = self.all_gather(torch.cat(raw, dim=-1), axis)
        out, at = [], 0
        for x, r in zip(xs, raw):
            n = r.shape[-1]
            shape = got.shape[:axis + 1] + x.shape[axis + 1:]
            out.append(got[..., at:at + n].contiguous().view(x.dtype).reshape(shape))
            at += n
        return out

    # -- reductions --------------------------------------------------------

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over ranks (a new tensor)."""
        y = x.contiguous().clone()
        self._all_reduce(y, dist.ReduceOp.MAX)
        return y

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over ranks (a new tensor)."""
        y = x.contiguous().clone()
        self._all_reduce(y, dist.ReduceOp.SUM)
        return y

    def all_sum_packed(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``all_sum`` of each of ``xs`` (one dtype), their elements packed
        side by side into one collective per ``_GATHER_CHUNK`` bytes;
        new tensors in ``xs``' shapes."""
        out, i = [], 0
        while i < len(xs):
            chunk, size = [], 0
            while i < len(xs) and (not chunk or size < _GATHER_CHUNK):
                chunk.append(xs[i])
                size += xs[i].numel() * xs[i].element_size()
                i += 1
            flat = self.all_sum(torch.cat([x.reshape(-1) for x in chunk]))
            at = 0
            for x in chunk:
                out.append(flat[at:at + x.numel()].view(x.shape))
                at += x.numel()
        return out

    def barrier(self) -> None:
        """Return once every rank has called it (a one-element sum, waited
        for on the host)."""
        float(self.all_sum(torch.zeros((1,), device=self.device))[0])

    def sum_ints(self, values: Sequence[int]) -> Tuple[int, ...]:
        """Host integers summed over ranks (byte counters of per-rank state)."""
        t = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        return tuple(int(v) for v in self.all_sum(t).cpu())

    # -- the two collectives every method above reaches ---------------------

    def _all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        dist.all_gather_into_tensor(out, x, group=self.group)

    def _all_reduce(self, y: torch.Tensor, op) -> None:
        dist.all_reduce(y, op=op, group=self.group)


class Collective(NamedTuple):
    """One collective an ``AbstractShard`` stood in for: its kind (the
    reference dry-run's names, "all-gather" or "all-reduce"), the shape of
    the rank's operand and the operand's bytes."""
    kind: str
    shape: Tuple[int, ...]
    nbytes: int


class AbstractShard(Shard):
    """Rank ``rank`` of a ``world``-rank model axis with no process group:
    the dry-run's ``Shard`` (``launch/specs.py``). It runs every local op
    of ``Shard``'s methods (the copies, the clones, the moves of the
    gathered axis), so a step's tensors and their shapes are the real
    rank's, and in place of each collective it appends a ``Collective``
    to ``log``: an all-gather's result is left unwritten, a reduction's is
    the rank's own operand. Its results have the right shapes and no
    meaning, so it takes only ``FakeTensor``s, and raises on any other
    tensor: it never stands in for a real group. ``sum_ints`` returns
    ``world`` times the rank's values (every rank alike) and ``barrier``
    returns at once; each logs its all-reduce. ``axis`` names the mesh
    axis it stands for ("model", "data", or "world" for the sequence
    group of a batch-1 decode), which the dry-run reads to rate its
    collectives."""

    def __init__(self, rank: int, world: int, axis: str = "model"):
        if not 0 <= rank < world:
            raise ValueError(f"AbstractShard: rank {rank} of world size {world}")
        self.group = None
        self.rank, self.world, self.axis = rank, world, axis
        self.device = torch.device("cpu")
        self.seq = None
        self.log: List[Collective] = []

    def __repr__(self) -> str:
        return f"AbstractShard(rank={self.rank}, world={self.world}, axis={self.axis!r})"

    def _record(self, kind: str, x: torch.Tensor) -> None:
        if not isinstance(x, FakeTensor):
            raise TypeError(f"AbstractShard takes FakeTensors only (a shape-only stand-in "
                            f"for a process group), got a real {x.device} tensor of shape "
                            f"{tuple(x.shape)}")
        self.log.append(Collective(kind, tuple(x.shape), x.numel() * x.element_size()))

    def _all_gather_into(self, out: torch.Tensor, x: torch.Tensor) -> None:
        self._record("all-gather", x)

    def _all_reduce(self, y: torch.Tensor, op) -> None:
        self._record("all-reduce", y)

    def barrier(self) -> None:
        self._record("all-reduce", torch.zeros((1,), device=self.device))

    def sum_ints(self, values: Sequence[int]) -> Tuple[int, ...]:
        self._record("all-reduce", torch.zeros((len(values),), dtype=torch.int64,
                                               device=self.device))
        return tuple(int(v) * self.world for v in values)


def decode_partition(shard: Shard, max_len: int, block_size: int) -> Tuple[int, int]:
    """(first token, tokens) of this rank's part of a contiguous cache of
    ``max_len`` tokens: whole gate blocks, the same count on every rank."""
    if max_len % (block_size * shard.world):
        raise ValueError(f"sequence-sharded decode: max_len {max_len} is not a multiple of "
                         f"block_size {block_size} x world size {shard.world}")
    s_loc = max_len // shard.world
    return shard.rank * s_loc, s_loc


def seq_shard_state(state, shard: Shard, block_size: int, *, gather_heads: bool = False):
    """A prefilled decode state -> this rank's part along the sequence:
    tokens ``[tok0, tok0 + s_loc)`` of the K/V caches and the matching Kg
    blocks, as copies; lengths and any other cache stay as they are. With
    ``gather_heads`` the caches hold the rank's KV heads (a sharded
    engine's prefill, whose attention splits): each layer's K, V and Kg
    heads are first gathered over the ranks, in one collective a layer,
    and the rank's part holds every head. The sequence is cut over
    ``shard.seq_group`` (the shard itself, or the data x model world of
    ``Shard.over_sequence``); the heads are gathered over ``shard``."""
    tok0, s_loc = decode_partition(shard.seq_group, state.k_cache.shape[3], block_size)
    nb0, nb_loc = tok0 // block_size, s_loc // block_size
    kg = state.kg_cache
    if not gather_heads:
        return state._replace(
            k_cache=state.k_cache.narrow(3, tok0, s_loc).clone(),
            v_cache=state.v_cache.narrow(3, tok0, s_loc).clone(),
            kg_cache=None if kg is None else kg.narrow(3, nb0, nb_loc).clone())
    caches = [state.k_cache, state.v_cache] + ([] if kg is None else [kg])
    cuts = [(tok0, s_loc), (tok0, s_loc), (nb0, nb_loc)]
    out = [c.new_empty(c.shape[:2] + (c.shape[2] * shard.world, n) + c.shape[4:])
           for c, (_, n) in zip(caches, cuts)]
    for i in range(state.k_cache.shape[0]):
        full = shard.all_gather_packed([c[i] for c in caches], 1)
        for o, f, (at, n) in zip(out, full, cuts):
            o[i] = f.narrow(2, at, n)
        del full
    return state._replace(k_cache=out[0], v_cache=out[1],
                          kg_cache=None if kg is None else out[2])


def attn_kv_heads(cfg, shard: Optional[Shard]) -> int:
    """The KV heads a sharded engine's attention holds on a rank: its block
    where the world size divides them, all of them otherwise (the block
    stays whole) or without a shard."""
    n = cfg.n_kv_heads
    return n // shard.world if part(shard, n) is not None else n


# ---------------------------------------------------------------------------
# training: the parameters' layout
# ---------------------------------------------------------------------------

class Layout(NamedTuple):
    """How a leaf splits: along ``axis``, which is the concatenation of
    ``parts``, each (full size, split?). A rank's leaf holds, part by
    part, its block of each split part and the whole of each replicated
    one."""
    axis: int
    parts: Tuple[Tuple[int, bool], ...]

    def local_parts(self, world: int) -> Tuple[Tuple[int, bool], ...]:
        return tuple((n // world if split else n, split) for n, split in self.parts)

    def replicated_slices(self, world: int) -> List[Tuple[int, int]]:
        """(offset, size) of each replicated part along ``axis`` of a rank's
        leaf."""
        out, at = [], 0
        for n, split in self.local_parts(world):
            if not split:
                out.append((at, n))
            at += n
        return out


def check_shard(shard) -> None:
    """A training shard is a ``Shard`` or None."""
    if shard is not None and not isinstance(shard, Shard):
        raise TypeError(f"shard must be a repro_torch.distributed.sharding.Shard, "
                        f"got {type(shard).__name__}")


def part(shard: Optional[Shard], n: int) -> Optional[Shard]:
    """``shard`` where its world size divides ``n`` (the module of size
    ``n`` splits), else None (it stays replicated and runs alone)."""
    return shard if shard is not None and n % shard.world == 0 else None


def _mlp_rule(leaf: str, d_ff: int, world: int):
    if d_ff % world:
        return None
    return {"wi_gate/w": (1, None), "wi_up/w": (1, None), "wo/w": (0, None)}.get(leaf)


def _mixer_rule(leaf: str, cfg, world: int):
    if cfg.family == "ssm":                         # Mamba1
        di = cfg.ssm.expand * cfg.d_model
        if di % world:
            return None
        return {"in_proj/w": (1, ((di, True), (di, True))), "conv_w": (1, None),
                "conv_b": (0, None), "x_proj/w": (0, None), "dt_proj/w": (1, None),
                "dt_bias": (0, None), "A_log": (0, None), "D": (0, None),
                "out_proj/w": (0, None)}.get(leaf)
    from repro_torch.models.mamba import _m2_dims   # Mamba2: [z | x | B | C | dt]
    di, _, nh, n = _m2_dims(cfg)
    if nh % world:
        return None
    xbc = ((di, True), (2 * n, False))
    return {"in_proj/w": (1, ((di, True), (di, True), (2 * n, False), (nh, True))),
            "conv_w": (1, xbc), "conv_b": (0, xbc), "A_log": (0, None),
            "dt_bias": (0, None), "D": (0, None), "norm/scale": (0, None),
            "out_proj/w": (0, None)}.get(leaf)


def _leaf_rule(path: str, cfg, world: int):
    """(axis, parts or None for one split part) of a leaf, or None."""
    if path == "embed/w":
        return (0, None) if cfg.vocab_size % world == 0 else None
    if path == "lm_head/w":
        return (1, None) if cfg.vocab_size % world == 0 else None
    if "/mixer/" in path:
        return _mixer_rule(path.split("/mixer/", 1)[1], cfg, world)
    if "/attn/" in path:                    # self, cross and the hybrid's shared block
        if cfg.n_kv_heads % world:
            return None
        return {"wq/w": (1, None), "wk/w": (1, None), "wv/w": (1, None),
                "wo/w": (0, None), "gate/wq": (0, None),
                "gate/wk": (0, None)}.get(path.split("/attn/", 1)[1])
    if "/moe/" in path:
        leaf = path.split("/moe/", 1)[1]
        if leaf in ("wi_gate", "wi_up", "wo"):
            return (0, None) if cfg.moe.n_experts % world == 0 else None
        if leaf.startswith("shared/"):
            return _mlp_rule(leaf[len("shared/"):],
                             cfg.moe.n_shared_experts * cfg.moe.expert_d_ff, world)
        return None                         # the router
    if "/mlp/" in path:
        return _mlp_rule(path.split("/mlp/", 1)[1], cfg.d_ff, world)
    return None                             # norms, scalars, the audio in_proj


def param_layout(path: str, shape: Sequence[int], cfg, world: int, *,
                 local: bool = False) -> Optional[Layout]:
    """The ``Layout`` of the leaf at ``path`` (the port's ``/``-joined path
    of a per-layer leaf: ``blocks/<i>/attn/wq/w``, ``units/<u>/<j>/mixer/
    in_proj/w``; the moments and the gate dict use the same paths) of FULL
    ``shape`` under ``world`` ranks, or of a rank's ``shape`` with
    ``local``; None where it is replicated. The port's own copy of the
    reference's ``_base_param_rule`` and ``sanitize_spec`` for the scheme
    in this module's docstring; the port's leaves are per layer, so no
    stack depth is stripped."""
    rule = _leaf_rule(path, cfg, world)
    if rule is None:
        return None
    axis, parts = rule
    if parts is None:
        parts = ((shape[axis] * world if local else shape[axis], True),)
    return Layout(axis, parts)


def _walk(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _map_paths(tree: Any, fn, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix[:-1], tree)


def local_block(t: torch.Tensor, layout: Layout, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s part of the full leaf ``t``, a new contiguous tensor."""
    pieces, at = [], 0
    for n, split in layout.parts:
        m = n // world if split else n
        pieces.append(t.narrow(layout.axis, at + (rank * m if split else 0), m))
        at += n
    if len(pieces) == 1:
        return pieces[0].clone(memory_format=torch.contiguous_format)
    return torch.cat(pieces, layout.axis)


def shard_params(tree: Any, cfg, shard: Shard) -> Any:
    """A full tree (the parameters, or a ``{path: tensor}`` dict of the
    gate or of moments) -> this rank's: each split leaf its block (a new
    tensor), each replicated leaf the same tensor."""
    def one(path, t):
        lay = param_layout(path, tuple(t.shape), cfg, shard.world)
        return t if lay is None else local_block(t, lay, shard.rank, shard.world)
    return _map_paths(tree, one)


# ---------------------------------------------------------------------------
# serving: the decode-side cut of the parameters and the recurrent state
# ---------------------------------------------------------------------------

_WHOLE_IN_SERVING = ("/gate/wq", "/gate/wk")


def decode_layout(path: str, shape: Sequence[int], cfg, world: int) -> Optional[Layout]:
    """The ``Layout`` a sharded engine cuts the leaf at ``path`` (FULL
    ``shape``) by: training's (``param_layout``), but None (whole) for the
    gate's ``wq``/``wk``, as the reference's ``param_pspecs`` replicates
    them."""
    if path.endswith(_WHOLE_IN_SERVING):
        return None
    return param_layout(path, shape, cfg, world)


def decode_params(tree: Any, cfg, shard: Shard) -> Any:
    """A full parameter tree -> the tree a sharded engine serves with: the
    rank's block of every leaf ``decode_layout`` splits (new tensors),
    every other leaf the same tensor. At world size 1 a block is the whole
    leaf, and the same tensor is kept."""
    def one(path, t):
        lay = decode_layout(path, tuple(t.shape), cfg, shard.world)
        if lay is None or shard.world == 1:
            return t
        return local_block(t, lay, shard.rank, shard.world)
    return _map_paths(tree, one)


def state_layouts(cfg, world: int) -> Tuple[Optional[Layout], Optional[Layout]]:
    """(conv, h) ``Layout``s of a recurrent family's per-layer state, slot
    or batch axis at 1: the conv windows ``[L, S, K-1, d_conv]`` on axis
    3, the hidden states on axis 2 (Mamba1 ``[L, S, di, n]``, Mamba2
    ``[L, S, nh, hd, n]``), split as the mixer's parameters are: Mamba1 by
    channel, Mamba2 by head with the conv windows' ``B|C`` columns whole.
    (None, None) for a family without one, or where the world size does
    not divide the mixer (it stays replicated)."""
    if cfg.family == "ssm":
        di = cfg.ssm.expand * cfg.d_model
        if di % world:
            return None, None
        return Layout(3, ((di, True),)), Layout(2, ((di, True),))
    if cfg.family == "hybrid":
        from repro_torch.models.mamba import _m2_dims
        di, _, nh, n = _m2_dims(cfg)
        if nh % world:
            return None, None
        return Layout(3, ((di, True), (2 * n, False))), Layout(2, ((nh, True),))
    return None, None


def local_shape(shape: Sequence[int], layout: Optional[Layout], world: int) -> Tuple[int, ...]:
    """A full ``shape`` cut to a rank's along ``layout`` (unchanged for None)."""
    shape = tuple(shape)
    if layout is None:
        return shape
    n = sum(m for m, _ in layout.local_parts(world))
    return shape[:layout.axis] + (n,) + shape[layout.axis + 1:]


def replicated_state_bytes(cfg, world: int, state) -> int:
    """Bytes of one request's recurrent rows (``state`` a rank's slot state
    ``(conv, h)``) that every rank of ``world`` holds whole: Mamba2's
    ``B|C`` conv columns, or all of them where the world size does not
    divide the mixer. A sum over the ranks counts them ``world`` times,
    the unsharded engine once."""
    conv_l, _ = state_layouts(cfg, world)
    if conv_l is None:
        return sum(t[:, 0].numel() * t.element_size() for t in state)
    conv = state[0]
    cols = sum(n for _, n in conv_l.replicated_slices(world))
    return conv.shape[0] * conv.shape[2] * cols * conv.element_size()


_GATHER_CHUNK = 1 << 30           # bytes of local leaves per collective
_ALIGN = 16


def gather_trees(trees: Sequence[Any], cfg, shard: Shard) -> List[Any]:
    """The inverse of ``shard_params`` on every rank, for each of ``trees``
    (None stays None): the full trees, exactly. The split leaves' bytes
    are gathered, packed into one collective per ``_GATHER_CHUNK`` bytes,
    and put back in place; the replicated leaves are this rank's
    tensors."""
    split = [(i, path, t, param_layout(path, tuple(t.shape), cfg, shard.world, local=True))
             for i, tree in enumerate(trees) for path, t in _walk(tree)]
    split = [((i, path), t, lay) for i, path, t, lay in split if lay is not None]
    full: Dict[Tuple[int, str], torch.Tensor] = {}
    i = 0
    while i < len(split):
        chunk, size = [], 0
        while i < len(split) and (not chunk or size < _GATHER_CHUNK):
            path, t, lay = split[i]
            nb = t.numel() * t.element_size()
            chunk.append((path, t, lay, size, nb))
            size += -(-nb // _ALIGN) * _ALIGN
            i += 1
        buf = torch.zeros(size, dtype=torch.uint8, device=chunk[0][1].device)
        for _, t, _, at, nb in chunk:
            buf[at:at + nb] = t.contiguous().reshape(-1).view(torch.uint8)
        got = shard.all_gather(buf[None], 0)                       # [world, size]
        for path, t, lay, at, nb in chunk:
            blocks = [got[r, at:at + nb].clone().view(t.dtype).reshape(t.shape)
                      for r in range(shard.world)]
            pieces, off = [], 0
            for n, is_split in lay.local_parts(shard.world):
                if is_split:
                    pieces += [b.narrow(lay.axis, off, n) for b in blocks]
                else:
                    pieces.append(t.narrow(lay.axis, off, n))
                off += n
            full[path] = torch.cat(pieces, lay.axis)
        del got, buf
    return [_map_paths(tree, lambda path, t, i=i: full.get((i, path), t))
            for i, tree in enumerate(trees)]


# ---------------------------------------------------------------------------
# the data axis: the two groups, the rows, ZeRO-1
# ---------------------------------------------------------------------------

def check_nccl_cards(world: int, backend: str) -> None:
    """NCCL runs one rank a card: a group of ``world`` NCCL ranks on a host
    with fewer visible cards raises (two ranks never share a card, and
    nothing falls back to gloo)."""
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks need {world} cards, "
                         f"{torch.cuda.device_count()} visible: NCCL runs one rank a card")


def data_model_shards(data_world: int, model_world: int) -> Tuple[Shard, Shard]:
    """(model shard, data shard) of this rank on a world of ``data_world x
    model_world`` ranks (the initialised default group's), rank ``d *
    model_world + m``: the model group of its ``d`` (ranks ``d*M ..
    d*M + M - 1``) and the data group of its ``m`` (ranks ``m, M + m,
    ...``). Every group is built on every rank in the same order
    (``dist.new_group`` is collective); the backend is the default
    group's."""
    if not dist.is_initialized():
        raise RuntimeError("data_model_shards needs an initialised torch.distributed "
                           "process group (init_process_group)")
    world = dist.get_world_size()
    if data_world < 1 or model_world < 1 or data_world * model_world != world:
        raise ValueError(f"data {data_world} x model {model_world} != world size {world}")
    check_nccl_cards(world, str(dist.get_backend()).lower())
    d, m = divmod(dist.get_rank(), model_world)
    model = data = None
    for dd in range(data_world):
        g = dist.new_group([dd * model_world + mm for mm in range(model_world)])
        if dd == d:
            model = Shard(g)
    for mm in range(model_world):
        g = dist.new_group([dd * model_world + mm for dd in range(data_world)])
        if mm == m:
            data = Shard(g)
    return model, data


def replica_rows(batch_size: int, world: int) -> int:
    """The rows of a ``batch_size`` batch on each of ``world`` data
    replicas: ``batch_size / world`` where ``world`` divides it, else the
    whole batch (the reference's ``batch_pspecs``: the batch dim
    replicated where the data axes do not divide it)."""
    return batch_size // world if batch_size % world == 0 else batch_size


def data_rows(global_batch: int, data: Optional[Shard]) -> Tuple[int, int]:
    """(first row, rows) of data rank ``data.rank``'s share of a
    ``global_batch`` batch: rows ``[d*B/D, (d+1)*B/D)`` where ``D``
    divides ``B``, else every row (and without a data shard)."""
    if data is None:
        return 0, global_batch
    n = replica_rows(global_batch, data.world)
    return (data.rank * n, n) if n * data.world == global_batch else (0, global_batch)


ZERO1_MIN_SIZE = 1 << 16          # the reference's "skip tiny leaves"


def stack_position(path: str, cfg) -> Tuple[Tuple[int, int], ...]:
    """((index, size), ...) of the per-layer leaf at ``path`` along the
    reference's leading layer-stack dims (its ``_stack_depth``): ``blocks``
    [L] (a vision model's [n_units, n_self], the port's self layers
    unit-major), ``cross_blocks`` [n_units], the hybrid's ``units``
    [n_units, period] and ``tail`` [n_tail]; () for any other leaf."""
    parts = path.split("/")
    top = parts[0]
    if top == "units":
        period = cfg.hybrid_period
        return ((int(parts[1]), cfg.num_layers // period), (int(parts[2]), period))
    if top == "tail":
        return ((int(parts[1]), cfg.num_layers % cfg.hybrid_period),)
    if top in ("blocks", "cross_blocks") and cfg.cross_attn_period:
        n_units, n_self = cfg.num_layers // cfg.cross_attn_period, cfg.cross_attn_period - 1
        i = int(parts[1])
        if top == "cross_blocks":
            return ((i, n_units),)
        return ((i // n_self, n_units), (i % n_self, n_self))
    if top == "blocks":
        return ((int(parts[1]), cfg.num_layers),)
    return ()


def zero1_dim(path: str, local_shape: Sequence[int], cfg, data_world: int,
              model_world: int = 1) -> Optional[int]:
    """The reference's ``zero1_param_pspecs`` choice for the leaf at
    ``path`` (a rank's ``local_shape`` under ``model_world`` model ranks):
    the dim of the REFERENCE's stacked leaf (its layer-stack dims first,
    ``stack_position``) that ZeRO-1 splits over ``data_world`` data ranks,
    or None. None for a leaf whose global stacked size is under
    ``ZERO1_MIN_SIZE``; otherwise the first dim that the model axis does
    not split (``param_layout``'s axis) and that ``data_world`` divides,
    as the reference takes the first dim its ``param_pspecs`` leaves
    unsharded. None for every leaf of a one-rank data group, which
    slices nothing."""
    if data_world == 1:
        return None
    lay = (param_layout(path, tuple(local_shape), cfg, model_world, local=True)
           if model_world > 1 else None)
    full = list(local_shape)
    if lay is not None:
        full[lay.axis] = sum(n for n, _ in lay.parts)
    stack = stack_position(path, cfg)
    gshape = [n for _, n in stack] + full
    if math.prod(gshape) < ZERO1_MIN_SIZE:
        return None
    split = None if lay is None else len(stack) + lay.axis
    for i, n in enumerate(gshape):
        if i != split and n % data_world == 0 and n >= data_world:
            return i
    return None


class Zero1(NamedTuple):
    """Every data rank's ZeRO-1 slice of a rank's (model-local) leaf:
    ``bounds[r]`` is (start, size) of data rank r's along ``axis``. A
    split of one of the leaf's dims gives each rank an equal block; a
    split of the reference's layer-stack dim gives the layer's owner the
    whole leaf and every other rank none of it (size 0)."""
    axis: int
    bounds: Tuple[Tuple[int, int], ...]

    def piece(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        start, n = self.bounds[rank]
        return t.narrow(self.axis, start, n)


def zero1_slice(path: str, local_shape: Sequence[int], cfg, data_world: int,
                model_world: int = 1) -> Optional[Zero1]:
    """The ``Zero1`` of the leaf at ``path`` (``zero1_dim``'s choice on
    the port's per-layer leaf), or None where ZeRO-1 leaves it whole."""
    dim = zero1_dim(path, local_shape, cfg, data_world, model_world)
    if dim is None:
        return None
    stack = stack_position(path, cfg)
    if dim >= len(stack):
        axis = dim - len(stack)
        n = local_shape[axis] // data_world
        return Zero1(axis, tuple((r * n, n) for r in range(data_world)))
    idx, size = stack[dim]
    owner = idx // (size // data_world)
    whole = local_shape[0]
    return Zero1(0, tuple((0, whole if r == owner else 0) for r in range(data_world)))


def zero1_slices(tree: Dict[str, torch.Tensor], cfg, data: Shard,
                 model_world: int = 1) -> Dict[str, Zero1]:
    """path -> ``Zero1`` of each leaf of a flat ``{path: tensor}`` tree of
    a rank's (model-local, unsliced) leaves that ZeRO-1 splits."""
    out = {}
    for k, t in tree.items():
        z = zero1_slice(k, tuple(t.shape), cfg, data.world, model_world)
        if z is not None:
            out[k] = z
    return out


def zero1_pieces(tree: Optional[Dict[str, torch.Tensor]], slices: Dict[str, Zero1],
                 data: Shard) -> Optional[Dict[str, torch.Tensor]]:
    """A flat tree -> this data rank's ZeRO-1 pieces of the leaves in
    ``slices`` (new tensors), every other leaf the same tensor."""
    if tree is None:
        return None
    return {k: slices[k].piece(t, data.rank).clone() if k in slices else t
            for k, t in tree.items()}


def zero1_gather(pieces: Dict[str, torch.Tensor], slices: Dict[str, Zero1],
                 data: Shard) -> Dict[str, torch.Tensor]:
    """The inverse of ``zero1_pieces`` on every data rank (a collective
    over the data group): each sliced leaf whole, exactly. Every rank's
    pieces are packed as bytes, one collective per ``_GATHER_CHUNK``
    bytes (a chunk padded to its largest rank's share), and put back in
    rank order along the slice's axis; the other leaves are this rank's
    tensors. A chunk ends on every rank at the same key: its size counts
    each leaf at its largest rank's share, since a split of the layer
    stack gives the owner the whole leaf and the other ranks nothing."""
    keys = [k for k in pieces if k in slices]
    out = dict(pieces)

    def shape_of(k, r):
        t, z = pieces[k], slices[k]
        return t.shape[:z.axis] + (z.bounds[r][1],) + t.shape[z.axis + 1:]

    def nbytes(k, r):
        return math.prod(shape_of(k, r)) * pieces[k].element_size()

    def aligned(n):
        return -(-n // _ALIGN) * _ALIGN

    i = 0
    while i < len(keys):
        chunk, size = [], 0
        while i < len(keys) and (not chunk or size < _GATHER_CHUNK):
            chunk.append(keys[i])
            size += max(aligned(nbytes(keys[i], r)) for r in range(data.world))
            i += 1
        width = max(sum(aligned(nbytes(k, r)) for k in chunk) for r in range(data.world))
        buf = torch.zeros(max(width, _ALIGN), dtype=torch.uint8,
                          device=pieces[chunk[0]].device)
        at = 0
        for k in chunk:
            n = nbytes(k, data.rank)
            buf[at:at + n] = pieces[k].contiguous().reshape(-1).view(torch.uint8)
            at += aligned(n)
        got = data.all_gather(buf[None], 0)                      # [world, width]
        offs = [0] * data.world
        for k in chunk:
            parts = []
            for r in range(data.world):
                n = nbytes(k, r)
                parts.append(got[r, offs[r]:offs[r] + n].clone().view(pieces[k].dtype)
                             .reshape(shape_of(k, r)))
                offs[r] += aligned(n)
            out[k] = torch.cat(parts, slices[k].axis)
        del got, buf
    return out


# ---------------------------------------------------------------------------
# training: the differentiable collectives
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return shard.all_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """Where a replicated tensor enters a split computation: forward the
    identity, backward the sum over ranks of the gradient (each rank's
    part of it). Identity without a shard."""
    return x if shard is None else _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """Where a split computation's partial sums leave it: forward the sum
    over ranks, backward the identity (every rank's loss is the same, so
    ``torch.distributed.nn``'s all_reduce, whose backward sums again,
    would multiply the gradient by the world size). Identity without a
    shard."""
    return x if shard is None else _ReduceFromModel.apply(x, shard)


class _SyncGradParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, shard, axis, slices):
        ctx.shard, ctx.axis, ctx.slices = shard, axis, slices
        return w

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        parts = [g.narrow(ctx.axis, at, n) for at, n in ctx.slices]
        summed = ctx.shard.all_sum(torch.cat([p.reshape(-1) for p in parts]))
        at = 0
        for p in parts:
            p.copy_(summed[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return g, None, None, None


def sync_grad_parts(w: torch.Tensor, shard: Optional[Shard], axis: int,
                    slices: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """A split leaf with replicated parts (the Mamba2 ``B``/``C`` columns):
    forward the identity, backward the gradient with the ``(offset, size)``
    slices along ``axis`` summed over ranks (each rank's heads read them)."""
    return w if shard is None else _SyncGradParts.apply(w, shard, axis, tuple(slices))


def vocab_parallel_embed(w: torch.Tensor, tokens: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Rows ``tokens`` of the full table whose block rank ``shard.rank``'s
    ``w`` [V / world, d] holds: this rank's rows where the token is in its
    range, zeros elsewhere, summed over ranks."""
    v = w.shape[0]
    t = tokens.long() - shard.rank * v
    mine = (t >= 0) & (t < v)
    x = torch.where(mine[..., None], w[t.clamp(0, v - 1)], 0)
    return reduce_from_model(x, shard)


class _VocabParallelNLL(torch.autograd.Function):
    """The negative log-likelihood of ``labels`` under logits split by
    vocabulary, with ``torch.logsumexp``'s and ``torch.gather``'s own
    arithmetic and backward (so a one-rank group is the unsharded loss and
    gradient bitwise): the max and the sum of exponentials over ranks,
    the label's logit from the rank that owns it."""

    @staticmethod
    def forward(ctx, logits, labels, shard):
        lf = logits.float()
        v = lf.shape[-1]
        t = labels.long() - shard.rank * v
        mine = (t >= 0) & (t < v)
        t = t.clamp(0, v - 1)
        m = shard.all_max(torch.amax(lf, dim=-1))
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = torch.sum(torch.exp(lf - m[..., None]), dim=-1)
        ll = torch.where(mine, torch.gather(lf, -1, t[..., None])[..., 0], 0)
        s, ll = shard.all_sum(torch.stack([s, ll])).unbind(0)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse, t, mine)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, lse, t, mine = ctx.saved_tensors
        grad = g[..., None] * (logits.float() - lse[..., None]).exp()
        hot = torch.zeros_like(grad).scatter_add_(-1, t[..., None],
                                                  torch.where(mine, -g, 0)[..., None])
        return (grad + hot).to(logits.dtype), None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       shard: Shard) -> torch.Tensor:
    """logits [..., V / world] (this rank's vocabulary block) -> the fp32
    NLL [...] of ``labels`` over the full vocabulary, on every rank."""
    return _VocabParallelNLL.apply(logits, labels, shard)
