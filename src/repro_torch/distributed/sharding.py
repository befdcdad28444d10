"""Sharding for the serving paths, over ``torch.distributed`` (port slice).

The JAX package shards with a device mesh whose ``model`` axis carries the
KV heads of the paged pools (``paged_pool_pspecs``) or the sequence axis
of the contiguous caches (``decode_partition``); GSPMD and ``shard_map``
insert the collectives. Here a ``Shard`` built from a process group plays
that ``model`` axis: every rank is one shard, holds only its part of the
state, and the collectives are explicit calls on the group. Data-parallel
axes have no counterpart: a data-parallel replica is another engine.

The group's backend is the caller's (gloo for CPU tensors, NCCL for CUDA
ones); ``Shard.device`` is where the collectives' tensors live. Every
collective goes through the group, also at world size 1.

What is sliced, and where (each rank keeps block ``rank`` of ``world``):
  * paged pools: axis 2, the KV heads, of every 5-dim leaf
    ``[L, P, Hkv, ps, Dh]`` and 4-dim leaf ``[L, P, Hkv, Dg]`` or
    ``[L, P, Hkv, 1]`` (the int8 scale rows), allocated at
    ``local_heads`` heads (``serve.paging.init_pages(kv_heads=)``);
  * the gate weights ``wq``/``wk [Hkv, ., Dg]`` on their head axis, and
    any head-major per-step operand (``head_slice``);
  * contiguous decode caches (``decode_partition``, ``seq_shard_state``):
    rank r holds tokens ``[r*S/w, (r+1)*S/w)`` of ``[L, B, Hkv, S, Dh]``
    and the matching Kg blocks of ``[L, B, Hkv, nb, Dg]``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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

    def __repr__(self) -> str:
        return f"Shard(rank={self.rank}, world={self.world}, device={self.device})"

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
        dist.all_gather_into_tensor(out, x, group=self.group)
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
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over ranks (a new tensor)."""
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def sum_ints(self, values: Sequence[int]) -> Tuple[int, ...]:
        """Host integers summed over ranks (byte counters of per-rank state)."""
        t = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        return tuple(int(v) for v in self.all_sum(t).cpu())


def decode_partition(shard: Shard, max_len: int, block_size: int) -> Tuple[int, int]:
    """(first token, tokens) of this rank's part of a contiguous cache of
    ``max_len`` tokens: whole gate blocks, the same count on every rank."""
    if max_len % (block_size * shard.world):
        raise ValueError(f"sequence-sharded decode: max_len {max_len} is not a multiple of "
                         f"block_size {block_size} x world size {shard.world}")
    s_loc = max_len // shard.world
    return shard.rank * s_loc, s_loc


def seq_shard_state(state, shard: Shard, block_size: int):
    """A prefilled ``DecodeState`` (replicated on every rank) -> this rank's
    part along the sequence: tokens ``[tok0, tok0 + s_loc)`` of the K/V
    caches and the matching Kg blocks, as copies; lengths stay replicated."""
    tok0, s_loc = decode_partition(shard, state.k_cache.shape[3], block_size)
    nb0, nb_loc = tok0 // block_size, s_loc // block_size
    kg = state.kg_cache
    return state._replace(
        k_cache=state.k_cache.narrow(3, tok0, s_loc).clone(),
        v_cache=state.v_cache.narrow(3, tok0, s_loc).clone(),
        kg_cache=None if kg is None else kg.narrow(3, nb0, nb_loc).clone())
