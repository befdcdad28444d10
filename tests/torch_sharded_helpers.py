"""Child-process bodies of tests/test_torch_sharded.py: the port's sharded
serving over a gloo process group, one process per rank.

This module imports torch, numpy and the port only: it is what the child
processes import (the test module imports JAX for the reference, and a
spawned child re-imports the module its target lives in). ``run`` is the
target of ``torch.multiprocessing.spawn``; it joins the group through a
``file://`` store, runs one task and saves the task's result to
``<out_dir>/<task>-<rank>.pt`` for the parent to check.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import DecodeOptions, DensePolicy
from repro_torch.distributed.sharding import Shard, decode_partition, seq_shard_state
from repro_torch.serve import paging as pg
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig

# a resident cap under the lists' width: evicts, faults and replays
EVICT = dict(n_slots=4, num_pages=10, eviction=EvictionConfig(max_resident_pages=2))

# name -> (DecodeOptions kwargs, serve kwargs); every engine has the shard
SERVE_CASES = {
    "fp": (dict(), dict(n_slots=2)),
    "fp-preempt": (dict(), dict(n_slots=4, num_pages=10)),
    "fp-split2": (dict(split_k=2), dict(n_slots=2)),
    "int8": (dict(quantize="int8"), dict(n_slots=2)),
    "int8-preempt": (dict(quantize="int8"), dict(n_slots=4, num_pages=10)),
    "int8-split2": (dict(quantize="int8", split_k=2), dict(n_slots=2)),
    "dense": (dict(policy=DensePolicy()), dict(n_slots=2)),
    "fp-evict": (dict(), EVICT),
    "fp-evict-split2": (dict(split_k=2), EVICT),
    "int8-evict": (dict(quantize="int8"), EVICT),
}
STATS = ("preemptions", "resumed", "decode_steps", "peak_pages_used",
         "swapped_out_bytes", "swapped_in_bytes", "sparsity_by_rid", "swap",
         "evictions", "page_restores", "replay_steps", "errors")


def _count_gathers(shard):
    """Count the shard's head and candidate gathers, the collectives that
    show a sharded path ran (an unsharded step makes none)."""
    real = shard.all_gather
    shard.gathers = 0

    def counted(x, axis):
        shard.gathers += 1
        return real(x, axis)
    shard.all_gather = counted


def run(rank, world, store, task, args, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    try:
        out = TASKS[task](Shard(), *args)
        torch.save(out, os.path.join(out_dir, f"{task}-{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _record_pools():
    """Record the shapes of every pool leaf ``serve`` allocates (None
    leaves kept), by wrapping ``paging.init_pages``."""
    shapes = []
    real = pg.init_pages

    def recording(*args, **kwargs):
        pages = real(*args, **kwargs)
        shapes.append([None if x is None else tuple(x.shape) for x in pages])
        return pages
    pg.init_pages = recording
    return shapes


def serve_cases(shard, cfg, np_params, reqs):
    """Every SERVE_CASES case on this rank: tokens, logits, stats and the
    shapes of the allocated pools per case, and the errors a world size
    that does not divide the KV heads must raise."""
    params = params_from_numpy(np_params, cfg, "cpu")
    _count_gathers(shard)
    pools = _record_pools()
    out = {}
    for name, (opt_kw, serve_kw) in SERVE_CASES.items():
        eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard,
                           options=DecodeOptions(**opt_kw))
        shard.gathers = 0
        n_alloc = len(pools)
        res = eng.serve([dict(r) for r in reqs], collect_logits=True, **serve_kw)
        out[name] = {"tokens": {r["rid"]: res[r["rid"]] for r in reqs},
                     "logits": res["logits"], "gathers": shard.gathers,
                     "pools": pools[n_alloc:],
                     "stats": {k: res["stats"][k] for k in STATS}}
    errors = []
    odd = DecodeEngine(cfg.replace(n_kv_heads=1), params, max_len=64, device="cpu",
                       shard=shard)
    for call in (lambda: odd.serve([dict(reqs[0])], n_slots=1),
                 lambda: shard.local_heads(3),
                 lambda: decode_partition(shard, 60, 8)):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def generate_teacher_forced(shard, jobs):
    """``_generate_one`` for each job of ``jobs``, in one process group."""
    _count_gathers(shard)
    return [_generate_one(shard, *job) for job in jobs]


def _generate_one(shard, cfg, np_params, prompt, tokens, max_len):
    """Sequence-sharded decode of ``prompt`` [B, L] fed the reference's
    greedy tokens (``tokens`` [n_steps + 1, B]: the prefill's, then each
    step's). Returns the prefill token, every step's logits, the caches
    gathered over ranks along the sequence, and kg_n."""
    params = params_from_numpy(np_params, cfg, "cpu")
    eng = DecodeEngine(cfg, params, max_len=max_len, device="cpu", shard=shard)
    first, state = eng.prefill({"tokens": prompt})
    full_len = state.k_cache.shape[3]           # the prefill is replicated
    state = seq_shard_state(state, shard, cfg.gate.block_size)
    assert state.k_cache.shape[3] == full_len // shard.world
    logits = []
    shard.gathers = 0
    for t in tokens[:-1]:
        _, lg, state, aux = eng._step(eng.params, state, torch.as_tensor(t))
        logits.append(lg.numpy())
    gathers = shard.gathers
    return {"first": first.numpy(), "logits": np.stack(logits), "gathers": gathers,
            "k_cache": shard.all_gather(state.k_cache, axis=3).numpy(),
            "v_cache": shard.all_gather(state.v_cache, axis=3).numpy(),
            "kg_cache": shard.all_gather(state.kg_cache, axis=3).numpy(),
            "kg_n": state.kg_n.numpy(), "sparsity": float(aux["sparsity"])}


# the MoE family's head-sharded serve (fp only): the experts replicated
MOE_CASES = ("fp", "fp-preempt")


def moe_cases(shard, cfg, np_params, reqs, gen_job):
    """MOE_CASES' serves of a MoE config on this rank (every rank computes
    all experts over all slots), then the sequence-sharded ``generate`` of
    ``gen_job`` (``_generate_one``'s arguments but the shard)."""
    params = params_from_numpy(np_params, cfg, "cpu")
    _count_gathers(shard)
    out = {}
    for name in MOE_CASES:
        opt_kw, serve_kw = SERVE_CASES[name]
        eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard,
                           options=DecodeOptions(**opt_kw))
        shard.gathers = 0
        res = eng.serve([dict(r) for r in reqs], collect_logits=True, **serve_kw)
        out[name] = {"tokens": {r["rid"]: res[r["rid"]] for r in reqs},
                     "logits": res["logits"], "gathers": shard.gathers,
                     "stats": {k: res["stats"][k] for k in STATS}}
    out["generate"] = _generate_one(shard, *gen_job)
    return out


TASKS = {"serve": serve_cases, "generate": generate_teacher_forced, "moe": moe_cases}
