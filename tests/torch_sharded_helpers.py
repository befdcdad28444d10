"""Child-process bodies of tests/test_torch_sharded.py,
tests/test_torch_sharded_options.py, tests/test_torch_train_sharded.py,
tests/test_torch_sharded_recurrent.py and tests/test_torch_data_parallel.py:
the port's sharded serving and training over a gloo process group, one
process per rank.

This module imports torch, numpy and the port only: it is what the child
processes import (the test module imports JAX for the reference, and a
spawned child re-imports the module its target lives in). ``run`` is the
target of ``torch.multiprocessing.spawn``; it joins the group through a
``file://`` store, runs one task and saves the task's result to
``<out_dir>/<task>-<rank>.pt`` for the parent to check.
"""
import contextlib
import dataclasses
import faulthandler
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.core.policy import DecodeOptions, DensePolicy, SelectionSchedule
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Shard, data_model_shards, data_rows,
                                              decode_partition, gather_trees, shard_params,
                                              zero1_gather, zero1_pieces, zero1_slices)
from repro_torch.models import moe as moe_mod
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw
from repro_torch.serve import paging as pg
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig
from repro_torch.serve.frontend import ServingFrontend
from repro_torch.serve.offload import SwapConfig
from repro_torch.serve import sharded as serve_sharded
from repro_torch.serve.sampling import SamplingParams
from repro_torch.train import loop as tl

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
COLLECTIVES = ("all_sum", "all_gather", "all_max")


def _count_calls(shard, name):
    """Count the calls of the shard's collective ``name`` in
    ``shard.calls[name]``."""
    real = getattr(shard, name)
    if not hasattr(shard, "calls"):
        shard.calls = {}
    shard.calls[name] = 0

    def counted(*a, **kw):
        shard.calls[name] += 1
        return real(*a, **kw)
    setattr(shard, name, counted)


def _count_collectives(shard):
    """Count every collective of the shard by kind (``shard.calls``)."""
    for name in COLLECTIVES:
        _count_calls(shard, name)


def _counted(shard):
    """A snapshot of the shard's collective counters (zeros without one)."""
    calls = getattr(shard, "calls", {})
    return {n: calls.get(n, 0) for n in COLLECTIVES}


def _since(shard, before):
    """The collectives by kind since the snapshot ``before``."""
    return {n: c - before[n] for n, c in _counted(shard).items()}


def _expert_shapes(params):
    """{path: shape} of the routed-expert leaves of a parameter tree."""
    return {path: tuple(t.shape) for path, t in tl._walk(params)
            if path.split("/moe/")[-1] in ("wi_gate", "wi_up", "wo") and "/moe/" in path}


def _leaf_shapes(params):
    """{path: shape} of every leaf of a parameter tree."""
    return {path: tuple(t.shape) for path, t in tl._walk(params)}


@contextlib.contextmanager
def one_rank_group(store):
    """A one-rank gloo group in this process (a ``file://`` store at
    ``store``), its ``Shard`` yielded, the group destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield Shard()
    finally:
        dist.destroy_process_group()


def run(rank, world, store, task, args, out_dir):
    """One rank: joins the group, runs ``TASKS[task]``, saves its result.
    A native abort of the rank (a C++ ``std::terminate``, a fatal signal)
    dumps every thread's Python stack to ``<out_dir>/<task>-<rank>.trace``
    (``faulthandler``), which ``join`` puts in the fixture's error. The
    rank leaves the group only once every rank has saved its result (a
    barrier), and then leaves the process at once (``os._exit``): no rank
    tears down its gloo pairs while a peer still uses them, and none runs
    the C++ runtime's exit-time teardown."""
    trace = open(os.path.join(out_dir, f"{task}-{rank}.trace"), "w")
    faulthandler.enable(trace, all_threads=True)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    torch.set_num_threads(1)
    try:
        out = TASKS[task](Shard(), *args)
        torch.save(out, os.path.join(out_dir, f"{task}-{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    faulthandler.disable()
    trace.close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def join(ctx, out_dir, task):
    """``ctx.join()`` of a ``run`` spawn until every rank is done. A rank
    that died of a signal raises with, for each rank, its stack dump
    (``run``'s ``<task>-<rank>.trace``) and whether it saved its result;
    a rank's Python exception raises as ``torch.multiprocessing`` reports
    it, with the rank's traceback."""
    try:
        while not ctx.join():
            pass
    except mp.ProcessExitedException as e:
        lines = [f"{e} (exit code {e.exit_code})"]
        for r in range(len(ctx.processes)):
            path = os.path.join(out_dir, f"{task}-{r}")
            dump = open(path + ".trace").read() if os.path.exists(path + ".trace") else ""
            saved = "saved" if os.path.exists(path + ".pt") else "not saved"
            lines.append(f"--- rank {r}: result {saved}; stack dump:\n{dump or '(none)'}")
        raise RuntimeError("\n".join(lines)) from e


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
    """Every SERVE_CASES case on this rank: tokens, logits, stats, the
    collectives by kind and the shapes of the allocated pools per case,
    the shapes of the engine's parameter leaves, and the errors a world
    size that does not divide the KV heads must raise."""
    params = params_from_numpy(np_params, cfg, "cpu")
    _count_collectives(shard)
    pools = _record_pools()
    out = {}
    for name, (opt_kw, serve_kw) in SERVE_CASES.items():
        eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard,
                           options=DecodeOptions(**opt_kw))
        n_alloc = len(pools)
        before = _counted(shard)
        res = eng.serve([dict(r) for r in reqs], collect_logits=True, **serve_kw)
        out[name] = {"tokens": {r["rid"]: res[r["rid"]] for r in reqs},
                     "logits": res["logits"], "collectives": _since(shard, before),
                     "pools": pools[n_alloc:],
                     "stats": {k: res["stats"][k] for k in STATS + ("admitted",)}}
    out["leaves"], out["full_leaves"] = _leaf_shapes(eng.params), _leaf_shapes(params)
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
    _count_collectives(shard)
    return [_generate_one(shard, *job) for job in jobs]


def _generate_one(shard, cfg, np_params, prompt, tokens, max_len):
    """Sequence-sharded decode of ``prompt`` [B, L] fed the reference's
    greedy tokens (``tokens`` [n_steps + 1, B]: the prefill's, then each
    step's). Returns the prefill token, every step's logits, the caches
    gathered over ranks along the sequence, kg_n, and the collectives by
    kind of the prefill, of the cut to the sequence-sharded caches, of
    the first step and of all the steps."""
    params = params_from_numpy(np_params, cfg, "cpu")
    eng = DecodeEngine(cfg, params, max_len=max_len, device="cpu", shard=shard)
    before = _counted(shard)
    first, state = eng.prefill({"tokens": prompt})
    coll = {"prefill": _since(shard, before)}
    full_len = state.k_cache.shape[3]
    # the prefill's caches hold the rank's KV heads: gathered over them
    # and cut along the sequence
    assert state.k_cache.shape[2] == cfg.n_kv_heads // shard.world
    before = _counted(shard)
    state = eng.seq_shard(state)
    coll["seq_shard"] = _since(shard, before)
    assert state.k_cache.shape[2:4] == (cfg.n_kv_heads, full_len // shard.world)
    logits = []
    before = _counted(shard)
    for i, t in enumerate(tokens[:-1]):
        _, lg, state, aux = eng._step(eng.params, state, torch.as_tensor(t))
        logits.append(lg.numpy())
        if i == 0:
            coll["step"] = _since(shard, before)
    coll["steps"] = _since(shard, before)
    return {"first": first.numpy(), "logits": np.stack(logits), "collectives": coll,
            "k_cache": shard.all_gather(state.k_cache, axis=3).numpy(),
            "v_cache": shard.all_gather(state.v_cache, axis=3).numpy(),
            "kg_cache": shard.all_gather(state.kg_cache, axis=3).numpy(),
            "kg_n": state.kg_n.numpy(), "sparsity": float(aux["sparsity"])}


# the MoE family's head-sharded serve (fp only): the experts replicated
MOE_CASES = ("fp", "fp-preempt")


def moe_cases(shard, cfg, np_params, reqs, gen_job):
    """MOE_CASES' serves of a MoE config on this rank (each rank computes
    its experts over all slots and gathers their outputs), then the
    sequence-sharded ``generate`` of ``gen_job`` (``_generate_one``'s
    arguments but the shard). Each serve also reports its collectives by
    kind, the calls that computed the rank's expert rows (one expert
    gather each), the shapes of the engine's routed-expert leaves and of
    all its leaves."""
    params = params_from_numpy(np_params, cfg, "cpu")
    _count_collectives(shard)
    rows, real = [0], moe_mod._expert_rows

    def counted_rows(*a, **kw):
        rows[0] += 1
        return real(*a, **kw)
    moe_mod._expert_rows = counted_rows
    out = {}
    for name in MOE_CASES:
        opt_kw, serve_kw = SERVE_CASES[name]
        eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard,
                           options=DecodeOptions(**opt_kw))
        rows[0] = 0
        before = _counted(shard)
        res = eng.serve([dict(r) for r in reqs], collect_logits=True, **serve_kw)
        out[name] = {"tokens": {r["rid"]: res[r["rid"]] for r in reqs},
                     "logits": res["logits"], "collectives": _since(shard, before),
                     "stats": {k: res["stats"][k] for k in STATS + ("admitted",)},
                     "expert_gathers": rows[0],
                     "experts": _expert_shapes(eng.params),
                     "full_experts": _expert_shapes(params),
                     "leaves": _leaf_shapes(eng.params),
                     "full_leaves": _leaf_shapes(params)}
    out["generate"] = _generate_one(shard, *gen_job)
    moe_mod._expert_rows = real
    return out


# ---------------------------------------------------------------------------
# every decode option on the head-sharded serve (tests/test_torch_sharded_options.py)
# ---------------------------------------------------------------------------

# the dense 2 / select 2 / correction 14 schedule needs 15 layers; the
# other options run on the 2-layer tiny config (fewer collectives a step)
OPTION_LAYERS = 15
SCHEDULE = dict(dense_first_n=2, select_layer=2, correction_layers=(14,))
OPTION_SPECS = [(20, 8), (18, 7), (22, 6)]
BUDGETS = {0: {"budget": 16}, 1: {"budget": 20}}
# name -> (layers, DecodeOptions, per-request overrides by rid, serve kwargs)
OPTION_CASES = {
    "schedule": (OPTION_LAYERS, DecodeOptions(schedule=SelectionSchedule(**SCHEDULE)), {},
                 {}),
    "schedule-unify": (OPTION_LAYERS, DecodeOptions(schedule=SelectionSchedule(
        **SCHEDULE, unify_heads=True)), {}, {}),
    "budgets": (2, DecodeOptions(), BUDGETS, {}),
    "sampling": (2, DecodeOptions(sampling=SamplingParams(temperature=0.8, top_p=0.95)),
                 {0: {"sampling": SamplingParams(temperature=0.7, top_k=50, top_p=0.9)}},
                 dict(sample_seed=3)),
    "arrivals": (2, DecodeOptions(), {}, {}),
    # split-K under a carried plan and budget caps: within the bf16-ulp rule
    "schedule-budgets-split4": (OPTION_LAYERS, DecodeOptions(
        schedule=SelectionSchedule(**SCHEDULE), split_k=4), BUDGETS, {}),
}
# pool -> serve kwargs of the closed-loop cases / ServingFrontend kwargs
POOLS = {"ample": dict(n_slots=3), "tight": dict(n_slots=3, num_pages=7)}
FRONTEND_POOLS = {"ample": dict(n_slots=3), "tight": dict(n_slots=3, num_pages=10)}
# the stochastic sequence-sharded generate: options, prompt shape, new tokens
GEN_SAMPLING = DecodeOptions(sampling=SamplingParams(temperature=0.8, top_p=0.95))
GEN_SHAPE, GEN_NEW = (2, 24), 6
OPTION_RUNS = [(name, pool) for name in OPTION_CASES for pool in POOLS
               if not (name.endswith("split4") and pool == "tight")]
STEP_STATS = ("preemptions", "resumed", "decode_steps", "peak_pages_used",
              "swapped_out_bytes", "swapped_in_bytes", "sparsity_by_rid",
              "sel_blocks_by_rid", "errors", "rejected_arrivals")
STEP_STAMPS = ("submit_step", "admit_step", "first_token_step", "retire_step", "n_tokens")


@contextlib.contextmanager
def recording_gate_ids():
    """Every id list ``GatePolicy.select`` returns while the block runs,
    in call order (numpy copies)."""
    real = TP.GatePolicy.select
    ids = []

    def recording(self, inp, cfg, **kw):
        idx = real(self, inp, cfg, **kw)
        ids.append(idx.clone().numpy())
        return idx
    TP.GatePolicy.select = recording
    try:
        yield ids
    finally:
        TP.GatePolicy.select = real


def option_case(shard, cfg, params, name, pool, reqs, trace):
    """One OPTION_RUNS case on ``shard`` (None: the unsharded engine):
    its tokens, logits, the gate's id lists and the step-clock stats. The
    unsharded engine runs a split-K case at one split."""
    _, opts, extra, serve_kw = OPTION_CASES[name]
    if shard is None:
        opts = opts.replace(split_k=1)
    eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard, options=opts)
    with recording_gate_ids() as ids:
        if name == "arrivals":
            res = ServingFrontend(eng, tier_policy=TP.default_tiers(cfg),
                                  **FRONTEND_POOLS[pool]).run(trace, collect_logits=True)
        else:
            res = eng.serve([dict(r, **extra.get(r["rid"], {})) for r in reqs],
                            collect_logits=True, **POOLS[pool], **serve_kw)
    st = res["stats"]
    rids = [e.rid for e in trace] if name == "arrivals" else [r["rid"] for r in reqs]
    out = {"tokens": {rid: res[rid] for rid in rids}, "logits": res["logits"],
           "ids": ids, "stats": {k: st[k] for k in STEP_STATS},
           "timing": {rid: {k: st["timing_by_rid"][rid][k] for k in STEP_STAMPS}
                      for rid in rids}}
    if name == "arrivals":
        out["tiers"] = {tier: {k: v for k, v in row.items() if "steps" in k or k == "n"}
                        for tier, row in st["tiers"].items()}
    return out


def sampled_generate(shard, cfg, params, options=GEN_SAMPLING):
    """``generate`` of a fixed [2, 24] batch on ``shard`` (None: the
    unsharded engine) under ``options``, drawing from a generator of seed 3;
    returns the tokens [2, GEN_NEW]."""
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, GEN_SHAPE).astype(np.int32)
    eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard, options=options)
    res = eng.generate({"tokens": toks}, GEN_NEW, generator=torch.Generator().manual_seed(3))
    return res["tokens"].numpy()


def option_cases(shard, models, reqs, trace):
    """Every OPTION_RUNS case on this rank, then the stochastic sharded
    ``generate`` on the 2-layer model (key ``"generate-sampling"``), in one
    process group; ``models`` maps a case's layer count to its (config,
    numpy parameters)."""
    params = {n: params_from_numpy(p, cfg, "cpu") for n, (cfg, p) in models.items()}
    out = {}
    for name, pool in OPTION_RUNS:
        n = OPTION_CASES[name][0]
        out[name, pool] = option_case(shard, models[n][0], params[n], name, pool, reqs, trace)
    out["generate-sampling"] = sampled_generate(shard, models[2][0], params[2])
    return out


# ---------------------------------------------------------------------------
# training under a shard
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_L = 2, 32


@contextlib.contextmanager
def recording_drops():
    """Record (flat expert ids, keep mask, capacity) of every MoE dispatch,
    in call order, by wrapping ``moe.dispatch``."""
    rec, real = [], moe_mod.dispatch

    def recording(top_i, mcfg):
        out = real(top_i, mcfg)
        rec.append((out[0].numpy().copy(), out[2].numpy().copy(), out[3]))
        return out
    moe_mod.dispatch = recording
    try:
        yield rec
    finally:
        moe_mod.dispatch = real


def value_and_grad(state, batch, cfg, mode, shard=None):
    """(loss, metrics, {path: grad}) of the state's training loss: every
    leaf in pretrain, the gate's in distill; the rank's under a shard."""
    if mode == "pretrain":
        return tl.pretrain_value_and_grad(state.params, batch, cfg, shard)
    return tl.distill_value_and_grad(state.params, state.gate, batch, cfg, shard)


def train_case(shard, cfg, tcfg, start):
    """From the full state ``start``: the step-0 loss, metrics and gradient
    (gathered), the MoE dispatches of that forward, two ``make_train_step``
    steps (metrics, and the state after each, gathered), and the shapes of
    the rank's parameter leaves. ``shard`` None: the unsharded port."""
    state = start if shard is None else tl.shard_state(start, cfg, shard)
    full = (lambda t: t) if shard is None else (lambda t: gather_trees([t], cfg, shard)[0])
    batch = make_batch(cfg, TRAIN_B, TRAIN_L, DataState(tcfg.seed, 0), device="cpu")
    with recording_drops() as drops:
        loss, metrics, grads = value_and_grad(state, batch, cfg, tcfg.mode, shard)
    out = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": full(grads), "drops": drops, "hist": [], "states": [],
           "local": {p: tuple(t.shape) for p, t in tl._walk(state.params)}}
    step = tl.make_train_step(cfg, tcfg, shard)
    for i in range(2):
        batch = make_batch(cfg, TRAIN_B, TRAIN_L, DataState(tcfg.seed, i), device="cpu")
        state, m = step(state, batch)
        out["hist"].append({k: float(v) for k, v in m.items()})
        out["states"].append(state if shard is None else tl.gather_state(state, cfg, shard))
    return out


def recovering_run(shard, cfg, tcfg):
    """``run_training`` with a failure injected before step 3 (every rank):
    (history, the final state gathered, the recovery log lines)."""
    armed, logs = [True], []

    def fail_at(i):
        if i == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure")

    state, hist = tl.run_training(cfg, tcfg, fail_at=fail_at, log=logs.append,
                                  device="cpu", shard=shard)
    if shard is not None:
        state = tl.gather_state(state, cfg, shard)
    return hist, state, [m for m in logs if m.startswith("[recover]")]


def sharded_optimizer(shard, cfg, ocfg, params, grads, opt):
    """``adamw.apply`` on the rank's blocks of full flat trees, gathered:
    (new params, m, v, ef, grad_norm); ``shard`` None: the unsharded
    apply."""
    if shard is not None:
        params, grads = (shard_params(t, cfg, shard) for t in (params, grads))
        opt = opt._replace(**{f: None if getattr(opt, f) is None
                              else shard_params(getattr(opt, f), cfg, shard)
                              for f in ("m", "v", "ef")})
    new, opt, om = adamw.apply(params, grads, opt, ocfg, **tl._opt_kw(params, cfg, shard))
    if shard is not None:
        new, m, v, ef = gather_trees([new, opt.m, opt.v, opt.ef], cfg, shard)
        opt = opt._replace(m=m, v=v, ef=ef)
    return new, opt, float(om["grad_norm"])


def train_cases(shard, cases, recover, optim):
    """Every training case on this rank: ``cases`` {name: (cfg, tcfg,
    full start state)}, ``recover`` (cfg, tcfg) of the failing
    ``run_training``, ``optim`` {name: (cfg, OptimConfig, params, grads,
    AdamWState)} of the optimizer alone."""
    torch.manual_seed(0)
    out = {name: train_case(shard, *case) for name, case in cases.items()}
    out["recover"] = recovering_run(shard, *recover)
    out["optim"] = {name: sharded_optimizer(shard, *case) for name, case in optim.items()}
    return out


# ---------------------------------------------------------------------------
# the recurrent families on a sharded engine
# (tests/test_torch_sharded_recurrent.py)
# ---------------------------------------------------------------------------

# ragged prompts (bucketed prefill, mid-stream admission) on 3 slots and 8
# pages of 8 tokens: the first three fill the pool and growth preempts
REC_SPECS = ((21, 6), (13, 9), (16, 8), (5, 7))
TIGHT = dict(n_slots=3, num_pages=8)
# a host swap tier bounded between a rank's swap entry of the hybrid's
# preemption (23744 B at two ranks, 46528 B unsharded) and the same less
# its replicated ``B|C`` conv rows (960 B): every rank writes the entry to
# the disk tier alike, and reads it back on resume
DISK_HOST_CAP = 23300
# name -> (arch, DecodeOptions kwargs, serve kwargs)
REC_CASES = {
    "falcon": ("falcon_mamba_7b", {}, TIGHT),
    "zamba2": ("zamba2_1_2b", {}, TIGHT),
    "zamba2-evict": ("zamba2_1_2b", {}, dict(TIGHT, eviction=EvictionConfig())),
    "zamba2-int8": ("zamba2_1_2b", dict(quantize="int8"), TIGHT),
    "zamba2-split2": ("zamba2_1_2b", dict(split_k=2), TIGHT),
    "zamba2-disk": ("zamba2_1_2b", {},
                    dict(TIGHT, swap_config=SwapConfig(host_capacity_bytes=DISK_HOST_CAP))),
}
# the MoE model's and the dense model's serves at world size 1
# (tests/test_torch_sharded.py holds them at two ranks)
ONE_RANK_CASES = {"deepseek": ("deepseek_moe_16b", {}, TIGHT),
                  "qwen3": ("qwen3_0_6b", {}, TIGHT)}
REC_GEN_SHAPE, REC_GEN_NEW = (2, 37), 7            # generate: prompt, new tokens
REC_STATS = STATS + ("admitted", "retired", "failed")


def rec_requests(vocab, specs, seed=0):
    """The numpy-seeded requests of tests/test_torch_recurrent.py."""
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, vocab, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(specs)]


def rec_batch(cfg):
    """The numpy-seeded ``generate`` batch of REC_GEN_SHAPE tokens, with a
    vision model's image embeddings."""
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             REC_GEN_SHAPE).astype(np.int32)
    if not cfg.cross_attn_period:
        return {"tokens": toks}
    img = np.random.default_rng(2).standard_normal(
        (REC_GEN_SHAPE[0], cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": toks, "image_embeds": img}


def rec_serve(shard, cfg, params, name, disk_dir=None):
    """One REC_CASES (or ONE_RANK_CASES) serve on ``shard`` (None: the
    unsharded engine; it runs a split-K case at one split): tokens,
    logits, stats and the collectives it made. A bounded swap tier's disk
    tier lies in ``disk_dir``."""
    _, opt_kw, serve_kw = REC_CASES[name] if name in REC_CASES else ONE_RANK_CASES[name]
    if shard is None:
        opt_kw = dict(opt_kw, split_k=1)
    if "swap_config" in serve_kw:
        serve_kw = dict(serve_kw, swap_config=dataclasses.replace(serve_kw["swap_config"],
                                                                  disk_dir=disk_dir))
    reqs = rec_requests(cfg.vocab_size, REC_SPECS)
    eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard,
                       options=DecodeOptions(**opt_kw))
    before = _counted(shard)
    res = eng.serve([dict(r) for r in reqs], collect_logits=True, **serve_kw)
    return {"tokens": {r["rid"]: res[r["rid"]] for r in reqs}, "logits": res["logits"],
            "stats": {k: res["stats"][k] for k in REC_STATS},
            "collectives": _since(shard, before)}


def rec_generate(shard, cfg, params):
    """``generate`` of ``rec_batch`` on ``shard`` (None: unsharded):
    tokens [B, REC_GEN_NEW], each decode step's logits and the
    collectives by kind."""
    eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard)
    logits, step = [], eng._step

    def recording(*a, **kw):
        out = step(*a, **kw)
        logits.append(out[1].numpy().copy())
        return out
    eng._step = recording
    before = _counted(shard)
    res = eng.generate(rec_batch(cfg), REC_GEN_NEW)
    return {"tokens": res["tokens"].numpy(), "logits": np.stack(logits),
            "collectives": _since(shard, before)}


def rank_shapes(shard, cfg, params):
    """The shapes a sharded engine holds: every parameter leaf ({path:
    shape}) and, for a recurrent family, a 3-slot state's (conv, h)."""
    eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard)
    api = get_api(cfg)
    st = (() if api.init_slot_state is None
          else api.init_slot_state(cfg, 3, device="cpu", shard=shard))
    return {"leaves": _leaf_shapes(eng.params), "state": tuple(tuple(t.shape) for t in st)}


def recurrent_cases(shard, models, disk_dir):
    """Every REC_CASES serve and each family's ``generate`` on this rank,
    the shapes the rank holds, and the error a world size that does not
    divide the hybrid's KV heads raises; ``models`` maps an arch to its
    (config, numpy parameters); the ranks share the disk tier
    ``disk_dir``."""
    params = {a: params_from_numpy(p, cfg, "cpu") for a, (cfg, p) in models.items()}
    _count_collectives(shard)
    out = {name: rec_serve(shard, models[arch][0], params[arch], name, disk_dir)
           for name, (arch, *_) in REC_CASES.items()}
    for arch, (cfg, _) in models.items():
        out[arch, "generate"] = rec_generate(shard, cfg, params[arch])
        out[arch, "shapes"] = rank_shapes(shard, cfg, params[arch])
    cfg = models["zamba2_1_2b"][0]
    odd = DecodeEngine(cfg.replace(n_kv_heads=1), params["zamba2_1_2b"], max_len=64,
                       device="cpu", shard=shard)
    try:
        odd.serve(rec_requests(cfg.vocab_size, REC_SPECS[:1]), n_slots=1)
        out["odd_heads"] = None
    except ValueError as e:
        out["odd_heads"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the data axis (tests/test_torch_data_parallel.py)
# ---------------------------------------------------------------------------

# the global batch of the data-parallel training cases: 4 rows of 32 tokens
# at DataState(0, DP_STEP0 + i); its two halves hold 60 and 62 loss-mask
# positions at both steps, so a mean of the replicas' means is not the
# global mean
DP_B, DP_L, DP_STEP0 = 4, 32, 2
# ZeRO-1's size floor for the reduced configs, whose leaves are all under
# the reference's 2**16 elements: low enough that the layers, the
# embedding and the logits split (sharding.ZERO1_MIN_SIZE at full size)
DP_ZERO1_MIN = 1 << 10
DP_GEN_NEW = 8
# zero1_gather's bytes a collective in the chunked cases (sharding's
# _GATHER_CHUNK at full size): under one sliced leaf at its owner, so the
# owner-whole layer slices cross chunk boundaries
DP_GATHER_CHUNK = 1 << 12


def dp_batch(cfg, i):
    """The global batch of data-parallel training step ``i``."""
    return make_batch(cfg, DP_B, DP_L, DataState(0, DP_STEP0 + i), device="cpu")


def dp_train_case(shard, data, cfg, tcfg, start):
    """Two ``make_train_step`` steps from the full state ``start`` over the
    ``data`` axis (each rank its rows of ``dp_batch``; None: the unsharded
    port on the whole batch): each step's metrics and the state after it
    (gathered over both axes), the MoE dispatches of the first step, and
    this rank's moment shapes and bytes."""
    split = shard is not None or data is not None
    state = tl.shard_state(start, cfg, shard, data) if split else start
    if sharding.ep_view(shard, cfg) is not shard:
        row0, rows = sharding.ep_rows(DP_B, shard, data)
    else:
        row0, rows = data_rows(DP_B, data)
    step = tl.make_train_step(cfg, tcfg, shard, data)
    out = {"hist": [], "states": []}
    for i in range(2):
        batch = {k: v[row0:row0 + rows] for k, v in dp_batch(cfg, i).items()}
        with recording_drops() as drops:
            state, m = step(state, batch)
        if i == 0:
            out["drops"] = drops
        out["hist"].append({k: float(v) for k, v in m.items()})
        out["states"].append(tl.gather_state(state, cfg, shard, data) if split else state)
    out["moments"] = {k: tuple(t.shape) for k, t in state.opt.m.items()}
    out["moment_bytes"] = sum(t.numel() * t.element_size() for t in state.opt.m.values())
    return out


def dp_optimizer(data, cfg, ocfg, params, grads, opt):
    """``adamw.apply`` over the data axis on full flat trees, pretraining's
    ZeRO-1 slices of the moments: rank r's gradient is ``grads[r]`` (the
    parent holds the unsharded apply to their sum). Returns the new
    params, the gathered m, v and ef, and the grad norm."""
    z = zero1_slices(params, cfg, data)
    opt = opt._replace(**{f: zero1_pieces(getattr(opt, f), z, data) for f in ("m", "v", "ef")})
    new, opt, om = adamw.apply(params, grads[data.rank], opt, ocfg, data=data, zero1=z)
    m, v, ef = (None if t is None else zero1_gather(t, z, data) for t in (opt.m, opt.v, opt.ef))
    return new, opt._replace(m=m, v=v, ef=ef), float(om["grad_norm"])


def dp_recovering_run(shard, data, cfg, tcfg):
    """``run_training`` over the data axis with a failure before step 3:
    (history, the final state gathered, the recovery log lines)."""
    armed, logs = [True], []

    def fail_at(i):
        if i == 3 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure")

    state, hist = tl.run_training(cfg, tcfg, fail_at=fail_at, log=logs.append,
                                  device="cpu", shard=shard, data=data)
    if shard is not None or data is not None:
        state = tl.gather_state(state, cfg, shard, data)
    return hist, state, [m for m in logs if m.startswith("[recover]")]


@contextlib.contextmanager
def recording_seq_ids():
    """Every sequence-sharded selection (``serve.sharded.sharded_select``)
    while the block runs, as the sorted global block ids each (b, KV head)
    selects [B, Hkv, n] (-1 padded), gathered over the ranks of the
    selection's shard."""
    real = serve_sharded.sharded_select
    ids = []

    def recording(qg, kg_loc, new_len, *, shard, **kw):
        cand_i, mine = real(qg, kg_loc, new_len, shard=shard, **kw)
        glob = torch.where(mine, shard.rank * kg_loc.shape[2] + cand_i, -1)
        got = shard.all_gather(glob, glob.dim() - 1)
        ids.append(torch.sort(got, dim=-1, descending=True).values.numpy())
        return cand_i, mine
    serve_sharded.sharded_select = recording
    try:
        yield ids
    finally:
        serve_sharded.sharded_select = real


def dp_generate(shard, data, cfg, params, batch, n_new=DP_GEN_NEW, seq_ids=False,
                options=None):
    """``generate`` on an engine over the data axis (``shard`` None: the
    unsharded engine) under ``options`` (the engine's default for None):
    tokens, each decode step's logits, the K cache's shape after the cut
    to the sequence-sharded step (if any) and, with ``seq_ids``, the
    sequence-sharded selections' ids."""
    eng = DecodeEngine(cfg, params, max_len=64, device="cpu", shard=shard, data=data,
                       options=options)
    logits, cuts, step, cut = [], [], eng._step, eng.seq_shard

    def recording(*a, **kw):
        out = step(*a, **kw)
        logits.append(out[1].numpy().copy())
        return out

    def recording_cut(*a, **kw):
        state = cut(*a, **kw)
        cuts.append(tuple(state.k_cache.shape))
        return state
    eng._step, eng.seq_shard = recording, recording_cut
    with (recording_seq_ids() if seq_ids else contextlib.nullcontext([])) as ids:
        res = eng.generate(batch, n_new)
    return {"tokens": res["tokens"].numpy(), "logits": logits, "ids": ids, "cuts": cuts,
            "final_len": res["final_len"].numpy()}


def dp_chunked(shard, data, jobs):
    """The "train" and "optim" cases of ``jobs`` again with
    ``zero1_gather``'s chunk at ``DP_GATHER_CHUNK`` bytes, so that each
    gather of the parameters (``adamw.apply``) and of the moments
    (``gather_state``) is many collectives: their results, the number of
    ``zero1_gather`` calls and the number of its collectives (the data
    group's all_gathers of bytes)."""
    calls = {"zero1_gather": 0, "collectives": 0}
    real, real_gather = data.all_gather, sharding.zero1_gather
    users = (sharding, tl, sys.modules[__name__])

    def counting(x, axis):
        calls["collectives"] += x.dtype == torch.uint8
        return real(x, axis)

    def counting_gather(*a, **kw):
        calls["zero1_gather"] += 1
        return real_gather(*a, **kw)
    data.all_gather, chunk = counting, sharding._GATHER_CHUNK
    for mod in users:
        mod.zero1_gather = counting_gather
    sharding._GATHER_CHUNK = DP_GATHER_CHUNK
    try:
        out = {"train": {name: dp_train_case(shard, data, *case)
                         for name, case in jobs.get("train", {}).items()},
               "optim": {name: dp_optimizer(data, *case)
                         for name, case in jobs.get("optim", {}).items()}}
    finally:
        del data.all_gather
        for mod in users:
            mod.zero1_gather = real_gather
        sharding._GATHER_CHUNK = chunk
    out["calls"] = calls
    return out


def data_cases(_, n_data, n_model, jobs):
    """The data-parallel cases on this rank of a ``n_data x n_model``
    world: ``jobs`` {"train": {name: (cfg, tcfg, full start state)},
    "optim": {name: (cfg, OptimConfig, params, [grads of each data rank],
    AdamWState)}, "recover": (cfg, tcfg), "generate": {name: (cfg, params,
    batch, seq_ids)}, "chunked": {"train": ..., "optim": ...}}, each part
    optional."""
    shard, data = data_model_shards(n_data, n_model)
    sharding.ZERO1_MIN_SIZE = DP_ZERO1_MIN
    torch.manual_seed(0)
    out = {"train": {name: dp_train_case(shard, data, *case)
                     for name, case in jobs.get("train", {}).items()},
           "optim": {name: dp_optimizer(data, *case)
                     for name, case in jobs.get("optim", {}).items()},
           "generate": {name: dp_generate(shard, data, cfg, p, batch, seq_ids=ids)
                        for name, (cfg, p, batch, ids) in jobs.get("generate", {}).items()}}
    if "recover" in jobs:
        out["recover"] = dp_recovering_run(shard, data, *jobs["recover"])
    if "chunked" in jobs:
        out["chunked"] = dp_chunked(shard, data, jobs["chunked"])
    out["ranks"] = (shard.rank, shard.world, data.rank, data.world)
    return out


# ---------------------------------------------------------------------------
# the MoE's expert dispatch over data x model (tests/test_torch_moe_dispatch.py)
# ---------------------------------------------------------------------------

EXCHANGES = ("all_sum", "all_gather", "all_to_all")


@contextlib.contextmanager
def recording_expert_buffers():
    """The shape of every expert buffer ``moe.expert_glu`` computes over,
    in call order."""
    real, shapes = moe_mod.expert_glu, []

    def recording(p, xb, activation):
        shapes.append(tuple(xb.shape))
        return real(p, xb, activation)
    moe_mod.expert_glu = recording
    try:
        yield shapes
    finally:
        moe_mod.expert_glu = real


def _count_exchanges(*groups):
    """Count the calls of EXCHANGES on each group from 0."""
    for g in groups:
        for name in EXCHANGES:
            if name in getattr(g, "calls", {}):
                g.calls[name] = 0
            else:
                _count_calls(g, name)


def _exchanges(group):
    return {n: group.calls[n] for n in EXCHANGES}


def moe_layer_params(np_params, shard, ep_major):
    """A rank's MoE layer from the full numpy one (``{"router/w", ...,
    "shared/<n>/w"}``): its block of the routed experts, the shared
    experts' block of hidden units (whole under ``ep_major``), the router
    whole; every leaf a fresh leaf that requires grad."""
    t = {k: torch.tensor(v) for k, v in np_params.items()}
    e_loc = t["wi_gate"].shape[0] // shard.world
    ff = t["shared/wo/w"].shape[0]
    f_loc = ff if ep_major or ff % shard.world else ff // shard.world
    lo = 0 if f_loc == ff else shard.rank * f_loc
    p = {"router": {"w": t["router/w"]},
         "wi_gate": t["wi_gate"].narrow(0, shard.rank * e_loc, e_loc),
         "wi_up": t["wi_up"].narrow(0, shard.rank * e_loc, e_loc),
         "wo": t["wo"].narrow(0, shard.rank * e_loc, e_loc),
         "shared": {"wi_gate": {"w": t["shared/wi_gate/w"].narrow(1, lo, f_loc)},
                    "wi_up": {"w": t["shared/wi_up/w"].narrow(1, lo, f_loc)},
                    "wo": {"w": t["shared/wo/w"].narrow(0, lo, f_loc)}}}
    return _fresh(p)


def _fresh(tree):
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return tree.clone().requires_grad_(True)


def moe_layer_case(shard, data, world, np_params, mcfg, x, r, ep_major):
    """One MoE layer on this rank of a data x model world: its rows of x
    (the replica's, or under ``ep_major`` its block of the world's), the
    loss ``sum(y * r) + aux`` summed over the rows' group, and its
    backward. Returns y, aux, dx and the gradient of each of the rank's
    leaves ({path: array}), the dispatch branch, the expert buffers'
    shapes and the exchanges on each group."""
    rows_group = world if ep_major else data
    n = x.shape[0] // rows_group.world
    lo = rows_group.rank * n
    xr = torch.tensor(x[lo:lo + n]).requires_grad_(True)
    p = moe_layer_params(np_params, shard, ep_major)
    _count_exchanges(shard, data, world)
    mshard = shard.as_ep_major() if ep_major else shard
    with recording_expert_buffers() as bufs:
        y, aux = moe_mod.moe_mlp(p, xr, mcfg, shard=mshard, data=data)
        loss = sharding.reduce_from_model((y * torch.tensor(r[lo:lo + n])).sum(),
                                          rows_group) + aux
        loss.backward()
    return {"y": y.detach().numpy(), "aux": float(aux), "dx": xr.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in tl._walk(p)},
            "branch": moe_mod.dispatch_branch(n, mcfg, mshard),
            "buffers": bufs,
            "exchanges": {name: _exchanges(g) for name, g in
                          (("model", shard), ("data", data), ("world", world))}}


def dispatch_cases(_, jobs):
    """The MoE dispatch cases on this rank of a data 2 x model 2 world:
    ``jobs`` {"layers": (numpy layer, {name: (MoEConfig, x, r,
    ep_major)}), "train": {name: (cfg, tcfg, full start state)},
    "generate": {name: (cfg, params, batch, options)}}. Training and
    ``generate`` record their expert buffers' shapes."""
    shard, data = data_model_shards(2, 2)
    world = Shard()
    np_params, cases = jobs["layers"]
    out = {"layers": {name: moe_layer_case(shard, data, world, np_params, *case)
                      for name, case in cases.items()}, "train": {}, "generate": {}}
    torch.manual_seed(0)
    for name, case in jobs["train"].items():
        with recording_expert_buffers() as bufs:
            out["train"][name] = dp_train_case(shard, data, *case)
        out["train"][name]["buffers"] = bufs
    for name, (cfg, params, batch, options) in jobs["generate"].items():
        with recording_expert_buffers() as bufs:
            out["generate"][name] = dp_generate(shard, data, cfg, params, batch,
                                                options=options)
        out["generate"][name]["buffers"] = bufs
    out["ranks"] = (shard.rank, data.rank, world.rank)
    return out


TASKS = {"serve": serve_cases, "generate": generate_teacher_forced, "moe": moe_cases,
         "options": option_cases, "train": train_cases, "recurrent": recurrent_cases,
         "data": data_cases, "dispatch": dispatch_cases}
