"""Child-process bodies of tests/test_torch_sharded.py,
tests/test_torch_sharded_options.py and tests/test_torch_train_sharded.py:
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
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.core.policy import DecodeOptions, DensePolicy, SelectionSchedule
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.distributed.sharding import (Shard, decode_partition, gather_trees,
                                              seq_shard_state, shard_params)
from repro_torch.models import moe as moe_mod
from repro_torch.optim import adamw
from repro_torch.serve import paging as pg
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig
from repro_torch.serve.frontend import ServingFrontend
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


def _count_gathers(shard):
    """Count the shard's head and candidate gathers, the collectives that
    show a sharded path ran (an unsharded step makes none)."""
    real = shard.all_gather
    shard.gathers = 0

    def counted(x, axis):
        shard.gathers += 1
        return real(x, axis)
    shard.all_gather = counted


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


TASKS = {"serve": serve_cases, "generate": generate_teacher_forced, "moe": moe_cases,
         "options": option_cases, "train": train_cases}
