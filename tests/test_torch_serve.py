"""``DecodeEngine.serve`` of the port on the CPU against the live JAX one.

The ``tests/capture_golden_policy.py::tiny_cfg`` model (qwen3 cut to 2
layers, float32, gate block 8) with JAX ``init_params`` weights converted
by ``convert.params_from_numpy``, and numpy-seeded prompts, go through the
JAX engine's ``serve()`` and the port's ``serve()`` (``device="cpu"``,
the plain versions of the paged kernels). In every case the greedy tokens
must be equal for every rid and the logits within 1e-4 (measured max
abs difference on a CPU run: 7.3e-7); under forced preemption the
scheduler and swap counters must be equal too. Then port-only bitwise
checks (lazy == reserve, tight pool == ample pool), the repaired
``sparsity_stats`` against the reference after ``generate`` and after
``serve``, the pressure-path options (eviction, faults, a swap config,
streaming, a table width, arrivals) against the reference's, and what a
sharded engine does not take yet, which must raise.

The JAX runs are cached per module so the file stays fast.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import capture_golden_policy as G
from repro.core.policy import DecodeOptions as JOptions
from repro.core.policy import DensePolicy as JDense
from repro.models.registry import get_api
from repro.serve import traffic as j_traffic
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.faults import FaultInjector as JFaults
from repro.serve.offload import SwapConfig as JSwapConfig
from repro.serve.scheduler import pages_needed
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import DecodeOptions as TOptions
from repro_torch.core.policy import DensePolicy as TDense
from repro_torch.core.policy import SelectionSchedule as TSchedule
from repro_torch.distributed.sharding import Shard
from repro_torch.kernels import ops as t_ops
from repro_torch.serve import traffic as t_traffic
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.offload import SwapConfig
from repro_torch.serve.sampling import SamplingParams

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4
PREEMPT = [(20, 12), (18, 10), (22, 9)]
CASES = {
    # ragged prompts, more requests than slots: mid-stream admission
    "ragged": ("budget", [(21, 8), (37, 5), (16, 11), (29, 7), (21, 4), (44, 6)],
               dict(n_slots=3), False),
    "threshold": ("threshold", [(17, 6), (25, 5), (40, 7)], dict(n_slots=2), False),
    # a pool too small for the admitted lifetimes: preempt -> swap -> resume
    "preemption": ("budget", PREEMPT, dict(n_slots=3, num_pages=8), False),
    # upfront reservation with room for one request: queued admission
    "reserve-exhaustion": ("budget", [(24, 6)] * 3,
                           dict(n_slots=3, num_pages=pages_needed(24, 6, 8) + 1,
                                admission="reserve"), False),
    # a request satisfied by prefill alone and a one-token prompt
    "new1-prompt1": ("budget", [(10, 1), (1, 5), (18, 4)], dict(n_slots=2), False),
    "dense": ("budget", [(13, 6), (26, 4), (9, 8)], dict(n_slots=2), True),
}
COUNTERS = ("preemptions", "resumed", "admitted", "retired", "decode_steps",
            "peak_pages_used", "swapped_out_bytes", "swapped_in_bytes",
            "admission_stalls", "retired_preempted", "max_active_slots")


def torch_tiny_cfg(method):
    cfg = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return cfg.replace(gate=dataclasses.replace(
        cfg.gate, block_size=8, d_gate=16, token_budget=32, method=method,
        threshold=2e-2))


def requests(cfg, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, cfg.vocab_size, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(specs)]


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) per gate method."""
    out = {}
    for method in ("budget", "threshold"):
        jcfg = G.tiny_cfg(method)
        params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
        tcfg = torch_tiny_cfg(method)
        out[method] = (jcfg, params, tcfg,
                       params_from_numpy(jax.device_get(params), tcfg, "cpu"))
    return out


def port_engine(models, method, dense=False, **kw):
    _, _, tcfg, tparams = models[method]
    opts = TOptions(policy=TDense()) if dense else None
    return DecodeEngine(tcfg, tparams, max_len=64, options=opts, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX serve() result and engine per case, computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            method, specs, kw, dense = CASES[name]
            jcfg, params, _, _ = models[method]
            eng = JaxEngine(jcfg, params, max_len=64,
                            options=JOptions(policy=JDense()) if dense else None)
            res = eng.serve(requests(jcfg, specs), collect_logits=True, **kw)
            cache[name] = (res, eng)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_serve_matches_jax(models, jax_runs, name):
    method, specs, kw, dense = CASES[name]
    j_res, _ = jax_runs(name)
    eng = port_engine(models, method, dense)
    t_ops.reset_launch_counts()
    t_res = eng.serve(requests(models[method][0], specs), collect_logits=True, **kw)
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)   # CPU: plain
    assert t_res["stats"]["retired"] == len(specs)
    for rid in range(len(specs)):
        assert t_res[rid] == j_res[rid], f"rid {rid} tokens"
        assert len(t_res[rid]) == specs[rid][1]
        np.testing.assert_allclose(t_res["logits"][rid], j_res["logits"][rid],
                                   atol=LOGIT_TOL, rtol=0)
    for key in COUNTERS:
        assert t_res["stats"][key] == j_res["stats"][key], key
    for rid, rho in j_res["stats"]["sparsity_by_rid"].items():
        assert t_res["stats"]["sparsity_by_rid"][rid] == pytest.approx(rho, abs=1e-6)
    if name == "preemption":
        assert t_res["stats"]["preemptions"] > 0
    if name == "dense":
        assert set(t_res["stats"]["sparsity_by_rid"].values()) == {0.0}


def test_serve_stats_keys_match_jax(models, jax_runs):
    """The port reports the reference's stats keys, less the one of its
    jit cache, with equal eviction, fault and arrival counters."""
    j_res, _ = jax_runs("ragged")
    t_res = port_engine(models, "budget").serve(
        requests(models["budget"][0], CASES["ragged"][1]), n_slots=3)
    not_ported = {"prefill_jit_programs"}
    assert set(t_res["stats"]) == set(j_res["stats"]) - not_ported
    for key in ("faults", "evictions", "page_restores", "replay_steps",
                "rejected_arrivals"):
        assert t_res["stats"][key] == j_res["stats"][key], key
    assert t_res["stats"]["swap"] == j_res["stats"]["swap"]
    assert t_res["stats"]["prefill_buckets_pages"] == j_res["stats"]["prefill_buckets_pages"]


def test_lazy_equals_reserve_bitwise(models):
    """With an ample pool both admission policies admit alike; physical
    placement differs, the math does not."""
    specs = [(21, 8), (37, 5), (16, 11), (29, 7)]
    reqs = requests(models["budget"][0], specs)
    eng = port_engine(models, "budget")
    lazy = eng.serve([dict(r) for r in reqs], n_slots=2, collect_logits=True)
    resv = eng.serve([dict(r) for r in reqs], n_slots=2, collect_logits=True,
                     admission="reserve")
    assert lazy["stats"]["preemptions"] == 0
    for rid in range(len(specs)):
        assert lazy[rid] == resv[rid]
        np.testing.assert_array_equal(lazy["logits"][rid], resv["logits"][rid])


def test_tight_pool_equals_ample_pool_bitwise(models):
    """Preempt -> swap to host -> resume into other pages is lossless."""
    reqs = requests(models["budget"][0], PREEMPT)
    eng = port_engine(models, "budget")
    ample = eng.serve([dict(r) for r in reqs], n_slots=3, collect_logits=True)
    tight = eng.serve([dict(r) for r in reqs], n_slots=3, num_pages=8,
                      collect_logits=True, watermark=0)
    st = tight["stats"]
    assert ample["stats"]["preemptions"] == 0 < st["preemptions"] == st["resumed"]
    assert st["swapped_out_bytes"] == st["swapped_in_bytes"] > 0
    assert st["swap"]["host_entries"] == 0
    for rid in range(len(PREEMPT)):
        assert tight[rid] == ample[rid]
        np.testing.assert_array_equal(tight["logits"][rid], ample["logits"][rid])


def _stats_close(t, j):
    assert set(t) == set(j)
    for key, val in j.items():
        if key == "measured":
            assert t[key] == val
        else:
            np.testing.assert_allclose(np.asarray(t[key], np.float64),
                                       np.asarray(val, np.float64), atol=1e-6, rtol=1e-6)


def test_sparsity_stats_match_jax_after_generate_and_serve(models, jax_runs):
    """Every key of ``sparsity_stats`` equals the reference's: before any
    step, after ``generate`` (all rows), and after ``serve`` (active slots
    of the last step only)."""
    jcfg, params, tcfg, tparams = models["budget"]
    j_eng = JaxEngine(jcfg, params, max_len=G.MAX_LEN)
    t_eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN, device="cpu")
    _stats_close(t_eng.sparsity_stats(), j_eng.sparsity_stats())
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, jcfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    j_eng.generate({"tokens": jnp.asarray(toks)}, 6)
    t_eng.generate({"tokens": toks}, 6)
    _stats_close(t_eng.sparsity_stats(), j_eng.sparsity_stats())
    _, j_served = jax_runs("ragged")
    t_served = port_engine(models, "budget")
    t_served.serve(requests(jcfg, CASES["ragged"][1]), n_slots=3)
    stats = t_served.sparsity_stats()
    _stats_close(stats, j_served.sparsity_stats())
    assert len(stats["sparsity_rows"]) < 3          # the last step had idle slots


def test_unported_options_raise(models, tmp_path):
    eng = port_engine(models, "budget")
    jcfg, jparams = models["budget"][:2]
    reqs = requests(jcfg, [(9, 3)])
    # the pressure-path options (Queue A item 7) are ported: each runs and
    # gives the JAX engine's tokens and stream
    j_eng = JaxEngine(jcfg, jparams, max_len=64)
    seen = {"port": [], "jax": []}
    trace = [t_traffic.TraceEntry(rid=0, arrival=0.0, prompt_len=9, output_len=3, seed=5),
             t_traffic.TraceEntry(rid=1, arrival=1.5, prompt_len=12, output_len=4, seed=6)]
    for t_kw, j_kw in (
            (dict(eviction=True), dict(eviction=True)),
            (dict(faults=FaultInjector({})), dict(faults=JFaults({}))),
            (dict(swap_config=SwapConfig(retries=0)), dict(swap_config=JSwapConfig(retries=0))),
            (dict(on_token=lambda r, tok, i, step: seen["port"].append((tok, i, step))),
             dict(on_token=lambda r, tok, i, step: seen["jax"].append((tok, i, step)))),
            (dict(table_pages=9), dict(table_pages=9)),
            (dict(arrivals=t_traffic.StepArrivals(trace, jcfg.vocab_size), max_steps=20,
                  table_pages=4),
             dict(arrivals=j_traffic.StepArrivals(
                 [j_traffic.TraceEntry(**dataclasses.asdict(e)) for e in trace],
                 jcfg.vocab_size), max_steps=20, table_pages=4))):
        got = eng.serve([] if "arrivals" in t_kw else reqs, **t_kw)
        want = j_eng.serve([] if "arrivals" in j_kw else reqs, **j_kw)
        rids = [e.rid for e in trace] if "arrivals" in t_kw else [0]
        for rid in rids:
            assert got[rid] == want[rid] and len(got[rid]) > 0
        assert got["stats"]["errors"] == want["stats"]["errors"] == {}
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 3
    # a sharded engine takes the decode options it once refused (a Shard
    # stub: construction makes no collective) ...
    stub = object.__new__(Shard)
    stub.rank, stub.world, stub.group, stub.device = 0, 1, None, torch.device("cpu")
    for opts in (TOptions(schedule=TSchedule(unify_heads=True)),
                 TOptions(schedule=TSchedule(select_layer=0)),
                 TOptions(sampling=SamplingParams(temperature=0.7))):
        assert DecodeEngine(models["budget"][2], models["budget"][3], max_len=64,
                            device="cpu", options=opts, shard=stub).options == opts
    # ... and serves the request overrides on a one-rank gloo group as the
    # unsharded engine does (two ranks: tests/test_torch_sharded_options.py)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        sharded = port_engine(models, "budget", shard=Shard())
        for key, val in (("budget", 16), ("sampling", SamplingParams(temperature=1.0))):
            rd = [dict(reqs[0], **{key: val})]
            assert sharded.serve(rd)[0] == eng.serve(rd)[0]
    finally:
        dist.destroy_process_group()
    q8 = TOptions(quantize="int8")
    assert q8.quantize == "int8" and q8 == TOptions(quantize="int8")
    with pytest.raises(ValueError, match="quantize"):
        TOptions(quantize="fp8")
    with pytest.raises(TypeError, match="Shard"):       # sharded serving: a Shard
        port_engine(models, "budget", shard=object())
    with pytest.raises(ValueError, match="encoder with no decode"):
        DecodeEngine(torch_tiny_cfg("budget").replace(family="audio"),
                     models["budget"][3], max_len=64, device="cpu")
    assert eng.serve(reqs)[0] == eng.serve(reqs)[0]          # still serves


def test_serve_step_limit_fails_unfinished(models):
    """``max_steps`` bounds the loop: unfinished requests retire with an
    error and keep their partial tokens, as in the reference."""
    eng = port_engine(models, "budget")
    res = eng.serve(requests(models["budget"][0], [(9, 30), (12, 2)]), n_slots=2,
                    max_steps=4)
    st = res["stats"]
    assert st["errors"] == {0: "step_limit"} and st["failed"] == 1
    assert len(res[1]) == 2 and 1 < len(res[0]) < 30
