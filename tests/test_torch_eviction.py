"""RaaS page eviction of the port's ``serve`` on the CPU against the live JAX one.

The reduced qwen3_0_6b (2 layers, float32, gate block 8, d_gate 16) with
JAX ``init_params`` weights (key 0) converted by
``convert.params_from_numpy``, and numpy-seeded prompts, go through the
JAX engine's ``serve(eviction=...)`` and the port's (``device="cpu"``, the
plain versions of the paged kernels). In every case the greedy tokens
must be equal for every rid, the eviction, restore and replay counters,
preemptions, swap bytes and errors equal, and the logits within 1e-4
(measured max abs difference on a CPU run: 5.7e-7). The cases: half the
ample pool (cold middle blocks, no replay), a resident cap that forces
fault -> restore -> replay, Quest (its min/max metadata rides the ghost
rows), int8 pools under the cap, and, under the cap, a host swap tier
bounded below its peak with a disk tier (replays promote pages from it). For fp pools the eviction run is also bitwise the
port's own ample run; for int8 pools it is not, in either package: a
replay requantizes the trailing page from its dequantized codes once more
(``paging.append_token_paged_quant``), which moves the logits by up to
~1e-3 here while the tokens stay equal. Then the ghost rows, the touched
mask and ``BlockHeat`` field by field against the reference, and the
refusals.

The JAX runs are cached per module so the file stays fast.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.config import reduced as j_reduced
from repro.core.metacache import BlockHeat as JHeat
from repro.core.policy import DecodeOptions as JOptions
from repro.core.policy import QuestPolicy as JQuest
from repro.models import attn_core as j_ac
from repro.models.registry import get_api
from repro.serve import paging as j_pg
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.eviction import EvictionConfig as JEviction
from repro.serve.eviction import EvictionManager as JManager
from repro.serve.offload import SwapConfig as JSwapConfig
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core.metacache import BlockHeat
from repro_torch.core.policy import DecodeOptions as TOptions
from repro_torch.core.policy import (DensePolicy, OraclePolicy, QuestPolicy,
                                     QuestRecomputePolicy, SelectionSchedule)
from repro_torch.models import attn_core as t_ac
from repro_torch.serve import paging as t_pg
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig, EvictionManager
from repro_torch.serve.offload import SwapConfig

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4
HALF = [(40, 25), (38, 24), (41, 22)]
COUNTERS = ("evictions", "page_restores", "replay_steps", "preemptions", "resumed",
            "failed", "errors", "retired", "decode_steps", "peak_pages_used",
            "swapped_out_bytes", "swapped_in_bytes", "swap")
# name -> (token budget, JAX / port options kwargs, request specs, prompt seed,
#          serve kwargs, EvictionConfig kwargs, pool: "half" of the ample
#          run's peak or None (the default), bounded swap tier)
CASES = {
    "half-pool": (16, {}, HALF, 0, dict(n_slots=3), {}, "half", False),
    "resident-cap": (32, {}, [(61, 10)], 3, dict(n_slots=1),
                     dict(max_resident_pages=3), None, False),
    "quest": (16, {"quest": True}, HALF, 1, dict(n_slots=3), {}, "half", False),
    "int8-cap": (32, {"quantize": "int8"}, [(61, 14), (45, 12), (30, 9)], 5,
                 dict(n_slots=3), dict(max_resident_pages=3), None, False),
    "bounded-swap": (32, {}, [(61, 10), (44, 12)], 3, dict(n_slots=2),
                     dict(max_resident_pages=3), None, True),
}
HOST_CAP = {}          # case -> the host tier's byte bound of its bounded run


def cfgs(token_budget):
    """(JAX cfg, port cfg): reduced qwen3_0_6b at float32, gate block 8."""
    gate = dict(block_size=8, d_gate=16, token_budget=token_budget, method="budget",
                threshold=2e-2)
    j = j_reduced(j_configs.get("qwen3_0_6b")).replace(dtype="float32")
    t = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return (j.replace(gate=dataclasses.replace(j.gate, **gate)),
            t.replace(gate=dataclasses.replace(t.gate, **gate)))


def requests(cfg, specs, seed):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, cfg.vocab_size, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(specs)]


def options(kw, jax_side):
    quest = kw.get("quest", False)
    quantize = kw.get("quantize")
    if jax_side:
        return JOptions(policy=JQuest(), quantize=quantize) if quest else \
            JOptions(quantize=quantize)
    return TOptions(policy=QuestPolicy(), quantize=quantize) if quest else \
        TOptions(quantize=quantize)


@pytest.fixture(scope="module")
def params():
    """(JAX params, port params): one weight set for every budget (the gate
    weights do not depend on it)."""
    jcfg, tcfg = cfgs(16)
    p = get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return p, params_from_numpy(jax.device_get(p), tcfg, "cpu")


def port_engine(params, budget, opt_kw=None):
    return DecodeEngine(cfgs(budget)[1], params[1], max_len=128, device="cpu",
                        options=options(opt_kw or {}, False))


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """Per case: (JAX ample, JAX eviction, port ample, port eviction,
    requests), computed once."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        budget, opt_kw, specs, seed, kw, ev_kw, pool, bounded = CASES[name]
        jcfg, _ = cfgs(budget)
        reqs = requests(jcfg, specs, seed)
        j_eng = JaxEngine(jcfg, params[0], max_len=128, options=options(opt_kw, True))
        t_eng = port_engine(params, budget, opt_kw)
        j_ample = j_eng.serve([dict(r) for r in reqs], collect_logits=True, **kw)
        t_ample = t_eng.serve([dict(r) for r in reqs], collect_logits=True, **kw)
        kw = dict(kw)
        if pool == "half":
            kw["num_pages"] = 1 + (j_ample["stats"]["peak_pages_used"] + 1) // 2
        j_kw, t_kw = dict(kw), dict(kw)
        if bounded:
            # probe the unbounded run's peak host footprint, then halve it
            # so the bounded run must demote to disk to keep serving
            probe = j_eng.serve([dict(r) for r in reqs], eviction=JEviction(**ev_kw), **kw)
            cap = HOST_CAP[name] = max(1, probe["stats"]["swap"]["peak_host_bytes"] // 2)
            tmp = tmp_path_factory.mktemp(name)
            j_kw["swap_config"] = JSwapConfig(host_capacity_bytes=cap,
                                              disk_dir=str(tmp / "jax"))
            t_kw["swap_config"] = SwapConfig(host_capacity_bytes=cap,
                                             disk_dir=str(tmp / "port"))
        j_ev = j_eng.serve([dict(r) for r in reqs], collect_logits=True,
                           eviction=JEviction(**ev_kw), **j_kw)
        t_ev = t_eng.serve([dict(r) for r in reqs], collect_logits=True,
                           eviction=EvictionConfig(**ev_kw), **t_kw)
        cache[name] = (j_ample, j_ev, t_ample, t_ev, reqs)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(CASES))
def test_eviction_matches_jax(runs, name):
    j_ample, j_ev, t_ample, t_ev, reqs = runs(name)
    st = t_ev["stats"]
    for key in COUNTERS:
        assert st[key] == j_ev["stats"][key], key
    assert st["errors"] == {} and st["retired"] == len(reqs)
    assert st["evictions"] > 0
    if CASES[name][5].get("max_resident_pages"):      # the cap forces replays
        assert st["replay_steps"] > 0 and st["page_restores"] > 0
    for r in reqs:
        rid = r["rid"]
        assert t_ev[rid] == j_ev[rid], f"rid {rid} tokens"
        assert len(t_ev[rid]) == r["max_new_tokens"]
        np.testing.assert_allclose(t_ev["logits"][rid], j_ev["logits"][rid],
                                   atol=LOGIT_TOL, rtol=0)
    if CASES[name][1].get("quantize"):
        # the reference's own int8 replays requantize the trailing page
        # again; the port matches it, drift included (module docstring)
        for r in reqs:
            assert t_ev[r["rid"]] == t_ample[r["rid"]] == j_ample[r["rid"]]
    else:
        for r in reqs:                 # fp: bitwise the port's ample run
            rid = r["rid"]
            assert t_ev[rid] == t_ample[rid]
            np.testing.assert_array_equal(t_ev["logits"][rid], t_ample["logits"][rid])


def test_eviction_degrades_pages_before_requests(runs, params):
    """At half the pool, eviction preempts fewer whole requests than the
    same pool without it (which must preempt), in both packages."""
    _, j_ev, _, t_ev, reqs = runs("half-pool")
    pool = t_ev["stats"]["num_pages"]
    base = port_engine(params, 16).serve([dict(r) for r in reqs], n_slots=3,
                                         num_pages=pool)
    assert base["stats"]["preemptions"] > 0
    assert t_ev["stats"]["preemptions"] < base["stats"]["preemptions"]


def test_bounded_swap_spills_to_disk(runs):
    _, j_ev, _, t_ev, _ = runs("bounded-swap")
    sw = t_ev["stats"]["swap"]
    assert 0 < sw["peak_host_bytes"] <= HOST_CAP["bounded-swap"]
    assert sw["demotions"] > 0 and sw["promotions"] > 0 and sw["peak_disk_bytes"] > 0
    assert sw["host_entries"] == 0 and sw["disk_entries"] == 0
    assert sw == j_ev["stats"]["swap"]


def test_unconstrained_eviction_is_the_ample_run(params):
    """Eviction on over the default pool: nothing is evicted and the run is
    bitwise the port's run without eviction (the clamped table and the
    touched-pages telemetry change no number)."""
    jcfg, _ = cfgs(32)
    reqs = requests(jcfg, [(21, 8), (37, 5), (16, 11), (29, 7)], 2)
    eng = port_engine(params, 32)
    ample = eng.serve([dict(r) for r in reqs], n_slots=3, collect_logits=True)
    ev = eng.serve([dict(r) for r in reqs], n_slots=3, collect_logits=True, eviction=True)
    assert ev["stats"]["evictions"] == ev["stats"]["replay_steps"] == 0
    for r in reqs:
        assert ev[r["rid"]] == ample[r["rid"]]
        np.testing.assert_array_equal(ev["logits"][r["rid"]], ample["logits"][r["rid"]])


def test_eviction_rejects_incompatible_modes(params):
    jcfg, _ = cfgs(16)
    reqs = requests(jcfg, [(20, 4)], 0)
    eng = port_engine(params, 16)
    with pytest.raises(ValueError, match="lazy"):
        eng.serve(reqs, admission="reserve", eviction=EvictionConfig())
    for policy in (DensePolicy(), QuestRecomputePolicy(), OraclePolicy()):
        with pytest.raises(ValueError, match="reads_full_kv"):
            TOptions(policy=policy, track_evictions=True)
    for sched in (SelectionSchedule(dense_first_n=1), SelectionSchedule(select_layer=1)):
        with pytest.raises(ValueError, match="DENSE"):
            TOptions(schedule=sched, track_evictions=True)
    dense = DecodeEngine(cfgs(16)[1], params[1], max_len=128, device="cpu",
                         options=TOptions(policy=DensePolicy()))
    with pytest.raises(ValueError, match="reads_full_kv"):
        dense.serve(reqs, eviction=EvictionConfig())
    # a reuse schedule stages no layer DENSE and is taken, as in the reference
    TOptions(schedule=SelectionSchedule(select_layer=0, correction_layers=(1,)),
             track_evictions=True)


def test_ghost_rows_and_gate_row_copy_match_jax():
    """``init_pages(ghost_rows=)`` extends the Kg and min/max pools only;
    ``copy_gate_rows`` parks rows as the reference's does; the restore
    bytes of one page equal the reference's, fp and int8."""
    jcfg, tcfg = cfgs(16)
    rng = np.random.default_rng(4)
    for quantize in (None, "int8"):
        jp = j_pg.init_pages(jcfg, 6, 2, with_meta=True, ghost_rows=5, quantize=quantize)
        tp = t_pg.init_pages(tcfg, 6, 2, with_meta=True, ghost_rows=5, quantize=quantize,
                             device="cpu")
        for a, b in zip(jp, tp):
            assert (a is None) == (b is None)
            assert a is None or tuple(a.shape) == tuple(b.shape)
        assert tp.kg_pages.shape[1] == tp.kmin_pages.shape[1] == 11
        assert tp.k_pages.shape[1] == 6
        assert (EvictionManager.page_restore_bytes(tp)
                == JManager.page_restore_bytes(jp))
        fill = [rng.normal(size=a.shape).astype(np.float32) for a in jp[2:5]]
        jp = jp._replace(kg_pages=jnp.asarray(fill[0]), kmin_pages=jnp.asarray(fill[1]),
                         kmax_pages=jnp.asarray(fill[2]))
        for pool, x in zip((tp.kg_pages, tp.kmin_pages, tp.kmax_pages), fill):
            pool.copy_(torch.from_numpy(x))
        src, dst = [3, 1], [9, 6]
        jp = j_pg.copy_gate_rows(jp, j_pg.pad_page_ids(src), j_pg.pad_page_ids(dst))
        t_pg.copy_gate_rows(tp, t_pg.pad_page_ids(src), t_pg.pad_page_ids(dst))
        for a, b in zip(jp[2:5], tp[2:5]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_touched_pages_match_jax():
    rng = np.random.default_rng(5)
    idx = rng.integers(-1, 9, size=(3, 2, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        t_ac._touched_pages(torch.from_numpy(idx), 9).numpy(),
        np.asarray(j_ac._touched_pages(jnp.asarray(idx), 9)))
    new_len = np.array([0, 5, 17], np.int32)
    np.testing.assert_array_equal(
        t_ac._dense_touched(torch.from_numpy(new_len), 8, 4).numpy(),
        np.asarray(j_ac._dense_touched(jnp.asarray(new_len), 8, 4)))
    per_layer = [(torch.zeros(()),) + (torch.zeros(3),) * 3
                 + (torch.from_numpy(rng.random((3, 9)) < 0.2),) for _ in range(3)]
    agg = t_ac.aggregate_decode_aux(per_layer)
    np.testing.assert_array_equal(agg["touched_pages"].numpy(),
                                  np.any([a[4].numpy() for a in per_layer], axis=0))


def test_block_heat_matches_jax():
    rng = np.random.default_rng(6)
    t, j = BlockHeat(3, 5, decay=0.7), JHeat(3, 5, decay=0.7)
    for step in range(12):
        touched = rng.random((3, 5)) < 0.4
        active = rng.random(3) < 0.8
        t.observe(touched, active)
        j.observe(touched, active)
        if step % 5 == 4:
            t.reset_row(step % 3)
            j.reset_row(step % 3)
        assert t.step == j.step
        np.testing.assert_array_equal(t.ema, j.ema)
        np.testing.assert_array_equal(t.last_touch, j.last_touch)
