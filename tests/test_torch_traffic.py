"""Open-loop traffic, SLO tiers and the streaming frontend of the port on
the CPU, against the live JAX package.

* ``serve/traffic.py``: the same seeded Poisson trace field by field, the
  same synthetic prompts, the JSONL round trip (each package reads the
  other's file), the same refusals of malformed traces,
  ``StepArrivals.pull`` and ``upfront_requests``.
* ``core/policy.py``'s tiers: ``TierSpec``/``TierPolicy``/``default_tiers``
  map request dicts as the reference's do.
* The scheduler's lifecycle stamps and its ``on_token`` stream.
* ``ServingFrontend`` over the reduced qwen3_0_6b (2 layers, float32, gate
  block 8, the weights of ``tests/test_torch_eviction.py``): token streams
  and every virtual-step stat equal to the JAX frontend's, two runs equal,
  streams exactly once and in order across preemption, an unservable
  arrival failing alone, and the latency tier's p99 TTFT (in steps) below
  the throughput tier's.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as j_configs
from repro.config import reduced as j_reduced
from repro.core import policy as j_policy
from repro.models.registry import get_api
from repro.serve import traffic as j_tr
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.frontend import ServingFrontend as JFrontend
from repro.serve.frontend import tier_latency_stats as j_tier_stats
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as t_policy
from repro_torch.core.policy import TierPolicy, TierSpec, default_tiers
from repro_torch.serve import traffic as t_tr
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig
from repro_torch.serve.frontend import ServingFrontend, tier_latency_stats
from repro_torch.serve.scheduler import Request, Scheduler

jax.config.update("jax_platform_name", "cpu")

STEP_KEYS = ("submit_step", "admit_step", "first_token_step", "retire_step", "n_tokens")


def cfgs(token_budget=16):
    gate = dict(block_size=8, d_gate=16, token_budget=token_budget)
    j = j_reduced(j_configs.get("qwen3_0_6b")).replace(dtype="float32")
    t = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return (j.replace(gate=dataclasses.replace(j.gate, **gate)),
            t.replace(gate=dataclasses.replace(t.gate, **gate)))


# ---------------------------------------------------------------------------
# traffic generator
# ---------------------------------------------------------------------------

def _as_tuple(entries):
    return [dataclasses.astuple(e) for e in entries]


def test_poisson_trace_matches_jax_and_roundtrips(tmp_path):
    kw = dict(seed=23, prompt_len=(4, 20), output_len=(3, 9),
              tiers={"latency": 0.3, "throughput": 0.7})
    a = t_tr.poisson_trace(12, 0.4, **kw)
    assert a == t_tr.poisson_trace(12, 0.4, **kw)          # deterministic
    assert a != t_tr.poisson_trace(12, 0.4, **{**kw, "seed": 24})
    assert _as_tuple(a) == _as_tuple(j_tr.poisson_trace(12, 0.4, **kw))
    assert {e.tier for e in a} == {"latency", "throughput"}
    path = str(tmp_path / "trace.jsonl")
    t_tr.save_trace(a, path)
    assert t_tr.load_trace(path) == a                      # exact round trip
    assert _as_tuple(j_tr.load_trace(path)) == _as_tuple(a)
    j_tr.save_trace(j_tr.poisson_trace(12, 0.4, **kw), str(tmp_path / "j.jsonl"))
    assert open(path).read() == open(tmp_path / "j.jsonl").read()
    for e in a:
        je = j_tr.TraceEntry(**dataclasses.asdict(e))
        np.testing.assert_array_equal(t_tr.synth_prompt(e, 97), j_tr.synth_prompt(je, 97))
    up_t = t_tr.upfront_requests(a, 97, tier_policy=default_tiers(cfgs()[1]))
    up_j = j_tr.upfront_requests(j_tr.poisson_trace(12, 0.4, **kw), 97,
                                 tier_policy=j_policy.default_tiers(cfgs()[0]))
    for rt, rj in zip(up_t, up_j):
        assert rt.keys() == rj.keys()
        for key in rt:
            np.testing.assert_array_equal(rt[key], rj[key])


@pytest.mark.parametrize("bad,msg", [
    ([(0, 1.0, 4, 2), (0, 2.0, 4, 2)], "duplicate"),
    ([(0, 1.0, 4, 2), (1, 0.5, 4, 2)], "sorted"),
    ([(0, 0.0, 0, 2)], "prompt_len"),
    ([(0, 0.0, 4, 0)], "output_len"),
])
def test_validate_trace_matches_jax(bad, msg):
    for mod in (t_tr, j_tr):
        trace = [mod.TraceEntry(rid=r, arrival=a, prompt_len=p, output_len=o)
                 for r, a, p, o in bad]
        with pytest.raises(ValueError, match=msg):
            mod.validate_trace(trace)
    with pytest.raises(ValueError, match="rate"):
        t_tr.poisson_trace(3, 0.0)


def test_step_arrivals_pull():
    trace = [t_tr.TraceEntry(rid=0, arrival=0.0, prompt_len=4, output_len=2),
             t_tr.TraceEntry(rid=1, arrival=1.5, prompt_len=4, output_len=2),
             t_tr.TraceEntry(rid=2, arrival=1.7, prompt_len=4, output_len=2)]
    arr = t_tr.StepArrivals(trace, vocab_size=64)
    jarr = j_tr.StepArrivals([j_tr.TraceEntry(**dataclasses.asdict(e)) for e in trace], 64)
    for step, want in ((0, [0]), (1, []), (2, [1, 2]), (99, [])):
        got = arr.pull(step)
        assert [r["rid"] for r in got] == want == [r["rid"] for r in jarr.pull(step)]
    assert arr.exhausted and jarr.exhausted


# ---------------------------------------------------------------------------
# SLO tiers
# ---------------------------------------------------------------------------

def test_tier_mapping_matches_jax():
    jcfg, tcfg = cfgs()
    t, j = default_tiers(tcfg), j_policy.default_tiers(jcfg)
    base = {"rid": 0, "tokens": np.zeros(4, np.int32), "max_new_tokens": 2}
    for req, tier in ((dict(base, tier="latency"), None),
                      (dict(base, budget=8), "throughput"),
                      (dict(base), None)):
        assert t.apply(req, tier).keys() == j.apply(req, tier).keys()
        got, want = t.apply(req, tier), j.apply(req, tier)
        assert {k: v for k, v in got.items() if k != "tokens"} == \
            {k: v for k, v in want.items() if k != "tokens"}
    lat = t.apply(dict(base, tier="latency"))
    assert lat["priority"] > 0 and lat["reserve"] is True and lat["budget"] > 0
    assert t.apply(dict(base, budget=8), "throughput")["budget"] == 8
    with pytest.raises(ValueError, match="unknown tier"):
        t.apply({"rid": 2}, "gold")
    with pytest.raises(ValueError, match="admission"):
        TierSpec(name="x", admission="eager")
    with pytest.raises(ValueError, match="duplicate"):
        TierPolicy(tiers=(TierSpec(name="a"), TierSpec(name="a")))


# ---------------------------------------------------------------------------
# scheduler stamps and stream
# ---------------------------------------------------------------------------

def test_lifecycle_stamps_and_on_token():
    sched = Scheduler(n_slots=1, num_pages=16, page_size=4, max_pages_per_seq=4)
    sched.now = 3
    r = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=2)
    sched.submit(r)
    assert r.submit_step == 3 and r.t_submit > 0
    sched.now = 5
    sched.admissions()
    assert r.admit_step == 5
    seen = []
    sched.on_token = lambda req, tok, idx, step: seen.append((req.rid, tok, idx, step))
    sched.complete_step(np.array([7], np.int32))
    assert r.first_token_step == 5
    sched.now = 6
    sched.complete_step(np.array([8], np.int32))
    assert r.retire_step == 6 and r.first_token_step == 5
    assert seen == [(0, 7, 0, 5), (0, 8, 1, 6)]


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = cfgs()
    p = get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return (JaxEngine(jcfg, p, max_len=128),
            DecodeEngine(tcfg, params_from_numpy(jax.device_get(p), tcfg, "cpu"),
                         max_len=128, device="cpu"))


def _two_tiers(mod):
    return mod.TierPolicy(tiers=(
        mod.TierSpec(name="latency", priority=10, admission="reserve"),
        mod.TierSpec(name="throughput", priority=0, admission="lazy")))


def _same_steps(a, b, trace):
    for e in trace:
        assert a[e.rid] == b[e.rid], f"rid {e.rid}"
        for key in STEP_KEYS:
            assert (a["stats"]["timing_by_rid"][e.rid][key]
                    == b["stats"]["timing_by_rid"][e.rid][key]), (e.rid, key)
    assert a["stats"]["errors"] == b["stats"]["errors"]
    for tier, row in a["stats"]["tiers"].items():
        other = b["stats"]["tiers"][tier]
        for key in ("n", "incomplete", "tokens", "ttft_steps_p50", "ttft_steps_p99",
                    "tpot_steps_p50", "tpot_steps_p99"):
            assert row[key] == other[key] or (np.isnan(row[key]) and np.isnan(other[key])), \
                (tier, key)


def test_frontend_matches_jax_and_is_deterministic(engines):
    j_eng, t_eng = engines
    kw = dict(seed=11, prompt_len=(6, 24), output_len=(4, 10),
              tiers={"latency": 0.4, "throughput": 0.6})
    trace = t_tr.poisson_trace(5, 0.3, **kw)
    runs = [ServingFrontend(t_eng, tier_policy=_two_tiers(t_policy), n_slots=2).run(
        trace, collect_events=True) for _ in range(2)]
    a, b = runs
    for e in trace:
        assert len(a[e.rid]) == e.output_len
    _same_steps(a, b, trace)
    ev = [[(e.rid, e.token, e.index, e.step) for e in r["events"]] for r in runs]
    assert ev[0] == ev[1]
    jr = JFrontend(j_eng, tier_policy=_two_tiers(j_policy), n_slots=2).run(
        j_tr.poisson_trace(5, 0.3, **kw), collect_events=True)
    _same_steps(a, jr, trace)
    assert ev[0] == [(e.rid, e.token, e.index, e.step) for e in jr["events"]]


def test_streaming_exactly_once_across_preemption(engines):
    j_eng, t_eng = engines
    trace = [t_tr.TraceEntry(rid=i, arrival=0.0, prompt_len=10, output_len=18,
                             seed=100 + i) for i in range(3)]
    free = ServingFrontend(t_eng, n_slots=3).run(trace)
    assert free["stats"]["preemptions"] == 0
    pool = 1 + (free["stats"]["peak_pages_used"] + 1) // 2
    for eviction in (None, EvictionConfig()):
        events = []
        res = ServingFrontend(t_eng, n_slots=3, num_pages=pool, eviction=eviction).run(
            trace, on_token=events.append)
        st = res["stats"]
        assert st["errors"] == {}
        if eviction is None:
            assert st["preemptions"] > 0               # the pressure is real
        streams = {}
        for ev in events:                             # exactly once, in order
            assert ev.index == len(streams.setdefault(ev.rid, []))
            streams[ev.rid].append(ev.token)
        for e in trace:
            assert streams[e.rid] == res[e.rid] == free[e.rid]
        assert [e.step for e in events] == sorted(e.step for e in events)
    jres = JFrontend(j_eng, n_slots=3, num_pages=pool).run(
        [j_tr.TraceEntry(**dataclasses.asdict(e)) for e in trace])
    res = ServingFrontend(t_eng, n_slots=3, num_pages=pool).run(trace)
    _same_steps(res, jres, trace)
    assert res["stats"]["preemptions"] == jres["stats"]["preemptions"]


def test_arrival_failure_isolated_mid_run(engines):
    j_eng, t_eng = engines
    trace = [t_tr.TraceEntry(rid=0, arrival=0.0, prompt_len=10, output_len=6),
             t_tr.TraceEntry(rid=1, arrival=2.0, prompt_len=60, output_len=4),
             t_tr.TraceEntry(rid=2, arrival=3.0, prompt_len=10, output_len=6)]
    res = ServingFrontend(t_eng, n_slots=2, num_pages=7).run(trace)
    st = res["stats"]
    assert "submit_rejected" in st["errors"][1]
    assert len(res[0]) == 6 and len(res[2]) == 6
    assert st["failed"] == 1 and st["retired"] == 2
    jres = JFrontend(j_eng, n_slots=2, num_pages=7).run(
        [j_tr.TraceEntry(**dataclasses.asdict(e)) for e in trace])
    _same_steps(res, jres, trace)


def test_latency_tier_p99_ttft_beats_throughput(engines):
    _, t_eng = engines
    # a burst of throughput work fills both slots; latency requests arrive
    # INTO the backlog and must jump the pending queue
    trace = [t_tr.TraceEntry(rid=i, arrival=0.0, prompt_len=10, output_len=12,
                             tier="throughput", seed=i) for i in range(4)]
    trace += [t_tr.TraceEntry(rid=4 + j, arrival=1.0, prompt_len=10, output_len=6,
                              tier="latency", seed=40 + j) for j in range(2)]
    res = ServingFrontend(t_eng, tier_policy=_two_tiers(t_policy), n_slots=2, num_pages=9).run(trace)
    rows = res["stats"]["tiers"]
    assert res["stats"]["errors"] == {}
    assert rows["latency"]["n"] == 2 and rows["throughput"]["n"] == 4
    assert rows["latency"]["ttft_steps_p99"] < rows["throughput"]["ttft_steps_p99"]
    # the same load without tiers: FIFO makes the late arrivals wait
    flat = ServingFrontend(t_eng, n_slots=2, num_pages=9).run(trace)

    def ttft(r, rid):
        tm = r["stats"]["timing_by_rid"][rid]
        return tm["first_token_step"] - tm["submit_step"]
    assert max(ttft(res, r) for r in (4, 5)) < max(ttft(flat, r) for r in (4, 5))


def test_sync_serve_timing_and_tier_stats(engines):
    j_eng, t_eng = engines
    trace = t_tr.poisson_trace(3, 0.5, seed=3, prompt_len=(6, 20), output_len=(3, 6))
    reqs = t_tr.upfront_requests(trace, t_eng.cfg.vocab_size)
    res = t_eng.serve(reqs, n_slots=2)
    jres = j_eng.serve(j_tr.upfront_requests(
        [j_tr.TraceEntry(**dataclasses.asdict(e)) for e in trace], t_eng.cfg.vocab_size),
        n_slots=2)
    for e in trace:
        tm = res["stats"]["timing_by_rid"][e.rid]
        assert tm["submit_step"] == 0 and tm["first_token_step"] == tm["admit_step"]
        assert tm["n_tokens"] == e.output_len
        assert tm["t_retire"] >= tm["t_first"] >= tm["t_submit"] > 0
        for key in STEP_KEYS:
            assert tm[key] == jres["stats"]["timing_by_rid"][e.rid][key]
    rows, jrows = tier_latency_stats(res["stats"]), j_tier_stats(jres["stats"])
    assert rows.keys() == jrows.keys() == {"default"}
    for key in ("n", "incomplete", "tokens", "ttft_steps_p99", "tpot_steps_p50"):
        assert rows["default"][key] == jrows["default"][key]


def test_arrivals_need_max_steps_and_table_pages(engines):
    _, t_eng = engines
    arr = t_tr.StepArrivals([t_tr.TraceEntry(rid=0, arrival=0.0, prompt_len=4,
                                             output_len=2)], t_eng.cfg.vocab_size)
    with pytest.raises(ValueError, match="max_steps"):
        t_eng.serve([], arrivals=arr, table_pages=4)
    with pytest.raises(ValueError, match="table_pages"):
        t_eng.serve([], arrivals=arr, max_steps=10)
