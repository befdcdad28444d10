"""Every decode option on the port's head-sharded ``serve``, at world size 2
(two gloo ranks on the CPU), against the port's unsharded engine and the
live unsharded JAX reference.

The reference's sharded path does not run on this toolchain (ROADMAP,
reference caveats), so the sharded port is held to the unsharded runs, as
``tests/test_torch_sharded.py`` holds its trivial-schedule serve. Cases
(``tests/torch_sharded_helpers.py::OPTION_CASES``), each over an ample
pool and a preempting one, on the tiny config (the schedule's cases at
15 layers, the others at its 2):

  * the dense 2 / select 2 / correction 14 SelectionSchedule: the carried
    plan holds each rank's KV heads; and the same with ``unify_heads``,
    whose max over heads is reduced over ranks;
  * per-request budgets (16 tokens, 20 tokens rounded up, no cap);
  * stochastic sampling (the options' top-p and a request's top-k/top-p
    override) from ``sample_seed``: every rank reads the same logits and
    draws from the same generator;
  * open-loop arrivals through ``ServingFrontend`` with the default SLO
    tiers (the tiers set budgets and reserve admission).

At ``split_k=1`` the tokens, every id list the gate returns (rank r's KV
heads of the unsharded run's, ties included) and the step-clock stats
are the unsharded port's, exactly, and the logits lie within LOGIT_TOL
of its logits (each rank holds its block of the weights, and the
row-split ``wo`` and MLP sum their partials over the ranks in another
order, as the reference's production layout does); the greedy tokens
equal the JAX engine's, and so do its counters and, under arrivals,
TTFT/TPOT in decode steps by tier. At ``split_k=4`` (a schedule with budget caps) the logits
lie within 8 bf16 ulps of max|logit| of the unsharded run's, the rule
``chip_smoke.py`` holds split-K to. The same spawn runs the
sequence-sharded ``generate`` under stochastic sampling: both ranks draw
the unsharded engine's tokens from one generator seed. Every case runs in
one spawn of two ranks.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.models import transformer as j_tf
from repro.serve import traffic as j_traffic
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.frontend import ServingFrontend as JFrontend
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import DecodeOptions as TOptions
from repro_torch.core.policy import SelectionSchedule as TSchedule
from repro_torch.distributed.sharding import Shard
from repro_torch.serve import traffic as t_traffic
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

WORLD = 2
ULPS = 8                      # chip_smoke.py's DECODE_ULPS: split-K reorders sums
LOGIT_TOL = 1e-4              # tests/test_torch_sharded.py: the ranks' partial sums
GREEDY = ("schedule", "schedule-unify", "budgets", "arrivals")
JAX_OPTIONS = {
    "schedule": JP.DecodeOptions(schedule=JP.SelectionSchedule(**H.SCHEDULE)),
    "schedule-unify": JP.DecodeOptions(schedule=JP.SelectionSchedule(
        **H.SCHEDULE, unify_heads=True)),
    "budgets": JP.DecodeOptions(),
    "arrivals": JP.DecodeOptions(),
}


def _cfgs(layers=H.OPTION_LAYERS):
    gate = dict(block_size=8, d_gate=16, token_budget=32)
    out = []
    for cfg in (j_reduced(j_configs.get("qwen3_0_6b")), t_reduced(t_get("qwen3_0_6b"))):
        cfg = cfg.replace(dtype="float32", num_layers=layers)
        out.append(cfg.replace(gate=dataclasses.replace(cfg.gate, **gate)))
    return out


def _trace():
    return t_traffic.poisson_trace(5, 0.5, seed=7, prompt_len=(16, 40), output_len=(3, 7),
                                   tiers={"latency": 0.35, "throughput": 0.65})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX runs, port unsharded runs, per-rank sharded runs), keyed by
    (case, pool)."""
    models = {}                     # layers -> (JAX cfg, JAX params, port cfg)
    for n in {case[0] for case in H.OPTION_CASES.values()}:
        jcfg, tcfg = _cfgs(n)
        models[n] = (jcfg, j_tf.init_lm(jax.random.PRNGKey(0), jcfg), tcfg)
    rng = np.random.default_rng(5)
    reqs = [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, 256, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(H.OPTION_SPECS)]
    trace = _trace()
    tmp = tmp_path_factory.mktemp("options")
    np_models = {n: (tcfg, jax.device_get(p)) for n, (_, p, tcfg) in models.items()}
    H.join(mp.spawn(H.run, args=(WORLD, str(tmp / "options.store"), "options",
                                 (np_models, reqs, trace), str(tmp)),
                    nprocs=WORLD, join=False), str(tmp), "options")
    sharded = [torch.load(tmp / f"options-{r}.pt", weights_only=False)
               for r in range(WORLD)]
    tparams = {n: params_from_numpy(p, tcfg, "cpu") for n, (tcfg, p) in np_models.items()}
    port = {"generate-sampling": H.sampled_generate(None, np_models[2][0], tparams[2]),
            "generate-greedy": H.sampled_generate(None, np_models[2][0], tparams[2],
                                                  TOptions())}
    for run in H.OPTION_RUNS:
        n = H.OPTION_CASES[run[0]][0]
        port[run] = H.option_case(None, np_models[n][0], tparams[n], *run, reqs, trace)
    jtrace = [j_traffic.TraceEntry(**dataclasses.asdict(e)) for e in trace]
    ref, engines = {}, {}
    for name in GREEDY:
        n, _, extra, _ = H.OPTION_CASES[name]
        jcfg, params, _ = models[n]
        opts = JAX_OPTIONS[name]
        if (n, opts) not in engines:       # one compiled step per model and options
            engines[n, opts] = JaxEngine(jcfg, params, max_len=64, options=opts)
        eng = engines[n, opts]
        for pool in H.POOLS:
            if name == "arrivals":
                ref[name, pool] = JFrontend(eng, tier_policy=JP.default_tiers(jcfg),
                                            **H.FRONTEND_POOLS[pool]).run(jtrace)
            else:
                ref[name, pool] = eng.serve(
                    [dict(r, **extra.get(r["rid"], {})) for r in reqs], **H.POOLS[pool])
    return ref, port, sharded


def _ulps(a, b):
    """|a - b| in bf16 ulps of max|a|."""
    top = float(np.abs(a).max())
    ulp = float(torch.finfo(torch.bfloat16).eps) * 2.0 ** np.floor(np.log2(top))
    return float(np.abs(a - b).max()) / ulp


@pytest.mark.parametrize("run", H.OPTION_RUNS, ids=["-".join(r) for r in H.OPTION_RUNS])
def test_sharded_option_is_the_unsharded_run(runs, run):
    _, port, sharded = runs
    a, b = (rank[run] for rank in sharded)
    want = port[run]
    assert a["tokens"] == b["tokens"], "ranks picked different tokens"
    for rid in a["logits"]:
        np.testing.assert_array_equal(a["logits"][rid], b["logits"][rid])
    assert a["stats"] == b["stats"] and a["timing"] == b["timing"]
    assert all(len(t) > 0 for t in a["tokens"].values())
    if run[0].endswith("split4"):
        # split-K reorders the softmax sums: the first decode step's logits
        # (and every step's up to a request's first differing token) lie
        # within ULPS bf16 ulps of the unsharded run's
        for rid, toks in want["tokens"].items():
            got = a["logits"][rid]
            n = next((i for i, (x, y) in enumerate(zip(a["tokens"][rid], toks)) if x != y),
                     len(toks))
            assert n > 1, f"rid {rid}: differs at the first decode step"
            worst = _ulps(want["logits"][rid][:n], got[:n])
            assert worst <= ULPS, f"rid {rid}: {worst:.2f} bf16 ulps"
        return
    assert a["tokens"] == want["tokens"]
    for rid in want["logits"]:
        np.testing.assert_allclose(a["logits"][rid], want["logits"][rid], atol=LOGIT_TOL,
                                   rtol=0)
    assert a["stats"] == want["stats"] and a["timing"] == want["timing"]
    assert a.get("tiers") == want.get("tiers")
    # each rank's id lists are its KV heads of the unsharded run's, call by call
    assert len(want["ids"]) > 0
    for r, rank in enumerate(sharded):
        ids = rank[run]["ids"]
        assert len(ids) == len(want["ids"])
        hl = ids[0].shape[1]
        for got, full in zip(ids, want["ids"]):
            np.testing.assert_array_equal(got, full[:, r * hl:(r + 1) * hl])
    if run[0].startswith("schedule"):
        # two selecting layers a step: the plan is carried through the rest
        steps = a["stats"]["decode_steps"]
        assert len(want["ids"]) <= 2 * steps
    if run[1] == "tight" and run[0] != "arrivals":
        assert a["stats"]["preemptions"] > 0


@pytest.mark.parametrize("run", [r for r in H.OPTION_RUNS if r[0] in GREEDY],
                         ids=["-".join(r) for r in H.OPTION_RUNS if r[0] in GREEDY])
def test_sharded_greedy_option_matches_reference(runs, run):
    ref, _, sharded = runs
    got, want = sharded[0][run], ref[run]
    for rid, toks in got["tokens"].items():
        assert toks == want[rid], f"rid {rid}"
    for key in ("preemptions", "resumed", "decode_steps", "swapped_out_bytes",
                "swapped_in_bytes", "errors"):
        assert got["stats"][key] == want["stats"][key], key
    for rid, val in want["stats"]["sparsity_by_rid"].items():
        assert got["stats"]["sparsity_by_rid"][rid] == pytest.approx(val, abs=1e-6)
    if run[0] == "arrivals":
        for tier, row in got["tiers"].items():
            for key, val in row.items():
                assert val == pytest.approx(want["stats"]["tiers"][tier][key], nan_ok=True), \
                    (tier, key)


def test_sharded_sampling_draws_on_every_rank(runs):
    """The stochastic case is stochastic: its draws differ from the
    greedy tokens of the same requests, on both pools alike."""
    _, port, sharded = runs
    for pool in H.POOLS:
        drawn = sharded[0][("sampling", pool)]["tokens"]
        greedy = port[("budgets", pool)]["tokens"]
        assert drawn[2] != greedy[2]
        assert drawn == sharded[0][("sampling", "ample")]["tokens"]


def test_sharded_generate_samples_as_unsharded(runs):
    """The sequence-sharded ``generate`` under top-p sampling: every rank
    reads the same combined logits and draws from the same seed, so both
    ranks pick the unsharded engine's tokens; the draws are not the
    greedy tokens."""
    _, port, sharded = runs
    a, b = (rank["generate-sampling"] for rank in sharded)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, port["generate-sampling"])
    assert a.shape == (H.GEN_SHAPE[0], H.GEN_NEW)
    assert not np.array_equal(a, port["generate-greedy"])


def test_sequence_sharded_generate_refuses_a_schedule():
    """``generate``'s sequence-sharded step fuses selection into its
    collectives: a non-trivial schedule raises ValueError before the
    prefill runs, as the reference refuses a carried plan there; ``serve``
    on the same engine takes it."""
    _, tcfg = _cfgs(3)
    from repro_torch.models.transformer import init_lm
    params = init_lm(torch.Generator().manual_seed(0), tcfg)
    stub = object.__new__(Shard)
    stub.rank, stub.world, stub.group, stub.device = 0, 1, None, torch.device("cpu")
    assert not dist.is_initialized()
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    for sched in (TSchedule(unify_heads=True), TSchedule(select_layer=1)):
        eng = DecodeEngine(tcfg, params, max_len=64, device="cpu", shard=stub,
                           options=TOptions(schedule=sched))
        assert eng.options.schedule == sched
        eng.prefill = None                  # a call would raise TypeError
        with pytest.raises(ValueError, match="trivial schedule"):
            eng.generate({"tokens": toks}, 3)
