"""The port's serving launcher and its two serving examples against the
live JAX engine on the CPU.

``repro_torch.launch.serve``, ``repro_torch.examples.serve_sparse`` and
``repro_torch.examples.serve_stream`` are each given the reference's
parameters (``init_params`` with a JAX key, carried across by
``convert.params_from_numpy``) and run on the CPU in float32; the
reference's ``DecodeEngine`` (its API, not its scripts) runs the same
calls on the same prompts. Held exactly:

  * the launcher's ``generate`` under the gate (budget and threshold),
    Quest and dense: greedy tokens equal; measured sparsity within 1e-6;
  * ``serve_sparse``: ``generate`` at 16-token blocks, and ``--paged``
    with the ragged requests of ``np.random.default_rng(3)`` (request 0 at
    half the budget) under lazy and reserve admission, under page
    eviction at a short pool (evictions and replays happen) and over
    int8 pools, held to the reference's int8: tokens equal, sparsity by
    request within 1e-6, the pressure counters equal;
  * ``serve_stream``: one Poisson trace through ``ServingFrontend`` with
    the default tiers: the streamed (rid, token, index, step) events
    equal, and TTFT/TPOT in decode steps by tier;
  * each ``main`` runs with ``--device cpu`` and, without a device and
    with no card, raises naming the missing CUDA device.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.models.registry import get_api as j_get_api
from repro.serve import traffic as j_traffic
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.eviction import EvictionConfig as JEviction
from repro.serve.frontend import ServingFrontend as JFrontend
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import DecodeOptions
from repro_torch.examples import distill_and_eval, quickstart, serve_sparse, serve_stream
from repro_torch.launch import serve as launch_serve

jax.config.update("jax_platform_name", "cpu")

B, PREFILL, NEW = 2, 64, 8


def _pair(tcfg, jcfg=None):
    """(reference cfg, port cfg) in float32, the reference's the same
    fields as the port's."""
    tcfg = tcfg.replace(dtype="float32")
    if jcfg is None:
        jcfg = j_reduced(j_configs.get(tcfg.arch_id))
    jcfg = jcfg.replace(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                           if f.name not in ("gate", "moe", "ssm")})
    jcfg = jcfg.replace(gate=dataclasses.replace(jcfg.gate, **dataclasses.asdict(tcfg.gate)))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    params = j_get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return params, params_from_numpy(jax.device_get(params), tcfg, "cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = {"gate": (None, "gate", False), "threshold": ("threshold", "gate", False),
          "quest": (None, "quest", False), "dense": (None, "gate", True)}


@pytest.mark.parametrize("case", list(LAUNCH))
def test_launcher_generate_matches_jax(case):
    method, policy, dense = LAUNCH[case]
    jcfg, tcfg = _pair(launch_serve.launch_config("qwen3_0_6b", reduced_scale=True,
                                                  method=method))
    jparams, tparams = _params(jcfg, tcfg)
    batch = launch_serve.launch_batch(tcfg, B, PREFILL, "cpu")
    got = launch_serve.serve_generate(tcfg, tparams, batch, new=NEW, policy=policy,
                                      dense=dense, device="cpu")
    pol = JP.get_policy(policy)
    opts = JP.DecodeOptions(policy=JP.DensePolicy() if dense else pol)
    eng = JaxEngine(jcfg, jparams, max_len=PREFILL + NEW + 16, options=opts)
    want = eng.generate({"tokens": batch["tokens"].numpy()}, NEW)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert got["policy"] == ("dense" if dense else policy)
    if dense:
        assert "sparsity" not in got
    else:
        stats = eng.sparsity_stats()
        assert got["sparsity"] == pytest.approx(stats["sparsity"], abs=1e-6)
        assert got["io_speedup"] == pytest.approx(stats["io_speedup"], rel=1e-6)
        assert 0.0 < got["sparsity"] < 1.0


def test_launcher_vision_batch_has_zero_image_embeds():
    """A vision config's batch carries zero image embeddings [B, n_img, d]
    in the config's dtype, as the reference's launcher builds them, and
    the launcher decodes it."""
    cfg = launch_serve.launch_config("llama_3_2_vision_11b", reduced_scale=True)
    batch = launch_serve.launch_batch(cfg, B, 16, "cpu")
    emb = batch["image_embeds"]
    assert emb.shape == (B, cfg.n_image_tokens, cfg.d_model)
    assert emb.dtype == getattr(torch, cfg.dtype) and not emb.any()
    res = launch_serve.main(["--arch", "llama_3_2_vision_11b", "--reduced", "--batch", "2",
                             "--prefill", "16", "--new", "3", "--device", "cpu"])
    assert res["tokens"].shape == (2, 3) and 0.0 <= res["sparsity"] <= 1.0


# ---------------------------------------------------------------------------
# serve_sparse
# ---------------------------------------------------------------------------

BUDGET = 48


def _example_models():
    return _pair(serve_sparse.example_config(budget=BUDGET))


def test_serve_sparse_generate_matches_jax():
    jcfg, tcfg = _example_models()
    jparams, tparams = _params(jcfg, tcfg)
    got = serve_sparse.run_generate(tcfg, tparams, batch=B, prefill=PREFILL, new=NEW,
                                    options=DecodeOptions(), device="cpu")
    from repro.data.pipeline import DataState, make_batch
    eng = JaxEngine(jcfg, jparams, max_len=PREFILL + NEW + 16)
    want = eng.generate({"tokens": make_batch(jcfg, B, PREFILL, DataState(3, 0))["tokens"]},
                        NEW)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert got["stats"]["sparsity"] == pytest.approx(eng.sparsity_stats()["sparsity"],
                                                     abs=1e-6)
    # stochastic sampling draws from a generator seeded 0: reproducible
    hot = DecodeOptions(sampling=serve_sparse.SamplingParams(temperature=0.8, top_p=0.95))
    a, b = (serve_sparse.run_generate(tcfg, tparams, batch=B, prefill=PREFILL, new=NEW,
                                      options=hot, device="cpu")["tokens"] for _ in "ab")
    assert torch.equal(a, b) and not torch.equal(a, got["tokens"])


# case -> (options kwargs, run_paged kwargs); the pool of 7 pages is
# short for the requests' lifetimes (eviction at the reference's defaults)
PAGED = {
    "lazy": (dict(), dict()),
    "reserve": (dict(), dict(admission="reserve")),
    "eviction": (dict(), dict(pool_pages=7, eviction=True)),
    "int8": (dict(quantize="int8"), dict()),
}
COUNTERS = ("preemptions", "resumed", "decode_steps", "evictions", "page_restores",
            "replay_steps", "peak_pages_used", "errors")


@pytest.mark.parametrize("case", list(PAGED))
def test_serve_sparse_paged_matches_jax(case):
    opt_kw, run_kw = PAGED[case]
    jcfg, tcfg = _example_models()
    jparams, tparams = _params(jcfg, tcfg)
    reqs = serve_sparse.ragged_requests(tcfg, 4, PREFILL, 16, BUDGET)
    assert reqs[0]["budget"] == BUDGET // 2
    n_slots = 2
    got = serve_sparse.run_paged(tcfg, tparams, reqs, max_len=PREFILL + 32, n_slots=n_slots,
                                 options=DecodeOptions(**opt_kw), device="cpu", **run_kw)
    eng = JaxEngine(jcfg, jparams, max_len=PREFILL + 32, options=JP.DecodeOptions(**opt_kw))
    want = eng.serve([dict(r) for r in reqs], n_slots=n_slots,
                     num_pages=run_kw.get("pool_pages"),
                     admission=run_kw.get("admission", "lazy"),
                     eviction=JEviction() if run_kw.get("eviction") else None)
    for r in reqs:
        assert got[r["rid"]] == want[r["rid"]], f"rid {r['rid']}"
        assert len(got[r["rid"]]) == r["max_new_tokens"]
    st, wst = got["stats"], want["stats"]
    for key in COUNTERS:
        assert st[key] == wst[key], key
    assert set(st["sparsity_by_rid"]) == set(wst["sparsity_by_rid"]) == {0, 1, 2, 3}
    for rid, val in wst["sparsity_by_rid"].items():
        assert st["sparsity_by_rid"][rid] == pytest.approx(val, abs=1e-6), rid
    if case == "eviction":
        assert st["evictions"] > 0 and st["replay_steps"] > 0
    # request 0's half budget binds: 24 tokens round up to 2 blocks
    assert st["sel_blocks_by_rid"][0] <= 2 < max(st["sel_blocks_by_rid"].values())


# ---------------------------------------------------------------------------
# serve_stream
# ---------------------------------------------------------------------------

def test_serve_stream_matches_jax():
    jcfg, tcfg = _pair(serve_stream.stream_config())
    jparams, tparams = _params(jcfg, tcfg)
    trace = serve_stream.example_trace(4, 0.5, 7)
    seen = {"port": [], "jax": []}
    got = serve_stream.run_stream(
        tcfg, tparams, trace, slots=2, device="cpu",
        on_token=lambda ev: seen["port"].append((ev.rid, ev.token, ev.index, ev.step)))
    jtrace = [j_traffic.TraceEntry(**dataclasses.asdict(e)) for e in trace]
    want = JFrontend(JaxEngine(jcfg, jparams, max_len=256),
                     tier_policy=JP.default_tiers(jcfg), n_slots=2).run(
        jtrace, on_token=lambda ev: seen["jax"].append((ev.rid, ev.token, ev.index, ev.step)))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == sum(
        e.output_len for e in trace)
    for e in trace:
        assert got[e.rid] == want[e.rid]
    assert set(got["stats"]["tiers"]) == {"latency", "throughput"}
    for tier, row in got["stats"]["tiers"].items():
        for key in ("n", "ttft_steps_p50", "ttft_steps_p99", "tpot_steps_p50",
                    "tpot_steps_p99"):
            assert row[key] == pytest.approx(want["stats"]["tiers"][tier][key]), (tier, key)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

CLIS = {
    "launch.serve": (launch_serve.main, ["--reduced", "--batch", "2", "--prefill", "32",
                                         "--new", "4"]),
    "serve_sparse": (serve_sparse.main, ["--batch", "2", "--prefill", "32", "--new", "4",
                                         "--paged", "--quantize", "int8"]),
    "serve_stream": (serve_stream.main, ["--requests", "2", "--quiet"]),
    "quickstart": (quickstart.main, []),
    "distill_and_eval": (distill_and_eval.main, ["--steps", "1"]),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_without_device_raises_when_no_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = CLIS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("name", ["launch.serve", "serve_sparse", "serve_stream"])
def test_cli_runs_on_cpu(name, capsys):
    main, argv = CLIS[name]
    res = main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert res is not None and "tok/s" in out
