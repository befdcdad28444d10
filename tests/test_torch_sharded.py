"""The port's sharded serving at world size 2 (two gloo ranks on the CPU)
against the live unsharded JAX reference.

The reference's own sharded path does not run on this toolchain (its
shard_map tests fail on the installed JAX), and its contract is stated
against its unsharded path, so that is what the port is held to
(tests/sharded_helpers.py):

  * head-sharded ``serve`` (``DecodeEngine(shard=...)``, each rank at its
    block of the reference's per-rank weight layout: attention by KV
    heads, the MLP by hidden units, the embedding and logits by
    vocabulary, the gate whole), the tiny config, weights and requests
    of ``paged_sharded_parity``: at ``split_k=1`` greedy tokens equal to
    the JAX engine's and to the port's own unsharded ``serve``, logits
    within LOGIT_TOL of both (a row-split ``wo`` and MLP sum their
    partials over the ranks in another order, as the reference's
    production layout does: not bitwise), also under the preempting
    10-page pool, whose preemption and swap-byte counters equal the
    unsharded run's; at ``split_k=2`` tokens equal and logits within
    LOGIT_TOL (the reference's split-K bound);
  * the same over int8 pools: within INT8_SHARD_TOL of the port's
    unsharded int8 ``serve`` and of the JAX int8 engine at ``split_k=1``
    (a rank's partial sums can move an int8 K/V code by one step), and at
    ``split_k=2`` tokens equal and logits within INT8_TOL of the JAX int8
    engine (tests/test_torch_quant.py's bound); DensePolicy through the
    dense fallback over local heads, within LOGIT_TOL of the unsharded
    port;
  * RaaS page eviction under a resident cap that forces replays, fp (at
    ``split_k`` 1 and 2) and int8: the clamped table and the touched mask
    (gathered over ranks with the ids) on the head-sharded body; the
    eviction, restore and replay counters equal to the JAX engine's
    eviction run, and to the port's unsharded eviction run at
    ``split_k=1``;
  * sequence-sharded ``generate``: budget and threshold gates with
    ``local_cap_factor=8.0`` (the candidate cap not binding), 12 decode
    steps teacher-forced with the reference's greedy tokens: logits within
    SEQ_TOL at every step, the caches gathered over ranks within SEQ_TOL,
    ``kg_n`` equal. The reference's check runs its bf16 config; the port's
    parity harness runs float32 (ROADMAP, port decisions);
  * a world size that does not divide the KV heads (or the cache length)
    raises ``ValueError``;
  * the MoE family (``deepseek_moe_16b`` at ``reduced()`` with its
    published router, expert-parallel: each rank holds and computes
    ``E / 2`` routed experts and gathers their outputs, and half the
    shared experts' hidden units): the head-sharded fp ``serve``, ample
    and preempting, greedy tokens equal to the JAX engine's and logits
    within LOGIT_TOL of the port's unsharded ``serve``, with one expert
    gather a MoE layer at every prefill and decode step; and the
    sequence-sharded ``generate`` teacher-forced with the reference's
    greedy tokens, logits within SEQ_TOL;
  * every rank's parameter leaves at ``local_shape`` of their
    ``param_layout`` block, the gate whole, and every run's collectives
    counted by kind, exactly as the code makes them.

Each path is one ``torch.multiprocessing.spawn`` of two ranks that runs all
of its cases (``tests/torch_sharded_helpers.py``, which imports no JAX);
the parent runs JAX and the port's unsharded engine. Both ranks must
return the same results, bitwise: every rank computes the same logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.config import reduced as j_reduced
from repro.core.policy import DecodeOptions as JOptions
from repro.core.policy import DensePolicy as JDense
from repro.models import transformer as j_tf
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.eviction import EvictionConfig as JEviction
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import DecodeOptions as TOptions
from repro_torch.distributed.sharding import decode_layout, local_shape, param_layout
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

WORLD = 2
LOGIT_TOL = 1e-4          # sharded_helpers.py:192, split_k=2 vs unsharded
INT8_TOL = 1e-3           # tests/test_torch_quant.py: port int8 vs reference int8
# the split_k=1 int8 serves: a rank's partial sums move the K/V that reach
# the quantizer by fp32 rounding, which can move an int8 code by one step
# (tests/test_torch_sharded_recurrent.py's bound)
INT8_SHARD_TOL = 2 * INT8_TOL
SEQ_TOL = 1e-3            # sharded_helpers.py:44-52, sequence-sharded decode
SPECS = [(21, 8), (13, 10), (30, 6), (17, 7)]
GATE = dict(block_size=8, d_gate=16)
N_LAYERS = t_reduced(t_get("qwen3_0_6b")).num_layers


def _cfgs(**gate):
    j = j_reduced(j_configs.get("qwen3_0_6b")).replace(dtype="float32")
    t = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return (j.replace(gate=dataclasses.replace(j.gate, **GATE, **gate)),
            t.replace(gate=dataclasses.replace(t.gate, **GATE, **gate)))


def _spawn(tmp, task, args):
    mp.spawn(H.run, args=(WORLD, str(tmp / f"{task}.store"), task, args, str(tmp)),
             nprocs=WORLD, join=True)
    return [torch.load(tmp / f"{task}-{r}.pt", weights_only=False) for r in range(WORLD)]


def _same_on_every_rank(runs):
    a, b = runs
    for key in a["tokens"]:
        assert a["tokens"][key] == b["tokens"][key]
        np.testing.assert_array_equal(a["logits"][key], b["logits"][key])
    assert a["stats"] == b["stats"]


# ---------------------------------------------------------------------------
# head-sharded serve
# ---------------------------------------------------------------------------

# sharded case -> (JAX options kwargs, serve kwargs of the JAX run it is
# held to, port-unsharded twin for the bitwise check or None, tolerance)
SERVE_REF = {
    "fp": (dict(), dict(n_slots=2), "fp", LOGIT_TOL),
    "fp-preempt": (dict(), dict(n_slots=4, num_pages=10), "fp-preempt", LOGIT_TOL),
    "fp-split2": (dict(), dict(n_slots=2), None, LOGIT_TOL),
    "int8": (dict(quantize="int8"), dict(n_slots=2), "int8", INT8_SHARD_TOL),
    "int8-preempt": (dict(quantize="int8"), dict(n_slots=4, num_pages=10), "int8-preempt",
                     INT8_SHARD_TOL),
    "int8-split2": (dict(quantize="int8"), dict(n_slots=2), None, INT8_TOL),
    "dense": (dict(policy=JDense()), dict(n_slots=2), "dense", LOGIT_TOL),
    "fp-evict": (dict(), H.EVICT, "fp-evict", LOGIT_TOL),
    "fp-evict-split2": (dict(), H.EVICT, None, LOGIT_TOL),
    "int8-evict": (dict(quantize="int8"), H.EVICT, "int8-evict", INT8_SHARD_TOL),
}
COUNTERS = ("preemptions", "resumed", "decode_steps", "peak_pages_used",
            "swapped_out_bytes", "swapped_in_bytes", "swap", "evictions",
            "page_restores", "replay_steps", "errors")


def _jax_serve_kw(serve_kw):
    """The JAX engine's serve kwargs: its own EvictionConfig."""
    ev = serve_kw.get("eviction")
    if ev is None:
        return serve_kw
    return dict(serve_kw, eviction=JEviction(**dataclasses.asdict(ev)))


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """(JAX results, port unsharded results, per-rank sharded results)."""
    jcfg, tcfg = _cfgs(token_budget=32)
    params = j_tf.init_lm(jax.random.PRNGKey(0), jcfg)
    np_params = jax.device_get(params)
    rng = np.random.default_rng(7)
    reqs = [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, jcfg.vocab_size, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(SPECS)]
    sharded = _spawn(tmp_path_factory.mktemp("serve"), "serve", (tcfg, np_params, reqs))
    jax_res, port_res = {}, {}
    tparams = params_from_numpy(np_params, tcfg, "cpu")
    for name, (j_kw, serve_kw, twin, _) in SERVE_REF.items():
        key = (tuple(sorted(j_kw)), tuple(sorted(serve_kw.items())))
        if key not in jax_res:
            eng = JaxEngine(jcfg, params, max_len=64, options=JOptions(**j_kw))
            jax_res[key] = eng.serve([dict(r) for r in reqs], collect_logits=True,
                                     **_jax_serve_kw(serve_kw))
        if twin is not None:
            opt_kw = H.SERVE_CASES[twin][0]
            eng = DecodeEngine(tcfg, tparams, max_len=64, device="cpu",
                               options=TOptions(**opt_kw))
            port_res[name] = eng.serve([dict(r) for r in reqs], collect_logits=True,
                                       **serve_kw)
    jax_by_case = {name: jax_res[(tuple(sorted(j_kw)), tuple(sorted(s_kw.items())))]
                   for name, (j_kw, s_kw, _, _) in SERVE_REF.items()}
    return jax_by_case, port_res, sharded


def _serve_collectives(st, n_layers, ids_gathers, moe=False):
    """The collectives by kind of a sharded ``serve`` of the dense or MoE
    model (``st`` its stats): at every prefill (``admitted``) and decode
    attempt (``decode_steps`` + ``replay_steps``) one sum for the
    embedding, and a layer one sum after ``wo`` and one for the MLP (a
    MoE layer's shared experts; its routed experts one gather); at every
    attempt one gather of the selected ids a selecting layer
    (``ids_gathers``: the telemetry reads them) and one of the logits at
    every run; one sum for the stats."""
    runs = st["decode_steps"] + st["replay_steps"]
    passes = runs + st["admitted"]
    gathers = passes + ids_gathers * n_layers * runs
    if moe:
        gathers += n_layers * passes
    return {"all_sum": (1 + 2 * n_layers) * passes + 1, "all_gather": gathers,
            "all_max": 0}


@pytest.mark.parametrize("case", list(SERVE_REF))
def test_head_sharded_serve_matches_unsharded(serve_runs, case):
    jax_res, port_res, sharded = serve_runs
    _same_on_every_rank([r[case] for r in sharded])
    got = sharded[0][case]
    want = jax_res[case]
    tol = SERVE_REF[case][3]
    # the sharded path ran, with exactly the collectives of the code
    assert got["stats"]["decode_steps"] > 0
    assert got["collectives"] == _serve_collectives(got["stats"], N_LAYERS,
                                                    case != "dense")
    for rid, (_, n_new) in enumerate(SPECS):
        assert got["tokens"][rid] == want[rid], f"rid {rid} tokens"
        assert len(got["tokens"][rid]) == n_new
        np.testing.assert_allclose(got["logits"][rid], want["logits"][rid], atol=tol, rtol=0)
    print(f"{case}: max |port - JAX| logit " + "%.2e" % max(
        float(np.abs(got["logits"][rid] - want["logits"][rid]).max())
        for rid in range(len(SPECS))))
    twin = port_res.get(case)
    if twin is not None:                       # split_k=1: the unsharded port's run
        for rid in range(len(SPECS)):
            assert got["tokens"][rid] == twin[rid]
            np.testing.assert_allclose(got["logits"][rid], twin["logits"][rid], atol=tol,
                                       rtol=0)
        for key in COUNTERS:
            assert got["stats"][key] == twin["stats"][key], key
        assert got["stats"]["sparsity_by_rid"] == twin["stats"]["sparsity_by_rid"]
    for key in COUNTERS:
        assert got["stats"][key] == want["stats"][key], key
    if "evict" in case:
        assert got["stats"]["replay_steps"] > 0 and got["stats"]["evictions"] > 0
    if case.endswith("preempt"):
        assert got["stats"]["preemptions"] > 0
        assert got["stats"]["swapped_out_bytes"] == got["stats"]["swapped_in_bytes"] > 0


def test_world_size_not_dividing_heads_raises(serve_runs):
    """n_kv_heads 1 over two ranks (a serve with sharded pools), 3 heads
    over two ranks, and a cache length of 60 tokens over two ranks of
    8-token blocks: each raises ValueError on every rank."""
    _, _, sharded = serve_runs
    for rank in sharded:
        assert all(e is not None for e in rank["errors"]), rank["errors"]
        assert "not divisible" in rank["errors"][0]


@pytest.mark.parametrize("case", list(SERVE_REF))
def test_sharded_serve_allocates_the_ranks_heads(serve_runs, case):
    """A sharded ``serve`` allocates its pools once, at this rank's block
    of KV heads on axis 2 of every leaf (the reference's
    ``paged_pool_pspecs``), the int8 scale rows included: never the whole
    pool."""
    _, _, sharded = serve_runs
    local = _cfgs()[1].n_kv_heads // WORLD
    for rank in sharded:
        (leaves,) = rank[case]["pools"]
        shapes = [x for x in leaves if x is not None]
        assert len(shapes) == (5 if case.startswith("int8") else 3)   # k, v, kg (+ scales)
        assert all(len(x) in (4, 5) and x[2] == local for x in shapes), shapes


# ---------------------------------------------------------------------------
# sequence-sharded generate
# ---------------------------------------------------------------------------

B, PRE, MAX, N_STEPS = 4, 120, 256, 12
GEN_GATES = {
    "budget": dict(token_budget=64, local_cap_factor=8.0),
    "threshold": dict(method="threshold", threshold=2e-2, token_budget=256,
                      local_cap_factor=8.0),
}


@pytest.fixture(scope="module")
def generate_runs(tmp_path_factory):
    """(JAX runs, per-rank port runs), one per gate method, in GEN_GATES order."""
    jobs, refs = [], []
    prompt = np.random.default_rng(3).integers(0, 256, (B, PRE)).astype(np.int32)
    for gate in GEN_GATES.values():
        jcfg, tcfg = _cfgs(**gate)
        params = j_tf.init_lm(jax.random.PRNGKey(0), jcfg)
        logits, st = j_tf.lm_prefill(params, {"tokens": jnp.asarray(prompt)}, jcfg,
                                     max_len=MAX)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        step = jax.jit(lambda p, s, t, c=jcfg: j_tf.lm_decode_step(
            p, s, t, c, options=JOptions()))
        toks, lgs = [np.asarray(tok)], []
        for _ in range(N_STEPS):
            lg, st, _ = step(params, st, tok)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            lgs.append(np.asarray(lg, np.float32))
        refs.append({"tokens": np.stack(toks), "logits": np.stack(lgs),
                     "k_cache": np.asarray(st.k_cache), "v_cache": np.asarray(st.v_cache),
                     "kg_cache": np.asarray(st.kg_cache), "kg_n": np.asarray(st.kg_n)})
        jobs.append((tcfg, jax.device_get(params), prompt, refs[-1]["tokens"], MAX))
    return refs, _spawn(tmp_path_factory.mktemp("generate"), "generate", (jobs,))


def _generate_collectives(method, n_layers, moe=False):
    """The collectives by kind of ``_generate_one``'s phases. The prefill:
    one sum for the embedding, a layer one after ``wo`` and one for the
    MLP or the shared experts (a MoE layer's routed experts one gather),
    and one gather of the logits. The cut to the sequence-sharded caches:
    one gather of the K, V and Kg heads a layer. A step: the embedding's
    sum, the logits' gather, and a layer the packed gather of the rank's
    q/k/v heads, ``sharded_sparse_decode``'s own (the budget gate's
    candidate gather, or the threshold's max and sum of the softmax; the
    max, the mass, the output and the counts of the combine), one sum
    after ``wo`` and the MLP's."""
    expert = int(moe)
    prefill = {"all_sum": 1 + 2 * n_layers, "all_gather": 1 + expert * n_layers,
               "all_max": 0}
    budget = method == "budget"
    step = {"all_sum": 1 + n_layers * (3 + 2 + (not budget)),
            "all_gather": 1 + n_layers * (1 + budget + expert),
            "all_max": n_layers * (1 + (not budget))}
    return {"prefill": prefill, "seq_shard": {"all_sum": 0, "all_gather": n_layers,
                                              "all_max": 0},
            "step": step, "steps": {k: N_STEPS * n for k, n in step.items()}}


@pytest.mark.parametrize("method", list(GEN_GATES))
def test_sequence_sharded_generate_matches_unsharded(generate_runs, method):
    refs, ranks = generate_runs
    i = list(GEN_GATES).index(method)
    ref = refs[i]
    a, b = (r[i] for r in ranks)
    for key in ("first", "logits", "k_cache", "v_cache", "kg_cache", "kg_n"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"ranks differ: {key}")
    np.testing.assert_array_equal(a["first"], ref["tokens"][0])
    assert a["collectives"] == _generate_collectives(method, N_LAYERS)
    for step in range(N_STEPS):
        d = float(np.max(np.abs(a["logits"][step] - ref["logits"][step])))
        assert d < SEQ_TOL, f"step {step}: dlogit {d}"
    print(f"{method}: max |port - JAX| logit over {N_STEPS} steps "
          f"{float(np.abs(a['logits'] - ref['logits']).max()):.2e}")
    for key in ("k_cache", "v_cache", "kg_cache"):
        d = float(np.max(np.abs(a[key] - ref[key])))
        assert d < SEQ_TOL, f"{key}: {d}"
    np.testing.assert_array_equal(a["kg_n"], ref["kg_n"])
    assert 0.0 < a["sparsity"] < 1.0


def test_child_module_imports_no_jax():
    """The ranks run tests/torch_sharded_helpers.py alone: it imports
    neither JAX nor the reference package."""
    import ast
    tree = ast.parse(open(H.__file__).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]


# ---------------------------------------------------------------------------
# the MoE family: head-sharded serve and sequence-sharded generate
# ---------------------------------------------------------------------------

def _moe_cfgs():
    j_full, t_full = j_configs.get("deepseek_moe_16b"), t_get("deepseek_moe_16b")
    out = []
    for full, reduce in ((j_full, j_reduced), (t_full, t_reduced)):
        m = full.moe
        cfg = reduce(full).replace(dtype="float32")
        out.append(cfg.replace(
            moe=type(m)(n_experts=m.n_experts, top_k=m.top_k,
                        n_shared_experts=m.n_shared_experts, expert_d_ff=64,
                        capacity_factor=m.capacity_factor),
            gate=dataclasses.replace(cfg.gate, **GATE, token_budget=32)))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """(JAX serves by case, port unsharded serves by case, JAX generate,
    per-rank sharded results)."""
    jcfg, tcfg = _moe_cfgs()
    params = j_tf.init_lm(jax.random.PRNGKey(0), jcfg)
    np_params = jax.device_get(params)
    rng = np.random.default_rng(7)
    reqs = [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, jcfg.vocab_size, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(SPECS)]
    prompt = np.random.default_rng(3).integers(0, 256, (B, PRE)).astype(np.int32)
    gcfg = [c.replace(gate=dataclasses.replace(c.gate, **GEN_GATES["budget"]))
            for c in (jcfg, tcfg)]
    gparams = j_tf.init_lm(jax.random.PRNGKey(0), gcfg[0])
    logits, st = j_tf.lm_prefill(gparams, {"tokens": jnp.asarray(prompt)}, gcfg[0],
                                 max_len=MAX)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    step = jax.jit(lambda p, s, t: j_tf.lm_decode_step(p, s, t, gcfg[0],
                                                       options=JOptions()))
    toks, lgs = [np.asarray(tok)], []
    for _ in range(N_STEPS):
        lg, st, _ = step(gparams, st, tok)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(lg, np.float32))
    gen_ref = {"tokens": np.stack(toks), "logits": np.stack(lgs)}
    gen_job = (gcfg[1], jax.device_get(gparams), prompt, gen_ref["tokens"], MAX)
    sharded = _spawn(tmp_path_factory.mktemp("moe"), "moe",
                     (tcfg, np_params, reqs, gen_job))
    jax_res, port_res = {}, {}
    tparams = params_from_numpy(np_params, tcfg, "cpu")
    for name in H.MOE_CASES:
        serve_kw = H.SERVE_CASES[name][1]
        jax_res[name] = JaxEngine(jcfg, params, max_len=64).serve(
            [dict(r) for r in reqs], collect_logits=True, **serve_kw)
        port_res[name] = DecodeEngine(tcfg, tparams, max_len=64, device="cpu").serve(
            [dict(r) for r in reqs], collect_logits=True, **serve_kw)
    return jax_res, port_res, gen_ref, sharded


@pytest.mark.parametrize("case", H.MOE_CASES)
def test_moe_head_sharded_serve_matches_unsharded(moe_runs, case):
    jax_res, port_res, _, sharded = moe_runs
    _same_on_every_rank([r[case] for r in sharded])
    got, want, twin = sharded[0][case], jax_res[case], port_res[case]
    assert got["stats"]["decode_steps"] > 0
    assert got["collectives"] == _serve_collectives(got["stats"], N_LAYERS, True, moe=True)
    for rid in range(len(SPECS)):
        assert got["tokens"][rid] == want[rid] == twin[rid], f"rid {rid} tokens"
        np.testing.assert_allclose(got["logits"][rid], twin["logits"][rid],
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(got["logits"][rid], want["logits"][rid],
                                   atol=LOGIT_TOL, rtol=0)
    for key in COUNTERS:
        assert got["stats"][key] == twin["stats"][key] == want["stats"][key], key
    assert (got["stats"]["preemptions"] > 0) == case.endswith("preempt")


@pytest.mark.parametrize("case", H.MOE_CASES)
def test_moe_rank_holds_its_experts(moe_runs, case):
    """The engine keeps block ``rank`` of the routed experts, E / 2 of each
    of ``wi_gate``/``wi_up``/``wo`` a layer, and every MoE layer gathered
    their outputs once at every prefill and decode step (counted by the
    calls that compute the rank's expert rows, apart from the head gathers
    above)."""
    _, _, _, sharded = moe_runs
    e = _moe_cfgs()[1].moe.n_experts
    for rank in sharded:
        got = rank[case]
        assert got["experts"].keys() == got["full_experts"].keys()
        assert len(got["experts"]) == 3 * N_LAYERS
        for path, full in got["full_experts"].items():
            assert full[0] == e and got["experts"][path] == (e // WORLD,) + full[1:], path
        st = got["stats"]
        assert got["expert_gathers"] == N_LAYERS * (st["decode_steps"] + st["admitted"]) > 0


def test_moe_sequence_sharded_generate_matches_unsharded(moe_runs):
    _, _, ref, sharded = moe_runs
    a, b = (r["generate"] for r in sharded)
    for key in ("first", "logits", "k_cache", "v_cache", "kg_cache", "kg_n"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"ranks differ: {key}")
    np.testing.assert_array_equal(a["first"], ref["tokens"][0])
    assert a["collectives"] == _generate_collectives("budget", N_LAYERS, moe=True)
    for step in range(N_STEPS):
        d = float(np.max(np.abs(a["logits"][step] - ref["logits"][step])))
        assert d < SEQ_TOL, f"step {step}: dlogit {d}"


# ---------------------------------------------------------------------------
# the per-rank weight layout
# ---------------------------------------------------------------------------

def _check_rank_leaves(leaves, full, cfg, rank):
    """Every leaf a rank's engine holds is ``local_shape`` of its
    ``param_layout`` block at WORLD ranks, but the gate's ``wq``/``wk``,
    which stay whole; returns the paths that split."""
    assert leaves.keys() == full.keys()
    split = []
    for path, shape in full.items():
        lay = param_layout(path, shape, cfg, WORLD)
        want = shape if "/gate/" in path else local_shape(shape, lay, WORLD)
        assert leaves[path] == want, (rank, path, leaves[path], want)
        assert decode_layout(path, shape, cfg, WORLD) == (None if "/gate/" in path else lay)
        if want != shape:
            split.append(path)
    return split


def test_sharded_engine_holds_the_ranks_blocks(serve_runs, moe_runs):
    """The dense and the MoE engine at two ranks: attention's ``wq``/``wk``/
    ``wv`` columns and ``wo`` rows of the rank's KV heads, the MLP's (or
    the shared experts') hidden units, the routed experts, the embedding
    and ``lm_head`` by vocabulary; the gate, the norms and the router
    whole."""
    cfg = _cfgs()[1]
    for r, rank in enumerate(serve_runs[2]):
        split = _check_rank_leaves(rank["leaves"], rank["full_leaves"], cfg, r)
        for leaf in ("attn/wq/w", "attn/wk/w", "attn/wv/w", "attn/wo/w", "mlp/wi_gate/w",
                     "mlp/wi_up/w", "mlp/wo/w"):
            assert f"blocks/0/{leaf}" in split, leaf
        assert "embed/w" in split
    mcfg = _moe_cfgs()[1]
    for r, rank in enumerate(moe_runs[3]):
        for case in H.MOE_CASES:
            got = rank[case]
            split = _check_rank_leaves(got["leaves"], got["full_leaves"], mcfg, r)
            for leaf in ("shared/wi_gate/w", "shared/wo/w", "wi_gate", "wo"):
                assert f"blocks/0/moe/{leaf}" in split, leaf
            assert "blocks/0/moe/router/w" not in split
