"""The rest of the decode API of the PyTorch port against the live JAX one.

Quest (the incremental metadata cache and its recompute reference), the
oracle, the sliding window, the SelectionSchedule (dense prefix, plan
reuse with correction, head unification), per-request budgets and
temperature/top-k/top-p sampling. Inputs are made from numpy seeds and go
through the reference (``kernel_impl="ref"``, one rollout with
``"pallas_interpret"``) and the port on the CPU. Held exactly: selected
ids, greedy tokens, stage tables, widths, filters and draws; logits
within 1e-4, as ``tests/test_torch_engine.py`` holds them; measured
sparsity within 1e-6; metadata rows bitwise.

The model is ``tests/capture_golden_policy.py::tiny_cfg`` (qwen3 cut to
2 layers, float32, gate block 8); the plan-reuse schedule needs a reusing
layer between two selecting ones, so it runs the same config at 4 layers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capture_golden_policy as G
from repro.core import metacache as j_mc
from repro.core import oracle as j_oracle
from repro.core import policy as JP
from repro.core import quest as j_quest
from repro.models.registry import get_api
from repro.serve import paging as j_pg
from repro.serve import sampling as j_smp
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core import metacache as t_mc
from repro_torch.core import oracle as t_oracle
from repro_torch.core import policy as TP
from repro_torch.core import quest as t_quest
from repro_torch.kernels import ops as t_ops
from repro_torch.serve import paging as t_pg
from repro_torch.serve import sampling as t_smp
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

LOGIT_TOL = 1e-4
B, HKV, G_, DH, BS = 3, 2, 2, 16, 8
PREEMPT = [(20, 12), (18, 10), (22, 9)]


def randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def torch_tiny_cfg(method="budget"):
    cfg = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return cfg.replace(gate=dataclasses.replace(
        cfg.gate, block_size=8, d_gate=16, token_budget=32, method=method,
        threshold=2e-2))


def configs(layers=2, dense_first_layers=0):
    """(reference cfg, port cfg) of the tiny model."""
    out = []
    for cfg in (G.tiny_cfg(), torch_tiny_cfg()):
        cfg = cfg.replace(num_layers=layers)
        out.append(cfg.replace(gate=dataclasses.replace(
            cfg.gate, dense_first_layers=dense_first_layers)))
    return out


@functools.lru_cache(maxsize=None)
def model(layers=2, dense_first_layers=0):
    jcfg, tcfg = configs(layers, dense_first_layers)
    params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
    return jcfg, params, tcfg, params_from_numpy(jax.device_get(params), tcfg, "cpu")


# ---------------------------------------------------------------------------
# quest.py, metacache.py, oracle.py, paging.append_meta_paged
# ---------------------------------------------------------------------------

def test_quest_functions_match_jax():
    """All five functions of core/quest.py; a non-block-aligned cache with
    kv_len == S clamps n_blocks to the stored rows."""
    r = np.random.default_rng(0)
    s = 5 * BS + 3
    k_sm = randn(r, B, s, HKV, DH)                     # seq-major
    kv = np.array([s, 17, 1], np.int32)
    q = randn(r, B, 1, HKV * G_, DH)
    tm = t_quest.build_quest_meta(torch.tensor(k_sm), torch.tensor(kv), BS)
    jm = j_quest.build_quest_meta(jnp.asarray(k_sm), jnp.asarray(kv), BS)
    for a, b in zip(tm, jm):
        eq(a, b)
    assert tm.n_blocks.tolist() == [5, 3, 1]
    for share in (True, False):
        np.testing.assert_allclose(
            t_quest.quest_scores(torch.tensor(q), tm, share_group=share),
            j_quest.quest_scores(jnp.asarray(q), jm, share_group=share), atol=1e-5)
    gcfg = G.tiny_cfg().gate
    ti, tmask = t_quest.quest_select(torch.tensor(q), tm, torch_tiny_cfg().gate)
    ji, jmask = j_quest.quest_select(jnp.asarray(q), jm, gcfg)
    eq(ti, ji)
    eq(tmask, jmask)
    k_hm = randn(r, B, HKV, s, DH)                     # head-major
    tmin, tmax = t_quest.quest_meta_decode(torch.tensor(k_hm), torch.tensor(kv), BS)
    jmin, jmax = j_quest.quest_meta_decode(jnp.asarray(k_hm), jnp.asarray(kv), BS)
    eq(tmin, jmin)
    eq(tmax, jmax)
    nb = torch.tensor([5, 3, 1], dtype=torch.int32)
    qg = q[:, 0].reshape(B, HKV, G_, DH)
    np.testing.assert_allclose(
        t_quest.quest_scores_grouped(torch.tensor(qg), tmin, tmax, nb),
        j_quest.quest_scores_grouped(jnp.asarray(qg), jmin, jmax, jnp.asarray(nb.numpy())),
        atol=1e-5)


def test_metacache_functions_match_jax():
    """prefill + 20 incremental updates (blocks finalize only on their
    boundary, never for an empty row), the trailing overlay, and the cache
    bitwise equal to the recompute reference on every visible block."""
    r = np.random.default_rng(1)
    s_max = 6 * BS
    k = randn(r, B, HKV, s_max, DH)
    length = np.array([13, 0, 16], np.int32)
    tc = t_mc.prefill_metacache(t_mc.init_metacache(B, 6, HKV, DH), torch.tensor(k),
                                torch.tensor(length), BS)
    jc = j_mc.prefill_metacache(j_mc.init_metacache(B, 6, HKV, DH), jnp.asarray(k),
                                jnp.asarray(length), BS)
    for a, b in zip(tc, jc):
        eq(a, b)
    for step in range(20):
        new_len = length + np.where(length > 0, step + 1, 0).astype(np.int32)
        tc = t_mc.update_metacache(tc, torch.tensor(k), torch.tensor(new_len), BS)
        jc = j_mc.update_metacache(jc, jnp.asarray(k), jnp.asarray(new_len), BS)
        for a, b in zip(tc, jc):
            eq(a, b)
        tt = t_mc.trailing_meta(torch.tensor(k), torch.tensor(new_len), BS)
        jt = j_mc.trailing_meta(jnp.asarray(k), jnp.asarray(new_len), BS)
        for a, b in zip(tt, jt):
            eq(a, b)
        tv = t_mc.overlay_trailing(tc.kmin, tc.kmax, *tt)
        jv = j_mc.overlay_trailing(jc.kmin, jc.kmax, *jt)
        for a, b in zip(tv, jv):
            eq(a, b)
        rmin, rmax = t_quest.quest_meta_decode(torch.tensor(k), torch.tensor(new_len), BS)
        for row in range(B):
            vis = -(-int(new_len[row]) // BS)
            eq(tv[0][row, :, :vis], rmin[row, :, :vis])
            eq(tv[1][row, :, :vis], rmax[row, :, :vis])
    assert tc.n_complete.tolist() == [4, 0, 4]


def _pools(r, n_pages=12, quant=False):
    k = randn(r, n_pages, HKV, BS, DH)
    if not quant:
        return k, None
    q, sc = j_pg.quantize_block(jnp.asarray(k), jnp.ones(k.shape, bool))
    return np.asarray(q), np.asarray(sc)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_metadata_matches_jax(quant):
    """``trailing_meta_paged`` and ``append_meta_paged`` (int8: dequantized
    under the scale rows) bitwise; the null page's rows and the rows of
    non-completing slots stay as they were."""
    r = np.random.default_rng(2)
    kp, ksc = _pools(r, n_pages=17, quant=quant)
    pt = r.permutation(np.arange(1, 17)).reshape(4, 4).astype(np.int32)   # distinct
    cur = np.array([7, 15, 0, 20], np.int32)
    act = np.array([True, True, False, True])
    mn0, mx0 = randn(r, 17, HKV, DH), randn(r, 17, HKV, DH)
    tks = None if ksc is None else torch.tensor(ksc)
    jks = None if ksc is None else jnp.asarray(ksc)
    tt = t_mc.trailing_meta_paged(torch.tensor(kp), torch.tensor(pt), torch.tensor(cur),
                                  BS, k_scale=tks)
    jt = j_mc.trailing_meta_paged(jnp.asarray(kp), jnp.asarray(pt), jnp.asarray(cur),
                                  BS, k_scale=jks)
    for a, b in zip(tt, jt):
        eq(a, b)
    tmn, tmx = torch.tensor(mn0), torch.tensor(mx0)
    t_pg.append_meta_paged(tmn, tmx, torch.tensor(kp), torch.tensor(pt), torch.tensor(cur),
                           torch.tensor(act), BS, k_scale=tks)
    jmn, jmx = jax.jit(j_pg.append_meta_paged, static_argnums=(6,))(
        jnp.asarray(mn0), jnp.asarray(mx0), jnp.asarray(kp), jnp.asarray(pt),
        jnp.asarray(cur), jnp.asarray(act), BS, k_scale=jks)
    eq(tmn, jmn)
    eq(tmx, jmx)
    done = [int(pt[0, 0]), int(pt[1, 1])]              # slots 0 and 1 complete a page
    changed = np.nonzero((tmn.numpy() != mn0).any(axis=(1, 2)))[0].tolist()
    assert sorted(changed) == sorted(done)


def test_oracle_functions_match_jax():
    r = np.random.default_rng(3)
    s = 5 * BS
    q = randn(r, B, 1, HKV * G_, DH)
    kv = np.array([s, 19, 3], np.int32)
    k_sm = randn(r, B, s, HKV, DH)
    np.testing.assert_allclose(
        t_oracle.oracle_scores_decode(torch.tensor(q), torch.tensor(k_sm),
                                      torch.tensor(kv), BS),
        j_oracle.oracle_scores_decode(jnp.asarray(q), jnp.asarray(k_sm),
                                      jnp.asarray(kv), BS), atol=1e-5)
    ti, _ = t_oracle.oracle_select(torch.tensor(q), torch.tensor(k_sm), torch.tensor(kv),
                                   torch_tiny_cfg().gate)
    ji, _ = j_oracle.oracle_select(jnp.asarray(q), jnp.asarray(k_sm), jnp.asarray(kv),
                                   G.tiny_cfg().gate)
    eq(ti, ji)
    k_hm = randn(r, B, HKV, s + 5, DH)                # floored to whole blocks
    qg = q[:, 0].reshape(B, HKV, G_, DH)
    np.testing.assert_allclose(
        t_oracle.oracle_scores_headmajor(torch.tensor(qg), torch.tensor(k_hm),
                                         torch.tensor(kv), BS),
        j_oracle.oracle_scores_headmajor(jnp.asarray(qg), jnp.asarray(k_hm),
                                         jnp.asarray(kv), BS), atol=1e-5)


# ---------------------------------------------------------------------------
# each policy's select, contiguous and paged
# ---------------------------------------------------------------------------

POLICY_NAMES = ["gate", "quest", "quest_recompute", "oracle", "sliding_window"]


def _select_inputs(paged: bool, quant: bool):
    """The same numpy inputs as (port SelectionInputs, reference
    SelectionInputs) of one decode step of the tiny model's layer 0."""
    jcfg, params, tcfg, tparams = model()
    r = np.random.default_rng(4 + paged + 2 * quant)
    nb, h, dg = 6, HKV * G_, tcfg.gate.d_gate
    new_len = np.array([nb * BS, 19, 3], np.int32)
    arrays = dict(q_nope=randn(r, B, 1, h, DH), qr=randn(r, B, 1, h, DH),
                  pos=(new_len - 1)[:, None], new_len=new_len)
    if paged:
        n_pages = 20
        kp, ksc = _pools(r, n_pages, quant)
        pt = np.stack([r.permutation(np.arange(1, n_pages))[:nb]
                       for _ in range(B)]).astype(np.int32)
        arrays.update(kg_pages=randn(r, n_pages, HKV, dg), k_pages=kp, page_table=pt,
                      kmin_pages=randn(r, n_pages, HKV, DH) - 1,
                      kmax_pages=randn(r, n_pages, HKV, DH) + 1, k_scale_pages=ksc)
    else:
        k = randn(r, B, HKV, nb * BS, DH)
        mn, mx = j_quest.quest_meta_decode(jnp.asarray(k), jnp.asarray(new_len), BS)
        arrays.update(kg=randn(r, B, HKV, nb, dg), k_cache=k, meta_kmin=np.asarray(mn),
                      meta_kmax=np.asarray(mx))
    t_in = TP.SelectionInputs(
        gate_params=tparams["blocks"][0]["attn"]["gate"],
        **{k: None if v is None else torch.tensor(v) for k, v in arrays.items()})
    j_in = JP.SelectionInputs(
        gate_params=jax.tree.map(lambda x: x[0], params["blocks"]["attn"]["gate"]),
        **{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    return t_in, j_in, tcfg, jcfg


@pytest.mark.parametrize("unify", [False, True], ids=["per-head", "unified"])
@pytest.mark.parametrize("view", ["contiguous", "paged", "paged-int8"])
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_policy_select_matches_jax(name, view, unify):
    t_in, j_in, tcfg, jcfg = _select_inputs(view != "contiguous", view == "paged-int8")
    for ms in (None, 2):
        t_idx = TP.get_policy(name).select(t_in, tcfg, max_selected=ms,
                                           unify_heads=unify)
        j_idx = JP.get_policy(name).select(j_in, jcfg, max_selected=ms,
                                           unify_heads=unify)
        eq(t_idx, j_idx)
        assert t_idx.dtype == torch.int32
        assert t_idx.shape[-1] == TP.selection_width(
            TP.get_policy(name), tcfg, t_in.n_blocks(BS), ms)
    if name == "sliding_window":
        assert (t_idx[2, 0] == -1).any()                  # holes in a short row


# ---------------------------------------------------------------------------
# greedy generate rollouts
# ---------------------------------------------------------------------------

def _options(pkg, name):
    """DecodeOptions of one rollout case in the reference (JP) or the port
    (TP), and the model it runs on (layers, dense_first_layers)."""
    if name == "gate-dense-prefix":        # from gate.dense_first_layers
        cfg = (G.tiny_cfg() if pkg is JP else torch_tiny_cfg()).replace(
            gate=dataclasses.replace(G.tiny_cfg().gate if pkg is JP
                                     else torch_tiny_cfg().gate, dense_first_layers=1))
        return pkg.default_options(cfg), (2, 1)
    if name == "gate-reuse-correction":
        return pkg.DecodeOptions(schedule=pkg.SelectionSchedule(
            select_layer=0, correction_layers=(2,))), (4, 0)
    if name == "gate-dense-select-reuse":
        return pkg.DecodeOptions(schedule=pkg.SelectionSchedule(
            dense_first_n=1, select_layer=1, correction_layers=(3,))), (4, 0)
    if name == "gate-unify":
        return pkg.DecodeOptions(schedule=pkg.SelectionSchedule(unify_heads=True)), (2, 0)
    if name == "quest-unify":
        return pkg.DecodeOptions(policy=pkg.QuestPolicy(), schedule=pkg.SelectionSchedule(
            unify_heads=True)), (2, 0)
    return pkg.DecodeOptions(policy=pkg.get_policy(name)), (2, 0)


def _rollout(eng, toks, n_steps, to_np):
    tok, st = eng.prefill({"tokens": toks})
    lgs, tks, rhos = [], [], []
    for _ in range(n_steps):
        tok, lg, st, aux = eng._step(eng.params, st, tok)
        lgs.append(to_np(lg))
        tks.append(to_np(tok))
        rhos.append(float(aux["sparsity"]))
    return np.stack(lgs), np.stack(tks), np.asarray(rhos), st


ROLLOUTS = ["quest", "quest_recompute", "oracle", "sliding_window", "gate-dense-prefix",
            "gate-reuse-correction", "gate-dense-select-reuse", "gate-unify",
            "quest-unify"]


@pytest.mark.parametrize("name", ROLLOUTS + ["quest-pallas-interpret"])
def test_generate_rollout_matches_jax(name):
    base = name.replace("-pallas-interpret", "")
    j_opts, shape = _options(JP, base)
    t_opts, _ = _options(TP, base)
    if base != name:
        j_opts = j_opts.replace(kernel_impl="pallas_interpret")
    jcfg, params, tcfg, tparams = model(*shape)
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, jcfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    n_steps = 6 if base != name else 3
    j_eng = JaxEngine(jcfg, params, max_len=G.MAX_LEN, options=j_opts)
    j_lg, j_tk, j_rho, j_st = _rollout(j_eng, jnp.asarray(toks), n_steps,
                                       lambda x: np.asarray(x, np.float32))
    t_ops.reset_launch_counts()
    t_eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN, options=t_opts, device="cpu")
    t_lg, t_tk, t_rho, t_st = _rollout(t_eng, toks, n_steps, lambda x: x.float().numpy())
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)   # CPU: plain
    eq(t_tk, j_tk)
    np.testing.assert_allclose(t_lg, j_lg, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(t_rho, j_rho, atol=1e-6, rtol=0)
    if t_opts.policy.needs_meta:                      # the metadata cache itself
        assert t_st.meta_kmin is not None
        for a, b in zip((t_st.meta_n,), (j_st.meta_n,)):
            eq(a, b)
    else:
        assert t_st.meta_kmin is None
    if base in ("gate-dense-prefix", "gate-dense-select-reuse"):
        assert t_rho.max() < 1.0 and (t_rho > 0).all()


def test_quest_cached_equals_recompute_bitwise():
    """The incremental cache's selections are the recompute reference's,
    so the two rollouts agree to the bit; 12 steps cross block
    boundaries (41 + 12 tokens at block 8)."""
    _, _, tcfg, tparams = model()
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, tcfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    runs = []
    for pol in (TP.QuestPolicy(), TP.QuestRecomputePolicy()):
        eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN,
                           options=TP.DecodeOptions(policy=pol), device="cpu")
        runs.append(_rollout(eng, toks, G.N_STEPS, lambda x: x.float().numpy())[:3])
    for a, b in zip(*runs):
        eq(a, b)


# ---------------------------------------------------------------------------
# serve: Quest over fp and int8 pools, per-request budgets
# ---------------------------------------------------------------------------

def requests(vocab, specs, seed=0, extra=None):
    """Numpy-seeded request dicts; ``extra`` maps a rid to its overrides."""
    rng = np.random.default_rng(seed)
    extra = extra or {}
    return [dict({"rid": i, "max_new_tokens": mn,
                  "tokens": rng.integers(0, vocab, size=(pl,)).astype(np.int32)},
                 **extra.get(i, {}))
            for i, (pl, mn) in enumerate(specs)]


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp", "int8"])
def test_quest_serve_matches_jax_with_preemption(quantize):
    """Quest over paged pools with a pool too small for the lifetimes: the
    metadata rows swap out and back; tokens equal the reference's, the
    swap counters too, and the tight run equals an ample one bitwise."""
    jcfg, params, tcfg, tparams = model()
    reqs = requests(jcfg.vocab_size, PREEMPT)
    j_res = JaxEngine(jcfg, params, max_len=64, options=JP.DecodeOptions(
        policy=JP.QuestPolicy(), quantize=quantize)).serve(
        reqs, n_slots=3, num_pages=8, collect_logits=True)
    eng = DecodeEngine(tcfg, tparams, max_len=64, device="cpu", options=TP.DecodeOptions(
        policy=TP.QuestPolicy(), quantize=quantize))
    tight = eng.serve(reqs, n_slots=3, num_pages=8, collect_logits=True)
    ample = eng.serve(reqs, n_slots=3, collect_logits=True)
    st = tight["stats"]
    assert st["preemptions"] > 0 and ample["stats"]["preemptions"] == 0
    for key in ("preemptions", "resumed", "swapped_out_bytes", "swapped_in_bytes",
                "decode_steps"):
        assert st[key] == j_res["stats"][key], key
    for rid in range(len(PREEMPT)):
        assert tight[rid] == j_res[rid], f"rid {rid}"
        np.testing.assert_allclose(tight["logits"][rid], j_res["logits"][rid],
                                   atol=LOGIT_TOL, rtol=0)
        assert tight[rid] == ample[rid]
        eq(tight["logits"][rid], ample["logits"][rid])


def test_request_budgets_match_jax():
    """Per-request caps (16 tokens = 2 blocks, 20 tokens rounds up to 3, no
    cap) under the gate and under a dense-prefix schedule: tokens and
    measured sparsity by request equal the reference's."""
    jcfg, params, tcfg, tparams = model(4)
    extra = {0: {"budget": 16}, 1: {"budget": 20}}
    specs = [(30, 8), (26, 7), (21, 6)]
    for sched in ("trivial", "dense-select-reuse"):
        jopt, topt = JP.DecodeOptions(), TP.DecodeOptions()
        if sched != "trivial":
            jopt, _ = _options(JP, "gate-dense-select-reuse")
            topt, _ = _options(TP, "gate-dense-select-reuse")
        reqs = requests(jcfg.vocab_size, specs, seed=5, extra=extra)
        j_res = JaxEngine(jcfg, params, max_len=64, options=jopt).serve(reqs, n_slots=2)
        t_res = DecodeEngine(tcfg, tparams, max_len=64, options=topt,
                             device="cpu").serve(reqs, n_slots=2)
        for rid in range(len(specs)):
            assert t_res[rid] == j_res[rid], (sched, rid)
        for key in ("sparsity_by_rid", "sel_blocks_by_rid"):
            for rid, val in j_res["stats"][key].items():
                assert t_res["stats"][key][rid] == pytest.approx(val, abs=1e-6), key
        if sched == "trivial":
            sel = t_res["stats"]["sel_blocks_by_rid"]
            assert sel[0] == 2.0 and sel[1] == 3.0 and sel[2] > 3.0     # uncapped


# ---------------------------------------------------------------------------
# schedule, widths and options validation
# ---------------------------------------------------------------------------

SCHEDULES = [dict(), dict(unify_heads=True), dict(dense_first_n=1),
             dict(select_layer=0), dict(dense_first_n=1, select_layer=2,
                                        correction_layers=(4,)),
             dict(select_layer=1, correction_layers=(3, 5)),
             dict(dense_first_n=-1), dict(correction_layers=(3,)),
             dict(dense_first_n=2, select_layer=1),
             dict(select_layer=0, correction_layers=(3, 2)),
             dict(select_layer=2, correction_layers=(2,)),
             dict(dense_first_n=6), dict(select_layer=6),
             dict(select_layer=0, correction_layers=(7,))]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", SCHEDULES, ids=[str(i) for i in range(len(SCHEDULES))])
def test_schedule_stages_and_errors_match_jax(kw):
    """Construction, is_trivial/needs_plan, layer_stages of a 6-layer stack
    and every validation message equal the reference's."""
    def run(pkg):
        s = pkg.SelectionSchedule(**kw)
        return (s.is_trivial, s.needs_plan, _outcome(lambda: s.layer_stages(6)))
    assert _outcome(lambda: run(TP)) == _outcome(lambda: run(JP))
    assert (TP.STAGE_DENSE, TP.STAGE_SELECT, TP.STAGE_REUSE) == \
        (JP.STAGE_DENSE, JP.STAGE_SELECT, JP.STAGE_REUSE)


@pytest.mark.parametrize("method", ["budget", "threshold"])
def test_selection_width_and_options_match_jax(method):
    tcfg, jcfg = torch_tiny_cfg(method), G.tiny_cfg(method)
    for name in POLICY_NAMES + ["dense"]:
        for nb in (1, 3, 8, 100):
            for ms in (None, 1, 2, 7):
                assert TP.selection_width(TP.get_policy(name), tcfg, nb, ms) == \
                    JP.selection_width(JP.get_policy(name), jcfg, nb, ms)
    assert sorted(TP.POLICIES) == sorted(JP.POLICIES)
    with pytest.raises(ValueError, match="unknown policy"):
        TP.get_policy("nope")
    with pytest.raises(ValueError, match="sink_blocks"):
        TP.SlidingWindowPolicy(sink_blocks=-1)
    for pol in POLICY_NAMES + ["dense"]:
        tp, jp = TP.get_policy(pol), JP.get_policy(pol)
        assert (tp.dense, tp.needs_gate, tp.needs_meta, tp.reads_full_kv) == \
            (jp.dense, jp.needs_gate, jp.needs_meta, jp.reads_full_kv)
    sched = dict(select_layer=0)
    for pkg in (TP, JP):
        with pytest.raises(ValueError, match="meaningless under DensePolicy"):
            pkg.DecodeOptions(policy=pkg.DensePolicy(),
                              schedule=pkg.SelectionSchedule(**sched))
    assert TP.DENSE_OPTIONS.policy.dense and TP.DecodeOptions().schedule.is_trivial


def test_defaults_meta_pools_and_sampling_work():
    """What the port refused before this slice now works: the config's
    dense prefix maps onto the schedule, metadata pools allocate, a
    stochastic SamplingParams samples."""
    jcfg, tcfg = configs(2, dense_first_layers=1)
    t_opt, j_opt = TP.default_options(tcfg), JP.default_options(jcfg)
    assert t_opt.schedule.dense_first_n == j_opt.schedule.dense_first_n == 1
    pools = t_pg.init_pages(tcfg, 5, 2, with_meta=True, device="cpu")
    assert pools.kmin_pages.shape == (2, 5, HKV, DH) == pools.kmax_pages.shape
    assert pools.kmin_pages.dtype == torch.float32
    assert pools.kmin_pages.data_ptr() != pools.kmax_pages.data_ptr()
    q8 = t_pg.init_pages(tcfg, 5, 2, with_meta=True, quantize="int8", device="cpu")
    assert q8.kmin_pages.dtype == torch.float32 and q8.k_pages.dtype == torch.int8
    tok = t_smp.sample(torch.zeros(2, 9), t_smp.SamplingParams(temperature=0.7),
                       torch.Generator().manual_seed(0))
    assert tok.shape == (2,) and tok.dtype == torch.int32
    with pytest.raises(ValueError, match="Generator"):
        t_smp.sample(torch.zeros(2, 9), t_smp.SamplingParams(temperature=0.7))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _tie_logits():
    r = np.random.default_rng(6)
    ints = r.integers(-3, 4, (6, 40)).astype(np.float32)     # many ties
    # nucleus cutoffs that fall on a tie, with exact probabilities
    probs = np.array([[0.4, 0.2, 0.2, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.5, 0.25, 0.125, 0.125]], np.float32)
    return ints, np.log(probs)


@pytest.mark.parametrize("k", [1, 3, 7, 40])
def test_filter_top_k_bitwise_with_ties(k):
    ints, _ = _tie_logits()
    t = t_smp._filter_top_k(torch.tensor(ints), k)
    eq(t, j_smp._filter_top_k(jnp.asarray(ints), k))
    assert (torch.isfinite(t).sum(-1) == k).all()            # no tied leak


@pytest.mark.parametrize("p", [0.3, 0.5, 0.7, 0.9, 1.0])
def test_filter_top_p_bitwise_with_ties(p):
    ints, lp = _tie_logits()
    for lg in (ints, lp):
        eq(t_smp._filter_top_p(torch.tensor(lg), p), j_smp._filter_top_p(jnp.asarray(lg), p))


def _j_filtered(lg, p):
    """The reference's filters in ``sample``'s order."""
    lg = lg.astype(jnp.float32) / p.temperature
    if p.top_k:
        lg = j_smp._filter_top_k(lg, min(p.top_k, lg.shape[-1]))
    if p.top_p < 1.0:
        lg = j_smp._filter_top_p(lg, p.top_p)
    return lg


@pytest.mark.parametrize("params", [
    dict(temperature=1.0), dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8), dict(temperature=0.7, top_k=50, top_p=0.9)])
def test_draw_matches_jax_categorical(params):
    """The port's draw, fed the uniforms JAX's categorical draws for its
    key, picks the reference's token; the filtered logits are bitwise."""
    r = np.random.default_rng(7)
    logits = randn(r, 16, 64) * 3
    tp, jp = t_smp.SamplingParams(**params), j_smp.SamplingParams(**params)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j_tok = j_smp.sample(jnp.asarray(logits), jp, key)
        u = jax.random.uniform(key, logits.shape, minval=np.finfo(np.float32).tiny,
                               maxval=1.0)
        lg = t_smp.filtered_logits(torch.tensor(logits), tp)
        eq(lg, _j_filtered(jnp.asarray(logits), jp))
        eq(t_smp.categorical(lg, torch.tensor(np.asarray(u))), j_tok)


STOCH = TP.DecodeOptions(sampling=t_smp.SamplingParams(temperature=0.7, top_k=50, top_p=0.9))


def test_seeded_generate_is_reproducible():
    _, _, tcfg, tparams = model()
    toks = np.random.default_rng(G.PROMPT_SEED).integers(0, tcfg.vocab_size, (2, 20))
    eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN, options=STOCH, device="cpu")
    a = eng.generate({"tokens": toks}, 8, generator=torch.Generator().manual_seed(3))
    b = eng.generate({"tokens": toks}, 8, generator=torch.Generator().manual_seed(3))
    c = eng.generate({"tokens": toks}, 8, generator=torch.Generator().manual_seed(4))
    d, e = eng.generate({"tokens": toks}, 8), eng.generate({"tokens": toks}, 8)
    eq(a["tokens"], b["tokens"])
    eq(d["tokens"], e["tokens"])                      # default: seed 0
    assert not torch.equal(a["tokens"], c["tokens"])
    greedy = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN, device="cpu")
    assert not torch.equal(a["tokens"], greedy.generate({"tokens": toks}, 8)["tokens"])


def test_seeded_serve_is_reproducible_and_preemption_free():
    """A stochastic request's stream is keyed by (sample_seed, its
    registration index, its token count): the same seed gives the same
    tokens, a tight (preempting) pool changes nothing, another seed does;
    a greedy request in the same batch is the greedy run's."""
    _, _, tcfg, tparams = model()
    sp = t_smp.SamplingParams(temperature=0.7, top_k=50, top_p=0.9)
    reqs = requests(tcfg.vocab_size, PREEMPT, extra={0: {"sampling": sp}, 2: {"sampling": sp}})
    eng = DecodeEngine(tcfg, tparams, max_len=64, device="cpu")
    ample = eng.serve(reqs, n_slots=3, sample_seed=1)
    again = eng.serve(reqs, n_slots=3, sample_seed=1)
    tight = eng.serve(reqs, n_slots=3, num_pages=8, sample_seed=1)
    other = eng.serve(reqs, n_slots=3, sample_seed=2)
    greedy = eng.serve(requests(tcfg.vocab_size, PREEMPT), n_slots=3)
    assert tight["stats"]["preemptions"] > 0
    for rid in range(3):
        assert ample[rid] == again[rid] == tight[rid]
    assert ample[1] == greedy[1] == other[1]
    assert ample[0] != other[0] or ample[2] != other[2]
    assert ample[0] != greedy[0] or ample[2] != greedy[2]
