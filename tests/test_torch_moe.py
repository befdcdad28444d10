"""The MoE family of the port against the live JAX reference.

``deepseek_moe_16b`` (64 routed experts, top 6, 2 shared, MHA 16 x 128)
and ``kimi_k2_1t_a32b`` (384 routed, top 8, 1 shared, GQA 64 / 8 x 128)
run through ``repro_torch.models.moe``. In float32 on the CPU (the plain
versions of the kernels), with the reference's ``init_params`` weights
converted by ``convert.params_from_numpy``:

- ``moe_mlp`` alone: routing ties (lower index first), the keep mask of a
  call whose capacity drops assignments, the shared experts and the
  Switch aux loss;
- ``generate`` rollouts of each config at ``reduced()`` (4 experts, top 2,
  capacity 2.0: nothing drops) and at its published router (E and top-k
  as published, capacity 1.25: decode rows share one slot an expert, so
  drops happen): greedy tokens, every selected id list and every
  expert-rank list equal, logits within 1e-4;
- fp and int8 ``serve`` with an ample and a preempting pool, each against
  the reference's same run. Rows are coupled through the experts'
  capacity, so the tight and the ample run differ from each other, in the
  reference as in the port; Quest on ``serve``;
- ``lm_forward(mode="distill")`` and ``params_from_numpy`` of the MoE tree.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capture_golden_policy as G
import repro.configs as j_configs
from repro.config import MoEConfig as JMoE
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.models import moe as j_moe
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch import configs as t_configs
from repro_torch.config import MoEConfig as TMoE
from repro_torch.config import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.kernels import ops as t_ops
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["deepseek_moe_16b", "kimi_k2_1t_a32b"]
LOGIT_TOL = 1e-4
INT8_TOL = 1e-3           # tests/test_torch_quant.py: port int8 vs reference int8
N_STEPS = 6
SERVE_SPECS = [(20, 10), (18, 8), (22, 7)]     # three requests, 8 pages: preempts


def _published_router(cfg, moe_cls):
    """The config's own router (E, top-k, shared experts, capacity 1.25 as
    published) at the reduced expert width."""
    m = cfg.moe
    return moe_cls(n_experts=m.n_experts, top_k=m.top_k,
                   n_shared_experts=m.n_shared_experts, expert_d_ff=64,
                   capacity_factor=m.capacity_factor)


@functools.lru_cache(maxsize=None)
def _pair(arch, router="reduced"):
    """(reference cfg, its params, port cfg, port params) in float32;
    built once a module (every user only reads them)."""
    j_full, t_full = j_configs.get(arch), t_configs.get(arch)
    jcfg = j_reduced(j_full).replace(dtype="float32")
    tcfg = t_reduced(t_full).replace(dtype="float32")
    if router == "published":
        jcfg = jcfg.replace(moe=_published_router(j_full, JMoE))
        tcfg = tcfg.replace(moe=_published_router(t_full, TMoE))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
    return jcfg, params, tcfg, params_from_numpy(jax.device_get(params), tcfg, "cpu")


@pytest.fixture
def recorded(monkeypatch):
    """Every GatePolicy.select result and every expert-rank list, in call
    order, of both packages: {"ids": (ref, port), "ranks": (ref, port)}.
    The reference's records come out of its compiled steps through
    ordered debug callbacks."""
    rec = {"ids": ([], []), "ranks": ([], [])}
    j_sel, t_sel = JP.GatePolicy.select, TP.GatePolicy.select
    j_rank, t_rank = j_moe._rank_within_expert, t_moe._rank_within_expert

    def j_select(self, inp, cfg, **kw):
        idx = j_sel(self, inp, cfg, **kw)
        jax.debug.callback(lambda x: rec["ids"][0].append(np.asarray(x)), idx, ordered=True)
        return idx

    def t_select(self, inp, cfg, **kw):
        idx = t_sel(self, inp, cfg, **kw)
        rec["ids"][1].append(idx.numpy().copy())
        return idx

    def j_ranks(flat_e, n):
        r = j_rank(flat_e, n)
        jax.debug.callback(lambda x: rec["ranks"][0].append(np.asarray(x)), r, ordered=True)
        return r

    def t_ranks(flat_e, n):
        r = t_rank(flat_e, n)
        rec["ranks"][1].append(r.numpy().copy())
        return r

    monkeypatch.setattr(JP.GatePolicy, "select", j_select)
    monkeypatch.setattr(TP.GatePolicy, "select", t_select)
    monkeypatch.setattr(j_moe, "_rank_within_expert", j_ranks)
    monkeypatch.setattr(t_moe, "_rank_within_expert", t_ranks)
    return rec


def _assert_same_lists(pair, n_calls=None):
    j, t = pair
    assert len(j) == len(t) > 0
    if n_calls is not None:
        assert len(t) == n_calls
    for i, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_array_equal(b, a, err_msg=f"call {i}")


# ---------------------------------------------------------------------------
# configs and moe_mlp alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_config_matches_reference(arch):
    j, t = j_configs.get(arch), t_configs.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t_reduced(t)) == dataclasses.asdict(j_reduced(j))


def _moe_params(d, mcfg, seed):
    params = j_moe.init_moe(jax.random.PRNGKey(seed), d, mcfg, "swiglu", "float32")
    return params, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), params)


def _moe_both(jp, tp, x, jm, tm):
    jy, jaux = j_moe.moe_mlp(jp, jnp.asarray(x), jm, "swiglu")
    ty, taux = t_moe.moe_mlp(tp, torch.tensor(x), tm, "swiglu")
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


@pytest.mark.parametrize("case", ["drops", "ample", "no-shared"])
def test_moe_mlp_matches_reference(case):
    """The routing, the rank of each assignment within its expert, the
    keep mask, the output and the aux loss. ``drops``: 24 tokens on 8
    experts at top 2 and capacity 1.0 (6 slots an expert)."""
    cap_f, shared = {"drops": (1.0, 1), "ample": (4.0, 1), "no-shared": (1.25, 0)}[case]
    kw = dict(n_experts=8, top_k=2, n_shared_experts=shared, expert_d_ff=32,
              capacity_factor=cap_f)
    jm, tm = JMoE(**kw), TMoE(**kw)
    jp, tp = _moe_params(64, jm, 3)
    x = np.random.default_rng(5).standard_normal((24, 64)).astype(np.float32)
    jprobs, jtop_i, _ = j_moe._route(jnp.asarray(x), jp["router"]["w"], 2)
    tprobs, ttop_i, _ = t_moe.route(torch.tensor(x), tp["router"]["w"], 2)
    np.testing.assert_array_equal(ttop_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-6)
    flat_e, slot, keep, cap = t_moe.dispatch(ttop_i, tm)
    assert cap == max(1, int(np.ceil(24 * 2 / 8 * cap_f)))
    jrank = np.asarray(j_moe._rank_within_expert(jnp.asarray(jtop_i).reshape(-1), 8))
    np.testing.assert_array_equal(keep.numpy(), jrank < cap)
    np.testing.assert_array_equal(slot.numpy(), np.where(jrank < cap, jrank, cap))
    assert (not keep.all()) == (case == "drops")
    (jy, jaux), (ty, taux) = _moe_both(jp, tp, x, jm, tm)
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    assert taux == pytest.approx(jaux, rel=1e-5)
    assert ("shared" in tp) == bool(shared)


def test_moe_routing_ties_take_the_lower_expert():
    """Experts 1, 4 and 6 share one router column, so every token ties
    them exactly: the lower index wins, as jax.lax.top_k orders them; the
    rows repeat, so the later rows' assignments drop at capacity."""
    kw = dict(n_experts=8, top_k=2, n_shared_experts=0, expert_d_ff=32,
              capacity_factor=1.0)
    jm, tm = JMoE(**kw), TMoE(**kw)
    jp, tp = _moe_params(64, jm, 4)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 1] += 10.0 * np.abs(w).max()          # 1 (and its copies) lead every row
    w[:, 4] = w[:, 6] = w[:, 1]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    tp = dict(tp, router={"w": torch.tensor(w)})
    x = np.abs(np.random.default_rng(6).standard_normal((4, 64))).astype(np.float32)
    x = np.concatenate([x, x])
    _, jtop_i, _ = j_moe._route(jnp.asarray(x), jp["router"]["w"], 2)
    _, ttop_i, _ = t_moe.route(torch.tensor(x), tp["router"]["w"], 2)
    np.testing.assert_array_equal(ttop_i.numpy(), np.asarray(jtop_i))
    assert (ttop_i.numpy() == [1, 4]).all()
    _, _, keep, _ = t_moe.dispatch(ttop_i, tm)
    assert not keep.all()
    (jy, jaux), (ty, taux) = _moe_both(jp, tp, x, jm, tm)
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=0)
    assert taux == pytest.approx(jaux, rel=1e-5)


def test_params_from_numpy_moe_tree():
    """The MoE tree: the experts' [L, E, d, f] / [L, E, f, d] leaves split
    into layers, the router and the shared GLU; the port's own init keeps
    the router fp32 in a bf16 model, with the reference's shapes."""
    jcfg, jparams, tcfg, tp = _pair("deepseek_moe_16b", "published")
    params = jax.device_get(jparams)
    m = tcfg.moe
    assert len(tp["blocks"]) == tcfg.num_layers and "mlp" not in tp["blocks"][0]
    for i, blk in enumerate(tp["blocks"]):
        moe = blk["moe"]
        assert tuple(moe["wi_gate"].shape) == (m.n_experts, tcfg.d_model, m.expert_d_ff)
        assert tuple(moe["wo"].shape) == (m.n_experts, m.expert_d_ff, tcfg.d_model)
        for path in (("router", "w"), ("wi_up",), ("shared", "wo", "w")):
            ref, got = params["blocks"]["moe"], moe
            for key in path:
                ref, got = ref[key], got[key]
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref[i], np.float32))
    t_init = t_tf.init_lm(torch.Generator().manual_seed(0), tcfg.replace(dtype="bfloat16"))
    t_moe_p = t_init["blocks"][0]["moe"]
    assert t_moe_p["router"]["w"].dtype == torch.float32
    assert t_moe_p["wi_gate"].dtype == t_moe_p["shared"]["wo"]["w"].dtype == torch.bfloat16
    assert jax.tree.map(lambda a: a.shape[1:], params["blocks"]["moe"]) == \
        jax.tree.map(lambda a: tuple(a.shape), t_moe_p)


# ---------------------------------------------------------------------------
# generate, serve, distill
# ---------------------------------------------------------------------------

def _rollout(eng, toks, n_steps, to_np):
    tok, st = eng.prefill({"tokens": toks})
    lgs, tks = [], []
    for _ in range(n_steps):
        tok, lg, st, _ = eng._step(eng.params, st, tok)
        lgs.append(to_np(lg))
        tks.append(to_np(tok))
    return np.stack(lgs), np.stack(tks)


@pytest.mark.parametrize("router", ["reduced", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch, router, recorded):
    jcfg, params, tcfg, tparams = _pair(arch, router)
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, jcfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    j_eng = JaxEngine(jcfg, params, max_len=G.MAX_LEN)
    j_lg, j_tk = _rollout(j_eng, jnp.asarray(toks), N_STEPS,
                          lambda x: np.asarray(x, np.float32))
    t_ops.reset_launch_counts()
    t_eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN, device="cpu")
    t_lg, t_tk = _rollout(t_eng, toks, N_STEPS, lambda x: x.float().numpy())
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)   # CPU: plain
    np.testing.assert_array_equal(t_tk, j_tk)
    np.testing.assert_allclose(t_lg, j_lg, atol=LOGIT_TOL, rtol=0)
    _assert_same_lists(recorded["ids"], tcfg.num_layers * N_STEPS)
    # one rank list a layer for the prefill, then one a layer and step
    _assert_same_lists(recorded["ranks"], tcfg.num_layers * (N_STEPS + 1))
    cap = t_moe.capacity(G.PROMPT_SHAPE[0], tcfg.moe)
    decode_ranks = recorded["ranks"][1][tcfg.num_layers:]
    dropped = sum(int((r >= cap).sum()) for r in decode_ranks)
    if router == "reduced":
        assert dropped == 0        # 2 rows, top 2 of 4 experts, capacity 2.0
    elif arch == "deepseek_moe_16b":
        assert dropped > 0         # 2 rows, top 6 of 64, one slot an expert


def _requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, vocab, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(SERVE_SPECS)]


@functools.lru_cache(maxsize=None)
def _serve_pair(arch, opts, pool, router="published"):
    """(requests, the reference's serve, the port's) with SERVE_OPTIONS[opts]."""
    opts_kw = SERVE_OPTIONS[opts]
    jcfg, params, tcfg, tparams = _pair(arch, router)
    reqs = _requests(jcfg.vocab_size)
    kw = dict(n_slots=3, num_pages=pool, collect_logits=True)
    j_res = JaxEngine(jcfg, params, max_len=64,
                      options=JP.DecodeOptions(**opts_kw(JP))).serve(reqs, **kw)
    t_ops.reset_launch_counts()
    t_res = DecodeEngine(tcfg, tparams, max_len=64, device="cpu",
                         options=TP.DecodeOptions(**opts_kw(TP))).serve(reqs, **kw)
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)
    return reqs, j_res, t_res


def _assert_same_serve(reqs, j_res, t_res, tol):
    for i in range(len(reqs)):
        assert t_res[i] == j_res[i], f"rid {i}"
        np.testing.assert_allclose(np.asarray(t_res["logits"][i], np.float32),
                                   np.asarray(j_res["logits"][i], np.float32),
                                   atol=tol, rtol=0)
    for key in ("preemptions", "resumed", "decode_steps", "swapped_out_bytes"):
        assert t_res["stats"][key] == j_res["stats"][key], key


SERVE_OPTIONS = {
    "fp": lambda pkg: {},
    "int8": lambda pkg: {"quantize": "int8"},
    "quest": lambda pkg: {"policy": pkg.QuestPolicy()},
}


SERVE_RUNS = [(arch, opts, pool) for arch in ARCHS
              for opts in ("fp", "int8") for pool in (None, 8)]
SERVE_RUNS.append(("deepseek_moe_16b", "quest", 8))


@pytest.mark.parametrize("arch,opts,pool", SERVE_RUNS)
def test_serve_matches_jax(arch, opts, pool):
    """The published routers on 3 slots: deepseek_moe_16b has one slot an
    expert a step, so the active and inactive rows (token 0) compete for
    capacity. Each run against the reference's same run."""
    reqs, j_res, t_res = _serve_pair(arch, opts, pool)
    _assert_same_serve(reqs, j_res, t_res, INT8_TOL if opts == "int8" else LOGIT_TOL)
    assert (t_res["stats"]["preemptions"] > 0) == (pool is not None)


def test_serve_tight_and_ample_differ_in_both_packages():
    """Capacity couples the rows of a step: once preemption changes which
    slots are active, a request's logits change, in the reference as in
    the port, and by the same amounts."""
    reqs, j_ample, t_ample = _serve_pair("deepseek_moe_16b", "fp", None)
    _, j_tight, t_tight = _serve_pair("deepseek_moe_16b", "fp", 8)

    def gap(a, b):
        return max(float(np.abs(np.asarray(a["logits"][i], np.float32)[:n]
                                - np.asarray(b["logits"][i], np.float32)[:n]).max())
                   for i in range(len(reqs))
                   for n in [min(len(a["logits"][i]), len(b["logits"][i]))])
    j_gap, t_gap = gap(j_tight, j_ample), gap(t_tight, t_ample)
    assert j_gap > 1e-3 and t_gap > 1e-3
    assert t_gap == pytest.approx(j_gap, abs=2 * LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_distill_matches_reference(arch):
    """The gate KL over the self layers plus 0 x the router loss, on a
    packed batch of the port's pipeline handed to both packages; and the
    pretrain loss (CE plus the router loss, which the published router's
    capacity drops feed) and its metrics on the same batch."""
    jcfg, params, tcfg, tparams = _pair(arch, "published")
    batch = make_batch(tcfg, 2, 64, DataState(0, 1), device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    kl_j, mj = get_api(jcfg).forward(params, jb, jcfg, mode="distill")
    kl_t, mt = t_tf.lm_forward(tparams, batch, tcfg, mode="distill")
    np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-5)
    np.testing.assert_allclose(float(mt["kl"]), float(mj["kl"]), rtol=1e-5)
    x = tparams["embed"]["w"][batch["tokens"]]
    _, _, aux, _ = t_tf.lm_backbone(tparams, x, tcfg, rope_positions=batch["positions"],
                                    segment_ids=batch["segment_ids"], distill=False)
    assert float(aux) > 0 and float(kl_t) > 0
    loss_j, mj = get_api(jcfg).forward(params, jb, jcfg, mode="pretrain")
    loss_t, mt = t_tf.lm_forward(tparams, batch, tcfg, mode="pretrain")
    for got, want in ((loss_t, loss_j), (mt["ce"], mj["ce"]), (mt["aux"], mj["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(mt["aux"]), float(aux), rtol=1e-6)
