"""The vision backbone of the port against the live JAX reference.

``llama_3_2_vision_11b``: one cross-attention layer every 5 into 1601
image tokens, the self layers gated, the cross layers dense and
position-free. In float32 on the CPU with the reference's weights
(``convert.params_from_numpy``) and the same ``image_embeds`` handed to
both packages:

- ``generate`` at ``reduced()`` (one unit: a self and a cross layer) and
  at two units of two self layers (``num_layers=6, cross_attn_period=3``,
  which an off-by-one-unit cache index would break): greedy tokens and
  every selected id list equal, every step's logits within 1e-4;
- the prefill's head-major ``cross_k``/``cross_v`` and the self layers'
  caches;
- the reference's refusals, mirrored: no paged step (and so no
  ``serve``), no plan-carrying SelectionSchedule;
- ``lm_forward(mode="distill")``, and the vision batch's keys and shapes
  against the reference's ``make_batch``.
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
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.data import pipeline as j_pipe
from repro.models import transformer as j_tf
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch import configs as t_configs
from repro_torch.config import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import ops as t_ops
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_tf
from repro_torch.serve import paging as t_pg
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

ARCH = "llama_3_2_vision_11b"
LOGIT_TOL = 1e-4
N_STEPS = 6
SHAPES = {"reduced": {}, "two-units": dict(num_layers=6, cross_attn_period=3)}


@functools.lru_cache(maxsize=None)
def _pair(shape="reduced"):
    """(reference cfg, its params, port cfg, port params) in float32."""
    jcfg = j_reduced(j_configs.get(ARCH), **SHAPES[shape]).replace(dtype="float32")
    tcfg = t_reduced(t_configs.get(ARCH), **SHAPES[shape]).replace(dtype="float32")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
    return jcfg, params, tcfg, params_from_numpy(jax.device_get(params), tcfg, "cpu")


def _inputs(cfg):
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, cfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    img = t_pipe.image_embeds(cfg, G.PROMPT_SHAPE[0], t_pipe.DataState(0, 0),
                              device="cpu").numpy()
    return toks, img


@pytest.fixture
def selections(monkeypatch):
    """Every GatePolicy.select result in call order: (reference, port)."""
    j_ids, t_ids = [], []
    j_orig, t_orig = JP.GatePolicy.select, TP.GatePolicy.select

    def j_select(self, inp, cfg, **kw):
        idx = j_orig(self, inp, cfg, **kw)
        jax.debug.callback(lambda x: j_ids.append(np.asarray(x)), idx, ordered=True)
        return idx

    def t_select(self, inp, cfg, **kw):
        idx = t_orig(self, inp, cfg, **kw)
        t_ids.append(idx.numpy().copy())
        return idx

    monkeypatch.setattr(JP.GatePolicy, "select", j_select)
    monkeypatch.setattr(TP.GatePolicy, "select", t_select)
    return j_ids, t_ids


def test_vision_config_matches_reference():
    j, t = j_configs.get(ARCH), t_configs.get(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for shape in SHAPES.values():
        assert dataclasses.asdict(t_reduced(t, **shape)) == \
            dataclasses.asdict(j_reduced(j, **shape))
    assert t_tf.n_self_layers(t) == j_tf.n_self_layers(j) == 32
    assert t_tf._n_gate_layers(t) == j_tf._n_gate_layers(j) == 32
    assert [k for k, _ in t_tf.layer_order(t)] == (["self"] * 4 + ["cross"]) * 8


def _rollout(eng, batch, n_steps, to_np):
    tok, st = eng.prefill(batch)
    lgs, tks = [], []
    for _ in range(n_steps):
        tok, lg, st, _ = eng._step(eng.params, st, tok)
        lgs.append(to_np(lg))
        tks.append(to_np(tok))
    return np.stack(lgs), np.stack(tks), st


@pytest.mark.parametrize("shape", list(SHAPES))
def test_generate_matches_jax(shape, selections):
    jcfg, params, tcfg, tparams = _pair(shape)
    toks, img = _inputs(tcfg)
    j_eng = JaxEngine(jcfg, params, max_len=G.MAX_LEN)
    j_lg, j_tk, j_st = _rollout(j_eng, {"tokens": jnp.asarray(toks),
                                        "image_embeds": jnp.asarray(img)},
                                N_STEPS, lambda x: np.asarray(x, np.float32))
    t_ops.reset_launch_counts()
    t_eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN, device="cpu")
    t_lg, t_tk, t_st = _rollout(t_eng, {"tokens": toks, "image_embeds": img}, N_STEPS,
                                lambda x: x.float().numpy())
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)   # CPU: plain
    np.testing.assert_array_equal(t_tk, j_tk)
    for step in range(N_STEPS):
        np.testing.assert_allclose(t_lg[step], j_lg[step], atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {step}")
    j_ids, t_ids = selections
    assert len(j_ids) == len(t_ids) == t_tf.n_self_layers(tcfg) * N_STEPS
    for i, (a, b) in enumerate(zip(j_ids, t_ids)):
        np.testing.assert_array_equal(b, a, err_msg=f"select call {i}")
    # the caches hold the self layers only; the image K/V ride along unchanged
    assert t_st.k_cache.shape[0] == t_tf.n_self_layers(tcfg)
    for name in ("k_cache", "v_cache", "kg_cache", "cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(t_st, name).numpy(),
                                   np.asarray(getattr(j_st, name)), atol=1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(t_st.kg_n.numpy(), np.asarray(j_st.kg_n))


def test_prefill_cross_kv_match_jax():
    """Head-major [n_units, B, Hkv, n_img, Dh] image K/V of every unit, and
    the prefill's logits."""
    jcfg, params, tcfg, tparams = _pair("two-units")
    toks, img = _inputs(tcfg)
    j_lg, j_st = j_tf.lm_prefill(params, {"tokens": jnp.asarray(toks),
                                          "image_embeds": jnp.asarray(img)}, jcfg,
                                 G.MAX_LEN)
    t_lg, t_st = t_tf.lm_prefill(tparams, {"tokens": torch.tensor(toks),
                                           "image_embeds": torch.tensor(img)}, tcfg,
                                 G.MAX_LEN)
    n_units = tcfg.num_layers // tcfg.cross_attn_period
    assert tuple(t_st.cross_k.shape) == (n_units, 2, tcfg.n_kv_heads, tcfg.n_image_tokens,
                                         tcfg.resolved_head_dim)
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(getattr(t_st, name).numpy(),
                                   np.asarray(getattr(j_st, name)), atol=1e-5, rtol=0)
    assert not torch.equal(t_st.cross_k[0], t_st.cross_k[1])
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), atol=LOGIT_TOL, rtol=0)
    # Quest's metadata caches hold the self layers only, as the K/V caches
    _, j_q = j_tf.lm_prefill(params, {"tokens": jnp.asarray(toks),
                                      "image_embeds": jnp.asarray(img)}, jcfg, G.MAX_LEN,
                             options=JP.DecodeOptions(policy=JP.QuestPolicy()))
    _, t_q = t_tf.lm_prefill(tparams, {"tokens": torch.tensor(toks),
                                       "image_embeds": torch.tensor(img)}, tcfg, G.MAX_LEN,
                             options=TP.DecodeOptions(policy=TP.QuestPolicy()))
    assert t_q.meta_kmin.shape[0] == t_tf.n_self_layers(tcfg) == 4
    for name in ("meta_kmin", "meta_kmax"):
        np.testing.assert_allclose(getattr(t_q, name).numpy(),
                                   np.asarray(getattr(j_q, name)), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_q.meta_n.numpy(), np.asarray(j_q.meta_n))
    with pytest.raises(ValueError, match="image_embeds"):
        t_tf.lm_prefill(tparams, {"tokens": torch.tensor(toks)}, tcfg, G.MAX_LEN)


def test_refusals_mirror_the_reference():
    """No paged step for a cross-attention model (so no serve), and no
    plan-carrying SelectionSchedule, in both packages."""
    jcfg, params, tcfg, tparams = _pair()
    toks, img = _inputs(tcfg)
    n = 2
    with pytest.raises(NotImplementedError, match="cross-attn"):
        j_tf.lm_decode_step_paged(params, None, None, jnp.zeros((n,), jnp.int32),
                                  jnp.zeros((n, 8), jnp.int32), jnp.zeros((n,), jnp.int32),
                                  jnp.ones((n,), bool), jcfg)
    pages = t_pg.init_pages(tcfg, 8, t_tf.n_self_layers(tcfg), device="cpu")
    with pytest.raises(NotImplementedError, match="cross-attn"):
        t_tf.lm_decode_step_paged(tparams, pages, None, torch.zeros(n, dtype=torch.int32),
                                  torch.zeros((n, 8), dtype=torch.int32),
                                  torch.zeros(n, dtype=torch.int32),
                                  torch.ones(n, dtype=torch.bool), tcfg)
    reqs = [{"rid": 0, "max_new_tokens": 4, "tokens": toks[0, :20]}]
    with pytest.raises(TypeError):        # the reference fails in its paged prefill
        JaxEngine(jcfg, params, max_len=64).serve(reqs, n_slots=2)
    eng = DecodeEngine(tcfg, tparams, max_len=64, device="cpu")   # builds, as the reference's
    with pytest.raises(NotImplementedError, match="cross-attn"):
        eng.serve(reqs, n_slots=2)
    for pkg, engine, extra in ((JP, JaxEngine, {}), (TP, DecodeEngine, {"device": "cpu"})):
        sched = pkg.SelectionSchedule(dense_first_n=0, select_layer=0)
        cfg, p = (jcfg, params) if pkg is JP else (tcfg, tparams)
        eng = engine(cfg, p, max_len=64, options=pkg.DecodeOptions(schedule=sched), **extra)
        batch = {"tokens": toks, "image_embeds": img}
        with pytest.raises(NotImplementedError, match="uniform self-attn stack"):
            eng.generate(batch if pkg is TP else
                         {k: jnp.asarray(v) for k, v in batch.items()}, 3)
    assert t_registry.get_api(tcfg) is t_registry.get_api(t_configs.get("qwen3_0_6b"))
    for family in ("ssm", "hybrid"):
        assert t_registry.get_api(tcfg.replace(family=family)).init_slot_state is not None
    # the audio encoder shares the transformer's api (forward only)
    assert t_registry.get_api(tcfg.replace(family="audio")) is t_registry.get_api(tcfg)


def test_lm_forward_distill_matches_reference():
    """The gate KL over the 4 self layers of two units (the cross layers
    carry no gate), on a packed vision batch handed to both packages."""
    jcfg, params, tcfg, tparams = _pair("two-units")
    batch = t_pipe.make_batch(tcfg, 2, 64, t_pipe.DataState(0, 1), device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    kl_j, mj = get_api(jcfg).forward(params, jb, jcfg, mode="distill")
    kl_t, mt = t_tf.lm_forward(tparams, batch, tcfg, mode="distill")
    np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-5)
    np.testing.assert_allclose(float(mt["kl"]), float(mj["kl"]), rtol=1e-5)
    assert float(kl_t) > 0
    extras = t_tf.lm_gate_collect(tparams, batch, tcfg)
    assert extras["glog"].shape[0] == t_tf.n_self_layers(tcfg) == 4


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_vision_batch_matches_reference_layout(seed, step):
    """The same keys, shapes and dtypes as the reference's vision batch,
    the token arrays bitwise (the image embeddings come from the port's
    own numpy stream: scaled normals, a stream apart from the tokens')."""
    tcfg = t_reduced(t_configs.get(ARCH))
    jcfg = j_reduced(j_configs.get(ARCH))
    tb = t_pipe.make_batch(tcfg, 2, 64, t_pipe.DataState(seed, step), device="cpu")
    jb = j_pipe.make_batch(jcfg, 2, 64, j_pipe.DataState(seed, step))
    assert set(tb) == set(jb)
    for key in jb:
        assert tuple(tb[key].shape) == jb[key].shape, key
        assert str(tb[key].dtype).split(".")[-1] == str(jb[key].dtype), key
        if key != "image_embeds":
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    img = tb["image_embeds"].float()
    assert 0.015 < float(img.std()) < 0.025 and abs(float(img.mean())) < 2e-3
    again = t_pipe.make_batch(tcfg, 2, 64, t_pipe.DataState(seed, step), device="cpu")
    assert torch.equal(again["image_embeds"], tb["image_embeds"])
    # an audio config's batch is the encoder's (features and labels), no tokens
    audio = t_pipe.make_batch(tcfg.replace(family="audio", n_audio_features=8), 2, 64,
                              t_pipe.DataState(0, 0), device="cpu")
    assert set(audio) == {"features", "labels"}
    assert tuple(audio["features"].shape) == (2, 64, 8)
