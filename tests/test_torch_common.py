"""Function-level parity of the PyTorch port against its JAX twins.

Every ported function of ``models/common.py``, ``core/attngate.py``,
``core/kcache.py``, ``core/sparsity.py`` and the aux helpers of
``models/attn_core.py`` runs on the same numpy-seeded float32 inputs in
both packages, at the ``tiny_cfg`` scale. Tolerance 1e-5 for values;
block ids are compared exactly, including a constructed exact-tie case
(the lower index wins, as ``jax.lax.top_k`` does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capture_golden_policy as G
from repro.config import GateConfig
from repro.core import attngate as j_ag
from repro.core import kcache as j_kc
from repro.core import sparsity as j_sp
from repro.models import attn_core as j_core
from repro.models import common as j_cm
from repro_torch import config as t_config
from repro_torch.configs import get as t_get
from repro_torch.core import attngate as t_ag
from repro_torch.core import kcache as t_kc
from repro_torch.core import sparsity as t_sp
from repro_torch.models import attn_core as t_core
from repro_torch.models import common as t_cm

jax.config.update("jax_platform_name", "cpu")

TOL = dict(atol=1e-5, rtol=1e-5)
GATE = GateConfig(block_size=8, d_gate=16, token_budget=32)


def rng(seed=0):
    return np.random.default_rng(seed)


def randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def tcfg(g: GateConfig):
    return t_config.GateConfig(**dataclasses.asdict(g))


def close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t.detach().cpu(), np.float32),
                               np.asarray(j, np.float32), **(kw or TOL))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    import repro.configs as j_configs
    from repro.config import reduced
    assert dataclasses.asdict(t_get("qwen3_0_6b")) == \
        dataclasses.asdict(j_configs.get("qwen3_0_6b"))
    for method in ("budget", "threshold"):
        jc = G.tiny_cfg(method)
        tc = t_config.reduced(t_get("qwen3_0_6b")).replace(
            dtype="float32", gate=tcfg(jc.gate))
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for arch in ("qwen3_0_6b", "gemma_2b", "granite_20b", "deepseek_coder_33b"):
        assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_configs.get(arch))
        assert dataclasses.asdict(t_config.reduced(t_get(arch))) == \
            dataclasses.asdict(reduced(j_configs.get(arch)))
    assert t_get("qwen3-0-6b").arch_id == "qwen3_0_6b"


# ---------------------------------------------------------------------------
# models/common.py
# ---------------------------------------------------------------------------

def test_linear_and_rms_norm():
    r = rng(1)
    x, w, sc = randn(r, 2, 5, 16), randn(r, 16, 8), randn(r, 16)
    close(t_cm.linear({"w": torch.tensor(w)}, torch.tensor(x)),
          j_cm.linear({"w": jnp.asarray(w)}, jnp.asarray(x)))
    close(t_cm.rms_norm({"scale": torch.tensor(sc)}, torch.tensor(x), 1e-6),
          j_cm.rms_norm({"scale": jnp.asarray(sc)}, jnp.asarray(x), 1e-6))


def test_rms_norm_bf16_casts_back():
    x = torch.tensor(randn(rng(2), 3, 16)).to(torch.bfloat16)
    out = t_cm.rms_norm({"scale": torch.ones(16, dtype=torch.bfloat16)}, x)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    r = rng(3)
    close(t_cm.rope_freqs(16, theta, "cpu"), j_cm.rope_freqs(16, theta))
    x = randn(r, 2, 7, 3, 16)
    pos = r.integers(-40, 60, size=(2, 7))
    close(t_cm.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
          j_cm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    r = rng(4)
    p = {"wi_gate": {"w": randn(r, 16, 32)}, "wi_up": {"w": randn(r, 16, 32)},
         "wo": {"w": randn(r, 32, 16)}}
    x = randn(r, 2, 3, 16)
    tp = jax.tree.map(torch.tensor, p)
    jp = jax.tree.map(jnp.asarray, p)
    close(t_cm.mlp(tp, torch.tensor(x), act), j_cm.mlp(jp, jnp.asarray(x), act))


def test_repeat_kv():
    x = randn(rng(5), 2, 3, 2, 4)
    close(t_cm.repeat_kv(torch.tensor(x), 3), j_cm.repeat_kv(jnp.asarray(x), 3),
          atol=0, rtol=0)
    assert t_cm.NEG_INF == j_cm.NEG_INF


@pytest.mark.parametrize("lq,q_chunk,causal,cap", [
    (20, 8, True, 0.0), (20, 32, True, 0.0), (13, 4, False, 0.0),
    (16, 5, True, 30.0)])
def test_chunked_attention(lq, q_chunk, causal, cap):
    r = rng(6)
    q, k, v = randn(r, 2, lq, 4, 16), randn(r, 2, lq, 2, 16), randn(r, 2, lq, 2, 16)
    o_t = t_cm.chunked_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                 causal=causal, q_chunk=q_chunk, logit_softcap=cap)
    o_j, _ = j_cm.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, q_chunk=q_chunk,
                                    logit_softcap=cap)
    close(o_t, o_j)


def test_decode_attention():
    r = rng(7)
    q, k, v = randn(r, 3, 1, 4, 16), randn(r, 3, 2, 24, 16), randn(r, 3, 2, 24, 16)
    kv_len = np.array([24, 9, 1], np.int32)
    close(t_cm.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                torch.tensor(kv_len)),
          j_cm.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(kv_len)))


# ---------------------------------------------------------------------------
# core/attngate.py
# ---------------------------------------------------------------------------

def _gate_params(r, hkv=2, g=2, dh=16, dg=16):
    p = {"wq": randn(r, hkv, g * dh, dg) * 0.2, "wk": randn(r, hkv, 3 * dh, dg) * 0.2}
    return ({k: torch.tensor(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("use_rope", [True, False])
def test_gate_q_pool_gate_k(use_rope):
    r = rng(8)
    g = dataclasses.replace(GATE, use_rope=use_rope)
    tp, jp = _gate_params(r)
    q = randn(r, 2, 3, 4, 16)
    pos = r.integers(0, 50, size=(2, 3))
    close(t_ag.gate_q(tp, torch.tensor(q), torch.tensor(pos), tcfg(g)),
          j_ag.gate_q(jp, jnp.asarray(q), jnp.asarray(pos), g))
    k = randn(r, 2, 24, 2, 16)
    close(t_ag.pool_k_blocks(torch.tensor(k), 8),
          j_ag.pool_k_blocks(jnp.asarray(k), 8))
    for first in (0, 5):
        close(t_ag.gate_k(tp, torch.tensor(k), tcfg(g), first_block_index=first),
              j_ag.gate_k(jp, jnp.asarray(k), g, first_block_index=first))


# ---------------------------------------------------------------------------
# core/kcache.py
# ---------------------------------------------------------------------------

def test_finalize_block_kg_matches_per_row():
    r = rng(9)
    tp, jp = _gate_params(r)
    blk = randn(r, 3, 8, 2, 16)
    start = np.array([0, 8, 40], np.int32)
    bidx = start // 8
    out = t_kc.finalize_block_kg(tp, torch.tensor(blk), torch.tensor(start),
                                 torch.tensor(bidx), tcfg(GATE), is_roped=True)
    for i in range(3):
        ref = j_kc.finalize_block_kg(jp, jnp.asarray(blk[i]), int(start[i]),
                                     int(bidx[i]), GATE, is_roped=True)
        close(out[i], ref)


@pytest.mark.parametrize("cur_len", [
    [16, 16, 16],        # every row crosses a block boundary
    [16, 13, 0],         # boundary, mid-block, empty slot (cur_len == 0)
    [8, 1, 24],          # first block completes; a lone token; third block
])
def test_update_kcache(cur_len):
    r = rng(10)
    tp, jp = _gate_params(r)
    b, s = 3, 32
    k_raw = randn(r, b, 2, s, 16)
    kg0 = randn(r, b, 2, s // 8, 16)
    n0 = np.array([1, 1, 2], np.int32)
    cl = np.array(cur_len, np.int32)
    t_kg = torch.tensor(kg0)
    t_out = t_kc.update_kcache(t_kc.KCompressionCache(t_kg, torch.tensor(n0)), tp,
                               torch.tensor(k_raw), torch.tensor(cl), tcfg(GATE),
                               cache_is_roped=True)
    j_out = j_kc.update_kcache(j_kc.KCompressionCache(jnp.asarray(kg0),
                                                      jnp.asarray(n0)),
                               jp, jnp.asarray(k_raw), jnp.asarray(cl), GATE,
                               cache_is_roped=True)
    assert t_out.kg is t_kg                     # written in place
    close(t_out.kg, j_out.kg)
    np.testing.assert_array_equal(t_out.n_complete.numpy(), np.asarray(j_out.n_complete))
    if cur_len[2] == 0:                         # the empty slot is untouched
        np.testing.assert_array_equal(t_out.kg[2].numpy(), kg0[2])


def test_visible_blocks():
    cl = np.array([0, 1, 8, 9, 63, 64], np.int32)
    np.testing.assert_array_equal(t_kc.visible_blocks(torch.tensor(cl), 8).numpy(),
                                  np.asarray(j_kc.visible_blocks(jnp.asarray(cl), 8)))


# ---------------------------------------------------------------------------
# core/sparsity.py
# ---------------------------------------------------------------------------

SEL_CONFIGS = [
    GATE,
    dataclasses.replace(GATE, always_first_block=False),
    dataclasses.replace(GATE, always_first_block=False, always_last_block=False),
    dataclasses.replace(GATE, method="threshold", threshold=5e-2),
    dataclasses.replace(GATE, method="threshold", threshold=2e-2,
                        always_first_block=False, always_last_block=False),
]


def _scores(method, x, n_valid):
    nb = x.shape[-1]
    s = np.where(np.arange(nb)[None, None] < n_valid[:, None, None], x, -1e30)
    if method == "threshold":
        s = np.asarray(jax.nn.softmax(jnp.asarray(s), axis=-1))
    return s.astype(np.float32)


@pytest.mark.parametrize("cfg", SEL_CONFIGS, ids=range(len(SEL_CONFIGS)))
@pytest.mark.parametrize("max_selected", [None, 3])
def test_select_blocks(cfg, max_selected):
    r = rng(11)
    n_valid = np.array([16, 9, 1], np.int32)
    s = _scores(cfg.method, randn(r, 3, 2, 16), n_valid)
    t_idx, t_mask = t_sp.select_blocks(torch.tensor(s), torch.tensor(n_valid),
                                       tcfg(cfg), max_selected)
    j_idx, j_mask = j_sp.select_blocks(jnp.asarray(s), jnp.asarray(n_valid), cfg,
                                       max_selected)
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    close(t_sp.sparsity_ratio(t_mask, torch.tensor(n_valid)),
          j_sp.sparsity_ratio(j_mask, jnp.asarray(n_valid)))


@pytest.mark.parametrize("method", ["budget", "threshold"])
def test_select_blocks_exact_ties_lower_index_wins(method):
    """Equal scores everywhere but two blocks: the winners among the tied
    blocks are the lowest indices, in ascending order."""
    cfg = dataclasses.replace(GATE, method=method, threshold=1e-3,
                              always_first_block=False, always_last_block=False)
    x = np.zeros((2, 2, 16), np.float32)
    x[:, :, 11] = 2.0
    x[:, 1, 4] = 2.0                         # tie among the top values too
    n_valid = np.array([16, 12], np.int32)
    s = _scores(method, x, n_valid)
    t_idx, _ = t_sp.select_blocks(torch.tensor(s), torch.tensor(n_valid), tcfg(cfg), 5)
    j_idx, _ = j_sp.select_blocks(jnp.asarray(s), jnp.asarray(n_valid), cfg, 5)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_idx[0, 1].numpy(), [4, 11, 0, 1, 2])


def test_resolve_max_selected():
    for ms in (None, 1, 7):
        assert t_sp.resolve_max_selected(tcfg(GATE), ms) == \
            j_sp.resolve_max_selected(GATE, ms)
    with pytest.raises(ValueError):
        t_sp.resolve_max_selected(tcfg(GATE), 0)


# ---------------------------------------------------------------------------
# models/attn_core.py aux helpers
# ---------------------------------------------------------------------------

def test_selection_and_dense_aux():
    idx = np.array([[[0, 5, -1, -1], [3, 3, 1, -1]],
                    [[2, -1, -1, -1], [0, 1, 2, -1]]], np.int32)
    n_valid = np.array([6, 3], np.int32)
    t_aux = t_core._selection_aux(torch.tensor(idx), torch.tensor(n_valid), 8)
    j_aux = j_core._selection_aux(jnp.asarray(idx), jnp.asarray(n_valid), 8)
    for a, b in zip(t_aux, j_aux):
        close(a, b)
    new_len = np.array([17, 1], np.int32)
    for a, b in zip(t_core._dense_aux(torch.tensor(new_len), 8),
                    j_core._dense_aux(jnp.asarray(new_len), 8)):
        close(a, b)
    agg_t = t_core.aggregate_decode_aux([t_aux, t_aux])
    agg_j = j_core.aggregate_decode_aux(tuple(jnp.stack([x, x]) for x in j_aux))
    for key in agg_j:
        close(agg_t[key], agg_j[key])
