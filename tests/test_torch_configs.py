"""The other dense configs of the port against the live JAX reference.

gemma_2b (MQA 8 x 256, GeGLU, tied embeddings, vocab 256000),
granite_20b (MQA 48 x 128) and deepseek_coder_33b (GQA 56 / 8 x 128) are
copied into ``repro_torch.configs``. Each must equal the reference's
config field by field, at full size and ``reduced()``. Then, in float32
on the CPU (the plain versions of the kernels), with the reference's
``init_params`` weights converted by ``convert.params_from_numpy``:

- a reduced ``generate`` rollout (a 2 x 41 prompt, greedy steps, the
  budget and the threshold gate) and a paged ``serve`` run with a
  preempting pool;
- a one-layer rollout at the config's own head geometry
  (``reduced(cfg, num_layers=1, n_heads=..., n_kv_heads=..., head_dim=...)``:
  8 x 256 MQA, 48 x 128 MQA, 56 / 8 x 128), which holds the plain decode
  at G 48 and at Dh 256 against the reference.

Greedy tokens and every selected id list (each layer, each step, recorded
at ``GatePolicy.select`` in both packages: in the reference through
``jax.debug.callback``, inside its jitted step) must be equal, and logits
within 1e-4, as ``tests/test_torch_engine.py`` holds the qwen3 rollouts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import capture_golden_policy as G
import repro.configs as j_configs
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.core.policy import default_options as j_default_options
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch import configs as t_configs
from repro_torch.config import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.core.policy import default_options as t_default_options
from repro_torch.kernels import ops as t_ops
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

NEW = ["gemma_2b", "granite_20b", "deepseek_coder_33b"]
# the MoE and vision configs (tests/test_torch_moe.py, tests/test_torch_vlm.py)
FAMILIES = ["deepseek_moe_16b", "kimi_k2_1t_a32b", "llama_3_2_vision_11b"]
# the recurrent configs (tests/test_torch_recurrent.py)
RECURRENT = ["falcon_mamba_7b", "zamba2_1_2b"]
LOGIT_TOL = 1e-4
N_STEPS = 8
SERVE_SPECS = [(20, 12), (18, 10), (22, 9)]     # three requests, 8 pages: preempts


def _own_geometry(cfg, reduce):
    """One layer at the config's own heads, KV heads and head dim."""
    return reduce(cfg, num_layers=1, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.head_dim)


def _pair(arch, method="budget", own=False):
    """(reference cfg, its params, port cfg, port params) in float32."""
    j_full, t_full = j_configs.get(arch), t_configs.get(arch)
    jcfg = (_own_geometry(j_full, j_reduced) if own else j_reduced(j_full)).replace(
        dtype="float32")
    tcfg = (_own_geometry(t_full, t_reduced) if own else t_reduced(t_full)).replace(
        dtype="float32")
    jcfg = jcfg.replace(gate=dataclasses.replace(jcfg.gate, method=method, threshold=2e-2))
    tcfg = tcfg.replace(gate=dataclasses.replace(tcfg.gate, method=method, threshold=2e-2))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
    return jcfg, params, tcfg, params_from_numpy(jax.device_get(params), tcfg, "cpu")


@pytest.fixture
def selections(monkeypatch):
    """Record every GatePolicy.select result, in call order: (reference
    list, port list). The reference's records come from its compiled step
    through an ordered debug callback."""
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


def _assert_same_ids(j_ids, t_ids, n_calls):
    assert len(j_ids) == len(t_ids) == n_calls
    for i, (a, b) in enumerate(zip(j_ids, t_ids)):
        np.testing.assert_array_equal(b, a, err_msg=f"select call {i}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_hold_the_four_dense_configs():
    """All ten configs of the reference, the audio encoder last."""
    assert t_configs.ARCH_IDS == ["qwen3_0_6b", *NEW, *FAMILIES, *RECURRENT,
                                  "hubert_xlarge"]
    assert sorted(t_configs.ARCH_IDS) == sorted(j_configs.ARCH_IDS)
    for arch in NEW + FAMILIES + RECURRENT + ["hubert_xlarge"]:
        assert t_configs.get(arch.replace("_", "-")).arch_id == arch
    with pytest.raises(ValueError, match="unported"):
        t_configs.get("hubert_base")


@pytest.mark.parametrize("arch", NEW + FAMILIES)
def test_config_matches_reference(arch):
    j, t = j_configs.get(arch), t_configs.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t_reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert dataclasses.asdict(_own_geometry(t, t_reduced)) == \
        dataclasses.asdict(_own_geometry(j, j_reduced))


# ---------------------------------------------------------------------------
# rollouts and serve
# ---------------------------------------------------------------------------

def _rollout(eng, toks, n_steps, to_np):
    tok, st = eng.prefill({"tokens": toks})
    lgs, tks = [], []
    for _ in range(n_steps):
        tok, lg, st, _ = eng._step(eng.params, st, tok)
        lgs.append(to_np(lg))
        tks.append(to_np(tok))
    return np.stack(lgs), np.stack(tks)


def _check_rollout(arch, method, own, selections):
    jcfg, params, tcfg, tparams = _pair(arch, method, own)
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, jcfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    j_eng = JaxEngine(jcfg, params, max_len=G.MAX_LEN, options=j_default_options(jcfg))
    j_lg, j_tk = _rollout(j_eng, jnp.asarray(toks), N_STEPS,
                          lambda x: np.asarray(x, np.float32))
    t_ops.reset_launch_counts()
    t_eng = DecodeEngine(tcfg, tparams, max_len=G.MAX_LEN,
                         options=t_default_options(tcfg), device="cpu")
    t_lg, t_tk = _rollout(t_eng, toks, N_STEPS, lambda x: x.float().numpy())
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)   # CPU: plain
    np.testing.assert_array_equal(t_tk, j_tk)
    np.testing.assert_allclose(t_lg, j_lg, atol=LOGIT_TOL, rtol=0)
    _assert_same_ids(*selections, tcfg.num_layers * N_STEPS)


@pytest.mark.parametrize("method", ["budget", "threshold"])
@pytest.mark.parametrize("arch", NEW)
def test_reduced_rollout_matches_jax(arch, method, selections):
    _check_rollout(arch, method, False, selections)


@pytest.mark.parametrize("arch", NEW)
def test_own_head_geometry_rollout_matches_jax(arch, selections):
    """One layer at 8 x 256 MQA (gemma_2b), 48 x 128 MQA (granite_20b) or
    56 / 8 x 128 (deepseek_coder_33b): the plain decode and gate at the
    configs' own group sizes and head dims."""
    _check_rollout(arch, "budget", True, selections)


@pytest.mark.parametrize("arch", NEW)
def test_reduced_serve_matches_jax(arch, selections):
    """Paged serve, three requests on 3 slots over 8 pages: preemption,
    swap and resume; tokens, logits and the scheduler's counters."""
    jcfg, params, tcfg, tparams = _pair(arch)
    rng = np.random.default_rng(0)
    reqs = [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, jcfg.vocab_size, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(SERVE_SPECS)]
    kw = dict(n_slots=3, num_pages=8, collect_logits=True)
    j_res = JaxEngine(jcfg, params, max_len=64).serve(reqs, **kw)
    t_ops.reset_launch_counts()
    t_res = DecodeEngine(tcfg, tparams, max_len=64, device="cpu").serve(reqs, **kw)
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)
    for i in range(len(reqs)):
        np.testing.assert_array_equal(np.asarray(t_res[i]), np.asarray(j_res[i]))
        np.testing.assert_allclose(np.asarray(t_res["logits"][i], np.float32),
                                   np.asarray(j_res["logits"][i], np.float32),
                                   atol=LOGIT_TOL, rtol=0)
    for key in ("preemptions", "resumed", "decode_steps", "swapped_out_bytes"):
        assert t_res["stats"][key] == j_res["stats"][key], key
    assert t_res["stats"]["preemptions"] > 0
    j_ids, t_ids = selections
    _assert_same_ids(j_ids, t_ids, tcfg.num_layers * t_res["stats"]["decode_steps"])
