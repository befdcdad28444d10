"""The port's training examples against the live JAX reference on the CPU.

``repro_torch.examples.quickstart``: two pretrain and two distill steps
from the reference's own initial state (``init_train_state`` with a JAX
key, carried across by ``convert.train_state_from_numpy``), float32, the
reduced config at 16-token gate blocks, 4 x 512 tokens a step. The CE
and KL of every step lie within 1e-5 relative of the reference's jitted
``make_train_step`` (``tests/test_torch_pretrain.py``'s bound); sparse vs
dense greedy decoding of the trained model gives the reference's
agreement; the top-p decode reproduces under one ``torch.Generator`` seed
(JAX's PRNG stream cannot be shared).

``repro_torch.examples.distill_and_eval``: its own copies of the
benchmark harness's ``quest_scores_rows`` and ``recall_at`` are held
against numpy written here (ties rank the lower index first, as
``jax.lax.top_k`` does); the recalls over the reference's
``lm_gate_collect`` output equal those over the port's; and the example
runs end to end, clearing its checkpoint directory unless it resumes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.config import OptimConfig as JOptim
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.core.policy import DecodeOptions as JOptions
from repro.core.policy import DensePolicy as JDense
from repro.data import pipeline as j_data
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.train import loop as j_loop
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.core.policy import DecodeOptions
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.examples import distill_and_eval as de
from repro_torch.examples import quickstart as qs
from repro_torch.models import transformer as t_tf
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.sampling import SamplingParams

jax.config.update("jax_platform_name", "cpu")

STEPS = 2
RTOL = 1e-5


def _j_quickstart_cfg(tcfg):
    j = j_reduced(j_configs.get("qwen3_0_6b")).replace(dtype="float32")
    j = j.replace(gate=dataclasses.replace(j.gate, block_size=16, d_gate=16, token_budget=192))
    assert dataclasses.asdict(j) == dataclasses.asdict(tcfg)
    return j


def _j_tcfg(t):
    return JTrain(**{**dataclasses.asdict(t), "optim": JOptim(**dataclasses.asdict(t.optim))})


@pytest.fixture(scope="module")
def quickstart_runs():
    """(the reference's CE, KL, agreement; the port's quickstart result)."""
    tcfg = qs.quickstart_config().replace(dtype="float32")
    jcfg = _j_quickstart_cfg(tcfg)
    p_t, d_t = qs.pretrain_config(STEPS), qs.distill_config(STEPS)
    p_j, d_j = _j_tcfg(p_t), _j_tcfg(d_t)
    pstate = j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, p_j)
    start = train_state_from_numpy(jax.device_get(pstate), tcfg, "cpu")
    step = jax.jit(j_loop.make_train_step(jcfg, p_j))
    ce, kl = [], []
    for i in range(STEPS):
        pstate, m = step(pstate, j_data.make_batch(jcfg, qs.BATCH, qs.SEQ,
                                                   j_data.DataState(11, i)))
        ce.append(float(m["ce"]))
    gate = j_loop.extract_gate(pstate.params)
    state = j_loop.TrainState(pstate.params, gate, j_adamw.init(gate, d_j.optim),
                              jnp.zeros((), jnp.int32))
    step = jax.jit(j_loop.make_train_step(jcfg, d_j))
    for i in range(STEPS):
        state, m = step(state, j_data.make_batch(jcfg, qs.BATCH, qs.SEQ,
                                                 j_data.DataState(0, i)))
        kl.append(float(m["kl"]))
    batch = {"tokens": j_data.make_batch(jcfg, 2, 256, j_data.DataState(9, 0))["tokens"]}
    sp = JaxEngine(jcfg, state.params, max_len=512).generate(batch, 32)["tokens"]
    dn = JaxEngine(jcfg, state.params, max_len=512,
                   options=JOptions(policy=JDense())).generate(batch, 32)["tokens"]
    agree = float(jnp.mean(sp == dn))
    got = qs.quickstart(tcfg, pretrain_steps=STEPS, distill_steps=STEPS, pstate=start,
                        device="cpu", log=lambda s: None)
    return (ce, kl, agree, np.asarray(sp)), got


def test_quickstart_losses_match_jax(quickstart_runs):
    (ce, kl, _, _), got = quickstart_runs
    np.testing.assert_allclose(got["ce"], ce, rtol=RTOL)
    np.testing.assert_allclose(got["kl"], kl, rtol=RTOL)
    assert all(np.isfinite(got["ce"] + got["kl"]))


def test_quickstart_sparse_dense_agreement_matches_jax(quickstart_runs):
    (_, _, agree, sparse), got = quickstart_runs
    assert got["agreement"] == agree
    np.testing.assert_array_equal(got["sparse"].numpy(), sparse)
    assert 0.0 < got["stats"]["sparsity"] < 1.0


def test_quickstart_sampled_decode_reproduces(quickstart_runs):
    _, got = quickstart_runs
    cfg = qs.quickstart_config().replace(dtype="float32")
    batch = {"tokens": make_batch(cfg, 2, 256, DataState(9, 0), device="cpu")["tokens"]}
    eng = DecodeEngine(cfg, got["state"].params, max_len=512, device="cpu",
                       options=DecodeOptions(sampling=SamplingParams(temperature=0.8,
                                                                     top_p=0.95)))
    again = eng.generate(batch, 32, generator=torch.Generator().manual_seed(7))["tokens"]
    assert torch.equal(again, got["sampled"])
    assert got["differs"] > 0.0
    other = eng.generate(batch, 32, generator=torch.Generator().manual_seed(8))["tokens"]
    assert not torch.equal(other, got["sampled"])


# ---------------------------------------------------------------------------
# distill_and_eval
# ---------------------------------------------------------------------------

def _np_quest_rows(qr, kr, bs):
    """The group-shared Quest bound per query row in plain loops of numpy."""
    b, l, h, dh = qr.shape
    hkv = kr.shape[2]
    g, nb = h // hkv, kr.shape[1] // bs
    out = np.zeros((b, hkv, l, nb), np.float64)
    for bi in range(b):
        for hi in range(h):
            kv = hi // g
            for n in range(nb):
                blk = kr[bi, n * bs:(n + 1) * bs, kv].astype(np.float64)
                lo, hi_ = blk.min(0), blk.max(0)
                q = qr[bi, :, hi].astype(np.float64)
                ub = np.maximum(q, 0) @ hi_ + np.minimum(q, 0) @ lo
                out[bi, kv, :, n] = ub if hi % g == 0 else np.maximum(out[bi, kv, :, n], ub)
    return out


def _np_recall(scores, gt, k, rows):
    sc, g = scores[..., rows, :], gt[..., rows, :]
    k = min(k, sc.shape[-1])
    idx = np.argsort(-sc, axis=-1, kind="stable")[..., :k]     # lower index on ties
    return float(np.take_along_axis(g, idx, axis=-1).sum(-1).mean())


@pytest.mark.parametrize("n_heads,n_kv", [(4, 2), (4, 1)])
def test_quest_scores_rows_matches_numpy(n_heads, n_kv):
    r = np.random.default_rng(0)
    qr = r.standard_normal((2, 12, n_heads, 8)).astype(np.float32)
    kr = r.standard_normal((2, 32, n_kv, 8)).astype(np.float32)
    got = de.quest_scores_rows(torch.from_numpy(qr), torch.from_numpy(kr), 8)
    np.testing.assert_allclose(got.numpy(), _np_quest_rows(qr, kr, 8),
                               rtol=1e-5, atol=1e-5)
    stacked = de.quest_scores_rows(torch.from_numpy(np.stack([qr, qr])),
                                   torch.from_numpy(np.stack([kr, kr])), 8)
    assert torch.equal(stacked[1], got)


def test_recall_at_matches_numpy_on_ties():
    r = np.random.default_rng(1)
    # scores from 3 distinct values: most top-k cut through a tie
    scores = r.integers(0, 3, (2, 3, 2, 20, 9)).astype(np.float32)
    gt = r.random((2, 3, 2, 20, 9)).astype(np.float32)
    rows = np.arange(10, 20, 2)
    for k in (1, 3, 5, 9, 12):
        got = de.recall_at(torch.from_numpy(scores), torch.from_numpy(gt), k, rows)
        assert got == pytest.approx(_np_recall(scores, gt, k, rows), rel=1e-6), k


def test_recalls_over_reference_collect_equal_port(tmp_path):
    """``gate_recalls`` over the reference's ``lm_gate_collect`` output
    equals it over the port's, on the reference's weights; the example
    runs end to end and clears its checkpoint directory unless it
    resumes."""
    tcfg, seq, _ = de.build_cfg("small")
    tcfg = tcfg.replace(dtype="float32")
    jcfg = j_reduced(j_configs.get("qwen3_0_6b"), num_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                     q_chunk=256).replace(dtype="float32")
    jcfg = jcfg.replace(gate=dataclasses.replace(jcfg.gate, block_size=16, d_gate=32,
                                                 token_budget=128))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = j_tf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.device_get(params), tcfg, "cpu")
    j_ex = j_tf.lm_gate_collect(params, j_data.make_batch(jcfg, 2, seq,
                                                          j_data.DataState(99, 0)), jcfg)
    t_ex = t_tf.lm_gate_collect(tparams, make_batch(tcfg, 2, seq, DataState(99, 0),
                                                    device="cpu"), tcfg)
    from_ref = de.gate_recalls(tcfg, {k: torch.from_numpy(np.array(j_ex[k], np.float32))
                                      for k in ("glog", "gt", "qr", "kr")}, seq)
    mine = de.gate_recalls(tcfg, t_ex, seq)
    assert list(mine) == [32, 64, 128]
    for budget, row in from_ref.items():
        for key, val in row.items():
            assert mine[budget][key] == pytest.approx(val, rel=1e-5, abs=1e-6), (budget, key)
        assert row["oracle"] >= max(row["gate"], row["quest"])

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "stale").write_text("x")
    res = de.distill_and_eval("small", steps=2, resume=True, ckpt_dir=str(ckpt),
                              device="cpu", log=lambda s: None)
    assert (ckpt / "stale").exists() and len(res["history"]) == 2
    res = de.distill_and_eval("small", steps=2, ckpt_dir=str(ckpt), device="cpu",
                              log=lambda s: None)
    assert not (ckpt / "stale").exists()
    assert 0 < res["n_gate"] < res["n_params"] and np.isfinite(res["history"][-1]["kl"])
    assert set(res["recalls"]) == {32, 64, 128}
