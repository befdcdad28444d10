"""Pretraining of the PyTorch port against the JAX reference, and the audio
encoder (hubert_xlarge).

Everything runs on the CPU in float32 at ``reduced()`` sizes. The weights
are the reference's own (``init_lm`` with a JAX key) carried across by
``convert.params_from_numpy``; the batches come from the port's pipeline
and are handed to both packages as the same arrays. Tolerances:

  * the plain ``chunked_attention``'s output within 2e-5 and its q/k/v
    gradients within 1e-5 of each gradient's largest entry, against
    ``jax.grad`` of the reference's (causal and not, packed segments,
    softcap, a ``q_chunk`` that does not divide L);
  * the pretrain loss and its metrics within 1e-5 relative; every
    gradient leaf (mapped to the reference's stacked tree by
    ``convert.stack_layers``) within 1e-5 of its largest entry, the
    leaves the loss does not read (the gate, the audio ``embed``) zero in
    both packages;
  * remat on against remat off: bitwise;
  * two ``run_training`` pretrain steps against the reference's jitted
    ``make_train_step`` from the same state: losses and ``grad_norm``
    within 1e-5 relative (``adamw.global_norm`` sums the leaves in
    another order: fp32 rounding), every parameter within 1e-5 and the
    moments within 1e-6 + 1e-4 relative, at AdamW eps 1e-4 (see OPT).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.checkpoint import manager as j_ckpt
from repro.config import OptimConfig as JOptim
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.data import pipeline as j_data
from repro.models import common as j_cm
from repro.models.registry import get_api as j_get_api
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch import configs as t_configs
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.convert import params_from_numpy, stack_layers, train_state_from_numpy
from repro_torch.data import pipeline as t_data
from repro_torch.models import common as t_cm
from repro_torch.models import transformer as t_tf
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

B, L = 2, 64
FAMILIES = ["qwen3_0_6b", "deepseek_moe_16b", "llama_3_2_vision_11b", "hubert_xlarge"]


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def ref_paths(tree, prefix=""):
    """{path: leaf} of a nested dict tree (the reference's layout)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(ref_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def cfgs(arch, **kw):
    jcfg = j_reduced(j_configs.get(arch), **kw).replace(dtype="float32")
    tcfg = t_config.reduced(t_configs.get(arch), **kw).replace(dtype="float32")
    return jcfg, tcfg


def pair(arch, seed=0, **kw):
    """(reference cfg, its params, port cfg, the same params in the port)."""
    jcfg, tcfg = cfgs(arch, **kw)
    params = jax.device_get(j_get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, params, tcfg, params_from_numpy(params, tcfg, device="cpu")


def batches(tcfg, step=1):
    """A port batch and the same arrays for the reference."""
    tb = t_data.make_batch(tcfg, B, L, t_data.DataState(0, step), device="cpu")
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def check_grads(port_grads, params, tcfg, ref_grads, rel=1e-5):
    """Every leaf of the port's gradient (a {path: tensor} dict over the
    port's tree) against the reference's gradient tree, within ``rel`` of
    the leaf's largest entry; leaves that are zero in one are zero in the
    other. Returns the paths that are zero."""
    got = ref_paths(stack_layers(t_loop.merge_gate(params, port_grads), tcfg))
    want = ref_paths(ref_grads)
    assert got.keys() == want.keys()
    zero = []
    for path, w in want.items():
        w, g = np.asarray(w, np.float32), np32(got[path])
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        if scale == 0:
            assert not g.any(), path
            zero.append(path)
            continue
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0, err_msg=path)
    return zero


# ---------------------------------------------------------------------------
# the tenth config, the audio batch
# ---------------------------------------------------------------------------

def test_hubert_config_matches_reference():
    j, t = j_configs.get("hubert_xlarge"), t_configs.get("hubert_xlarge")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t_config.reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert t.resolved_head_dim == 80 and not t.causal and not t.is_decoder
    assert not t.gate.enabled and t.activation == "gelu"


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_audio_batch_layout(seed, step):
    """The reference's keys, shapes and dtypes (features in the working
    dtype, int32 labels below the vocabulary); the values are the port's
    own numpy stream, the same for the same (seed, step) and another for
    another step."""
    for dtype in ("bfloat16", "float32"):
        jcfg = j_reduced(j_configs.get("hubert_xlarge")).replace(dtype=dtype)
        tcfg = t_config.reduced(t_configs.get("hubert_xlarge")).replace(dtype=dtype)
        jb = j_data.make_batch(jcfg, 3, 40, j_data.DataState(seed, step))
        tb = t_data.make_batch(tcfg, 3, 40, t_data.DataState(seed, step), device="cpu")
        assert set(tb) == set(jb) == {"features", "labels"}
        for key in jb:
            assert tuple(tb[key].shape) == jb[key].shape, key
            assert str(tb[key].dtype).split(".")[-1] == str(jb[key].dtype), key
        lab = tb["labels"].numpy()
        assert lab.min() >= 0 and lab.max() < tcfg.vocab_size
        f = tb["features"].float()
        assert abs(float(f.mean())) < 0.1 and 0.9 < float(f.std()) < 1.1
        again = t_data.make_batch(tcfg, 3, 40, t_data.DataState(seed, step), device="cpu")
        other = t_data.make_batch(tcfg, 3, 40, t_data.DataState(seed, step + 1), device="cpu")
        assert all(torch.equal(again[k], tb[k]) for k in tb)
        assert not torch.equal(other["features"], tb["features"])


# ---------------------------------------------------------------------------
# the attention's and the loss's gradients
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: causal, segments, softcap, q_chunk (L = 40)
    "causal": (True, False, 0.0, 16),
    "noncausal": (False, False, 0.0, 16),
    "causal-segments": (True, True, 0.0, 16),
    "noncausal-segments": (False, True, 0.0, 12),
    "softcap": (True, True, 30.0, 16),
    "chunk-not-dividing": (True, False, 0.0, 17),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_grads_match_reference(case):
    causal, with_seg, cap, qc = ATTN_CASES[case]
    r = np.random.default_rng(4)
    b, l, h, hkv, d = 2, 40, 4, 2, 16
    q, k, v = (r.standard_normal(s).astype(np.float32) * 2
               for s in ((b, l, h, d), (b, l, hkv, d), (b, l, hkv, d)))
    w = r.standard_normal((b, l, h, d)).astype(np.float32)     # the cotangent
    seg = None
    if with_seg:
        seg = np.zeros((b, l), np.int32)
        for row, cuts in enumerate(((5, 16, 17, 33), (1, 24, 39))):
            for c in cuts:
                seg[row, c:] += 1

    def jloss(q, k, v):
        o, _ = j_cm.chunked_attention(q, k, v, causal=causal, q_chunk=qc,
                                      logit_softcap=cap,
                                      segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(o * w), o

    (_, o_j), g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o_t = t_cm.chunked_attention(tq, tk, tv, causal=causal, q_chunk=qc, logit_softcap=cap,
                                 segment_ids=None if seg is None else torch.tensor(seg))
    g_t = torch.autograd.grad((o_t * torch.tensor(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(np32(o_t), np32(o_j), atol=2e-5, rtol=2e-5)
    for name, gt, gj in zip("qkv", g_t, g_j):
        scale = float(np.abs(np32(gj)).max())
        np.testing.assert_allclose(np32(gt), np32(gj), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
    # without autograd the in-place path gives the same output bitwise
    with torch.no_grad():
        o_n = t_cm.chunked_attention(tq, tk, tv, causal=causal, q_chunk=qc,
                                     logit_softcap=cap,
                                     segment_ids=None if seg is None else torch.tensor(seg))
    assert torch.equal(o_n, o_t.detach())


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_reference(masked):
    r = np.random.default_rng(2)
    logits = (r.standard_normal((2, 9, 31)) * 4).astype(np.float32)
    labels = r.integers(0, 31, (2, 9)).astype(np.int32)
    mask = (r.random((2, 9)) > 0.4).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    lj, gj = jax.value_and_grad(lambda x: j_cm.cross_entropy_loss(x, jnp.asarray(labels),
                                                                  jm))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    lt = t_cm.cross_entropy_loss(x, torch.tensor(labels),
                                 None if mask is None else torch.tensor(mask))
    (gt,) = torch.autograd.grad(lt, x)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    np.testing.assert_allclose(np32(gt), np32(gj), atol=1e-7, rtol=1e-5)
    # an all-zero mask divides by 1, not 0
    zero = t_cm.cross_entropy_loss(x, torch.tensor(labels), torch.zeros(2, 9))
    assert float(zero.detach()) == 0.0


# ---------------------------------------------------------------------------
# lm_forward(mode="pretrain") of the transformer's four families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_pretrain_loss_and_grads_match_reference(arch):
    """Loss, metrics and every gradient leaf; the gate (the decoders) and
    the audio encoder's ``embed`` are not read: zero in both packages."""
    jcfg, params, tcfg, tparams = pair(arch)
    tb, jb = batches(tcfg)
    (loss_j, mj), g_j = jax.value_and_grad(
        lambda p: j_get_api(jcfg).forward(p, jb, jcfg, mode="pretrain"), has_aux=True)(params)
    loss_t, mt, g_t = t_loop.pretrain_value_and_grad(tparams, tb, tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert set(mt) == set(mj) == {"ce", "aux"}
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-5, atol=1e-8)
    zero = check_grads(g_t, tparams, tcfg, g_j)
    gate = [p for p in zero if "/gate/" in p]
    if tcfg.gate.enabled:
        assert gate and set(zero) == set(gate)
    else:
        assert zero == ["embed/w"]
    if arch == "deepseek_moe_16b":
        assert float(mt["aux"]) > 0
    # the port's own loss is differentiable only where autograd records
    assert not loss_t.requires_grad


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_matches_no_remat(arch):
    """``remat`` recomputes each layer in the backward: the same loss and
    the same gradient, bitwise."""
    _, _, tcfg, tparams = pair(arch)
    tb, _ = batches(tcfg, step=2)
    base = t_loop.pretrain_value_and_grad(tparams, tb, tcfg)
    for policy in ("nothing_saveable", "dots_saveable"):
        again = t_loop.pretrain_value_and_grad(tparams, tb, tcfg.replace(remat=policy))
        assert torch.equal(again[0], base[0])
        assert all(torch.equal(again[2][k], g) for k, g in base[2].items())


def test_pretrain_refusals():
    _, _, tcfg, tparams = pair("qwen3_0_6b")
    tb, _ = batches(tcfg)
    with pytest.raises(TypeError, match="Shard"):
        t_tf.lm_forward(tparams, tb, tcfg, mode="pretrain", shard=object())
    with pytest.raises(ValueError, match="unknown mode"):
        t_tf.lm_forward(tparams, tb, tcfg, mode="finetune")
    _, _, acfg, aparams = pair("hubert_xlarge")
    from repro_torch.serve.engine import DecodeEngine
    with pytest.raises(ValueError, match="encoder"):
        DecodeEngine(acfg, aparams, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="no prefill or decode"):
        t_tf.lm_prefill(aparams, {"tokens": torch.zeros(1, 8, dtype=torch.int32)}, acfg, 64)
    with pytest.raises(ValueError, match="no gate"):
        t_loop.init_train_state(torch.Generator().manual_seed(0), acfg,
                                t_config.TrainConfig(mode="distill"))


# ---------------------------------------------------------------------------
# the train loop in pretrain mode
# ---------------------------------------------------------------------------

# eps 1e-4: Adam's step m / (sqrt(v) + eps) turns a gradient entry near 0
# into up to a whole lr; at eps 1e-8 the fp32 rounding of such an entry
# (1e-7 of its leaf's largest, within the gradient tolerance above) moves
# a parameter by ~1e-5, at 1e-4 by ~1e-9
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01, eps=1e-4)


def _train_cfgs(tmp, **kw):
    base = dict(mode="pretrain", seq_len=L, global_batch=B, steps=2, checkpoint_every=1,
                checkpoint_dir=str(tmp), log_every=0)
    base.update(kw)
    return (JTrain(optim=JOptim(**OPT), **base),
            t_config.TrainConfig(optim=t_config.OptimConfig(**OPT), **base))


def _ref_state(jcfg, jt):
    return j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jt)


def test_run_training_pretrain_matches_reference(tmp_path, monkeypatch):
    """Two run_training steps of reduced qwen3 from the reference's initial
    state (handed to the port's loop) against two jitted reference steps
    on the same batches: losses, grad_norm, every parameter and both
    moments. Its last checkpoint restores into the reference: the final
    state bitwise."""
    jcfg, tcfg = cfgs("qwen3_0_6b")
    jt, tt = _train_cfgs(tmp_path)
    jstate = _ref_state(jcfg, jt)
    start = train_state_from_numpy(jax.device_get(jstate), tcfg, device="cpu")
    assert start.gate is None and set(start.opt.m) == set(dict(t_loop._walk(start.params)))
    monkeypatch.setattr(t_loop, "init_train_state", lambda gen, cfg, tc: start)
    tstate, hist = t_loop.run_training(tcfg, tt, device="cpu")
    jstep = jax.jit(j_loop.make_train_step(jcfg, jt))
    for i, h in enumerate(hist):
        jstate, mj = jstep(jstate, j_data.make_batch(jcfg, B, L, j_data.DataState(0, i)))
        for key in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(h[key], float(mj[key]), rtol=1e-5, atol=1e-8,
                                       err_msg=f"step {i} {key}")
    assert len(hist) == 2 and int(tstate.step) == int(jstate.step) == 2
    want = train_state_from_numpy(jax.device_get(jstate), tcfg, device="cpu")
    for p, t in t_loop._walk(tstate.params):
        np.testing.assert_allclose(np32(t), np32(dict(t_loop._walk(want.params))[p]),
                                   atol=1e-5, rtol=0, err_msg=p)
    for got, ref in ((tstate.opt.m, want.opt.m), (tstate.opt.v, want.opt.v)):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(np32(got[k]), np32(ref[k]), atol=1e-6, rtol=1e-4,
                                       err_msg=k)
    # the reference reads the port's checkpoint of the final state
    like = jax.device_get({"params": jstate.params, "gate": None, "opt": jstate.opt})
    tree, meta = j_ckpt.restore(str(tmp_path), 2, like)
    assert meta == {"data_step": 2, "seed": tt.seed}
    back = train_state_from_numpy(jstate._replace(params=tree["params"], opt=tree["opt"]),
                                  tcfg, device="cpu")
    for p, t in t_loop._walk(tstate.params):
        assert torch.equal(dict(t_loop._walk(back.params))[p], t), p
    assert all(torch.equal(back.opt.m[k], t) for k, t in tstate.opt.m.items())
    assert all(torch.equal(back.opt.v[k], t) for k, t in tstate.opt.v.items())


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "hubert_xlarge"])
def test_pretrain_fault_recovery(tmp_path, arch):
    """A failure before step 3 restores the step-2 checkpoint and replays
    step 2 with the same loss; every leaf moved from the seed, the unused
    ones by weight decay alone."""
    _, tcfg = cfgs(arch)
    _, tt = _train_cfgs(tmp_path, steps=4, checkpoint_every=2)
    boom, logs = {"armed": True}, []

    def fail_at(i):
        if i == 3 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    seed = t_loop.init_train_state(torch.Generator().manual_seed(tt.seed), tcfg, tt)
    state, hist = t_loop.run_training(tcfg, tt, fail_at=fail_at, log=logs.append,
                                      device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3] and int(state.step) == 4
    assert any("[recover] step 3" in m and "restoring step 2" in m for m in logs)
    assert all(np.isfinite(h["loss"]) for h in hist)
    first, replay = (h["loss"] for h in hist if h["step"] == 2)
    assert first == replay
    before = dict(t_loop._walk(seed.params))
    assert all(not torch.equal(t, before[p]) for p, t in t_loop._walk(state.params))
    assert t_ckpt.latest_step(str(tmp_path)) == 4


def test_launcher_pretrains_the_audio_encoder(tmp_path):
    from repro_torch.launch import train as t_launch
    argv = ["--arch", "hubert_xlarge", "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt-every", "1", "--ckpt-dir",
            str(tmp_path)]
    hist = t_launch.main(argv + ["--mode", "pretrain"])
    assert [h["step"] for h in hist] == [0, 1] and all(np.isfinite(h["ce"]) for h in hist)
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    for arch in ("hubert_xlarge", "falcon_mamba_7b"):
        with pytest.raises(SystemExit, match="no gate to distill"):
            t_launch.main(["--arch", arch, "--reduced", "--device", "cpu"])
