"""Gate-distillation training of the PyTorch port against the JAX reference.

Everything runs on the CPU at tiny sizes in float32 (the plain PyTorch
path; the CUDA kernel of TPU kernel 6 is held against that plain version
on the card in tests/test_torch_cuda.py). Inputs are numpy-seeded, or the
reference's own initial train state carried across by
``convert.train_state_from_numpy``; every comparison is against the live
JAX package:

  * kernel 6's plain version against the Pallas kernel in interpret mode
    (no segments) and against the reference's naive and chunked paths with
    packed segments: o within 2e-5, blockmax NEG_INF in exactly the same
    places and within 2e-5 elsewhere;
  * ``core/distill.py``, ``gate_logits`` and ``block_causal_mask``;
  * ``make_batch`` bitwise; AdamW, its schedule and clip within 1e-6;
  * the slice on ``reduced(qwen3_0_6b)``: the distill KL, the gate
    gradients, ``lm_gate_collect`` and three train steps;
  * the reference's training contracts (tests/test_train.py) on the port:
    held-out KL drops with the base frozen bitwise, ``fail_at`` recovery,
    checkpoint round trip and atomic publish.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as J_C
from repro.config import OptimConfig as JOptim
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.core import attngate as j_ag
from repro.core import distill as j_dist
from repro.data import pipeline as j_data
from repro.kernels import ops as j_ops
from repro.models import common as j_cm
from repro.models import transformer as j_tf
from repro.models.registry import get_api as j_get_api
from repro.optim import adamw as j_adamw
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.configs import get as t_get
from repro_torch.convert import train_state_from_numpy
from repro_torch.core import attngate as t_ag
from repro_torch.core import distill as t_dist
from repro_torch.data import pipeline as t_data
from repro_torch.kernels import gate_gt_fwd as t_gt
from repro_torch.kernels import ops as t_ops
from repro_torch.models import transformer as t_tf
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

NEG = np.float32(-1e30)
TOL = dict(atol=2e-5, rtol=2e-5)


def randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def check_blockmax(bm_t, bm_j, **tol):
    """NEG_INF in exactly the same places (and exactly -1e30 there), the
    other entries within the tolerance."""
    t, j = np32(bm_t), np32(bm_j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t <= -1e29, j <= -1e29)
    assert np.all(t[t <= -1e29] == NEG) and np.all(j[j <= -1e29] == NEG)
    live = t > -1e29
    np.testing.assert_allclose(t[live], j[live], **(tol or TOL))


# ---------------------------------------------------------------------------
# config copies
# ---------------------------------------------------------------------------

def test_train_configs_match_reference():
    assert dataclasses.asdict(t_config.OptimConfig()) == dataclasses.asdict(JOptim())
    assert dataclasses.asdict(t_config.TrainConfig()) == dataclasses.asdict(JTrain())
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=8, grad_compression="topk_ef")
    assert dataclasses.asdict(t_config.OptimConfig(**kw)) == dataclasses.asdict(JOptim(**kw))


# ---------------------------------------------------------------------------
# kernel 6: plain version vs the Pallas kernel (interpret) and the jnp paths
# ---------------------------------------------------------------------------

# the shapes of tests/test_kernels.py's GT_SWEEP: b, lq, h, hkv, dh, bs, q_chunk
GT_SHAPES = [(1, 64, 2, 1, 32, 16, 16), (2, 128, 4, 2, 64, 32, 32),
             (2, 128, 8, 2, 64, 64, 64), (1, 256, 4, 4, 128, 64, 128),
             # head dim 256 (gemma_2b's MQA group of 8) and 128-key blocks
             (1, 192, 8, 1, 256, 64, 64), (1, 256, 2, 1, 256, 128, 128),
             (2, 256, 4, 2, 64, 128, 128), (1, 384, 6, 2, 128, 128, 128)]


def _qkv(seed, b, lq, h, hkv, dh):
    r = np.random.default_rng(seed)
    return randn(r, b, lq, h, dh), randn(r, b, lq, hkv, dh), randn(r, b, lq, hkv, dh)


@pytest.mark.parametrize("b,lq,h,hkv,dh,bs,qc", GT_SHAPES)
def test_gate_gt_plain_matches_pallas_interpret(b, lq, h, hkv, dh, bs, qc):
    q, k, v = _qkv(7, b, lq, h, hkv, dh)
    o_j, bm_j = j_ops.gate_gt_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        block_size=bs, q_chunk=qc, impl="pallas_interpret")
    # the plain version at the kernel's chunk and at one that does not
    # divide L (a partial last chunk, the causal shortcut ending mid-block)
    for chunk in (qc, qc + bs // 2 + 1):
        o_t, bm_t = t_ops.gate_gt_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                            block_size=bs, q_chunk=chunk)
        np.testing.assert_allclose(np32(o_t), np32(o_j), **TOL)
        check_blockmax(bm_t, bm_j)


def _segments(b, l, cuts):
    """[B, L] int32 document ids from the cut positions of each row."""
    seg = np.zeros((b, l), np.int32)
    for row, cs in enumerate(cuts):
        for c in cs:
            seg[row, c:] += 1
    return seg


# documents cut mid-block and at block edges (bs 16), one-token documents
SEG_CUTS = [(5, 16, 17, 32, 45, 46), (1, 2, 3, 31, 48, 63)]


@pytest.mark.parametrize("qc", [16, 24, 64])
def test_gate_gt_plain_with_segments_matches_reference(qc):
    b, l, h, hkv, dh, bs = 2, 64, 4, 2, 32, 16
    q, k, v = _qkv(3, b, l, h, hkv, dh)
    seg = _segments(b, l, SEG_CUTS)
    jq, jk, jv, js = (jnp.asarray(a) for a in (q, k, v, seg))
    o_r, bm_r = j_ops.gate_gt_attention(jq, jk, jv, block_size=bs, impl="ref", segment_ids=js)
    # the reference's training path: chunked_attention with the packing mask
    # (ops' impl="chunked" refuses segments, the model calls it directly)
    o_c, bm_c = j_cm.chunked_attention(jq, jk, jv, causal=True, q_chunk=qc,
                                       gt_block_size=bs, segment_ids=js)
    o_t, bm_t = t_ops.gate_gt_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                        block_size=bs, q_chunk=qc,
                                        segment_ids=torch.tensor(seg))
    for o_j, bm_j in ((o_r, bm_r), (o_c, bm_c)):
        np.testing.assert_allclose(np32(o_t), np32(o_j), **TOL)
        check_blockmax(bm_t, bm_j)
    # a block holding only other documents' keys is fully masked: exactly
    # NEG_INF even where it is causally visible
    assert np32(bm_t)[0, :, 17, 0].max() == NEG


@pytest.mark.parametrize("b,l,h,hkv,dh,bs,qc", [
    (2, 256, 8, 1, 256, 64, 64), (2, 256, 2, 1, 256, 128, 128),
    (2, 384, 4, 2, 64, 128, 96), (1, 512, 6, 2, 128, 128, 128)])
def test_gate_gt_plain_with_segments_at_new_shapes(b, l, h, hkv, dh, bs, qc):
    """Head dim 256 and 128-key blocks with packed documents (the Pallas
    kernel takes no segments): against the reference's oracle and its
    training path, documents cut mid-block, at a 64-key tile edge inside a
    128-key block and at a block edge, one-token documents."""
    q, k, v = _qkv(5, b, l, h, hkv, dh)
    cuts = [(3, bs // 2, bs // 2 + 1, bs, l // 2 + 7, l - 1), (64, 65, 2 * bs - 1)]
    seg = _segments(b, l, cuts[:b])
    jq, jk, jv, js = (jnp.asarray(a) for a in (q, k, v, seg))
    o_r, bm_r = j_ops.gate_gt_attention(jq, jk, jv, block_size=bs, impl="ref", segment_ids=js)
    o_c, bm_c = j_cm.chunked_attention(jq, jk, jv, causal=True, q_chunk=qc,
                                       gt_block_size=bs, segment_ids=js)
    o_t, bm_t = t_ops.gate_gt_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                        block_size=bs, q_chunk=qc,
                                        segment_ids=torch.tensor(seg))
    for o_j, bm_j in ((o_r, bm_r), (o_c, bm_c)):
        np.testing.assert_allclose(np32(o_t), np32(o_j), **TOL)
        check_blockmax(bm_t, bm_j)


def test_gate_gt_attention_refusals():
    q, k, v = (torch.tensor(a) for a in _qkv(0, 1, 24, 2, 1, 16))
    with pytest.raises(ValueError, match="multiple of the block size"):
        t_ops.gate_gt_attention(q, k, v, block_size=16)
    with pytest.raises(NotImplementedError, match="no backward"):
        t_ops.gate_gt_attention(q.requires_grad_(), k, v, block_size=8)
    assert "gate_gt_attention" in t_ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        t_gt.gate_gt_attention_cuda(q.detach(), k, v, block_size=8)


# ---------------------------------------------------------------------------
# distill losses, gate logits, block mask
# ---------------------------------------------------------------------------

def test_distill_functions_match_reference():
    r = np.random.default_rng(5)
    b, h, g, l, nb, bs, dg = 2, 4, 2, 24, 6, 4, 16
    bm = randn(r, b, h, l, nb) * 3
    bm[:, :, :, 4:] = NEG                       # fully masked blocks
    bm[0, 1, 3, :] = NEG                        # one row with nothing visible
    gt_t = t_dist.ground_truth_from_blockmax(torch.tensor(bm), g)
    gt_j = j_dist.ground_truth_from_blockmax(jnp.asarray(bm), g)
    np.testing.assert_allclose(np32(gt_t), np32(gt_j), atol=1e-6, rtol=1e-6)
    assert np.array_equal(np32(gt_t) == 0, np32(gt_j) == 0)

    glog = randn(r, b, h // g, l, nb)
    glog[..., 5] = NEG
    valid = (r.random((b, l)) > 0.3).astype(np.float32)
    for vr in (None, valid):
        kl_t = t_dist.gate_kl_loss(torch.tensor(glog), gt_t,
                                   None if vr is None else torch.tensor(vr))
        kl_j = j_dist.gate_kl_loss(jnp.asarray(glog), gt_j,
                                   None if vr is None else jnp.asarray(vr))
        np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-6)

    qpos = np.arange(l, dtype=np.int32)
    m_t = t_dist.mask_blockmax_causal(torch.tensor(bm), torch.tensor(qpos), bs)
    m_j = j_dist.mask_blockmax_causal(jnp.asarray(bm), jnp.asarray(qpos), bs)
    np.testing.assert_array_equal(np32(m_t), np32(m_j))
    np.testing.assert_array_equal(
        t_ag.block_causal_mask(torch.tensor(qpos), nb, bs).numpy(),
        np.asarray(j_ag.block_causal_mask(jnp.asarray(qpos), nb, bs)))

    qg, kg = randn(r, b, l, 2, dg), randn(r, b, nb, 2, dg)
    np.testing.assert_allclose(
        np32(t_ag.gate_logits(torch.tensor(qg), torch.tensor(kg))),
        np32(j_ag.gate_logits(jnp.asarray(qg), jnp.asarray(kg))), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# data pipeline, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,mean_doc_len", [(0, 0, 2048), (0, 7, 32), (3, 2, 100)])
def test_make_batch_bitwise(seed, step, mean_doc_len):
    jcfg, tcfg = j_reduced(J_C.get("qwen3_0_6b")), t_config.reduced(t_get("qwen3_0_6b"))
    jb = j_data.make_batch(jcfg, 3, 96, j_data.DataState(seed, step), mean_doc_len=mean_doc_len)
    tb = t_data.make_batch(tcfg, 3, 96, t_data.DataState(seed, step), device="cpu",
                           mean_doc_len=mean_doc_len)
    assert set(tb) == set(jb)
    for key in jb:
        a, t = np.asarray(jb[key]), tb[key].numpy()
        assert a.dtype == t.dtype and a.shape == t.shape, key
        np.testing.assert_array_equal(t, a, err_msg=key)
    if mean_doc_len == 2048:         # the default: the iterator resumes at step
        it = t_data.data_iterator(tcfg, 3, 96, t_data.DataState(seed, step), device="cpu")
        nb, after = next(it)
        assert after == t_data.DataState(seed, step + 1)
        assert all(torch.equal(nb[k], tb[k]) for k in tb)


def _grad_tree(seed):
    r = np.random.default_rng(seed)
    return {"w": randn(r, 6, 5), "b": randn(r, 7) * 1e-3, "c": randn(r, 3, 2, 4) * 10}


@pytest.mark.parametrize("compression", ["none", "bf16", "topk_ef"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_apply_matches_reference(compression, clip):
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=8, weight_decay=0.01, grad_clip=clip,
              grad_compression=compression, topk_ratio=0.25)
    jc, tc = JOptim(**kw), t_config.OptimConfig(**kw)
    p, g1, g2 = _grad_tree(0), _grad_tree(1), _grad_tree(2)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.tensor(a) for k, a in p.items()}
    js, ts = j_adamw.init(jp, jc), t_adamw.init(tp, tc)
    for g in (g1, g2):                           # two updates: bias terms, ef carry
        jp, js, jm = j_adamw.apply(jp, {k: jnp.asarray(a) for k, a in g.items()}, js, jc)
        tp, ts, tm = t_adamw.apply(tp, {k: torch.tensor(a) for k, a in g.items()}, ts, tc)
        for k in p:
            np.testing.assert_allclose(np32(tp[k]), np32(jp[k]), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(np32(ts.m[k]), np32(js.m[k]), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(np32(ts.v[k]), np32(js.v[k]), atol=1e-6, rtol=1e-6)
            if compression == "topk_ef":
                np.testing.assert_allclose(np32(ts.ef[k]), np32(js.ef[k]), atol=1e-6)
        assert int(ts.count) == int(js.count)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)


def test_cosine_lr_and_clip_match_reference():
    c = dict(lr=1.0, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(
            float(t_adamw.cosine_lr(t_config.OptimConfig(**c), torch.tensor(s))),
            float(j_adamw.cosine_lr(JOptim(**c), jnp.asarray(s))), rtol=1e-6, atol=1e-7)
    g = _grad_tree(3)
    for max_norm in (0.5, 1e6):
        ct, nt = t_adamw.clip_by_global_norm({k: torch.tensor(a) for k, a in g.items()},
                                             max_norm)
        cj, nj = j_adamw.clip_by_global_norm({k: jnp.asarray(a) for k, a in g.items()},
                                             max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(np32(ct[k]), np32(cj[k]), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the slice: reduced qwen3 in float32 from the reference's train state
# ---------------------------------------------------------------------------

SLICE_B, SLICE_L = 2, 64


def _slice_cfgs():
    jcfg = j_reduced(J_C.get("qwen3_0_6b")).replace(dtype="float32")
    return jcfg, t_config.reduced(t_get("qwen3_0_6b")).replace(dtype="float32")


def _tcfgs(tmp, **kw):
    base = dict(mode="distill", seq_len=SLICE_L, global_batch=SLICE_B, steps=8,
                checkpoint_every=0, checkpoint_dir=str(tmp), log_every=0)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=8, weight_decay=0.0)
    base.update(kw)
    return (JTrain(optim=JOptim(**opt), **base),
            t_config.TrainConfig(optim=t_config.OptimConfig(**opt), **base))


@pytest.fixture(scope="module")
def slice_setup():
    jcfg, tcfg = _slice_cfgs()
    jt, tt = _tcfgs("unused")
    jstate = j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    tstate = train_state_from_numpy(jax.device_get(jstate), tcfg, device="cpu")
    batches = [(j_data.make_batch(jcfg, SLICE_B, SLICE_L, j_data.DataState(0, i)),
                t_data.make_batch(tcfg, SLICE_B, SLICE_L, t_data.DataState(0, i),
                                  device="cpu")) for i in range(3)]
    return jcfg, tcfg, jt, tt, jstate, tstate, batches


def _per_layer(jtree, n_layers):
    """The reference's {"blocks/<rest>": [L, ...]} as the port's keys."""
    return {f"blocks/{i}/{k.split('/', 1)[1]}": np.asarray(a)[i]
            for k, a in jtree.items() for i in range(n_layers)}


def test_train_state_from_numpy_carries_the_reference_state(slice_setup):
    jcfg, tcfg, _, _, jstate, tstate, _ = slice_setup
    want = _per_layer(jstate.gate, jcfg.num_layers)
    assert set(tstate.gate) == set(want) == set(t_loop.extract_gate(tstate.params))
    for k, a in want.items():
        np.testing.assert_array_equal(tstate.gate[k].numpy(), a)
        assert t_loop.extract_gate(tstate.params)[k] is tstate.gate[k]
    np.testing.assert_array_equal(tstate.params["blocks"][1]["attn"]["wq"]["w"].numpy(),
                                  np.asarray(jstate.params["blocks"]["attn"]["wq"]["w"])[1])
    assert set(tstate.opt.m) == set(want) and int(tstate.opt.count) == 0
    assert all(not t.requires_grad for t in t_loop.extract_gate(tstate.params).values())


def test_lm_forward_distill_matches_reference(slice_setup):
    jcfg, tcfg, _, _, jstate, tstate, batches = slice_setup
    for jb, tb in batches[:2]:
        kl_j, mj = j_get_api(jcfg).forward(jstate.params, jb, jcfg, mode="distill")
        kl_t, mt = t_tf.lm_forward(tstate.params, tb, tcfg, mode="distill")
        np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-5)
        np.testing.assert_allclose(float(mt["kl"]), float(mj["kl"]), rtol=1e-5)
        assert float(kl_t) > 0
    # pretrain mode on the same state: CE of the tied logits, router loss 0
    jb, tb = batches[0]
    loss_j, mj = j_get_api(jcfg).forward(jstate.params, jb, jcfg, mode="pretrain")
    loss_t, mt = t_tf.lm_forward(tstate.params, tb, tcfg, mode="pretrain")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"]), float(mj["ce"]), rtol=1e-5)
    assert float(mt["aux"]) == float(mj["aux"]) == 0.0


def test_gate_gradients_match_reference(slice_setup):
    jcfg, tcfg, _, _, jstate, tstate, batches = slice_setup
    jb, tb = batches[0]
    api = j_get_api(jcfg)

    def loss_fn(gate, params):
        return api.forward(j_loop.merge_gate(params, gate), jb, jcfg, mode="distill")[0]
    jg = _per_layer(jax.device_get(jax.grad(loss_fn)(jstate.gate, jstate.params)),
                    jcfg.num_layers)
    leaves = {k: v.detach().requires_grad_(True) for k, v in tstate.gate.items()}
    loss, _ = t_tf.lm_forward(t_loop.merge_gate(tstate.params, leaves), tb, tcfg,
                              mode="distill")
    tg = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, want in jg.items():
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(np32(tg[k]), want, atol=1e-5 * scale, rtol=0, err_msg=k)
    # no gradient reaches the base model
    assert all(not t.requires_grad for p, t in t_loop._walk(tstate.params)
               if not t_loop.is_gate_path(p))


def test_lm_gate_collect_matches_reference(slice_setup):
    jcfg, tcfg, _, _, jstate, tstate, batches = slice_setup
    jb, tb = batches[1]
    ej = j_tf.lm_gate_collect(jstate.params, jb, jcfg)
    et = t_tf.lm_gate_collect(tstate.params, tb, tcfg)
    assert set(et) == set(ej) == {"glog", "gt", "qr", "kr"}
    check_blockmax(et["glog"], ej["glog"], atol=1e-5, rtol=1e-5)
    for key in ("gt", "qr", "kr"):
        np.testing.assert_allclose(np32(et[key]), np32(ej[key]), atol=1e-5, rtol=1e-5,
                                   err_msg=key)


def test_train_steps_match_reference(slice_setup):
    """Three jitted reference steps against three port steps on the same
    batches. The first update is about sign(g) * lr per entry (Adam's
    bias-corrected m/sqrt(v)), so an entry whose gradient is ~0 with
    opposite rounding in the two packages would move by up to 2 * lr =
    6e-3: the gradients themselves are held to 1e-5 of each leaf's max
    above; here the gate parameters must stay within 1e-5, which no such
    flip would pass and which leaves room for the fp32 rounding of
    lr-sized updates, and the KL history within 1e-5 relative."""
    jcfg, tcfg, jt, tt, jstate, tstate, batches = slice_setup
    jstep = jax.jit(j_loop.make_train_step(jcfg, jt))
    tstep = t_loop.make_train_step(tcfg, tt)
    for jb, tb in batches:
        jstate, mj = jstep(jstate, jb)
        tstate, mt = tstep(tstate, tb)
        for key in ("loss", "kl", "lr", "grad_norm"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]), rtol=1e-5,
                                       err_msg=key)
    assert int(tstate.step) == int(jstate.step) == 3
    want = _per_layer(jax.device_get(jstate.gate), jcfg.num_layers)
    for k, a in want.items():
        np.testing.assert_allclose(np32(tstate.gate[k]), a, atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_array_equal(np32(t_loop.extract_gate(tstate.params)[k]),
                                      np32(tstate.gate[k]))
    for k, a in _per_layer(jax.device_get(jstate.opt.m), jcfg.num_layers).items():
        np.testing.assert_allclose(np32(tstate.opt.m[k]), a, atol=1e-6, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the reference's training contracts (tests/test_train.py) on the port
# ---------------------------------------------------------------------------

def _port_tcfg(tmp, **kw):
    base = dict(mode="distill", seq_len=64, global_batch=2, steps=8,
                optim=t_config.OptimConfig(lr=3e-3, warmup_steps=2, total_steps=8,
                                           weight_decay=0.0),
                checkpoint_every=4, checkpoint_dir=str(tmp), log_every=0)
    base.update(kw)
    return t_config.TrainConfig(**base)


def test_port_distill_reduces_kl_and_freezes_base(tmp_path):
    cfg = t_config.reduced(t_get("qwen3_0_6b"))
    tc = _port_tcfg(tmp_path, steps=12, checkpoint_every=0)
    state = t_loop.init_train_state(torch.Generator().manual_seed(0), cfg, tc)
    base_before = {p: t.clone() for p, t in t_loop._walk(state.params)
                   if not t_loop.is_gate_path(p)}
    g0 = {k: v.clone() for k, v in state.gate.items()}
    step = t_loop.make_train_step(cfg, tc)
    eval_batch = t_data.make_batch(cfg, 2, 64, t_data.DataState(99, 0), mean_doc_len=32,
                                   device="cpu")
    kl_before = float(t_tf.lm_forward(state.params, eval_batch, cfg, mode="distill")[0])
    for i in range(12):
        batch = t_data.make_batch(cfg, 2, 64, t_data.DataState(0, i), mean_doc_len=32,
                                  device="cpu")
        state, _ = step(state, batch)
    kl_after = float(t_tf.lm_forward(state.params, eval_batch, cfg, mode="distill")[0])
    assert kl_after < kl_before, f"held-out KL: {kl_before} -> {kl_after}"
    for p, t in t_loop._walk(state.params):
        if not t_loop.is_gate_path(p):
            assert torch.equal(t, base_before[p]), p
            assert not t.requires_grad, p
    assert any(not torch.allclose(g0[k], v) for k, v in state.gate.items())


def test_port_fault_injection_recovery(tmp_path):
    cfg = t_config.reduced(t_get("qwen3_0_6b"))
    tc = _port_tcfg(tmp_path, steps=9, checkpoint_every=3)
    boom = {"armed": True}
    logs = []

    def fail_at(i):
        if i == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    state, hist = t_loop.run_training(cfg, tc, steps=9, batch_size=2, seq_len=64,
                                      fail_at=fail_at, log=logs.append, device="cpu")
    assert int(state.step) == 9
    assert any("[recover] step 5" in m and "restoring step 3" in m for m in logs)
    by_step = {}
    for h in hist:
        by_step.setdefault(h["step"], []).append(h["loss"])
    assert [s for s, v in by_step.items() if len(v) > 1] == [3, 4]
    for s, losses in by_step.items():
        np.testing.assert_allclose(losses[0], losses[-1], rtol=1e-6)
    assert t_ckpt.latest_step(str(tmp_path)) == 9


@pytest.mark.parametrize("ckpt_dir", ["given", "default"])
def test_port_launcher_trains_on_cpu(tmp_path, monkeypatch, ckpt_dir):
    """The launcher's CPU run: two steps, a checkpoint after each. Without
    --ckpt-dir they land in a new directory under the temporary directory,
    never in one that another run shares."""
    import tempfile
    from repro_torch.launch import train as t_launch
    argv = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "64", "--device", "cpu",
            "--ckpt-every", "1"]
    if ckpt_dir == "given":
        argv += ["--ckpt-dir", str(tmp_path)]
        where = tmp_path
    else:
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    hist = t_launch.main(argv)
    if ckpt_dir == "default":
        made = [d for d in os.listdir(tmp_path) if d.startswith("repro_torch_ckpt_")]
        assert len(made) == 1
        where = tmp_path / made[0]
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["kl"]) for h in hist)
    assert t_ckpt.latest_step(str(where)) == 2
    # --mode pretrain trains every leaf: a CE history and its own checkpoints
    pre = tmp_path / "pretrain"
    hist = t_launch.main(argv + ["--mode", "pretrain", "--ckpt-dir", str(pre)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["ce"]) and "kl" not in h for h in hist)
    assert t_ckpt.latest_step(str(pre)) == 2


def test_port_checkpoint_roundtrip_bitwise(tmp_path):
    r = np.random.default_rng(0)
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.tensor(randn(r, 2, 3)).to(torch.bfloat16),
                  "d": [torch.tensor([1, -2], dtype=torch.int32), None]},
            "opt": t_adamw.AdamWState({"x": torch.tensor(randn(r, 4))},
                                      {"x": torch.tensor(randn(r, 4))},
                                      torch.tensor(3, dtype=torch.int32))}
    t_ckpt.save(str(tmp_path), 7, tree, meta={"data_step": 7})
    assert t_ckpt.latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(5), "b": {"c": torch.zeros(2, 3, dtype=torch.bfloat16),
                                       "d": [torch.zeros(2, dtype=torch.int32), None]},
            "opt": t_adamw.AdamWState({"x": torch.zeros(4)}, {"x": torch.zeros(4)},
                                      torch.tensor(0, dtype=torch.int32))}
    out, meta = t_ckpt.restore(str(tmp_path), 7, like)
    assert meta == {"data_step": 7}
    assert out["b"]["c"].dtype == torch.bfloat16 and out["b"]["d"][1] is None
    assert isinstance(out["opt"], t_adamw.AdamWState)
    for got, want in zip(t_ckpt._flatten(out), t_ckpt._flatten(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # the reference's layout: bf16 as uint16, one .npy per leaf
    path = tmp_path / "step_7"
    assert sorted(os.listdir(path)) == ["0.npy", "1.npy", "2.npy", "3.npy", "4.npy",
                                        "5.npy", "manifest.json"]
    stored = np.load(path / "1.npy")
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(stored, tree["b"]["c"].view(torch.int16).numpy()
                                  .view(np.uint16))
    # atomic publish: no temporary directory lingers, and a rewrite replaces
    t_ckpt.save(str(tmp_path), 7, tree)
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    saver = t_ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(8, tree, meta={"data_step": 8})
    saver.wait()
    assert t_ckpt.latest_step(str(tmp_path)) == 8
    with pytest.raises(ValueError, match="leaves"):
        t_ckpt.restore(str(tmp_path), 8, {"a": torch.zeros(5)})
