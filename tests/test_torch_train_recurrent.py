"""Training of the recurrent families (falcon_mamba_7b's Mamba1 LM,
zamba2_1_2b's Mamba2 hybrid) against the JAX reference, and checkpoint
interchange for every family's train state.

CPU, float32 at ``reduced()`` sizes (the hybrid at 5 layers: two units of
two Mamba2 layers and a tail layer), the reference's own weights carried
across by ``convert.params_from_numpy``. Tolerances: losses within 1e-5
relative, gradients within 1e-5 of each leaf's (or tensor's) largest
entry, remat bitwise; checkpoints bitwise in both directions.

The reference's hybrid gradient is NaN wherever the SSD chunk's masked
decay overflows (``jnp.where(tri, jnp.exp(decay), 0)``: 0 * inf in the
backward), which the reduced config's seed state reaches. The port masks
before the exp (the same forward values, a finite gradient). So the
hybrid's gradients are held to the reference's where the reference's are
finite, everywhere at a state whose decays do not overflow (``dt_bias``
lowered by 4, the same state in both packages), and at the seed state to
a token-by-token run of the port's own ``mamba2_step``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.checkpoint import manager as j_ckpt
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.models import mamba as j_mamba
from repro.models.registry import get_api as j_get_api
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch import configs as t_configs
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.convert import _tree, params_from_numpy, stack_layers, train_state_from_numpy
from repro_torch.data import pipeline as t_data
from repro_torch.models import hybrid as t_hybrid
from repro_torch.models import mamba as t_mamba
from repro_torch.models import transformer as t_tf
from repro_torch.models.common import rms_norm
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

B, L = 2, 48


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def ref_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(ref_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def cfgs(arch, dtype="float32"):
    kw = {"num_layers": 5} if arch == "zamba2_1_2b" else {}
    jcfg = j_reduced(j_configs.get(arch), **kw).replace(dtype=dtype)
    tcfg = t_config.reduced(t_configs.get(arch), **kw).replace(dtype=dtype)
    return jcfg, tcfg


def pair(arch, dt_shift=0.0):
    """(reference cfg, params, port cfg, port params); ``dt_shift`` is added
    to every Mamba layer's dt_bias (in both, before the crossing)."""
    jcfg, tcfg = cfgs(arch)
    params = jax.device_get(j_get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg))
    if dt_shift:
        params = jax.tree_util.tree_map_with_path(
            lambda kp, a: a + dt_shift if str(kp[-1].key) == "dt_bias" else a, params)
    return jcfg, params, tcfg, params_from_numpy(params, tcfg, device="cpu")


def batches(tcfg, step=1):
    tb = t_data.make_batch(tcfg, B, L, t_data.DataState(0, step), mean_doc_len=16,
                           device="cpu")
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def close(got, want, rel=1e-5, msg=""):
    want = np32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np32(got), want, atol=rel * scale, rtol=0, err_msg=msg)


def port_grad_tree(grads, params, tcfg):
    return ref_paths(stack_layers(t_loop.merge_gate(params, grads), tcfg))


# ---------------------------------------------------------------------------
# the Mamba blocks' gradients
# ---------------------------------------------------------------------------

def test_scan_chunk_grad_matches_sequential_loop():
    """The out-of-place doubling rounds (autograd) give the in-place path's
    values bitwise, and the gradient of a sequential recurrence."""
    r = np.random.default_rng(0)
    a0 = r.uniform(0.5, 1.0, (2, 13, 3, 4)).astype(np.float32)
    b0 = r.standard_normal((2, 13, 3, 4)).astype(np.float32)
    wa, wb = (r.standard_normal((2, 13, 3, 4)).astype(np.float32) for _ in range(2))
    a, b = torch.tensor(a0, requires_grad=True), torch.tensor(b0, requires_grad=True)
    pa, ph = t_mamba._scan_chunk(a, b)
    with torch.no_grad():
        na, nh = t_mamba._scan_chunk(torch.tensor(a0), torch.tensor(b0))
    assert torch.equal(pa.detach(), na) and torch.equal(ph.detach(), nh)
    loss = (pa * torch.tensor(wa)).sum() + (ph * torch.tensor(wb)).sum()
    ga, gb = torch.autograd.grad(loss, (a, b))
    a2, b2 = torch.tensor(a0, requires_grad=True), torch.tensor(b0, requires_grad=True)
    prod, h, outs_a, outs_h = torch.ones_like(a2[:, 0]), torch.zeros_like(b2[:, 0]), [], []
    for t in range(a2.shape[1]):
        prod, h = prod * a2[:, t], a2[:, t] * h + b2[:, t]
        outs_a.append(prod)
        outs_h.append(h)
    seq = ((torch.stack(outs_a, 1) * torch.tensor(wa)).sum()
           + (torch.stack(outs_h, 1) * torch.tensor(wb)).sum())
    sa, sb = torch.autograd.grad(seq, (a2, b2))
    close(ga, sa, 1e-5, "a")
    close(gb, sb, 1e-5, "b")


def _block(version, dt_shift=0.0):
    jcfg, tcfg = cfgs("falcon_mamba_7b" if version == 1 else "zamba2_1_2b")
    init = j_mamba.init_mamba1 if version == 1 else j_mamba.init_mamba2
    p = jax.device_get(init(jax.random.PRNGKey(3), jcfg))
    p = {k: (v + dt_shift if k == "dt_bias" else v) for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal((B, 40, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x, w


def _block_grads(version, jcfg, tcfg, p, x, w):
    jfull = j_mamba.mamba1_full if version == 1 else j_mamba.mamba2_full
    tfull = t_mamba.mamba1_full if version == 1 else t_mamba.mamba2_full
    gj = jax.grad(lambda p, x: jnp.sum(jfull(p, x, jcfg)[0] * w), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tree = _tree(p, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in t_loop._walk(tree)}
    tx = torch.tensor(x, requires_grad=True)
    y = tfull(t_loop.merge_gate(tree, leaves), tx, tcfg)[0]
    gt = torch.autograd.grad((y * torch.tensor(w)).sum(), [*leaves.values(), tx])
    return (ref_paths(gj[0]), gj[1]), dict(zip([*leaves, "x"], gt))


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_full_grads_match_reference(version):
    """``jax.grad`` of the reference's mamba1_full / mamba2_full against
    autograd of the port's, every parameter and the input. Mamba2 at
    dt_bias - 4, where the reference's SSD gradient is finite."""
    jcfg, tcfg, p, x, w = _block(version, dt_shift=0.0 if version == 1 else -4.0)
    (gp, gx), gt = _block_grads(version, jcfg, tcfg, p, x, w)
    assert set(gp) == set(gt) - {"x"}
    for k in gp:
        assert np.isfinite(np32(gp[k])).all(), k
        close(gt[k], gp[k], 1e-5, k)
    close(gt["x"], gx, 1e-5, "x")


def test_mamba2_grad_finite_where_the_reference_is_nan():
    """At the seed's dt_bias the reference's mamba2_full gradient is NaN;
    the port's is finite and equals autograd through a token-by-token run
    of ``mamba2_step`` (no masked exp on that path)."""
    jcfg, tcfg, p, x, w = _block(2)
    (gp, _), gt = _block_grads(2, jcfg, tcfg, p, x, w)
    assert not all(np.isfinite(np32(v)).all() for v in gp.values())
    assert all(torch.isfinite(g).all() for g in gt.values())
    tree = _tree(p, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in t_loop._walk(tree)}
    tp = t_loop.merge_gate(tree, leaves)
    tx = torch.tensor(x, requires_grad=True)
    di, hd, nh, n = t_mamba._m2_dims(tcfg)
    conv = torch.zeros((B, tcfg.ssm.conv_dim - 1, di + 2 * n))
    h = torch.zeros((B, nh, hd, n))
    ys = []
    for t in range(tx.shape[1]):
        y, (conv, h) = t_mamba.mamba2_step(tp, tx[:, t:t + 1], tcfg, conv, h)
        ys.append(y)
    seq = torch.autograd.grad((torch.cat(ys, 1) * torch.tensor(w)).sum(),
                              [*leaves.values(), tx])
    for k, g in zip([*leaves, "x"], seq):
        close(gt[k], g, 1e-4, k)


# ---------------------------------------------------------------------------
# lm_forward of the recurrent families
# ---------------------------------------------------------------------------

_REF_GRAD = {}


def _ref_value_and_grad(jcfg):
    """The reference's jitted pretrain value and gradient, one compile a
    config (the hybrid runs it at two states)."""
    if jcfg not in _REF_GRAD:
        _REF_GRAD[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: j_get_api(jcfg).forward(p, b, jcfg, mode="pretrain"), has_aux=True))
    return _REF_GRAD[jcfg]


def _pretrain_both(arch, dt_shift=0.0):
    jcfg, params, tcfg, tparams = pair(arch, dt_shift)
    tb, jb = batches(tcfg)
    (loss_j, mj), gj = _ref_value_and_grad(jcfg)(params, jb)
    loss_t, mt, gt = t_loop.pretrain_value_and_grad(tparams, tb, tcfg)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert set(mt) == set(mj) == {"ce"}
    got, want = port_grad_tree(gt, tparams, tcfg), ref_paths(gj)
    assert got.keys() == want.keys()
    assert all(torch.isfinite(g).all() for g in got.values())
    return got, {k: np32(v) for k, v in want.items()}


def test_mamba1_pretrain_loss_and_grads_match_reference():
    got, want = _pretrain_both("falcon_mamba_7b")
    for path, w in want.items():
        close(got[path], w, 1e-5, path)


def test_hybrid_pretrain_loss_and_grads_match_reference():
    """The seed state: the loss equal, the reference's finite leaves equal
    and the port's all finite (the reference's NaN leaves are its SSD
    mask's, see the module docstring); dt_bias - 4: every leaf equal."""
    got, want = _pretrain_both("zamba2_1_2b")
    finite = [p for p, w in want.items() if np.isfinite(w).all()]
    assert 0 < len(finite) < len(want)
    for path in finite:
        close(got[path], want[path], 1e-5, path)
    got, want = _pretrain_both("zamba2_1_2b", dt_shift=-4.0)
    zero = []
    for path, w in want.items():
        if not np.abs(w).max():
            zero.append(path)
            assert not np32(got[path]).any(), path
            continue
        close(got[path], w, 1e-5, path)
    assert zero and all("/gate/" in p for p in zero)   # the gate is not read


def test_hybrid_distill_loss_and_gate_grads_match_reference():
    """The shared block's KL summed over the two units and divided by 2,
    and its gradient with respect to the gate, which accumulates over the
    units; nothing else takes a gradient."""
    jcfg, params, tcfg, tparams = pair("zamba2_1_2b")
    assert t_hybrid._plan(tcfg)[0] == 2
    tb, jb = batches(tcfg)
    jgate = j_loop.extract_gate(params)
    assert set(jgate) == set(t_loop.extract_gate(tparams))
    assert all(k.startswith("shared_attn/attn/gate/") for k in jgate)

    def loss_fn(gate):
        return j_get_api(jcfg).forward(j_loop.merge_gate(params, gate), jb, jcfg,
                                       mode="distill")[0]
    kl_j, gj = jax.value_and_grad(loss_fn)(jgate)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in t_loop.extract_gate(tparams).items()}
    kl_t, mt = t_hybrid.lm_forward(t_loop.merge_gate(tparams, leaves), tb, tcfg,
                                   mode="distill")
    np.testing.assert_allclose(float(kl_t.detach()), float(kl_j), rtol=1e-5)
    np.testing.assert_allclose(float(mt["kl"]), float(kl_j), rtol=1e-5)
    gt = dict(zip(leaves, torch.autograd.grad(kl_t, list(leaves.values()))))
    for k, w in gj.items():
        assert float(np.abs(np32(w)).max()) > 0, k
        close(gt[k], w, 1e-5, k)
    # the KL is the mean of the shared block's KL over the units
    kls = []
    with torch.no_grad():
        x = tparams["embed"]["w"][tb["tokens"]]
        for unit in tparams["units"]:
            x = t_mamba.stack_train(unit, x, tcfg, t_mamba.mamba2_full)
            x, l_kl, _, _ = t_tf.block_fwd_full(
                tparams["shared_attn"], x, tcfg, rope_positions=tb["positions"],
                segment_ids=tb["segment_ids"], distill=True)
            kls.append(float(l_kl))
    assert min(kls) > 0
    np.testing.assert_allclose(float(kl_t.detach()), sum(kls) / 2, rtol=1e-6)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1_2b"])
def test_remat_matches_no_remat(arch):
    _, _, tcfg, tparams = pair(arch)
    tb, _ = batches(tcfg, step=2)
    base = t_loop.pretrain_value_and_grad(tparams, tb, tcfg)
    again = t_loop.pretrain_value_and_grad(tparams, tb, tcfg.replace(remat="nothing_saveable"))
    assert torch.equal(again[0], base[0])
    assert all(torch.equal(again[2][k], g) for k, g in base[2].items())


# ---------------------------------------------------------------------------
# checkpoints of every tree, both directions, bitwise
# ---------------------------------------------------------------------------

TREES = [("deepseek_moe_16b", "distill"), ("deepseek_moe_16b", "pretrain"),
         ("llama_3_2_vision_11b", "distill"), ("llama_3_2_vision_11b", "pretrain"),
         ("falcon_mamba_7b", "pretrain"),
         ("zamba2_1_2b", "distill"), ("zamba2_1_2b", "pretrain")]


def _ref_state(arch, mode):
    """The reference's train state in the config's dtype (bf16), its
    moments numpy-seeded (a fresh state's are zero) and a step count, as
    numpy leaves."""
    jcfg, tcfg = cfgs(arch, dtype="bfloat16")
    state = jax.device_get(j_loop.init_train_state(jax.random.PRNGKey(0), jcfg,
                                                   JTrain(mode=mode)))
    r = np.random.default_rng(1)
    fill = lambda t: jax.tree.map(  # noqa: E731
        lambda a: r.standard_normal(np.shape(a)).astype(np.float32), t)
    opt = state.opt._replace(m=fill(state.opt.m), v=fill(state.opt.v),
                             count=np.asarray(3, np.int32))
    return jcfg, tcfg, state._replace(opt=opt)


def _tree_of(state):
    return {"params": state.params, "gate": state.gate, "opt": state.opt}


def _assert_states_equal(got, want):
    a, b = dict(t_loop._walk(got.params)), dict(t_loop._walk(want.params))
    assert a.keys() == b.keys()
    for p in b:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p
    assert (got.gate is None) == (want.gate is None)
    pairs = [(got.opt.m, want.opt.m), (got.opt.v, want.opt.v)]
    if want.gate is not None:
        pairs.append((got.gate, want.gate))
    for gd, wd in pairs:
        assert gd.keys() == wd.keys()
        for k in wd:
            assert gd[k].dtype == wd[k].dtype and torch.equal(gd[k], wd[k]), k
    assert int(got.opt.count) == int(want.opt.count)


@pytest.mark.parametrize("arch,mode", TREES)
def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path, arch, mode):
    jcfg, tcfg, jstate = _ref_state(arch, mode)
    j_ckpt.save(str(tmp_path), 3, _tree_of(jstate), meta={"data_step": 3})
    like = t_loop.init_train_state(torch.Generator().manual_seed(5), tcfg,
                                   t_config.TrainConfig(mode=mode))
    tree, meta = t_ckpt.restore(str(tmp_path), 3, t_loop.checkpoint_tree(like), cfg=tcfg)
    assert meta == {"data_step": 3}
    got = t_loop.state_from_checkpoint_tree(tree, torch.tensor(3))
    _assert_states_equal(got, train_state_from_numpy(jstate, tcfg, device="cpu"))


@pytest.mark.parametrize("arch,mode", TREES)
def test_port_checkpoint_restores_into_the_reference_bitwise(tmp_path, arch, mode):
    jcfg, tcfg, jstate = _ref_state(arch, mode)
    tstate = train_state_from_numpy(jstate, tcfg, device="cpu")
    t_ckpt.save(str(tmp_path), 4, t_loop.checkpoint_tree(tstate), meta={"data_step": 4},
                cfg=tcfg)
    leaves = jax.tree_util.tree_leaves(_tree_of(jstate))
    with open(tmp_path / "step_4" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == len(leaves)
    assert manifest["shapes"] == [list(np.shape(a)) for a in leaves]
    assert manifest["dtypes"] == [str(np.asarray(a).dtype) for a in leaves]
    tree, meta = j_ckpt.restore(str(tmp_path), 4, jax.tree.map(jnp.zeros_like,
                                                               _tree_of(jstate)))
    assert meta == {"data_step": 4}
    for got, want in zip(jax.tree_util.tree_leaves(tree), leaves):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def test_train_state_from_numpy_pretrain():
    """A pretrain state: no gate; moments keyed by the parameters' paths,
    each the reference's leaf at that path (the hybrid's units, tail and
    shared block)."""
    jcfg, tcfg, jstate = _ref_state("zamba2_1_2b", "pretrain")
    t = train_state_from_numpy(jstate, tcfg, device="cpu")
    paths = dict(t_loop._walk(t.params))
    assert t.gate is None and set(t.opt.m) == set(t.opt.v) == set(paths)
    assert any(k.startswith("units/1/1/") for k in paths)
    assert any(k.startswith("tail/0/") for k in paths)
    assert any(k.startswith("shared_attn/attn/gate/") for k in paths)
    for moments, ref in ((t.opt.m, jstate.opt.m), (t.opt.v, jstate.opt.v)):
        got = port_grad_tree(moments, t.params, tcfg)
        for path, want in ref_paths(ref).items():
            assert np.array_equal(np32(got[path]), np.asarray(want)), path
    assert int(t.opt.count) == 3 and int(t.step) == 0
    with pytest.raises(ValueError, match="no gate"):
        t_loop.init_train_state(torch.Generator().manual_seed(0),
                                cfgs("falcon_mamba_7b")[1], t_config.TrainConfig())


def test_hybrid_distill_run_training_recovers(tmp_path):
    """run_training in distill mode on the hybrid: a failure before step 3
    restores the step-2 checkpoint; the replayed loss is equal, the base
    bitwise the seed's, the shared block's gate moved; the last checkpoint
    restores into the reference."""
    jcfg, tcfg = cfgs("zamba2_1_2b")
    tc = t_config.TrainConfig(mode="distill", seq_len=L, global_batch=B, steps=4,
                              checkpoint_every=2, checkpoint_dir=str(tmp_path), log_every=0,
                              optim=t_config.OptimConfig(lr=3e-3, warmup_steps=1,
                                                         total_steps=4))
    boom = {"armed": True}

    def fail_at(i):
        if i == 3 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    seed = t_loop.init_train_state(torch.Generator().manual_seed(tc.seed), tcfg, tc)
    state, hist = t_loop.run_training(tcfg, tc, fail_at=fail_at, log=lambda m: None,
                                      device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3] and int(state.step) == 4
    first, replay = (h["loss"] for h in hist if h["step"] == 2)
    assert first == replay and all(np.isfinite(h["kl"]) for h in hist)
    before = dict(t_loop._walk(seed.params))
    for p, t in t_loop._walk(state.params):
        if not t_loop.is_gate_path(p):
            assert torch.equal(t, before[p]), p
    assert all(not torch.equal(state.gate[k], seed.gate[k]) for k in state.gate)
    jstate = jax.device_get(j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, JTrain()))
    tree, _ = j_ckpt.restore(str(tmp_path), 4, _tree_of(jstate))
    back = train_state_from_numpy(jstate._replace(params=tree["params"], gate=tree["gate"],
                                                  opt=tree["opt"]), tcfg, device="cpu")
    _assert_states_equal(back, state)


def test_stack_train_is_the_residual_layer():
    """``mamba.stack_train`` over the hybrid's tail equals its pre-norm
    residual layer written out."""
    _, _, tcfg, tparams = pair("zamba2_1_2b")
    x = torch.randn(B, 16, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    bp = tparams["tail"][0]
    want = x + t_mamba.mamba2_full(bp["mixer"], rms_norm(bp["ln"], x, tcfg.norm_eps), tcfg)[0]
    assert torch.equal(t_mamba.stack_train(tparams["tail"], x, tcfg, t_mamba.mamba2_full),
                       want)
