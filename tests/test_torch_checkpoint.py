"""Checkpoints interchange between the JAX package and the PyTorch port.

The port writes the reference's layout (``repro_torch.checkpoint.manager``):
the same files, the same leaf order and the same stacked [L, ...] shapes.
Each direction is held bitwise on a reduced qwen3_0_6b distill train state,
in bf16 (the config's dtype) and in fp32:

  * the reference saves (``repro.checkpoint.manager.save``), the port
    restores, and the result equals ``convert.train_state_from_numpy`` of
    the same state;
  * the port saves, the reference restores into its own ``like`` tree, and
    ``train_state_from_numpy`` of what it read equals the port's state;
  * ``run_training``'s own checkpoints are read by the reference.

The AdamW moments are filled with numpy-seeded values (a fresh state's are
zero), so a leaf that lands in the wrong place shows.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as J_C
from repro.checkpoint import manager as j_ckpt
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.configs import get as t_get
from repro_torch.convert import train_state_from_numpy
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

DTYPES = ["bfloat16", "float32"]


def _cfgs(dtype):
    jcfg = j_reduced(J_C.get("qwen3_0_6b")).replace(dtype=dtype)
    tcfg = t_config.reduced(t_get("qwen3_0_6b")).replace(dtype=dtype)
    return jcfg, tcfg


def _jax_state(jcfg):
    """The reference's distill train state with numpy-seeded moments and a
    step count, as numpy leaves."""
    state = jax.device_get(j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, JTrain()))
    r = np.random.default_rng(1)
    fill = lambda t: {k: r.standard_normal(np.shape(a)).astype(np.float32)  # noqa: E731
                      for k, a in t.items()}
    opt = state.opt._replace(m=fill(state.opt.m), v=fill(state.opt.v),
                             count=np.asarray(3, np.int32))
    return state._replace(opt=opt)


def _tree(state):
    """The checkpoint tree of a train state, as both packages' loops save it."""
    return {"params": state.params, "gate": state.gate, "opt": state.opt}


def _assert_states_equal(got, want):
    """Every leaf of two port train states equal bitwise, in dtype too."""
    a, b = dict(t_loop._walk(got.params)), dict(t_loop._walk(want.params))
    assert a.keys() == b.keys()
    for p in b:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p
    for got_d, want_d in ((got.gate, want.gate), (got.opt.m, want.opt.m),
                          (got.opt.v, want.opt.v)):
        assert got_d.keys() == want_d.keys()
        for k in want_d:
            assert got_d[k].dtype == want_d[k].dtype and torch.equal(got_d[k], want_d[k]), k
    assert int(got.opt.count) == int(want.opt.count) and got.opt.ef is None
    # the gate leaves inside params are the gate dict's
    assert all(torch.equal(t_loop.extract_gate(got.params)[k], got.gate[k]) for k in got.gate)


def _port_like(tcfg):
    """A port train state of the right structure and different values."""
    return t_loop.init_train_state(torch.Generator().manual_seed(5), tcfg,
                                   t_config.TrainConfig())


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jstate = _jax_state(jcfg)
    j_ckpt.save(str(tmp_path), 3, _tree(jstate), meta={"data_step": 3, "seed": 0})
    tree, meta = t_ckpt.restore(str(tmp_path), 3, _tree(_port_like(tcfg)))
    assert meta == {"data_step": 3, "seed": 0}
    got = t_loop.TrainState(tree["params"], tree["gate"], tree["opt"], torch.tensor(3))
    _assert_states_equal(got, train_state_from_numpy(jstate, tcfg, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_into_the_reference_bitwise(tmp_path, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jstate = _jax_state(jcfg)
    tstate = train_state_from_numpy(jstate, tcfg, device="cpu")
    t_ckpt.save(str(tmp_path), 4, _tree(tstate), meta={"data_step": 4})
    # the reference's own leaf count, order and shapes
    leaves = jax.tree_util.tree_leaves(_tree(jstate))
    with open(tmp_path / "step_4" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == len(leaves)
    assert manifest["shapes"] == [list(np.shape(a)) for a in leaves]
    assert manifest["dtypes"] == [str(np.asarray(a).dtype) for a in leaves]
    like = jax.tree.map(jnp.zeros_like, _tree(jstate))
    tree, meta = j_ckpt.restore(str(tmp_path), 4, like)
    assert meta == {"data_step": 4}
    for got, want in zip(jax.tree_util.tree_leaves(tree), leaves):
        assert got.dtype == np.asarray(want).dtype
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    back = jstate._replace(params=tree["params"], gate=tree["gate"], opt=tree["opt"])
    _assert_states_equal(train_state_from_numpy(back, tcfg, device="cpu"), tstate)


def test_run_training_checkpoints_are_the_references(tmp_path):
    """The port's run_training (fp32, 2 steps, a checkpoint after each)
    writes checkpoints the reference restores; read back, the last one is
    the port's final state bitwise."""
    jcfg, tcfg = _cfgs("float32")
    tc = t_config.TrainConfig(seq_len=64, global_batch=2, steps=2, checkpoint_every=1,
                              checkpoint_dir=str(tmp_path), log_every=0,
                              optim=t_config.OptimConfig(lr=3e-3, warmup_steps=1,
                                                         total_steps=2))
    state, _ = t_loop.run_training(tcfg, tc, device="cpu")
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    jstate = jax.device_get(j_loop.init_train_state(jax.random.PRNGKey(0), jcfg, JTrain()))
    tree, meta = j_ckpt.restore(str(tmp_path), 2, _tree(jstate))
    assert meta == {"data_step": 2, "seed": tc.seed}
    back = jstate._replace(params=tree["params"], gate=tree["gate"], opt=tree["opt"])
    _assert_states_equal(train_state_from_numpy(back, tcfg, device="cpu"), state)


def test_restore_refuses_a_tree_of_other_shapes(tmp_path):
    """A checkpoint of the reduced config (2 layers) does not restore into a
    state with more layers: the leaf count is equal, the shapes are not."""
    jcfg, tcfg = _cfgs("float32")
    t_ckpt.save(str(tmp_path), 1, _tree(_port_like(tcfg)))
    deeper = _port_like(tcfg.replace(num_layers=tcfg.num_layers + 1))
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.restore(str(tmp_path), 1, _tree(deeper))
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
