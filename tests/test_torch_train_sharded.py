"""Training under a Shard: tensor-parallel distillation and pretraining of
every family over torch.distributed, against the unsharded port and the
JAX reference.

CPU, float32, ``reduced()`` configs (the hybrid at 5 layers: two units
and a tail; the MoE router at capacity 1.0, so that it drops), each case
started from the port's initial state, the reference from the same
numbers (``convert.stack_layers``: the reference's initialiser costs
seconds a config on the CPU, and the port's parameters are held to its layout
by tests/test_torch_checkpoint.py). One
``torch.multiprocessing.spawn`` of two gloo ranks runs every two-rank case
(``tests/torch_sharded_helpers.py::train_cases``); the world-size-1 cases
run in this process on a one-rank gloo group.

Tolerances:
  * world size 1: bitwise the unsharded port (loss, every gradient, the
    state after a step, every leaf of the checkpoint);
  * world size 2 (the row splits reorder fp32 sums) against the unsharded
    port: losses and metrics within 1e-5 relative; every gathered
    gradient leaf within 1e-5 of its own largest entry
    (tests/test_torch_pretrain.py's rule), with one exception: a Mamba2
    mixer's per-head leaves (``dt_bias``, ``A_log``, ``D``: two entries
    each) are held within 1e-5 of the largest gradient entry of their
    layer (the leaves under the same ``units/<u>/<j>/`` or ``tail/<j>/``
    prefix). Each of their entries is a sum of B * L * 64 products that
    cancel to ~1e-3 of the layer's scale, and its fp32 rounding follows
    the blocking of the reduction, which changes with the local head
    count: up to ~1.6e-5 of the leaf's own largest entry at these
    shapes. After each of
    two steps every parameter within 1e-5 and the moments within 1e-6 +
    1e-4 relative, at AdamW eps 1e-4 (tests/test_torch_pretrain.py's
    tolerances, for its reasons);
  * world size 2 against the reference's jitted ``make_train_step`` from
    the same state on the same batches: the same tolerances on both
    steps' losses, metrics and ``grad_norm`` and on the state after each
    step. The first step's moments carry the gradient (m = (1 - b1) g
    times the clip scale), so the reference's gradient is held there;
  * the hybrid's pretraining starts at dt_bias - 4, where the reference's
    gradient is finite everywhere (its SSD mask's NaN caveat:
    tests/test_torch_train_recurrent.py holds the seed state);
  * the MoE's drops: every dispatch's keep mask equal on both ranks, in
    the unsharded port and in the reference (its ranks within experts
    under the capacity), with some assignments dropped;
  * the optimizer alone (grad clipping, ``topk_ef``, ``bf16``) on random
    gradients against the unsharded ``adamw.apply``: the error-feedback
    residual bitwise (the top-k threshold is exact), the rest within
    1e-6.
"""
import contextlib
import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.checkpoint import manager as j_ckpt
from repro.config import OptimConfig as JOptim
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.models import moe as j_moe
from repro.optim import adamw as j_adamw
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch import configs as t_configs
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.convert import stack_layers, train_state_from_numpy
from repro_torch.data import pipeline as t_data
from repro_torch.distributed.sharding import Shard, param_layout
from repro_torch.optim import adamw
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

WORLD = 2
REL, PARAM_ATOL, MOM_ATOL, MOM_RTOL = 1e-5, 1e-5, 1e-6, 1e-4
# tests/test_torch_pretrain.py's OPT: eps 1e-4 keeps a gradient entry near
# 0 from turning fp32 rounding into a visible parameter step
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01, eps=1e-4)
MOE_CAPACITY = 1.0

# name -> (arch, mode, config overrides, optimizer overrides, dt_bias shift)
CASES = {
    "qwen3-distill": ("qwen3_0_6b", "distill", {}, {}, 0.0),
    "qwen3-pretrain": ("qwen3_0_6b", "pretrain", {"remat": "nothing_saveable"}, {}, 0.0),
    "gemma-distill": ("gemma_2b", "distill", {}, {}, 0.0),
    "gemma-pretrain": ("gemma_2b", "pretrain", {}, {}, 0.0),
    "moe-distill": ("deepseek_moe_16b", "distill", {}, {}, 0.0),
    "moe-pretrain": ("deepseek_moe_16b", "pretrain", {}, {}, 0.0),
    "vision-pretrain": ("llama_3_2_vision_11b", "pretrain", {}, {}, 0.0),
    "audio-pretrain": ("hubert_xlarge", "pretrain", {}, {}, 0.0),
    "mamba1-pretrain": ("falcon_mamba_7b", "pretrain", {}, {"grad_compression": "topk_ef"},
                        0.0),
    "hybrid-pretrain": ("zamba2_1_2b", "pretrain", {"remat": "nothing_saveable"}, {}, -4.0),
    "hybrid-distill": ("zamba2_1_2b", "distill", {}, {}, 0.0),
}
ARCHS = sorted({c[0] for c in CASES.values()})
# the cases also held against the reference's jitted steps: every config,
# both modes of the paper's qwen3_0_6b (the other cases' unsharded port
# is held to the reference by tests/test_torch_{pretrain,moe,train,
# train_recurrent}.py)
REFERENCE = ["qwen3-distill", "qwen3-pretrain", "gemma-distill", "moe-pretrain",
             "vision-pretrain", "audio-pretrain", "mamba1-pretrain", "hybrid-pretrain"]
# name -> (arch, optimizer overrides) of the optimizer-alone cases
OPTIM_CASES = {
    "clip": ("qwen3_0_6b", {"grad_clip": 0.5}),
    "topk_ef-clip": ("zamba2_1_2b", {"grad_compression": "topk_ef", "grad_clip": 1.0}),
    "bf16": ("deepseek_moe_16b", {"grad_compression": "bf16"}),
}


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def cfgs(arch, **over):
    kw = {"num_layers": 5} if arch == "zamba2_1_2b" else {}
    jcfg = j_reduced(j_configs.get(arch), **kw).replace(dtype="float32", **over)
    tcfg = t_config.reduced(t_configs.get(arch), **kw).replace(dtype="float32", **over)
    if arch == "deepseek_moe_16b":
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=MOE_CAPACITY))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=MOE_CAPACITY))
    return jcfg, tcfg


def train_cfgs(mode, tmp="", **optim):
    base = dict(mode=mode, seq_len=H.TRAIN_L, global_batch=H.TRAIN_B, steps=2,
                checkpoint_every=2, checkpoint_dir=str(tmp), log_every=0)
    opt = dict(OPT, **optim)
    return (JTrain(optim=JOptim(**opt), **base),
            t_config.TrainConfig(optim=t_config.OptimConfig(**opt), **base))


def to_jax(tree):
    """A port tree in the reference's structure (``convert.stack_layers``)
    -> jnp arrays, copies (``mp.spawn`` moves a pickled tensor's storage
    into shared memory, which a zero-copy array would lose)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.array(tree.numpy(), copy=True)


def start_states(tcfg, jcfg, tt, jt, dt_shift=0.0):
    """The port's initial train state (seed 0; dt_bias shifted by
    ``dt_shift``) and the same numbers as the reference's initial state:
    its parameters stacked into the reference's layout, its gate and
    AdamW state built by the reference's own ``extract_gate`` and
    ``adamw.init``, as its ``init_train_state`` builds them."""
    state = t_loop.init_train_state(torch.Generator().manual_seed(0), tcfg, tt)
    if dt_shift:
        shifted = {p: t + dt_shift for p, t in t_loop._walk(state.params)
                   if p.endswith("/dt_bias")}
        state = t_loop.TrainState(t_loop.merge_gate(state.params, shifted), state.gate,
                                  state.opt, state.step)
    params = to_jax(stack_layers(state.params, tcfg))
    gate = j_loop.extract_gate(params) if jt.mode == "distill" else None
    opt = j_adamw.init(gate if gate is not None else params, jt.optim)
    return state, j_loop.TrainState(params, gate, opt, jnp.zeros((), jnp.int32))


def case_setup(name):
    """(reference cfg, port cfg, reference and port TrainConfig, the port's
    start state, the reference's); a ``remat`` override is the port's (the
    reference's values are the same either way)."""
    arch, mode, over, optim, shift = CASES[name]
    jcfg, tcfg = cfgs(arch)
    tcfg = tcfg.replace(**over)
    jt, tt = train_cfgs(mode, **optim)
    return (jcfg, tcfg, jt, tt) + start_states(tcfg, jcfg, tt, jt, shift)


def jax_batch(tcfg, step):
    tb = t_data.make_batch(tcfg, H.TRAIN_B, H.TRAIN_L, t_data.DataState(0, step), device="cpu")
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def recording_reference_drops(tcfg):
    """Yields a list that a reference step traced inside the block fills,
    at every call, with the keep mask of each of its forward's MoE
    dispatches (its ranks within experts, recorded through ordered debug
    callbacks, under the call's capacity)."""
    masks, real = [], j_moe._rank_within_expert
    t = H.TRAIN_B * H.TRAIN_L
    cap = max(1, int(np.ceil(t * tcfg.moe.top_k / tcfg.moe.n_experts * MOE_CAPACITY)))

    def recording(flat_e, n):
        r = real(flat_e, n)
        jax.debug.callback(lambda x: masks.append(np.asarray(x) < cap), r, ordered=True)
        return r

    j_moe._rank_within_expert = recording
    try:
        yield masks
    finally:
        j_moe._rank_within_expert = real


# ---------------------------------------------------------------------------
# the two-rank run, the unsharded port and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The file's torch work on one intra-op thread: its shapes are tiny,
    and idle intra-op threads spin against the spawned ranks and the
    reference's compiles."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two-rank spawn, computes the unsharded port's and the
    reference's runs while it works, then joins it."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    setups = {name: case_setup(name) for name in CASES}
    cases = {name: (tcfg, tt, start) for name, (_, tcfg, _, tt, start, _) in setups.items()}
    _, rcfg = cfgs("qwen3_0_6b")
    _, rtt = train_cfgs("pretrain", tmp / "ckpt_sharded")
    recover = (rcfg, dataclasses.replace(rtt, steps=4))
    gen = np.random.default_rng(5)
    optim = {}
    for name, (arch, over) in OPTIM_CASES.items():
        _, cfg = cfgs(arch)
        ocfg = t_config.OptimConfig(**dict(OPT, **over))
        params = dict(t_loop._walk(t_loop.init_train_state(
            torch.Generator().manual_seed(0), cfg, t_config.TrainConfig(mode="pretrain")).params))
        grads = {k: torch.tensor(gen.standard_normal(t.shape), dtype=torch.float32)
                 for k, t in params.items()}
        optim[name] = (cfg, ocfg, params, grads, adamw.init(params, ocfg))
    ctx = mp.spawn(H.run, args=(WORLD, str(tmp / "train.store"), "train",
                                (cases, recover, optim), str(tmp)),
                   nprocs=WORLD, join=False)
    try:
        port = {name: H.train_case(None, *case) for name, case in cases.items()}
        ref = {}
        for name in REFERENCE:
            jcfg, tcfg, jt, _, _, jstate = setups[name]
            step, states, hist = jax.jit(j_loop.make_train_step(jcfg, jt)), [], []
            with (recording_reference_drops(tcfg) if name == "moe-pretrain"
                  else contextlib.nullcontext([])) as drops:
                for i in range(2):
                    jstate, m = step(jstate, jax_batch(tcfg, i))
                    hist.append({k: float(v) for k, v in m.items()})
                    states.append(train_state_from_numpy(jax.device_get(jstate), tcfg, "cpu"))
                    if i == 0 and name == "moe-pretrain":
                        jax.effects_barrier()
                        ref["drops"] = list(drops)
            ref[name] = {"hist": hist, "states": states}
        plain_recover = H.recovering_run(None, rcfg, dataclasses.replace(
            recover[1], checkpoint_dir=str(tmp / "ckpt_plain")))
        plain_optim = {name: H.sharded_optimizer(None, *case) for name, case in optim.items()}
    finally:
        while not ctx.join():
            pass
    sharded = [torch.load(tmp / f"train-{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"setups": setups, "port": port, "ref": ref, "sharded": sharded, "tmp": tmp,
            "recover": (recover, plain_recover), "optim": (optim, plain_optim)}


# a Mamba2 mixer's per-head leaves, held to their layer's scale (above)
M2_PER_HEAD = ("mixer/dt_bias", "mixer/A_log", "mixer/D")


def grad_scales(grads, cfg):
    """path -> the scale of its gradient tolerance: the leaf's largest
    entry, or for a Mamba2 per-head leaf the largest entry of its layer
    (the leaves sharing the prefix up to the first name after the layer
    indices)."""
    def layer(path):
        parts = path.split("/")
        n = 1
        while n < len(parts) and parts[n].isdigit():
            n += 1
        return "/".join(parts[:n])
    own = {k: float(g.abs().max()) for k, g in grads.items()}
    if cfg.family != "hybrid":
        return own
    layers = {}
    for k, m in own.items():
        layers[layer(k)] = max(layers.get(layer(k), 0.0), m)
    return {k: layers[layer(k)] if k.endswith(M2_PER_HEAD) else m for k, m in own.items()}


def _close_metrics(got, want, err):
    assert set(want) <= set(got), err
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=1e-8, err_msg=f"{err} {k}")


def _close_state(got, want, err):
    gp, wp = dict(t_loop._walk(got.params)), dict(t_loop._walk(want.params))
    assert gp.keys() == wp.keys(), err
    for p, w in wp.items():
        np.testing.assert_allclose(np32(gp[p]), np32(w), atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{err} {p}")
    for field in ("m", "v"):
        g, w = getattr(got.opt, field), getattr(want.opt, field)
        assert g.keys() == w.keys(), err
        for k in w:
            np.testing.assert_allclose(np32(g[k]), np32(w[k]), atol=MOM_ATOL, rtol=MOM_RTOL,
                                       err_msg=f"{err} {field} {k}")
    assert int(got.step) == int(want.step) and int(got.opt.count) == int(want.opt.count)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_unsharded_port(runs, name):
    """Both ranks: the step-0 loss and metrics, every gathered gradient
    leaf, both steps' metrics and the gathered state after each step."""
    want = runs["port"][name]
    for rank, out in enumerate(runs["sharded"]):
        got, err = out[name], f"{name} rank {rank}"
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL, err_msg=err)
        _close_metrics(got["metrics"], want["metrics"], err)
        assert got["grads"].keys() == want["grads"].keys()
        scale = grad_scales(want["grads"], runs["setups"][name][1])
        for k, w in want["grads"].items():
            g, w = np32(got["grads"][k]), np32(w)
            assert g.shape == w.shape and np.isfinite(g).all(), f"{err} {k}"
            np.testing.assert_allclose(g, w, atol=REL * scale[k], rtol=0,
                                       err_msg=f"{err} {k}")
        for i in range(2):
            _close_metrics(got["hist"][i], want["hist"][i], f"{err} step {i}")
            _close_state(got["states"][i], want["states"][i], f"{err} step {i}")


@pytest.mark.parametrize("name", REFERENCE)
def test_sharded_matches_reference(runs, name):
    """The gathered two-rank run against the reference's jitted steps:
    both steps' metrics and the state after each (the first step's
    moments hold the reference's gradient)."""
    want = runs["ref"][name]
    got = runs["sharded"][0][name]
    for i in range(2):
        _close_metrics(got["hist"][i], want["hist"][i], f"{name} step {i}")
        _close_state(got["states"][i], want["states"][i], f"{name} step {i}")
    assert all(np.isfinite(h["grad_norm"]) for h in want["hist"])


def _expected_local(arch, path, full):
    """The scheme's local shape of a leaf at world size 2 (written from the
    scheme, not from ``param_layout``)."""
    cfg = cfgs(arch)[1]
    leaf = path.rsplit("/", 2)
    shape = list(full)
    half = lambda ax: shape.__setitem__(ax, shape[ax] // 2)  # noqa: E731
    attn_split = cfg.n_kv_heads % 2 == 0
    if path == "embed/w":
        half(0)
    elif path == "lm_head/w":
        half(1)
    elif "/mixer/" in path:
        name = path.split("/mixer/")[1]
        if cfg.family == "ssm":
            if name in ("in_proj/w", "conv_w", "dt_proj/w"):
                half(1)
            elif name in ("conv_b", "x_proj/w", "dt_bias", "A_log", "D", "out_proj/w"):
                half(0)
        else:
            di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
            nh = di // 64
            if name == "in_proj/w":
                shape[1] = di + 2 * n + nh // 2
            elif name == "conv_w":
                shape[1] = di // 2 + 2 * n
            elif name == "conv_b":
                shape[0] = di // 2 + 2 * n
            elif name in ("A_log", "dt_bias", "D", "norm/scale", "out_proj/w"):
                half(0)
    elif "/attn/" in path:
        name = path.split("/attn/")[1]
        if attn_split and name in ("wq/w", "wk/w", "wv/w"):
            half(1)
        elif attn_split and name in ("wo/w", "gate/wq", "gate/wk"):
            half(0)
    elif "/moe/" in path:
        name = path.split("/moe/")[1]
        if name in ("wi_gate", "wi_up", "wo"):
            half(0)
        elif name in ("shared/wi_gate/w", "shared/wi_up/w"):
            half(1)
        elif name == "shared/wo/w":
            half(0)
    elif "/mlp/" in path:
        half(1 if leaf[-2] in ("wi_gate", "wi_up") else 0)
    return tuple(shape)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_holds_its_blocks(runs, name):
    """Each rank's parameter leaves: 1/2 of every split leaf along its
    split axis (a Mamba2 leaf's B/C columns whole), replicated leaves
    whole; the MQA config's attention and gate replicated, the audio
    in_proj and the router replicated."""
    arch = CASES[name][0]
    full = {p: tuple(t.shape) for p, t in t_loop._walk(runs["port"][name]["states"][0].params)}
    n_split = 0
    for out in runs["sharded"]:
        local = out[name]["local"]
        assert local.keys() == full.keys()
        for p, shape in full.items():
            want = _expected_local(arch, p, shape)
            assert local[p] == want, (p, local[p], want)
            n_split += want != shape
    assert n_split > 0
    if arch == "gemma_2b":
        assert local["blocks/0/attn/wq/w"] == full["blocks/0/attn/wq/w"]
    if arch == "hubert_xlarge":
        assert local["in_proj/w"] == full["in_proj/w"]


@pytest.mark.parametrize("name", ["moe-pretrain", "moe-distill"])
def test_expert_parallel_drops_are_the_references(runs, name):
    """Every dispatch of the step-0 forward keeps the same assignments on
    both ranks as the unsharded port (the router, the capacity and the
    ranks within experts are computed alike on every rank), some of them
    dropped; in pretrain they are the reference's."""
    want = runs["port"][name]["drops"]
    assert len(want) == cfgs("deepseek_moe_16b")[1].num_layers
    for out in runs["sharded"]:
        got = out[name]["drops"]
        assert len(got) == len(want)
        for (ge, gk, gc), (we, wk, wc) in zip(got, want):
            assert gc == wc
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_array_equal(gk, wk)
    assert any((~k).any() for _, k, _ in want)
    if name == "moe-pretrain":
        ref = runs["ref"]["drops"]
        assert len(ref) == len(want)
        for (_, keep, _), r in zip(want, ref):
            np.testing.assert_array_equal(keep, r)


def test_sharded_recovery_and_checkpoint(runs):
    """run_training under the shard with a failure before step 3: every
    rank logs the restore of step 2 and replays it; the history and the
    final state are the unsharded run's (within the tolerances); the
    checkpoint rank 0 wrote is the full tree, which the reference's
    restore reads tree for tree, bitwise the gathered final state."""
    (rcfg, rtt), (p_hist, p_state, p_logs) = runs["recover"]
    for out in runs["sharded"]:
        hist, state, logs = out["recover"]
        assert [h["step"] for h in hist] == [h["step"] for h in p_hist] == [0, 1, 2, 2, 3]
        assert len(logs) == 1 and "step 3 failed" in logs[0] and "restoring step 2" in logs[0]
        first, replay = (h["loss"] for h in hist if h["step"] == 2)
        assert first == replay
        for got, want in zip(hist, p_hist):
            _close_metrics(got, {k: v for k, v in want.items() if k != "step"},
                           f"step {got['step']}")
        _close_state(state, p_state, "recovered run")
    assert t_ckpt.latest_step(rtt.checkpoint_dir) == 4
    jcfg, _ = cfgs("qwen3_0_6b")
    jt, _ = train_cfgs("pretrain")
    like = jax.device_get(start_states(rcfg, jcfg, rtt, jt)[1])
    tree, meta = j_ckpt.restore(rtt.checkpoint_dir, 4,
                                {"params": like.params, "gate": None, "opt": like.opt})
    assert meta == {"data_step": 4, "seed": rtt.seed}
    back = train_state_from_numpy(like._replace(params=tree["params"], opt=tree["opt"],
                                                step=np.int32(4)), rcfg, "cpu")
    state = runs["sharded"][0]["recover"][1]
    for p, t in t_loop._walk(state.params):
        assert torch.equal(dict(t_loop._walk(back.params))[p], t), p
    for field in ("m", "v"):
        assert all(torch.equal(getattr(back.opt, field)[k], t)
                   for k, t in getattr(state.opt, field).items())


@pytest.mark.parametrize("name", list(OPTIM_CASES))
def test_sharded_optimizer_matches_unsharded(runs, name):
    """adamw.apply on the ranks' blocks (gathered) against the unsharded
    apply: the global norm over every leaf once, the clip, the top-k
    threshold over the whole leaf."""
    optim, plain = runs["optim"]
    p_new, p_opt, p_gn = plain[name]
    cfg, ocfg = optim[name][:2]
    assert ocfg.grad_clip == 0 or p_gn > ocfg.grad_clip       # the clip binds
    for out in runs["sharded"]:
        new, opt, gn = out["optim"][name]
        np.testing.assert_allclose(gn, p_gn, rtol=REL)
        for k, w in p_new.items():
            np.testing.assert_allclose(np32(new[k]), np32(w), atol=1e-6, rtol=0, err_msg=k)
        for field in ("m", "v"):
            for k, w in getattr(p_opt, field).items():
                np.testing.assert_allclose(np32(getattr(opt, field)[k]), np32(w), atol=1e-6,
                                           rtol=1e-5, err_msg=f"{field} {k}")
        if ocfg.grad_compression == "topk_ef":
            partial = [k for k in p_opt.ef
                       if (lay := param_layout(k, p_opt.ef[k].shape, cfg, WORLD)) is not None
                       and lay.replicated_slices(WORLD)]
            assert partial                                   # the B/C columns' leaves
            assert all(torch.equal(opt.ef[k], t) for k, t in p_opt.ef.items())


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------

def _one_rank_cases():
    for arch in ARCHS:
        _, cfg = cfgs(arch)
        modes = ["pretrain"] + (["distill"] if cfg.gate.enabled and cfg.is_decoder else [])
        for mode in modes:
            yield arch, mode


@pytest.mark.parametrize("arch,mode", list(_one_rank_cases()))
def test_one_rank_is_the_unsharded_port_bitwise(tmp_path, arch, mode):
    """On a one-rank group: the loss, every gradient, the state after a
    run_training step and every leaf of its checkpoint bitwise the
    unsharded port's (a one-rank sum is the identity, a one-rank block the
    whole leaf). Pretrain under remat."""
    _, cfg = cfgs(arch, remat="nothing_saveable" if mode == "pretrain" else "none")
    tts = {k: dataclasses.replace(train_cfgs(mode, tmp_path / k, grad_compression="topk_ef")[1],
                                  steps=1, checkpoint_every=1)
           for k in ("plain", "sharded")}
    start = t_loop.init_train_state(torch.Generator().manual_seed(0), cfg, tts["plain"])
    batch = t_data.make_batch(cfg, H.TRAIN_B, H.TRAIN_L, t_data.DataState(0, 0), device="cpu")
    plain = H.value_and_grad(start, batch, cfg, mode)
    p_state, p_hist = t_loop.run_training(cfg, tts["plain"], log=lambda m: None, device="cpu")
    with H.one_rank_group(tmp_path / "store") as one:
        local = t_loop.shard_state(start, cfg, one)
        got = H.value_and_grad(local, batch, cfg, mode, one)
        s_state, s_hist = t_loop.run_training(cfg, tts["sharded"], log=lambda m: None,
                                              device="cpu", shard=one)
    assert torch.equal(got[0], plain[0]) and got[1].keys() == plain[1].keys()
    assert all(torch.equal(got[1][k], v) for k, v in plain[1].items())
    assert got[2].keys() == plain[2].keys()
    assert all(torch.equal(got[2][k], g) for k, g in plain[2].items())
    assert s_hist == p_hist
    for a, b in ((s_state.params, p_state.params), (s_state.opt.m, p_state.opt.m),
                 (s_state.opt.v, p_state.opt.v), (s_state.opt.ef, p_state.opt.ef)):
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(t_loop._walk(a),
                                                                 t_loop._walk(b)))
    for i in range(len(os.listdir(tmp_path / "plain" / "step_1")) - 1):
        a, b = (np.load(tmp_path / k / "step_1" / f"{i}.npy") for k in ("plain", "sharded"))
        assert a.dtype == b.dtype and np.array_equal(a, b), i


def test_launcher_trains_under_torchrun_env(tmp_path, monkeypatch):
    """``launch.train`` under a one-rank torchrun environment joins a gloo
    group, trains through the shard and leaves no group behind; its
    history and its checkpoint are the single-process run's."""
    from repro_torch.launch import train as t_launch
    argv = ["--arch", "qwen3_0_6b", "--reduced", "--steps", "2", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--ckpt-every", "2", "--ckpt-dir"]
    plain = t_launch.main(argv + [str(tmp_path / "plain")])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    real = t_loop.run_training

    def spy(*a, **kw):
        seen.append(kw.get("shard"))
        return real(*a, **kw)
    monkeypatch.setattr(t_loop, "run_training", spy)
    sharded = t_launch.main(argv + [str(tmp_path / "sharded")])
    assert isinstance(seen[0], Shard) and seen[0].world == 1
    assert not torch.distributed.is_initialized()
    assert sharded == plain
    for i in range(len(os.listdir(tmp_path / "plain" / "step_2")) - 1):
        a, b = (np.load(tmp_path / k / "step_2" / f"{i}.npy") for k in ("plain", "sharded"))
        assert np.array_equal(a, b), i
