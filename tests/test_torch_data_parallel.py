"""The port's data axis: data-parallel training with ZeRO-1 moments, rows
over data on decode, and the batch-1 sequence over data x model, against
the unsharded port and the JAX reference.

CPU, float32, ``reduced()`` configs. ``sharding.data_model_shards(D, M)``
cuts a gloo world of ``D x M`` ranks (rank ``d*M + m``) into the model
group of each ``d`` and the data group of each ``m``. One
``torch.multiprocessing.spawn`` of two ranks (data 2 x model 1) runs every
two-rank case, and one of four ranks (data 2 x model 2) runs two training
cases; both run while the parent computes the unsharded port's runs and
the reference's jitted steps. World-size-1 cases run in this process.

The training batch is 4 rows of 32 tokens (``H.dp_batch``), packed so
that the two replicas' halves hold different ``loss_mask`` counts (60
and 62): the global masked mean is then not the mean of the replicas'
means. The MoE router runs at capacity 1.0, so it drops. The children
lower ``sharding.ZERO1_MIN_SIZE`` to ``H.DP_ZERO1_MIN`` (the reduced
leaves are all under the reference's 2**16 elements), so that ZeRO-1
splits the layers' leaves (on the reference's layer-stack dim: two layers
over two data ranks) and the embedding and logits (on their first dim).
The two-rank child also runs a pretrain step and the optimizer again with
``zero1_gather``'s chunk lowered to ``H.DP_GATHER_CHUNK`` bytes, so that
the owner-whole layer slices cross chunk boundaries.

Tolerances (tests/test_torch_train_sharded.py's, for its reasons):
losses, metrics and ``grad_norm`` within 1e-5 relative; after each of two
steps every parameter within 1e-5 and the moments within 1e-6 + 1e-4
relative, at AdamW eps 1e-4. Against the unsharded port and against the
reference's jitted ``make_train_step`` on the global batch. At one rank
every result is bitwise the run without a data axis. The optimizer alone
(``bf16`` and ``topk_ef`` compression over ZeRO-1 slices) is held to the
unsharded ``adamw.apply`` of the ranks' summed gradients: ``bf16`` and
the error-feedback residual bitwise (the all-reduce is one fp32 sum of
two, commutative, before the compression), the rest within 1e-6.
``generate`` at batch 1 over the world: greedy tokens and every selected
id list exact, logits within LOGIT_TOL (1e-4; the sequence-sharded
combine reorders the softmax sums). MoE rows over data: tokens equal to
the unsharded engine's, where two independent half-batch engines differ.
"""
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh, PartitionSpec
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.checkpoint import manager as j_ckpt
from repro.config import OptimConfig as JOptim
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.distributed import sharding as j_shd
from repro.models.registry import get_api as j_get_api
from repro.optim import adamw as j_adamw
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch import configs as t_configs
from repro_torch.convert import stack_layers, train_state_from_numpy
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, specs
from repro_torch.launch import train as t_launch
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

REL, PARAM_ATOL, MOM_ATOL, MOM_RTOL = 1e-5, 1e-5, 1e-6, 1e-4
LOGIT_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01, eps=1e-4)
MOE_CAPACITY = 1.0
GATE = dict(block_size=8, d_gate=16, local_cap_factor=8.0)

# name -> (arch, mode) of the training cases; LAYOUTS -> the cases each runs
CASES = {"qwen3-distill": ("qwen3_0_6b", "distill"),
         "qwen3-pretrain": ("qwen3_0_6b", "pretrain"),
         "moe-distill": ("deepseek_moe_16b", "distill"),
         "moe-pretrain": ("deepseek_moe_16b", "pretrain")}
LAYOUTS = {(2, 1): list(CASES), (2, 2): ["qwen3-distill", "moe-pretrain"]}
RUNS = [(layout, name) for layout, names in LAYOUTS.items() for name in names]
OPTIM_CASES = {"bf16": ("deepseek_moe_16b", {"grad_compression": "bf16"}),
               "topk_ef-clip": ("qwen3_0_6b", {"grad_compression": "topk_ef",
                                               "grad_clip": 0.5})}
# the cases run again with zero1_gather's chunk lowered (H.DP_GATHER_CHUNK)
CHUNKED = {"train": ["qwen3-pretrain"], "optim": ["topk_ef-clip"]}


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def cfgs(arch):
    jcfg = j_reduced(j_configs.get(arch)).replace(dtype="float32")
    tcfg = t_config.reduced(t_configs.get(arch)).replace(dtype="float32")
    if arch == "deepseek_moe_16b":
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=MOE_CAPACITY))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=MOE_CAPACITY))
    return jcfg, tcfg


def train_cfgs(mode, **over):
    base = dict(mode=mode, seq_len=H.DP_L, global_batch=H.DP_B, steps=2, checkpoint_every=2,
                log_every=0)
    base.update(over)
    opt = dict(OPT)
    return (JTrain(optim=JOptim(**opt), **base),
            t_config.TrainConfig(optim=t_config.OptimConfig(**opt), **base))


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.array(tree.numpy(), copy=True)


def start_states(tcfg, jt, tt):
    """The port's seed-0 state and the same numbers as the reference's."""
    state = t_loop.init_train_state(torch.Generator().manual_seed(0), tcfg, tt)
    params = to_jax(stack_layers(state.params, tcfg))
    gate = j_loop.extract_gate(params) if jt.mode == "distill" else None
    opt = j_adamw.init(gate if gate is not None else params, jt.optim)
    return state, j_loop.TrainState(params, gate, opt, jnp.zeros((), jnp.int32))


def jax_batch(tcfg, i):
    return {k: jnp.asarray(v.numpy()) for k, v in H.dp_batch(tcfg, i).items()}


def gen_cfg(arch):
    """A generate config: qwen3_0_6b with 8-token blocks (the candidate cap
    not binding), or deepseek_moe_16b at its published router (E 64, top
    6, capacity 1.25: decode rows compete for the experts' slots)."""
    cfg = t_config.reduced(t_configs.get(arch)).replace(dtype="float32")
    if arch == "deepseek_moe_16b":
        m = t_configs.get(arch).moe
        return cfg.replace(moe=type(m)(n_experts=m.n_experts, top_k=m.top_k,
                                       n_shared_experts=m.n_shared_experts, expert_d_ff=64,
                                       capacity_factor=m.capacity_factor))
    return cfg.replace(gate=dataclasses.replace(cfg.gate, **GATE))


def gen_jobs():
    """name -> (cfg, the port's seed-0 parameters, batch, record the
    sequence-sharded ids?)."""
    out = {}
    for name, arch, shape in (("batch1", "qwen3_0_6b", (1, 21)),
                              ("moe-rows", "deepseek_moe_16b", (4, 24))):
        cfg = gen_cfg(arch)
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        toks = np.random.default_rng(3).integers(0, cfg.vocab_size, shape).astype(np.int32)
        out[name] = (cfg, params, {"tokens": toks}, name == "batch1")
    return out


def _spawn(tmp, tag, n_data, n_model, jobs):
    world = n_data * n_model
    return mp.spawn(H.run, args=(world, str(tmp / f"{tag}.store"), "data",
                                 (n_data, n_model, jobs), str(tmp / tag)),
                    nprocs=world, join=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two- and four-rank spawns, computes the unsharded port's
    and the reference's runs while they work, then joins them."""
    tmp = tmp_path_factory.mktemp("data_parallel")
    setups = {}
    for name, (arch, mode) in CASES.items():
        jcfg, tcfg = cfgs(arch)
        jt, tt = train_cfgs(mode)
        setups[name] = (jcfg, tcfg, jt, tt) + start_states(tcfg, jt, tt)
    gen = np.random.default_rng(5)
    optim = {}
    for name, (arch, over) in OPTIM_CASES.items():
        _, cfg = cfgs(arch)
        ocfg = t_config.OptimConfig(**dict(OPT, **over))
        params = dict(t_loop._walk(t_loop.init_train_state(
            torch.Generator().manual_seed(0), cfg, t_config.TrainConfig(mode="pretrain")).params))
        grads = [{k: torch.tensor(gen.standard_normal(t.shape), dtype=torch.float32)
                  for k, t in params.items()} for _ in range(2)]
        optim[name] = (cfg, ocfg, params, grads, adamw.init(params, ocfg))
    _, rcfg = cfgs("qwen3_0_6b")
    _, rtt = train_cfgs("pretrain", steps=4, checkpoint_dir=str(tmp / "ckpt_data"))
    generate = gen_jobs()
    train = {n: setups[n][1:2] + setups[n][3:5] for n in CASES}
    jobs = {(2, 1): {"train": {n: train[n] for n in LAYOUTS[2, 1]},
                     "optim": optim, "recover": (rcfg, rtt), "generate": generate,
                     "chunked": {"train": {n: train[n] for n in CHUNKED["train"]},
                                 "optim": {n: optim[n] for n in CHUNKED["optim"]}}},
            (2, 2): {"train": {n: train[n] for n in LAYOUTS[2, 2]}}}
    for layout in jobs:
        os.makedirs(tmp / f"{layout[0]}x{layout[1]}")
    ctxs = {layout: _spawn(tmp, f"{layout[0]}x{layout[1]}", *layout, job)
            for layout, job in jobs.items()}
    try:
        port = {name: H.dp_train_case(None, None, tcfg, tt, start)
                for name, (_, tcfg, _, tt, start, _) in setups.items()}
        ref = {}
        for name, (jcfg, tcfg, jt, _, _, jstate) in setups.items():
            step, states, hist = jax.jit(j_loop.make_train_step(jcfg, jt)), [], []
            for i in range(2):
                jstate, m = step(jstate, jax_batch(tcfg, i))
                hist.append({k: float(v) for k, v in m.items()})
                states.append(train_state_from_numpy(jax.device_get(jstate), tcfg, "cpu"))
            ref[name] = {"hist": hist, "states": states}
        plain_optim = {}
        for name, (cfg, ocfg, params, grads, opt) in optim.items():
            total = {k: grads[0][k] + grads[1][k] for k in grads[0]}
            new, o, om = adamw.apply(params, total, opt, ocfg)
            plain_optim[name] = (new, o, float(om["grad_norm"]))
        plain_recover = H.dp_recovering_run(None, None, rcfg, dataclasses.replace(
            rtt, checkpoint_dir=str(tmp / "ckpt_plain")))
        plain_gen = {}
        for name, (cfg, params, batch, _) in generate.items():
            with H.recording_gate_ids() as ids:
                got = H.dp_generate(None, None, cfg, params, batch)
            got["gate_ids"] = ids
            toks = batch["tokens"]
            if len(toks) > 1:           # the control: independent half-batch engines
                got["halves"] = np.concatenate([
                    H.dp_generate(None, None, cfg, params, {"tokens": half})["tokens"]
                    for half in np.split(toks, 2)])
            plain_gen[name] = got
    finally:
        for (n_data, n_model), ctx in ctxs.items():
            H.join(ctx, str(tmp / f"{n_data}x{n_model}"), "data")
    ranks = {layout: [torch.load(tmp / f"{layout[0]}x{layout[1]}" / f"data-{r}.pt",
                                 weights_only=False) for r in range(layout[0] * layout[1])]
             for layout in jobs}
    return {"setups": setups, "port": port, "ref": ref, "ranks": ranks, "optim": optim,
            "plain_optim": plain_optim, "recover": ((rcfg, rtt), plain_recover),
            "generate": generate, "plain_gen": plain_gen}


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


def test_replicas_hold_unequal_mask_counts():
    """The premise of the global-loss cases: the two halves of each step's
    global batch hold different loss-mask counts."""
    _, cfg = cfgs("qwen3_0_6b")
    for i in range(2):
        m = H.dp_batch(cfg, i)["loss_mask"].sum(dim=1)
        assert float(m[:2].sum()) != float(m[2:].sum())


@pytest.mark.parametrize("layout,name", RUNS, ids=[f"{d}x{m}-{n}" for (d, m), n in RUNS])
def test_data_parallel_matches_unsharded_port(runs, layout, name):
    """Every rank: both steps' metrics and the state after each (gathered
    over both axes) against the unsharded port on the global batch."""
    want = runs["port"][name]
    for rank, out in enumerate(runs["ranks"][layout]):
        got, err = out["train"][name], f"{layout} {name} rank {rank}"
        for i in range(2):
            _close_metrics(got["hist"][i], want["hist"][i], f"{err} step {i}")
            _close_state(got["states"][i], want["states"][i], f"{err} step {i}")


@pytest.mark.parametrize("layout,name", RUNS, ids=[f"{d}x{m}-{n}" for (d, m), n in RUNS])
def test_data_parallel_matches_reference(runs, layout, name):
    """Rank 0's two steps against the reference's jitted steps on the
    global batch: metrics (loss, kl or ce and aux, grad_norm) and the
    state after each step."""
    want = runs["ref"][name]
    got = runs["ranks"][layout][0]["train"][name]
    for i in range(2):
        _close_metrics(got["hist"][i], want["hist"][i], f"{name} step {i}")
        _close_state(got["states"][i], want["states"][i], f"{name} step {i}")
    assert all(np.isfinite(h["grad_norm"]) for h in want["hist"])


@pytest.mark.parametrize("layout,name", [r for r in RUNS if r[1].startswith("moe")],
                         ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_moe_routing_is_the_global_batchs(runs, layout, name):
    """Every MoE dispatch of the first step on every rank routes the global
    batch: the expert ids, the keep mask and the capacity equal the
    unsharded port's on the whole batch, with drops."""
    want = runs["port"][name]["drops"]
    assert any((~k).any() for _, k, _ in want)
    for out in runs["ranks"][layout]:
        got = out["train"][name]["drops"]
        assert len(got) == len(want)
        for (ge, gk, gc), (we, wk, wc) in zip(got, want):
            assert gc == wc
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_array_equal(gk, wk)


def _zero1_floor(monkeypatch):
    monkeypatch.setattr(sharding, "ZERO1_MIN_SIZE", H.DP_ZERO1_MIN)


@pytest.mark.parametrize("layout,name", RUNS, ids=[f"{d}x{m}-{n}" for (d, m), n in RUNS])
def test_moments_hold_the_zero1_slice(runs, monkeypatch, layout, name):
    """A pretraining rank's moments are its data rank's ZeRO-1 slices
    (``zero1_slice`` at the children's size floor) of its model block,
    their bytes the rule's sum; distillation's gate moments stay whole
    (the model block only)."""
    _zero1_floor(monkeypatch)
    cfg, start = runs["setups"][name][1], runs["setups"][name][4]
    n_data, n_model = layout
    pretrain = start.gate is None
    for out in runs["ranks"][layout]:
        _, m_world, d_rank, d_world = out["ranks"]
        assert (d_world, m_world) == layout
        want, n_sliced = {}, 0
        for k, t in start.opt.m.items():
            lay = sharding.param_layout(k, tuple(t.shape), cfg, n_model) if n_model > 1 \
                else None
            local = sharding.local_shape(t.shape, lay, n_model)
            z = sharding.zero1_slice(k, local, cfg, n_data, n_model) if pretrain else None
            if z is not None:
                local = local[:z.axis] + (z.bounds[d_rank][1],) + local[z.axis + 1:]
                n_sliced += 1
            want[k] = local
        got = out["train"][name]
        assert got["moments"] == want
        assert got["moment_bytes"] == sum(4 * math.prod(s) for s in want.values())
        assert (n_sliced > 0) == pretrain


@pytest.mark.parametrize("name", list(OPTIM_CASES))
def test_data_parallel_optimizer(runs, name):
    """``adamw.apply`` over two data ranks with ZeRO-1 moments, each rank
    its partial gradient: the unsharded apply of their sum. The bf16
    compression and the error-feedback residual are bitwise (the
    compression reads the fp32 sum); the parameters and moments within
    1e-6, the norm (summed over the slices) within 1e-5."""
    p_new, p_opt, p_gn = runs["plain_optim"][name]
    ocfg = runs["optim"][name][1]
    assert ocfg.grad_clip == 0 or p_gn > ocfg.grad_clip
    for out in runs["ranks"][2, 1]:
        new, opt, gn = out["optim"][name]
        np.testing.assert_allclose(gn, p_gn, rtol=REL)
        for k, w in p_new.items():
            if ocfg.grad_compression == "bf16":
                assert torch.equal(new[k], w), k
            np.testing.assert_allclose(np32(new[k]), np32(w), atol=1e-6, rtol=0, err_msg=k)
        for field in ("m", "v"):
            for k, w in getattr(p_opt, field).items():
                np.testing.assert_allclose(np32(getattr(opt, field)[k]), np32(w), atol=1e-6,
                                           rtol=1e-5, err_msg=f"{field} {k}")
        if ocfg.grad_compression == "topk_ef":
            assert all(torch.equal(opt.ef[k], t) for k, t in p_opt.ef.items())


def test_zero1_gather_chunks_end_on_every_rank_alike(runs):
    """The parameters' gather in ``adamw.apply`` and the moments' in
    ``gather_state`` at a chunk of ``H.DP_GATHER_CHUNK`` bytes, where the
    owner of a layer holds its whole leaves and the other data rank none:
    every gather takes several collectives, both ranks issue the same
    ones, and the results are bitwise those at the default chunk (one
    collective a gather)."""
    for rank, out in enumerate(runs["ranks"][2, 1]):
        got = out["chunked"]
        calls = got["calls"]
        assert calls["collectives"] > calls["zero1_gather"] > 0, calls
        assert calls == runs["ranks"][2, 1][0]["chunked"]["calls"]
        for name in CHUNKED["train"]:
            a, b = got["train"][name], out["train"][name]
            assert a["hist"] == b["hist"], f"rank {rank} {name}"
            for sa, sb in zip(a["states"], b["states"]):
                for x, y in ((sa.params, sb.params), (sa.opt.m, sb.opt.m),
                             (sa.opt.v, sb.opt.v)):
                    assert all(torch.equal(u, w) for (_, u), (_, w) in
                               zip(t_loop._walk(x), t_loop._walk(y))), f"rank {rank} {name}"
        for name in CHUNKED["optim"]:
            (pa, oa, ga), (pb, ob, gb) = got["optim"][name], out["optim"][name]
            assert ga == gb
            for x, y in ((pa, pb), (oa.m, ob.m), (oa.v, ob.v), (oa.ef, ob.ef)):
                assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


def test_data_parallel_recovery_and_checkpoint(runs):
    """run_training over data 2 with a failure before step 3: every rank
    restores step 2 (the ZeRO-1 slices cut again) and replays it; the
    history and the final state are the unsharded run's; the checkpoint
    world rank 0 wrote is the reference's full layout, read by its restore
    tree for tree, bitwise the gathered final state."""
    (rcfg, rtt), (p_hist, p_state, _) = runs["recover"]
    for out in runs["ranks"][2, 1]:
        hist, state, logs = out["recover"]
        assert [h["step"] for h in hist] == [h["step"] for h in p_hist] == [0, 1, 2, 2, 3]
        assert len(logs) == 1 and "restoring step 2" in logs[0]
        first, replay = (h["loss"] for h in hist if h["step"] == 2)
        assert first == replay
        for got, want in zip(hist, p_hist):
            _close_metrics(got, {k: v for k, v in want.items() if k != "step"},
                           f"step {got['step']}")
        _close_state(state, p_state, "recovered run")
    assert t_loop.ckpt.latest_step(rtt.checkpoint_dir) == 4
    jcfg, _ = cfgs("qwen3_0_6b")
    jt, tt = train_cfgs("pretrain")
    like = jax.device_get(start_states(rcfg, jt, tt)[1])
    tree, meta = j_ckpt.restore(rtt.checkpoint_dir, 4,
                                {"params": like.params, "gate": None, "opt": like.opt})
    assert meta == {"data_step": 4, "seed": rtt.seed}
    back = train_state_from_numpy(like._replace(params=tree["params"], opt=tree["opt"],
                                                step=np.int32(4)), rcfg, "cpu")
    state = runs["ranks"][2, 1][0]["recover"][1]
    for p, t in t_loop._walk(state.params):
        assert torch.equal(dict(t_loop._walk(back.params))[p], t), p
    for field in ("m", "v"):
        assert all(torch.equal(getattr(back.opt, field)[k], t)
                   for k, t in getattr(state.opt, field).items())


def test_batch1_generate_over_the_world(runs):
    """Batch 1 over data 2 x model 1: the caches' sequence splits over the
    two-rank world. Greedy tokens and every selected id list (the sorted
    global block ids of each layer and step) equal the unsharded engine's,
    logits within LOGIT_TOL; both ranks return the same."""
    want = runs["plain_gen"]["batch1"]
    a, b = (out["generate"]["batch1"] for out in runs["ranks"][2, 1])
    cfg = gen_cfg("qwen3_0_6b")
    assert a["cuts"] == b["cuts"] == [(cfg.num_layers, 1, cfg.n_kv_heads, 64 // 2,
                                       cfg.resolved_head_dim)]
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"], want["tokens"])
    assert len(a["logits"]) == len(want["logits"]) == H.DP_GEN_NEW - 1
    for got, w in zip(a["logits"], want["logits"]):
        np.testing.assert_allclose(got, w, atol=LOGIT_TOL, rtol=0)
    n_layers = gen_cfg("qwen3_0_6b").num_layers
    assert len(a["ids"]) == len(want["gate_ids"]) == n_layers * (H.DP_GEN_NEW - 1)
    for got, w in zip(a["ids"], want["gate_ids"]):
        w = np.sort(w, axis=-1)[..., ::-1]
        assert got.shape[-1] >= w.shape[-1]
        np.testing.assert_array_equal(got[..., :w.shape[-1]], w)
        assert (got[..., w.shape[-1]:] == -1).all()
    for x, y in zip(a["ids"], b["ids"]):
        np.testing.assert_array_equal(x, y)


def test_moe_rows_over_data_keep_the_global_routing(runs):
    """deepseek_moe_16b at its published router, a batch of 4 over data 2:
    each replica decodes its two rows, routing as the whole batch would,
    and both ranks return the unsharded engine's tokens. The control: two
    independent engines on the halves give other tokens (the experts'
    capacity couples the rows)."""
    want = runs["plain_gen"]["moe-rows"]
    for out in runs["ranks"][2, 1]:
        got = out["generate"]["moe-rows"]
        cfg = gen_cfg("deepseek_moe_16b")      # two rows, the sequence whole (model 1)
        assert got["cuts"] == [(cfg.num_layers, 2, cfg.n_kv_heads, 64,
                                cfg.resolved_head_dim)]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["final_len"], want["final_len"])
    assert (want["halves"] != want["tokens"]).any()


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mode", [("qwen3_0_6b", "distill"), ("qwen3_0_6b", "pretrain"),
                                       ("deepseek_moe_16b", "pretrain")])
def test_one_rank_data_axis_is_bitwise(tmp_path, monkeypatch, arch, mode):
    """data 1 x model 1: two steps (no ZeRO-1 slice and no gradient
    all-reduce on a one-rank data group) bitwise the unsharded port's,
    metrics too."""
    _zero1_floor(monkeypatch)
    _, cfg = cfgs(arch)
    _, tt = train_cfgs(mode)
    start = t_loop.init_train_state(torch.Generator().manual_seed(0), cfg, tt)
    plain = H.dp_train_case(None, None, cfg, tt, start)
    with H.one_rank_group(tmp_path / "store"):
        shard, data = sharding.data_model_shards(1, 1)
        got = H.dp_train_case(shard, data, cfg, tt, start)
    assert got["hist"] == plain["hist"]
    assert got["moments"] == plain["moments"]       # a one-rank group slices nothing
    for s, p in zip(got["states"], plain["states"]):
        for a, b in ((s.params, p.params), (s.opt.m, p.opt.m), (s.opt.v, p.opt.v)):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(t_loop._walk(a),
                                                                     t_loop._walk(b)))


@pytest.mark.parametrize("batch", [2, 1])
def test_one_rank_generate_is_bitwise(tmp_path, batch):
    """data 1 x model 1: ``generate`` (the rows over the one data rank)
    bitwise the engine with the model group alone, for the dense and the
    MoE model."""
    for arch in ("qwen3_0_6b", "deepseek_moe_16b"):
        cfg = gen_cfg(arch)
        params = get_api(cfg).init_params(torch.Generator().manual_seed(0), cfg)
        toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                 (batch, 21)).astype(np.int32)
        with H.one_rank_group(tmp_path / f"{arch}.store"):
            shard, data = sharding.data_model_shards(1, 1)
            a = H.dp_generate(shard, data, cfg, params, {"tokens": toks})
            b = H.dp_generate(shard, None, cfg, params, {"tokens": toks})
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert all(np.array_equal(x, y) for x, y in zip(a["logits"], b["logits"]))


# ---------------------------------------------------------------------------
# the rules without ranks
# ---------------------------------------------------------------------------

def _spec_axis(spec, ndim, names):
    """The dim of ``spec`` whose entry is one of ``names`` (a name or a
    tuple of them), or None."""
    parts = list(spec) + [None] * (ndim - len(spec))
    for i, p in enumerate(parts):
        if p in names:
            return i
    return None


def _ref_specs(tree):
    return {j_loop._pathstr(kp): s for kp, s in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))}


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_zero1_rule_is_the_references(arch):
    """Every leaf of every config at the 16 x 16 and 2 x 16 x 16 meshes
    (the reference's axis names and sizes on an ``AbstractMesh``): where
    the port's model split is ``param_pspecs``' dim, ``zero1_dim`` of the
    rank's leaf is the dim the reference's ``zero1_param_pspecs`` gives
    the data axes (its stacked leaf's, layer-stack dims first)."""
    jcfg, tcfg = j_configs.get(arch), t_configs.get(arch)
    jp = jax.eval_shape(functools.partial(j_get_api(jcfg).init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    ref_shapes = {j_loop._pathstr(kp): t.shape
                  for kp, t in jax.tree_util.tree_leaves_with_path(jp)}
    with FakeTensorMode(allow_fallback_kernels=False):
        tp = {p: tuple(t.shape) for p, t in t_loop._walk(get_api(tcfg).init_params(
            torch.Generator().manual_seed(0), tcfg))}
    for axes, sizes in ((("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16))):
        mesh = AbstractMesh(sizes, axes)
        dp = axes[:-1]
        n_data = math.prod(sizes[:-1])
        base = _ref_specs(j_shd.param_pspecs(jp, jcfg, mesh))
        zero = _ref_specs(j_shd.zero1_param_pspecs(jp, mesh, jcfg))
        checked = split = 0
        for path, full in tp.items():
            ref = adamw._stacked(path)
            shape = ref_shapes[ref]
            depth = len(shape) - len(full)
            assert tuple(shape[depth:]) == full, path
            lay = sharding.param_layout(path, full, tcfg, 16)
            if _spec_axis(base[ref], len(shape), ("model",)) != (
                    None if lay is None else depth + lay.axis):
                continue
            want = _spec_axis(zero[ref], len(shape), (dp, dp[0]) if len(dp) == 1 else (dp,))
            local = sharding.local_shape(full, lay, 16)
            assert sharding.zero1_dim(path, local, tcfg, n_data, 16) == want, (path, axes)
            checked += 1
            split += want is not None
        assert checked > 0 and split > 0, (arch, axes)


def test_dryrun_carries_the_data_axis(monkeypatch):
    """The dry-run's notes no longer say the data axis is free; a reduced
    train cell on data 2 x model 2 logs the data all-reduce of the
    gradient (and, in pretraining, the parameters' all-gather after the
    ZeRO-1 update, at the children's size floor, with a rank's moments
    smaller); a batch-1 decode cell splits the sequence over the
    four-rank world."""
    _zero1_floor(monkeypatch)
    cfg = t_config.reduced(t_configs.get("qwen3_0_6b"))
    for shape in t_config.SHAPES.values():
        for mesh in ("single", "multi"):
            notes = " ".join(specs.cell_notes(t_configs.get("qwen3_0_6b"), shape,
                                              dryrun.resolve_mesh(mesh)))
            assert "no ZeRO-1" not in notes and "model axis only" not in notes
            assert "no data-parallel" not in notes
    train = t_config.ShapeConfig("train_s", 64, 4, "train")
    rec = dryrun.run_cell(cfg, train, MeshSpec(1, 2, 2), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["collectives_by_axis"]["data"]["all-reduce"] > 0
    hub = t_config.reduced(t_configs.get("hubert_xlarge"))
    local = dryrun.run_cell(hub, train, "local", verbose=False)
    zero = dryrun.run_cell(hub, train, MeshSpec(1, 2, 1), verbose=False)
    assert zero["ok"] and zero["collectives_by_axis"]["data"]["all-gather"] > 0
    assert zero["argument_size_in_bytes"] < local["argument_size_in_bytes"]
    long = t_config.ShapeConfig("long_s", 256, 1, "decode")
    rec = dryrun.run_cell(cfg, long, MeshSpec(1, 2, 2), verbose=False)
    assert rec["ok"] and rec["collectives_by_axis"]["world"]["_count"] > 0
    assert any("pod x data x model (4 ranks)" in n for n in rec["notes"])


def test_launcher_axis_sizes():
    """``--model-parallel M``: the data axis is the rest of the world; the
    default is every rank on the model axis; an M that does not divide
    the world raises."""
    assert t_launch.axis_sizes(4) == (1, 4)
    assert t_launch.axis_sizes(4, 2) == (2, 2)
    assert t_launch.axis_sizes(4, 1) == (4, 1)
    with pytest.raises(ValueError, match="does not divide"):
        t_launch.axis_sizes(4, 3)
