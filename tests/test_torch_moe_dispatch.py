"""The MoE's expert dispatch as the reference shards it, on a data 2 x
model 2 gloo world: the default ``"gspmd"`` dispatch with the capacity's
slots split over data, and the reference's ``moe_mlp_sharded`` bodies
(``dispatch="shard_map"``: large T, decode-size T, EP-major).

One ``torch.multiprocessing.spawn`` of four ranks (rank ``d*2 + m``)
runs every two-axis case (``torch_sharded_helpers.dispatch_cases``)
while the reference's sharded calls run live in one subprocess on four
forced host devices (tests/torch_moe_reference.py, a (data 2, model 2)
mesh of Auto axes) and this process runs the reference's single-device
calls and the world-size-1 cases. Float32 throughout.

  * each ``shard_map`` body against the reference's sharded call on the
    same rows and parameters (E 8, top 2, d 32, one shared expert): y,
    the router loss, dx and every parameter's gradient of ``sum(y * r) +
    aux`` within 1e-5. At ``capacity_factor`` 1.25 the capacity is each
    shard's rows' and binds, so the reference's sharded call is another
    function than its single-device one (asserted); at 8.0 it binds
    nowhere and both equal the single-device call;
  * the default dispatch over data: the same layer against the
    reference's single-device call, each replica's expert buffer at
    ``[E / M, ceil(C / D), d]`` and the collectives counted exactly; a
    reduced deepseek_moe_16b distill and pretrain step over the four
    ranks against the reference's jitted steps on the global batch
    (tests/test_torch_data_parallel.py's tolerances), and its
    ``generate`` at the published router (E 64, top 6, capacity 1.25)
    against the reference's: tokens exact, logits within LOGIT_TOL;
  * the ``shard_map`` bodies and the EP-major layout (the rows over data
    x model, only the experts and the logits split) through training
    (distill and pretrain) and ``generate``, at capacity 8.0, where no
    shard's capacity binds, against the reference's single-device runs;
  * world size 1 on both axes: every body bitwise the unsharded port.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.configs as j_configs
import torch_moe_reference as R
import torch_sharded_helpers as H
from repro.config import OptimConfig as JOptim
from repro.config import TrainConfig as JTrain
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.train import loop as j_loop
from repro.optim import adamw as j_adamw
from repro_torch import config as t_config
from repro_torch import configs as t_configs
from repro_torch.config import MoEConfig
from repro_torch.convert import stack_layers, train_state_from_numpy
from repro_torch.core.policy import DecodeOptions, DensePolicy
from repro_torch.distributed import sharding
from repro_torch.models import moe
from repro_torch.models.registry import get_api
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 1e-5
LOGIT_TOL = 1e-4
# tests/test_torch_data_parallel.py's training tolerances and optimizer
REL, PARAM_ATOL, MOM_ATOL, MOM_RTOL = 1e-5, 1e-5, 1e-6, 1e-4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.01, eps=1e-4)
D, M = R.MESH
GSPMD = "gspmd-1.25"          # the default dispatch on large-1.25's rows
# the model-level cases: name -> (mode, capacity factor, dispatch, EP-major);
# at 8.0 no shard's capacity binds, so the sharded bodies are the
# single-device function and are held to the reference's single-device run
TRAIN = {"distill": ("distill", 1.0, "gspmd", False),
         "pretrain": ("pretrain", 1.0, "gspmd", False),
         "sm-pretrain": ("pretrain", 8.0, "shard_map", False),
         "ep-distill": ("distill", 8.0, "shard_map", True),
         "ep-pretrain": ("pretrain", 8.0, "shard_map", True)}
GEN = {"gspmd": (1.25, "gspmd", False), "sm": (8.0, "shard_map", False),
       "ep": (8.0, "shard_map", True)}
GEN_SHAPE, GEN_NEW = (4, 24), H.DP_GEN_NEW


def layer_cfg(cf, dispatch="gspmd"):
    return MoEConfig(n_experts=R.N_EXPERTS, top_k=R.TOP_K, n_shared_experts=R.N_SHARED,
                     expert_d_ff=R.D_FF, capacity_factor=cf, dispatch=dispatch)


def layer_inputs():
    """The MoE layer's parameters and every case's rows and cotangent, from
    numpy seeds, in the reference's ``init_moe`` scales."""
    rng = np.random.default_rng(0)
    e, d, f = R.N_EXPERTS, R.D_MODEL, R.D_FF

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)
    params = {"router/w": normal((d, e), d), "wi_gate": normal((e, d, f), d),
              "wi_up": normal((e, d, f), d), "wo": normal((e, f, d), f),
              "shared/wi_gate/w": normal((d, f), d), "shared/wi_up/w": normal((d, f), d),
              "shared/wo/w": normal((f, d), f)}
    rows = {}
    for name, (t, _, _) in R.CASES.items():
        rows[name] = (rng.standard_normal((t, d)).astype(np.float32),
                      rng.standard_normal((t, d)).astype(np.float32))
    return params, rows


def model_cfgs(cf, dispatch="gspmd", ep=False):
    """Reduced deepseek_moe_16b in both packages at capacity ``cf`` (1.0
    drops), the port's at ``dispatch`` and EP-major or not."""
    jcfg = j_reduced(j_configs.get("deepseek_moe_16b")).replace(dtype="float32")
    tcfg = t_config.reduced(t_configs.get("deepseek_moe_16b")).replace(dtype="float32")
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf,
                                                 dispatch=dispatch), ep_major=ep))


def train_cfgs(mode):
    base = dict(mode=mode, seq_len=H.DP_L, global_batch=H.DP_B, steps=2, checkpoint_every=2,
                log_every=0)
    return (JTrain(optim=JOptim(**OPT), **base),
            t_config.TrainConfig(optim=t_config.OptimConfig(**OPT), **base))


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.array(tree.numpy(), copy=True)


def gen_cfg(cf=1.25, dispatch="gspmd", ep=False):
    """deepseek_moe_16b reduced at its published router (E 64, top 6; at
    capacity 1.25 decode rows compete for the experts' slots)."""
    cfg = t_config.reduced(t_configs.get("deepseek_moe_16b")).replace(dtype="float32")
    m = t_configs.get("deepseek_moe_16b").moe
    return cfg.replace(moe=MoEConfig(n_experts=m.n_experts, top_k=m.top_k,
                                     n_shared_experts=m.n_shared_experts, expert_d_ff=64,
                                     capacity_factor=cf, dispatch=dispatch), ep_major=ep)


def _reference_generate(cfg, params, toks):
    jcfg = j_reduced(j_configs.get("deepseek_moe_16b")).replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **{
        f.name: getattr(cfg.moe, f.name) for f in dataclasses.fields(cfg.moe)
        if f.name != "dispatch"}))
    eng = JaxEngine(jcfg, to_jax(stack_layers(params, cfg)), max_len=64,
                    options=JP.DecodeOptions(policy=JP.DensePolicy()))
    tok, st = eng.prefill({"tokens": jnp.asarray(toks)})
    tks, lgs = [np.asarray(tok)], []
    for _ in range(GEN_NEW - 1):
        tok, lg, st, _ = eng._step(eng.params, st, tok)
        tks.append(np.asarray(tok))
        lgs.append(np.asarray(lg, np.float32))
    return {"tokens": np.stack(tks, axis=1), "logits": lgs}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the reference's sharded subprocess and the four-rank spawn,
    computes the reference's single-device runs and the world-size-1
    cases while they work, then joins both."""
    tmp = tmp_path_factory.mktemp("moe_dispatch")
    params, rows = layer_inputs()
    np.savez(tmp / "ref_in.npz", **{f"p/{k}": v for k, v in params.items()},
             **{f"x/{n}": x for n, (x, _) in rows.items()},
             **{f"r/{n}": r for n, (_, r) in rows.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref_proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_moe_reference.py"),
                                 str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    layers = {name: (layer_cfg(cf, "shard_map"), *rows[name], ep)
              for name, (_, cf, ep) in R.CASES.items()}
    layers[GSPMD] = (layer_cfg(1.25), *rows["large-1.25"], False)
    train, jstarts = {}, {}
    for name, (mode, cf, dispatch, ep) in TRAIN.items():
        jcfg, tcfg = model_cfgs(cf, dispatch, ep)
        jt, tt = train_cfgs(mode)
        start = t_loop.init_train_state(torch.Generator().manual_seed(0), tcfg, tt)
        if (mode, cf) not in jstarts:
            jp = to_jax(stack_layers(start.params, tcfg))
            gate = j_loop.extract_gate(jp) if mode == "distill" else None
            jstarts[mode, cf] = (jcfg, jt, j_loop.TrainState(jp, gate, j_adamw.init(
                gate if gate is not None else jp, jt.optim), jnp.zeros((), jnp.int32)))
        train[name] = (tcfg, tt, start)
    gcfgs = {name: gen_cfg(*case) for name, case in GEN.items()}
    gparams = get_api(gcfgs["gspmd"]).init_params(torch.Generator().manual_seed(0),
                                                  gcfgs["gspmd"])
    toks = np.random.default_rng(3).integers(0, gcfgs["gspmd"].vocab_size,
                                             GEN_SHAPE).astype(np.int32)
    dense = DecodeOptions(policy=DensePolicy())
    jobs = {"layers": (params, layers), "train": train,
            "generate": {name: (cfg, gparams, {"tokens": toks}, dense)
                         for name, cfg in gcfgs.items()}}
    os.makedirs(tmp / "ranks")
    ctx = mp.spawn(H.run, args=(D * M, str(tmp / "dispatch.store"), "dispatch", (jobs,),
                                str(tmp / "ranks")), nprocs=D * M, join=False)
    try:
        ref_train = {}
        for key, (jcfg, jt, jstate) in jstarts.items():
            tcfg = train[next(n for n, c in TRAIN.items() if (c[0], c[1]) == key)][0]
            step, states, hist = jax.jit(j_loop.make_train_step(jcfg, jt)), [], []
            for i in range(2):
                jstate, m = step(jstate, {k: jnp.asarray(v.numpy())
                                          for k, v in H.dp_batch(tcfg, i).items()})
                hist.append({k: float(v) for k, v in m.items()})
                states.append(train_state_from_numpy(jax.device_get(jstate), tcfg, "cpu"))
            ref_train[key] = {"hist": hist, "states": states}
        ref_gen = {cf: _reference_generate(gen_cfg(cf), gparams, toks) for cf in (1.25, 8.0)}
        plain_gen = H.dp_generate(None, None, gcfgs["gspmd"], gparams, {"tokens": toks},
                                  GEN_NEW, options=dense)
        one = world_one_cases(tmp, params, rows)
    finally:
        H.join(ctx, str(tmp / "ranks"), "dispatch")
        out, _ = ref_proc.communicate(timeout=600)
    assert ref_proc.returncode == 0, out
    ranks = [torch.load(tmp / "ranks" / f"dispatch-{r}.pt", weights_only=False)
             for r in range(D * M)]
    return {"params": params, "rows": rows, "ref": dict(np.load(tmp / "ref_out.npz")),
            "ranks": ranks, "ref_train": ref_train, "ref_gen": ref_gen,
            "plain_gen": plain_gen, "one": one, "gen_cfgs": gcfgs,
            "tcfgs": {n: c[0] for n, c in train.items()}}


def _one_layer(np_params, x, r, mcfg, **kw):
    """y, aux, dx and the gradients of ``sum(y * r) + aux`` for one call."""
    p = H._fresh({"router": {"w": torch.tensor(np_params["router/w"])},
                  **{n: torch.tensor(np_params[n]) for n in ("wi_gate", "wi_up", "wo")},
                  "shared": {n: {"w": torch.tensor(np_params[f"shared/{n}/w"])}
                             for n in ("wi_gate", "wi_up", "wo")}})
    xr = torch.tensor(x).requires_grad_(True)
    y, aux = moe.moe_mlp(p, xr, mcfg, **kw)
    ((y * torch.tensor(r)).sum() + aux).backward()
    with torch.no_grad():
        yg, _ = moe.moe_mlp(p, xr, mcfg, gather=True, **kw)
    return {"y": y.detach(), "aux": aux.detach(), "dx": xr.grad, "yg": yg,
            "grads": {k: v.grad for k, v in H.tl._walk(p)}}


def world_one_cases(tmp, params, rows):
    """Every body on a one-rank data and model group (rows that take each
    branch, and the decode-size branch at 2 rows), with the unsharded
    call beside it."""
    out = {}
    with H.one_rank_group(tmp / "one.store"):
        shard, data = sharding.data_model_shards(1, 1)
        for name, (x, r) in list(rows.items()) + [("decode-2", (rows["decode-1.25"][0][:2],
                                                              rows["decode-1.25"][1][:2]))]:
            cf = 1.25 if name == "decode-2" else R.CASES[name][1]
            for dispatch, ep in (("gspmd", False), ("shard_map", False), ("shard_map", True)):
                mcfg = layer_cfg(cf, dispatch)
                mshard = shard.as_ep_major() if ep else shard
                got = _one_layer(params, x, r, mcfg, shard=mshard, data=data)
                got["branch"] = moe.dispatch_branch(len(x), mcfg, mshard)
                out[name, dispatch, ep] = (got, _one_layer(params, x, r, layer_cfg(cf)))
    return out


def _rank(runs, d, m):
    return runs["ranks"][d * M + m]


def _assemble(runs, name, ep):
    """The ranks' results of one layer case as the reference's whole
    arrays: y and dx over every row, each gradient summed over the ranks
    that computed a share of it and concatenated over the blocks."""
    ranks = [_rank(runs, d, m)["layers"][name] for d in range(D) for m in range(M)]
    if ep:
        y = np.concatenate([c["y"] for c in ranks])
        dx = np.concatenate([c["dx"] for c in ranks])
    else:
        y = np.concatenate([_rank(runs, d, 0)["layers"][name]["y"] for d in range(D)])
        dx = np.concatenate([_rank(runs, d, 0)["layers"][name]["dx"] for d in range(D)])
    grads = {}
    for k in ranks[0]["grads"]:
        by_m = [sum(_rank(runs, d, m)["layers"][name]["grads"][k] for d in range(D))
                for m in range(M)]
        if k in ("wi_gate", "wi_up", "wo"):
            grads[k] = np.concatenate(by_m)
        elif k.startswith("shared/") and not ep:
            grads[k] = np.concatenate(by_m, axis=0 if k == "shared/wo/w" else 1)
        elif ep:
            grads[k] = sum(by_m)
        else:
            grads[k] = by_m[0]
    return y, float(ranks[0]["aux"]), dx, grads, ranks


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def _against(runs, name, tag, ep):
    y, aux, dx, grads, ranks = _assemble(runs, name, ep)
    ref = runs["ref"]
    _close(y, ref[f"{tag}/y"], f"{name} y")
    _close(aux, ref[f"{tag}/aux"], f"{name} aux")
    _close(dx, ref[f"{tag}/dx"], f"{name} dx")
    for k, g in grads.items():
        _close(g, ref[f"{tag}/g/{k}"], f"{name} grad {k}")
    return ranks


@pytest.mark.parametrize("name", list(R.CASES))
def test_shard_map_body_matches_reference(runs, name):
    """Each ``moe_mlp_sharded`` body, taken where the reference takes it,
    against the reference's sharded call: y, aux, dx and every gradient.
    Where the capacity binds (1.25) the shards' local capacities make
    another function than the single-device call; at 8.0 the same."""
    t, cf, ep = R.CASES[name]
    ranks = _against(runs, name, f"sharded/{name}", ep)
    assert {c["branch"] for c in ranks} == {name.split("-")[0]}
    ref = runs["ref"]
    gap = np.abs(ref[f"sharded/{name}/y"] - ref[f"single/{name}/y"]).max()
    if cf == 1.25:
        assert gap > 1e-2, gap
    else:
        assert gap < TOL, gap


def test_shard_map_exchanges(runs):
    """The collectives of each body over forward and backward, per group:
    the large-T body's two dispatch all-to-alls each way and its row
    gather; EP-major's all-to-alls alone on the model group; the
    decode-size body's sums. The router loss's means add one sum per
    group and term (fractions, mass), the test's loss one over its rows'
    group."""
    want = {
        # model: dispatch + return a2a forward and backward (4); sums: the
        # x and router copies' backward (2), the shared experts' forward
        # (1), the loss means (2); the row gather (1)
        "large": {"model": {"all_sum": 5, "all_gather": 1, "all_to_all": 4},
                  "data": {"all_sum": 3, "all_gather": 0, "all_to_all": 0}},
        # model: x and top-weight copies' backward (2), the sum of routed
        # and shared rows (1)
        "decode": {"model": {"all_sum": 3, "all_gather": 0, "all_to_all": 0},
                   "data": {"all_sum": 3, "all_gather": 0, "all_to_all": 0}},
        "ep": {"model": {"all_sum": 2, "all_gather": 0, "all_to_all": 4},
               "data": {"all_sum": 2, "all_gather": 0, "all_to_all": 0}},
    }
    for name in R.CASES:
        branch = name.split("-")[0]
        for c in (_rank(runs, d, m)["layers"][name] for d in range(D) for m in range(M)):
            got = c["exchanges"]
            assert {g: got[g] for g in ("model", "data")} == want[branch], (name, got)
            loss_sums = {"all_sum": 1, "all_gather": 0, "all_to_all": 0}
            assert got["world"] == (loss_sums if branch == "ep" else
                                    {"all_sum": 0, "all_gather": 0, "all_to_all": 0})


def test_gspmd_slot_ranges_match_single_device(runs):
    """The default dispatch over data: routing and drops global, each data
    replica computing its slot range only ([E / M, ceil(C / D), d]), y,
    aux, dx and every gradient within 1e-5 of the reference's
    single-device call; one all-to-all each way over the data group
    forward, and again backward."""
    ranks = _against(runs, GSPMD, "single/large-1.25", False)
    t = R.CASES["large-1.25"][0]
    cap = math.ceil(t * R.TOP_K / R.N_EXPERTS * 1.25)
    for c in ranks:
        assert c["branch"] == "gspmd"
        assert c["buffers"] == [(R.N_EXPERTS // M, -(-cap // D), R.D_MODEL)]
        assert c["exchanges"]["data"] == {"all_sum": 2, "all_gather": 1, "all_to_all": 4}
        assert c["exchanges"]["model"] == {"all_sum": 3, "all_gather": 0, "all_to_all": 0}


def _close_state(got, want, err):
    """tests/test_torch_data_parallel.py's: every parameter and moment."""
    gp, wp = dict(t_loop._walk(got.params)), dict(t_loop._walk(want.params))
    assert gp.keys() == wp.keys(), err
    for p, w in wp.items():
        np.testing.assert_allclose(gp[p].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=f"{err} {p}")
    for field in ("m", "v"):
        g, w = getattr(got.opt, field), getattr(want.opt, field)
        assert g.keys() == w.keys(), err
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), atol=MOM_ATOL,
                                       rtol=MOM_RTOL, err_msg=f"{err} {field} {k}")
    assert int(got.step) == int(want.step)


@pytest.mark.parametrize("name", list(TRAIN))
def test_training_matches_reference(runs, name):
    """A reduced deepseek_moe_16b step over data 2 x model 2 against the
    reference's jitted steps on the global batch: metrics and every
    parameter and moment after each of two steps. The default dispatch at
    capacity 1.0 (it drops), each replica's expert buffers at ceil(C / D)
    slots of the global capacity; the ``shard_map`` bodies and EP-major
    (the rows over data x model, only the experts and the logits split)
    at 8.0, where no shard's capacity binds, so that they compute the
    single-device function: the large-T body's [E / M, M * C_ll, d]
    buffers, EP-major's capacity from a rank's B L / (D M) rows."""
    mode, cf, dispatch, ep = TRAIN[name]
    tcfg, want = runs["tcfgs"][name], runs["ref_train"][mode, cf]
    e, k, e_loc = tcfg.moe.n_experts, tcfg.moe.top_k, tcfg.moe.n_experts // M
    n = H.DP_B * H.DP_L
    if dispatch == "gspmd":
        slots = -(-math.ceil(n * k / e * cf) // D)
    else:
        rows = n // (D * M)           # a model rank's routed rows, either body
        slots = M * math.ceil(rows * k / e * cf)
    for r in runs["ranks"]:
        got = r["train"][name]
        for i in range(2):
            for key in want["hist"][i]:
                np.testing.assert_allclose(got["hist"][i][key], want["hist"][i][key],
                                           rtol=REL, atol=1e-8, err_msg=f"{name} step {i} {key}")
            _close_state(got["states"][i], want["states"][i], f"{name} step {i}")
        assert got["buffers"] and set(got["buffers"]) == {(e_loc, slots, tcfg.d_model)}


@pytest.mark.parametrize("name", list(GEN))
def test_generate_matches_reference(runs, name):
    """``generate`` at batch 4 over data 2 x model 2 (dense attention):
    the reference's tokens exactly and its logits within LOGIT_TOL, on
    every rank. The default dispatch at the published router (capacity
    1.25: two rows a replica, its buffers at ceil(C / D) slots of the
    global capacity of the prefill's and the steps' rows, and the
    unsharded engine's tokens); the ``shard_map`` bodies and EP-major (one
    row a rank) at 8.0, against the reference's run at 8.0."""
    cf, dispatch, ep = GEN[name]
    cfg, want = runs["gen_cfgs"][name], runs["ref_gen"][cf]
    b, l = GEN_SHAPE
    for r in runs["ranks"]:
        got = r["generate"][name]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        n = b // (D * M) if ep else b // D
        at = (r["ranks"][2] if ep else r["ranks"][1]) * n
        assert len(got["logits"]) == len(want["logits"])
        for a, w in zip(got["logits"], want["logits"]):     # the rank's rows
            np.testing.assert_allclose(a, w[at:at + n], rtol=0, atol=LOGIT_TOL)
        assert {s[0] for s in got["buffers"]} == {cfg.moe.n_experts // M}
        if dispatch == "gspmd":
            np.testing.assert_array_equal(got["tokens"], runs["plain_gen"]["tokens"])
            caps = {math.ceil(t * cfg.moe.top_k / cfg.moe.n_experts * cf) for t in (b * l, b)}
            assert {s[1] for s in got["buffers"]} == {-(-c // D) for c in caps}


@pytest.mark.parametrize("name", list(R.CASES) + ["decode-2"])
def test_world_one_is_the_unsharded_port_bitwise(runs, name):
    """data 1 x model 1: the default dispatch (its one-rank exchange), each
    ``shard_map`` body the rows take (the large-T one wherever one model
    rank's rows reach E / k, so ``decode-2``'s two rows take the
    decode-size one) and EP-major, training and decode, bitwise the
    unsharded call."""
    branches = set()
    for dispatch, ep in (("gspmd", False), ("shard_map", False), ("shard_map", True)):
        got, plain = runs["one"][name, dispatch, ep]
        branches.add(got["branch"])
        for k in ("y", "aux", "dx", "yg"):
            assert torch.equal(got[k], plain[k]), (name, dispatch, ep, k)
        for k, g in plain["grads"].items():
            assert torch.equal(got["grads"][k], g), (name, dispatch, ep, k)
    assert branches == {"gspmd", "ep", "decode" if name == "decode-2" else "large"}


def test_shard_map_refuses_experts_the_model_axis_does_not_split():
    """``dispatch="shard_map"`` needs the model axis to divide E (the
    reference asserts it); the EP-major layout needs that dispatch."""
    class Three:
        world, rank, ep_major = 3, 0, False
    with pytest.raises(ValueError, match="do not divide"):
        moe.dispatch_branch(64, layer_cfg(1.25, "shard_map"), Three())
    three = Three()
    three.ep_major = True
    with pytest.raises(ValueError, match="EP-major"):
        moe.dispatch_branch(64, layer_cfg(1.25), three)
