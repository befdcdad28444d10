"""The recurrent families and expert parallelism on a sharded engine: the
port's ``DecodeEngine(..., shard=Shard(group))`` for ``falcon_mamba_7b``
(the Mamba1 LM) and ``zamba2_1_2b`` (the Mamba2 hybrid) at two gloo ranks
on the CPU, against the live unsharded JAX reference and the unsharded
port, with the vision backbone's sequence-sharded ``generate``; and every
family at world size 1 against the unsharded port.

The reference's sharded paths do not run on the installed JAX, and its
contract is stated against its unsharded path, so that is what the port
is held to (as tests/test_torch_sharded.py does). Both families at
``reduced()``, float32, with the reference's parameters through
``convert.params_from_numpy`` (the Mamba1 LM paged at 8-token blocks, the
hybrid at 5 layers: two units and a tail; tests/test_torch_recurrent.py's
cut). A rank holds half the Mamba channels (Mamba1) or heads (Mamba2) of
every mixer and of its per-slot state, half the vocabulary of the
embedding and the logits, and, on the hybrid, half the KV heads of the
shared block's weights, pools and caches and half its MLP's hidden
units.

  * ``serve`` (``torch_sharded_helpers.REC_CASES``): ragged requests,
    preemption through the host swap tier, the hybrid's eviction replay,
    int8 pools, ``split_k=2`` and a bounded host tier over a disk tier
    that the ranks share (every rank's entry the same size, so every rank
    places it alike). Greedy tokens equal to the reference's
    and to the unsharded port's; logits within LOGIT_TOL of both (the
    ranks' partial sums reorder fp32 additions, so not bitwise), the
    int8 run within INT8_TOL of the reference's int8 run; scheduling,
    swap and eviction counters equal to both, the swap bytes summed over
    ranks (the Mamba2 conv windows' replicated ``B|C`` columns counted
    once); the collectives a run makes counted exactly;
  * ``generate``: tokens equal to the reference's, logits within
    LOGIT_TOL (the Mamba1 LM) or SEQ_TOL (the hybrid's shared block takes
    the sequence-sharded step, tests/test_torch_sharded.py's bound);
  * the shapes a rank holds: every mixer leaf and the slot state at
    1 / world of the channels or heads, the ``B|C`` parts whole, and
    every other leaf at ``local_shape`` of its ``param_layout`` block,
    the gate whole;
  * ``llama_3_2_vision_11b`` at ``reduced()``: the sequence-sharded
    ``generate`` over split self and cross blocks (the image K/V at the
    rank's heads), tokens equal to the reference's, logits within
    SEQ_TOL;
  * a world size that does not divide the hybrid's KV heads raises;
  * world size 1 in this process, on a one-rank gloo group: ``serve`` of
    falcon_mamba_7b, zamba2_1_2b, deepseek_moe_16b (expert-parallel, its
    shared experts split) and qwen3_0_6b (the dense model) bitwise the
    unsharded port (tokens, logits, counters), ample and preempting;
    ``generate`` bitwise for the Mamba1 LM, and for the others tokens
    equal and logits within SEQ_TOL (their attention's sequence-sharded
    step is another arithmetic at any world size).

Every rank must return the same results. One ``torch.multiprocessing.spawn``
of two ranks runs every two-rank case (``torch_sharded_helpers.
recurrent_cases``, which imports no JAX) while this process runs the
reference, the unsharded port and the world-size-1 cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.eviction import EvictionConfig as JEviction
from repro.serve.offload import SwapConfig as JSwapConfig
from repro_torch import configs as t_configs
from repro_torch.config import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import (decode_layout, local_shape, param_layout,
                                              state_layouts)
from repro_torch.models import registry as t_registry
from repro_torch.models.mamba import _m2_dims
from repro_torch.models.transformer import layer_order
from repro_torch.train.loop import _walk

jax.config.update("jax_platform_name", "cpu")

WORLD = 2
ARCHS = ("falcon_mamba_7b", "zamba2_1_2b")
VISION = "llama_3_2_vision_11b"
LOGIT_TOL = 1e-4          # tests/test_torch_recurrent.py
INT8_TOL = 1e-3           # tests/test_torch_quant.py: port int8 vs reference int8
# the two-rank int8 serve: the ranks' partial sums move the K/V that reach
# the quantizer by fp32 rounding, enough to move an int8 code by one step
# where an entry lies on a rounding boundary (on these inputs once, from
# rid 0's first decode step: 1.0e-3 from the reference's int8 logits, a
# tenth of the reference's own int8-vs-fp difference, 1.1e-2 to 2.2e-2 by
# request); the world-size-1 int8 serve is held bitwise
INT8_SHARD_TOL = 2 * INT8_TOL
SEQ_TOL = 1e-3            # tests/test_torch_sharded.py: the sequence-sharded step
# the world-size-1 serves: case -> arch
ONE_RANK = {"falcon": "falcon_mamba_7b", "zamba2": "zamba2_1_2b",
            "zamba2-int8": "zamba2_1_2b", "deepseek": "deepseek_moe_16b",
            "qwen3": "qwen3_0_6b"}
COUNTERS = ("preemptions", "resumed", "decode_steps", "peak_pages_used",
            "swapped_out_bytes", "swapped_in_bytes", "evictions", "page_restores",
            "replay_steps", "errors", "admitted", "retired", "failed")


def _small(arch):
    """(reference cfg, port cfg) of tests/test_torch_recurrent.py's cut."""
    out = []
    for get, reduce in ((j_configs.get, j_reduced), (t_configs.get, t_reduced)):
        cfg = reduce(get(arch), **({"num_layers": 5} if arch == "zamba2_1_2b" else {}))
        cfg = cfg.replace(dtype="float32")
        if cfg.family == "ssm":
            cfg = cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=8))
        out.append(cfg)
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _reference_serve(engines, jcfg, params, name, disk_dir):
    """The reference's run of a REC_CASES serve (a split-K case: its fp
    run), on one engine a (model, quantize) pair, so that its compiled
    steps are shared; a bounded swap tier's disk tier in ``disk_dir``."""
    _, opt_kw, serve_kw = H.REC_CASES[name]
    quant = opt_kw.get("quantize")
    if (jcfg.arch_id, quant) not in engines:
        engines[jcfg.arch_id, quant] = JaxEngine(jcfg, params, max_len=64,
                                                 options=JP.DecodeOptions(quantize=quant))
    serve_kw = dict(serve_kw)
    if "eviction" in serve_kw:
        serve_kw["eviction"] = JEviction(**dataclasses.asdict(serve_kw["eviction"]))
    if "swap_config" in serve_kw:
        serve_kw["swap_config"] = JSwapConfig(**dict(
            dataclasses.asdict(serve_kw["swap_config"]), disk_dir=disk_dir))
    reqs = H.rec_requests(jcfg.vocab_size, H.REC_SPECS)
    return engines[jcfg.arch_id, quant].serve([dict(r) for r in reqs], collect_logits=True,
                                              **serve_kw)


def _reference_generate(engines, jcfg, params):
    if (jcfg.arch_id, None) not in engines:
        engines[jcfg.arch_id, None] = JaxEngine(jcfg, params, max_len=64)
    eng = engines[jcfg.arch_id, None]
    tok, st = eng.prefill({k: jnp.asarray(v) for k, v in H.rec_batch(jcfg).items()})
    tks, lgs = [np.asarray(tok)], []
    for _ in range(H.REC_GEN_NEW - 1):
        tok, lg, st, _ = eng._step(eng.params, st, tok)
        tks.append(np.asarray(tok))
        lgs.append(np.asarray(lg, np.float32))
    return {"tokens": np.stack(tks, axis=1), "logits": np.stack(lgs)}


def _one_rank_cfg(arch):
    """The port-initialised models of the world-size-1 cases."""
    return t_reduced(t_configs.get(arch)).replace(dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The file's torch work on one intra-op thread: its shapes are tiny,
    and idle intra-op threads spin against the spawned ranks."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two-rank spawn; computes the reference's runs, the
    unsharded port's and the world-size-1 cases while it works; joins it."""
    tmp = tmp_path_factory.mktemp("sharded_recurrent")
    models, jax_models = {}, {}
    for arch in ARCHS + (VISION,):
        jcfg, tcfg = _small(arch)
        # jitted: one compile in place of the initialiser's op-by-op ones
        params = jax.jit(lambda k, c=jcfg: get_api(c).init_params(k, c))(
            jax.random.PRNGKey(0))
        jax_models[arch] = (jcfg, params)
        models[arch] = (tcfg, jax.device_get(params))
    ctx = mp.spawn(H.run, args=(WORLD, str(tmp / "rec.store"), "recurrent",
                                (models, str(tmp / "disk")), str(tmp)),
                   nprocs=WORLD, join=False)
    try:
        tparams = {a: params_from_numpy(p, cfg, "cpu") for a, (cfg, p) in models.items()}
        port = {name: H.rec_serve(None, models[arch][0], tparams[arch], name,
                                  str(tmp / "port-disk"))
                for name, (arch, *_) in H.REC_CASES.items()}
        engines = {}
        ref = {name: _reference_serve(engines, *jax_models[arch], name, str(tmp / "jax-disk"))
               for name, (arch, *_) in H.REC_CASES.items() if not name.endswith("split2")}
        ref["zamba2-split2"] = ref["zamba2"]
        for arch in ARCHS + (VISION,):
            port[arch, "generate"] = H.rec_generate(None, models[arch][0], tparams[arch])
            ref[arch, "generate"] = _reference_generate(engines, *jax_models[arch])
        for arch in {ONE_RANK[name] for name in H.ONE_RANK_CASES}:
            cfg = _one_rank_cfg(arch)
            models[arch] = (cfg, None)
            tparams[arch] = t_registry.get_api(cfg).init_params(
                torch.Generator().manual_seed(0), cfg)
        one, alone = {}, {}
        with H.one_rank_group(tmp / "one.store") as shard:
            H._count_collectives(shard)
            for name, arch in ONE_RANK.items():
                cfg, p = models[arch][0], tparams[arch]
                if name in H.ONE_RANK_CASES:
                    alone[name] = H.rec_serve(None, cfg, p, name)
                    alone[arch, "generate"] = H.rec_generate(None, cfg, p)
                one[name] = H.rec_serve(shard, cfg, p, name)
                if (arch, "generate") not in one:
                    one[arch, "generate"] = H.rec_generate(shard, cfg, p)
    finally:
        H.join(ctx, str(tmp), "recurrent")
    sharded = [torch.load(tmp / f"recurrent-{r}.pt", weights_only=False)
               for r in range(WORLD)]
    return {"models": models, "port": port, "ref": ref, "sharded": sharded, "one": one,
            "alone": alone}


def _same_on_every_rank(a, b):
    """Two ranks' results of one serve or generate, equal bitwise."""
    if "stats" in a:
        assert a["tokens"] == b["tokens"] and a["stats"] == b["stats"]
        for rid in a["logits"]:
            np.testing.assert_array_equal(a["logits"][rid], b["logits"][rid])
    else:
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["logits"], b["logits"])


@pytest.mark.parametrize("case", list(H.REC_CASES))
def test_sharded_recurrent_serve_matches_unsharded(runs, case):
    arch = H.REC_CASES[case][0]
    cfg = runs["models"][arch][0]
    got, other = (r[case] for r in runs["sharded"])
    _same_on_every_rank(got, other)
    want, twin = runs["ref"][case], runs["port"][case]
    tol = INT8_SHARD_TOL if "int8" in case else LOGIT_TOL
    reqs = H.rec_requests(cfg.vocab_size, H.REC_SPECS)
    for r in reqs:
        rid = r["rid"]
        assert got["tokens"][rid] == want[rid] == twin["tokens"][rid], f"rid {rid} tokens"
        assert len(got["tokens"][rid]) == r["max_new_tokens"]
        np.testing.assert_allclose(got["logits"][rid], want["logits"][rid], atol=tol, rtol=0)
        np.testing.assert_allclose(got["logits"][rid], twin["logits"][rid], atol=tol, rtol=0)
    print(f"{case}: max |sharded - JAX| logit " + "%.2e" % max(
        float(np.abs(got["logits"][r["rid"]] - want["logits"][r["rid"]]).max())
        for r in reqs))
    for key in COUNTERS:
        assert got["stats"][key] == twin["stats"][key], key
        if key in want["stats"]:
            assert got["stats"][key] == want["stats"][key], key
    st = got["stats"]
    assert st["preemptions"] > 0 and st["resumed"] == st["preemptions"]
    assert st["swapped_out_bytes"] == st["swapped_in_bytes"] > 0
    if "evict" in case:
        assert st["evictions"] > 0
    if "disk" in case:
        # every rank's entry went to the disk tier and came back from it
        sw = st["swap"]
        assert sw["promotions"] == st["resumed"] and sw["peak_host_bytes"] == 0
        assert sw["peak_disk_bytes"] > 0 and sw["disk_bytes"] == 0 and st["failed"] == 0
    # at every prefill, decode step and replayed attempt: two all_sums a
    # Mamba layer (x_proj and out_proj, or the gated norm and out_proj),
    # two a shared-block call (after wo and the MLP), one for the
    # vocabulary-split embedding and one gather of the logits; one gather
    # of the selected ids a shared-block call of a paged step (the
    # telemetry reads them); one all_sum for the stats
    steps = st["decode_steps"] + st["replay_steps"]
    runs_of_layers = steps + st["admitted"]
    n_units = t_registry.get_api(cfg).paged_attn_layers(cfg)
    assert got["collectives"] == {
        "all_sum": (2 * cfg.num_layers + 2 * n_units + 1) * runs_of_layers + 1,
        "all_gather": runs_of_layers + n_units * steps, "all_max": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_recurrent_generate_matches_unsharded(runs, arch):
    cfg = runs["models"][arch][0]
    got, other = (r[arch, "generate"] for r in runs["sharded"])
    _same_on_every_rank(got, other)
    want, twin = runs["ref"][arch, "generate"], runs["port"][arch, "generate"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["tokens"], twin["tokens"])
    tol = LOGIT_TOL if arch == "falcon_mamba_7b" else SEQ_TOL
    np.testing.assert_allclose(got["logits"], want["logits"], atol=tol, rtol=0)
    print(f"{arch} generate: max |sharded - JAX| logit "
          f"{float(np.abs(got['logits'] - want['logits']).max()):.2e}")
    # the prefill and every decode step: two all_sums a Mamba layer
    assert got["collectives"]["all_sum"] >= 2 * cfg.num_layers * H.REC_GEN_NEW


def _rank_leaves_match(leaves, full, cfg):
    """Every leaf of a rank's engine at ``local_shape`` of its
    ``param_layout`` block (``decode_layout``), the gate's ``wq``/``wk``
    whole; returns the paths that split."""
    assert leaves.keys() == full.keys()
    split = []
    for path, shape in full.items():
        lay = decode_layout(path, shape, cfg, WORLD)
        assert lay == (None if "/gate/" in path else param_layout(path, shape, cfg, WORLD))
        assert leaves[path] == local_shape(shape, lay, WORLD), path
        if lay is not None:
            split.append(path)
    return split


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_holds_its_channels_and_heads(runs, arch):
    """Every mixer leaf of the engine at its rank's block (1 / world of the
    channels or heads, Mamba2's ``B|C`` parts whole), every other leaf at
    its ``param_layout`` block (the hybrid's shared block by KV heads and
    hidden units, the vocabulary), the gate whole, and a 3-slot state at
    the same split."""
    cfg = runs["models"][arch][0]
    full = {p: tuple(t.shape) for p, t in _walk(params_from_numpy(
        runs["models"][arch][1], cfg, "cpu"))}
    n = cfg.ssm.state_dim
    for r, rank in enumerate(runs["sharded"]):
        got = rank[arch, "shapes"]
        split = _rank_leaves_match(got["leaves"], full, cfg)
        # every mixer leaf splits, and the vocabulary
        assert {p for p in full if "/mixer/" in p} <= set(split) and "embed/w" in split
        if arch == "zamba2_1_2b":
            assert {"shared_attn/attn/wq/w", "shared_attn/attn/wo/w",
                    "shared_attn/mlp/wo/w"} <= set(split)
        conv, h = got["state"]
        if arch == "falcon_mamba_7b":
            di = cfg.ssm.expand * cfg.d_model
            assert conv[-1] == di // WORLD and h[2] == di // WORLD
            assert got["leaves"]["blocks/0/mixer/in_proj/w"] == (cfg.d_model, di)
        else:
            di, hd, nh, _ = _m2_dims(cfg)
            assert conv[-1] == di // WORLD + 2 * n and h[2:] == (nh // WORLD, hd, n)
            assert got["leaves"]["units/0/0/mixer/conv_w"] == (cfg.ssm.conv_dim,
                                                               di // WORLD + 2 * n)
        layouts = state_layouts(cfg, WORLD)
        st = t_registry.get_api(cfg).init_slot_state(cfg, 3, device="meta")
        assert (conv, h) == tuple(local_shape(t.shape, lay, WORLD)
                                  for t, lay in zip(st, layouts))


def tf_layers(cfg):
    """(self layers, cross layers) of a cross-attention model."""
    kinds = [kind for kind, _ in layer_order(cfg)]
    return kinds.count("self"), kinds.count("cross")


def test_sharded_vision_generate_matches_reference(runs):
    """The vision backbone's sequence-sharded ``generate`` at two ranks:
    its self and cross blocks at the rank's block of the weights (the
    image K/V at the rank's heads), tokens equal to the reference's and
    to the unsharded port's, logits within SEQ_TOL; every rank alike."""
    cfg = runs["models"][VISION][0]
    got, other = (r[VISION, "generate"] for r in runs["sharded"])
    _same_on_every_rank(got, other)
    want, twin = runs["ref"][VISION, "generate"], runs["port"][VISION, "generate"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["tokens"], twin["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], atol=SEQ_TOL, rtol=0)
    print(f"{VISION} generate: max |sharded - JAX| logit "
          f"{float(np.abs(got['logits'] - want['logits']).max()):.2e}")
    full = {p: tuple(t.shape) for p, t in _walk(params_from_numpy(
        runs["models"][VISION][1], cfg, "cpu"))}
    for rank in runs["sharded"]:
        split = _rank_leaves_match(rank[VISION, "shapes"]["leaves"], full, cfg)
        assert {"cross_blocks/0/attn/wk/w", "cross_blocks/0/attn/wo/w",
                "cross_blocks/0/mlp/wi_up/w", "blocks/0/attn/wq/w"} <= set(split)
    # the prefill: the embedding's sum, two sums a layer (after wo and the
    # MLP), the logits' gather; the cut to the sequence: one gather a self
    # layer; a step: the embedding's sum and the logits' gather, a self
    # layer's q/k/v gather, the budget gate's candidate gather (the
    # threshold's max and sum), the combine's max and three sums and its
    # two sums, a cross layer's two sums
    n_self, n_cross = tf_layers(cfg)
    steps, budget = H.REC_GEN_NEW - 1, cfg.gate.method != "threshold"
    assert got["collectives"] == {
        "all_sum": 1 + 2 * (n_self + n_cross)
        + steps * (1 + n_self * (5 + (not budget)) + 2 * n_cross),
        "all_gather": 1 + n_self + steps * (1 + n_self * (1 + budget)),
        "all_max": steps * n_self * (1 + (not budget))}


def test_world_size_not_dividing_hybrid_heads_raises(runs):
    for rank in runs["sharded"]:
        assert rank["odd_heads"] is not None and "not divisible" in rank["odd_heads"]


@pytest.mark.parametrize("case", list(ONE_RANK))
def test_one_rank_is_the_unsharded_port_bitwise(runs, case):
    """World size 1 in process: a preempting serve bitwise the unsharded
    port's (tokens, logits, counters), fp pools and the hybrid's int8
    pools; generate bitwise for the Mamba1 LM, tokens equal and logits
    within SEQ_TOL where the shared or self attention takes the
    sequence-sharded step."""
    arch = ONE_RANK[case]
    got = runs["one"][case]
    want = (runs["alone"] if case in H.ONE_RANK_CASES else runs["port"])[case]
    assert got["tokens"] == want["tokens"]
    for rid in want["logits"]:
        np.testing.assert_array_equal(got["logits"][rid], want["logits"][rid])
    assert got["stats"] == want["stats"] and got["stats"]["preemptions"] > 0
    # the collectives ran: the Mamba layers' sums beside the stats' one,
    # or the MoE layers' expert gathers
    if arch == "deepseek_moe_16b":
        assert got["collectives"]["all_gather"] > 0
    else:
        assert got["collectives"]["all_sum"] > 1
    if case == "zamba2-int8":
        return
    got = runs["one"][arch, "generate"]
    alone = arch in {ONE_RANK[name] for name in H.ONE_RANK_CASES}
    want = (runs["alone"] if alone else runs["port"])[arch, "generate"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    if arch == "falcon_mamba_7b":
        np.testing.assert_array_equal(got["logits"], want["logits"])
    else:
        np.testing.assert_allclose(got["logits"], want["logits"], atol=SEQ_TOL, rtol=0)
