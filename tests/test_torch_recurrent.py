"""The recurrent families of the port against the live JAX reference.

``falcon_mamba_7b`` (the Mamba1 LM, ``repro_torch.models.ssm_lm``:
attention-free, its whole decode state in the per-slot recurrent state)
and ``zamba2_1_2b`` (the Mamba2 hybrid, ``repro_torch.models.hybrid``:
its weight-shared attention block carries the gate) in float32 on the
CPU (the kernels' plain versions), with the reference's weights converted
by ``convert.params_from_numpy`` and numpy-seeded prompts. As in the
reference's tests, the Mamba1 LM's disabled gate keeps block size 64, so
its paging is cut to 8-token pages; the hybrid runs at 5 layers: two
units of 2 Mamba2 layers and the shared block, then a tail layer (an
off-by-one unit would break every step).

- configs equal to the reference's, full and ``reduced()``;
- ``generate``: greedy tokens equal, logits within LOGIT_TOL, and the
  hybrid's selected block ids equal at every unit and step;
- ``serve`` with ragged prompts (bucketed prefill) against the
  reference's same run; the bucketed ``lengths`` prefill against per-row
  unpadded prefill;
- preemption: the tight run bitwise the port's ample run, the swapped
  bytes the reference's (the recurrent rows alone for the Mamba1 LM),
  also through the disk tier; hybrid eviction with restore and replay
  bitwise the ample run; the hybrid's int8 serve against the reference's;
- the refusals mirrored: Quest on the hybrid, a plan-carrying schedule on
  its paged step, Quest on a sharded engine, ``lm_forward``.

Every test that asserts a launch count resets the counters first.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.config import reduced as j_reduced
from repro.core import policy as JP
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.eviction import EvictionConfig as JEviction
from repro_torch import configs as t_configs
from repro_torch.config import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as TP
from repro_torch.distributed.sharding import Shard, shard_params
from repro_torch.kernels import ops as t_ops
from repro_torch.models import hybrid as t_hybrid
from repro_torch.models import registry as t_registry
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig
from repro_torch.serve.offload import SwapConfig
from repro_torch.serve.slotstate import SlotState, read_slot, write_slot

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["falcon_mamba_7b", "zamba2_1_2b"]
LOGIT_TOL = 1e-4
INT8_TOL = 1e-3           # tests/test_torch_quant.py: port int8 vs reference int8
N_STEPS = 6
RAGGED = {"falcon_mamba_7b": [(21, 6), (13, 5), (5, 7)],
          "zamba2_1_2b": [(21, 6), (13, 5), (27, 4)]}
PREEMPT = [(16, 10), (16, 9), (16, 8)]      # 3 slots, 8 pages: preempts


def _small(cfg, reduce, arch, layers):
    cfg = reduce(cfg, **({"num_layers": layers} if layers else {})).replace(dtype="float32")
    if cfg.family == "ssm":
        # the disabled gate keeps block 64; serve pages at the gate block
        cfg = cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=8))
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(arch, layers=None):
    """(reference cfg, its params, port cfg, port params), built once."""
    jcfg = _small(j_configs.get(arch), j_reduced, arch, layers)
    tcfg = _small(t_configs.get(arch), t_reduced, arch, layers)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    params = get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, tcfg, params_from_numpy(jax.device_get(params), tcfg, "cpu")


def _layers(arch):
    """The hybrid at two units of 2 Mamba2 layers and a tail layer."""
    return 5 if arch == "zamba2_1_2b" else None


def _requests(vocab, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, vocab, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(specs)]


def _assert_bitwise(res, ref, reqs):
    for r in reqs:
        rid = r["rid"]
        assert res[rid] == ref[rid], f"rid {rid} tokens"
        np.testing.assert_array_equal(res["logits"][rid], ref["logits"][rid])


def _assert_close(t_res, j_res, reqs, tol):
    for r in reqs:
        rid = r["rid"]
        assert t_res[rid] == j_res[rid], f"rid {rid} tokens"
        np.testing.assert_allclose(np.asarray(t_res["logits"][rid], np.float32),
                                   np.asarray(j_res["logits"][rid], np.float32),
                                   atol=tol, rtol=0)
    for key in ("preemptions", "resumed", "decode_steps", "swapped_out_bytes"):
        assert t_res["stats"][key] == j_res["stats"][key], key


# ---------------------------------------------------------------------------
# configs, trees, the slot state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_config_matches_reference(arch):
    j, t = j_configs.get(arch), t_configs.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t_reduced(t)) == dataclasses.asdict(j_reduced(j))
    assert t_configs.get(arch.replace("_", "-")) == t


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_recurrent_trees(arch):
    """The reference's trees: blocks [L] (Mamba1) or units [n_units,
    period] + shared_attn + tail [rem] (hybrid, two units here) split into
    lists with every leaf equal; in a bf16 tree (the reference's shapes
    and dtypes, from ``jax.eval_shape``) A_log / D / dt_bias stay float32
    through the conversion and in the port's own init, which has the
    reference's shapes and dtypes leaf for leaf."""
    jcfg, params, tcfg, tp = _pair(arch, _layers(arch))
    params = jax.device_get(params)
    if arch == "zamba2_1_2b":
        assert (len(tp["units"]), len(tp["units"][0]), len(tp["tail"])) == (2, 2, 1)
        pairs = [(tp["units"][u][j], jax.tree.map(lambda a: a[u, j], params["units"]))
                 for u in range(2) for j in range(2)]
        pairs += [(tp["tail"][0], jax.tree.map(lambda a: a[0], params["tail"])),
                  (tp["shared_attn"], params["shared_attn"])]
    else:
        assert len(tp["blocks"]) == tcfg.num_layers == 2
        pairs = [(tp["blocks"][i], jax.tree.map(lambda a: a[i], params["blocks"]))
                 for i in range(2)]
    for got, ref in pairs:
        jax.tree.map(lambda g, r: np.testing.assert_array_equal(g.numpy(), np.asarray(r)),
                     got, ref)
    bf_j = j_reduced(j_configs.get(arch), num_layers=5)
    bf_t = t_reduced(t_configs.get(arch), num_layers=5)
    shapes = jax.eval_shape(lambda: get_api(bf_j).init_params(jax.random.PRNGKey(0), bf_j))
    conv = params_from_numpy(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                             bf_t, "cpu")
    own = t_registry.get_api(bf_t).init_params(torch.Generator().manual_seed(0), bf_t)
    first = ((lambda t: t["units"][0][0]) if arch == "zamba2_1_2b"
             else (lambda t: t["blocks"][0]))
    lead = 2 if arch == "zamba2_1_2b" else 1
    ref = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[lead:], a.dtype),
                       shapes["units" if arch == "zamba2_1_2b" else "blocks"])
    for tree in (conv, own):
        jax.tree.map(lambda g, r: (tuple(g.shape), str(g.dtype)[6:]) == (r.shape, str(r.dtype))
                     or pytest.fail(f"{g.shape} {g.dtype} vs {r.shape} {r.dtype}"),
                     first(tree), ref)
        for key in ("A_log", "D", "dt_bias"):
            assert first(tree)["mixer"][key].dtype == torch.float32
        assert first(tree)["mixer"]["in_proj"]["w"].dtype == torch.bfloat16


def test_slot_rows_write_and_read_without_touching_the_input():
    """write_slot returns a new state; read_slot copies; the input stays."""
    st = SlotState(conv=torch.zeros(3, 4, 2, 5), h=torch.zeros(3, 4, 6))
    row = SlotState(conv=torch.ones(3, 2, 5), h=torch.full((3, 6), 2.0))
    new = write_slot(st, row, 2)
    assert float(st.conv.abs().sum()) == 0 and float(st.h.abs().sum()) == 0
    got = read_slot(new, 2)
    assert torch.equal(got.conv, row.conv) and torch.equal(got.h, row.h)
    got.h.fill_(9.0)
    assert float(new.h[:, 2].max()) == 2.0 and float(new.h[:, 1].abs().max()) == 0


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded_ids(monkeypatch):
    """Every GatePolicy.select result of both packages, in call order (the
    reference's out of its compiled steps through an ordered callback)."""
    rec = ([], [])
    j_sel, t_sel = JP.GatePolicy.select, TP.GatePolicy.select

    def j_select(self, inp, cfg, **kw):
        idx = j_sel(self, inp, cfg, **kw)
        jax.debug.callback(lambda x: rec[0].append(np.asarray(x)), idx, ordered=True)
        return idx

    def t_select(self, inp, cfg, **kw):
        idx = t_sel(self, inp, cfg, **kw)
        rec[1].append(idx.numpy().copy())
        return idx

    monkeypatch.setattr(JP.GatePolicy, "select", j_select)
    monkeypatch.setattr(TP.GatePolicy, "select", t_select)
    return rec


def _rollout(eng, toks, to_np):
    tok, st = eng.prefill({"tokens": toks})
    lgs, tks = [], []
    for _ in range(N_STEPS):
        tok, lg, st, _ = eng._step(eng.params, st, tok)
        lgs.append(to_np(lg))
        tks.append(to_np(tok))
    return np.stack(lgs), np.stack(tks), st


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch, recorded_ids):
    """2 x 37 prompt (the hybrid's gate blocks of 8: 4 complete and a
    partial one), N_STEPS decode steps; the hybrid at two units."""
    jcfg, params, tcfg, tparams = _pair(arch, _layers(arch))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    j_lg, j_tk, j_st = _rollout(JaxEngine(jcfg, params, max_len=64), jnp.asarray(toks),
                                lambda x: np.asarray(x, np.float32))
    t_ops.reset_launch_counts()
    t_lg, t_tk, t_st = _rollout(DecodeEngine(tcfg, tparams, max_len=64, device="cpu"), toks,
                                lambda x: x.float().numpy())
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)   # CPU: plain
    np.testing.assert_array_equal(t_tk, j_tk)
    np.testing.assert_allclose(t_lg, j_lg, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(t_st.h.numpy(), np.asarray(j_st.h), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(t_st.cur_len.numpy(), np.asarray(j_st.cur_len))
    j_ids, t_ids = recorded_ids
    n_units = t_hybrid._plan(tcfg)[0] if arch == "zamba2_1_2b" else 0
    assert len(t_ids) == len(j_ids) == n_units * N_STEPS
    for i, (a, b) in enumerate(zip(j_ids, t_ids)):
        np.testing.assert_array_equal(b, a, err_msg=f"select call {i}")
    if n_units:
        np.testing.assert_array_equal(t_st.kg_n.numpy(), np.asarray(j_st.kg_n))
        np.testing.assert_allclose(t_st.kg_cache.numpy(), np.asarray(j_st.kg_cache),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_lengths_bucketing(arch):
    """Right-padded rows with ``lengths`` (the serve path's buckets) give
    each row's unpadded prefill logits, and the reference's bucketed
    prefill's; the states resume from the true lengths."""
    jcfg, params, tcfg, tparams = _pair(arch, _layers(arch))
    lens = (11, 16, 5) if arch == "falcon_mamba_7b" else (21, 32, 13)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                             (len(lens), max(lens))).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    api = t_registry.get_api(tcfg)
    lg_b, st = api.prefill(tparams, {"tokens": torch.tensor(toks),
                                     "lengths": torch.tensor(lens, dtype=torch.int32)},
                           tcfg, 64)
    j_lg, _ = get_api(jcfg).prefill(params, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens, jnp.int32)},
                                    jcfg, 64)
    np.testing.assert_allclose(lg_b.numpy(), np.asarray(j_lg), atol=LOGIT_TOL, rtol=0)
    assert st.cur_len.tolist() == list(lens)
    for i, n in enumerate(lens):
        lg1, st1 = api.prefill(tparams, {"tokens": torch.tensor(toks[i:i + 1, :n])}, tcfg, 64)
        np.testing.assert_allclose(lg_b[i].numpy(), lg1[0].numpy(), atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(st.conv[:, i].numpy(), st1.conv[:, 0].numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _serve_pair(arch, specs, pool, quant=None, n_slots=2, eviction=False):
    """(requests, the reference's serve, the port's) on the same inputs."""
    jcfg, params, tcfg, tparams = _pair(arch, _layers(arch))
    reqs = _requests(jcfg.vocab_size, specs)
    kw = dict(n_slots=n_slots, num_pages=pool, collect_logits=True)
    j_res = JaxEngine(jcfg, params, max_len=64, options=JP.DecodeOptions(quantize=quant)
                      ).serve([dict(r) for r in reqs], **kw,
                              **({"eviction": JEviction()} if eviction else {}))
    t_ops.reset_launch_counts()
    t_res = DecodeEngine(tcfg, tparams, max_len=64, device="cpu",
                         options=TP.DecodeOptions(quantize=quant)
                         ).serve([dict(r) for r in reqs], **kw,
                                 **({"eviction": EvictionConfig()} if eviction else {}))
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)
    return reqs, j_res, t_res


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_ragged_prompts_match_jax(arch):
    """Block-unaligned prompts through the bucketed masked prefill (21 ->
    a 32-token bucket), mid-stream admission on 2 slots."""
    reqs, j_res, t_res = _serve_pair(arch, tuple(RAGGED[arch]), None)
    assert t_res["stats"]["retired"] == len(reqs) and t_res["stats"]["admitted"] == 3
    _assert_close(t_res, j_res, reqs, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_preemption_roundtrip_bitwise(arch):
    """8 pages on 3 slots preempt: the swap entry carries the pages (none
    for the Mamba1 LM) and the recurrent rows, and the tight run is
    bitwise the port's ample run; the swapped bytes are the reference's."""
    reqs, j_tight, t_tight = _serve_pair(arch, tuple(PREEMPT), 8, n_slots=3)
    _, _, t_ample = _serve_pair(arch, tuple(PREEMPT), None, n_slots=3)
    st = t_tight["stats"]
    assert t_ample["stats"]["preemptions"] == 0
    assert st["preemptions"] > 0 and st["resumed"] == st["preemptions"]
    _assert_bitwise(t_tight, t_ample, reqs)
    _assert_close(t_tight, j_tight, reqs, LOGIT_TOL)
    _, _, tcfg, _ = _pair(arch, _layers(arch))
    rows = sum(t.numel() * t.element_size()
               for t in t_registry.get_api(tcfg).init_slot_state(tcfg, 1, device="cpu"))
    if arch == "falcon_mamba_7b":
        assert st["swapped_out_bytes"] == st["preemptions"] * rows     # rows alone
    else:
        assert st["swapped_out_bytes"] > st["preemptions"] * rows


def test_preemption_through_the_disk_tier(tmp_path):
    """A host tier too small for one entry sends the hybrid's swap entry,
    recurrent rows included, through the .npz disk tier: still bitwise."""
    jcfg, params, tcfg, tparams = _pair("zamba2_1_2b", 5)
    reqs, _, t_ample = _serve_pair("zamba2_1_2b", tuple(PREEMPT), None, n_slots=3)
    res = DecodeEngine(tcfg, tparams, max_len=64, device="cpu").serve(
        [dict(r) for r in reqs], n_slots=3, num_pages=8, collect_logits=True,
        swap_config=SwapConfig(host_capacity_bytes=1, disk_dir=str(tmp_path)))
    sw = res["stats"]["swap"]
    assert res["stats"]["preemptions"] > 0 and sw["peak_disk_bytes"] > 0
    assert sw["promotions"] == res["stats"]["resumed"] and sw["peak_host_bytes"] == 0
    _assert_bitwise(res, t_ample, reqs)


def test_hybrid_eviction_replay_bitwise():
    """Page eviction on the shared block's pools: a faulted step restores
    and replays from the unadopted recurrent state, bitwise the ample run;
    the same evictions and replays as the reference's run."""
    reqs, j_res, t_res = _serve_pair("zamba2_1_2b", tuple(PREEMPT), 8, n_slots=3,
                                     eviction=True)
    _, _, t_ample = _serve_pair("zamba2_1_2b", tuple(PREEMPT), None, n_slots=3)
    st = t_res["stats"]
    assert st["retired"] == len(reqs) and st["failed"] == 0 and st["evictions"] > 0
    _assert_bitwise(t_res, t_ample, reqs)
    for key in ("evictions", "page_restores", "replay_steps"):
        assert st[key] == j_res["stats"][key], key


@pytest.mark.parametrize("pool", [None, 8])
def test_hybrid_int8_serve_matches_jax(pool):
    """Int8 pools under the shared block, against the reference's int8
    serve (jitted where the reference jits: tests/test_torch_quant.py)."""
    reqs, j_res, t_res = _serve_pair("zamba2_1_2b", tuple(PREEMPT), pool, quant="int8",
                                     n_slots=3)
    assert (t_res["stats"]["preemptions"] > 0) == (pool is not None)
    _assert_close(t_res, j_res, reqs, INT8_TOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals_mirror_the_reference(tmp_path):
    """Quest on the hybrid has no metadata cache (ValueError at its first
    step, in both packages); a plan-carrying schedule has no paged hybrid
    step (NotImplementedError in both); a sharded engine for a recurrent
    family (tests/test_torch_sharded_recurrent.py) refuses Quest, as for
    every family, before any collective. The recurrent families' lm_forward
    with mode="distill" is the reference's: the Mamba1 LM pretrains in
    either mode (CE), the hybrid distils; under a one-rank shard it is
    the unsharded loss bitwise."""
    jcfg, params, tcfg, tparams = _pair("zamba2_1_2b", 5)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    with pytest.raises(ValueError, match="selection-metadata cache"):
        JaxEngine(jcfg, params, max_len=64,
                  options=JP.DecodeOptions(policy=JP.QuestPolicy())).generate(
            {"tokens": jnp.asarray(toks)}, 3)
    with pytest.raises(ValueError, match="selection-metadata cache"):
        DecodeEngine(tcfg, tparams, max_len=64, device="cpu",
                     options=TP.DecodeOptions(policy=TP.QuestPolicy())).generate(
            {"tokens": toks}, 3)
    reqs = _requests(jcfg.vocab_size, [(12, 3)])
    for pkg, engine, cfg, p, extra in ((JP, JaxEngine, jcfg, params, {}),
                                       (TP, DecodeEngine, tcfg, tparams, {"device": "cpu"})):
        sched = pkg.SelectionSchedule(dense_first_n=0, select_layer=0)
        eng = engine(cfg, p, max_len=64, options=pkg.DecodeOptions(schedule=sched), **extra)
        with pytest.raises(NotImplementedError, match="uniform self-attn stack"):
            eng.serve([dict(r) for r in reqs], n_slots=2)
    shard = Shard.__new__(Shard)          # the refusal comes before any collective
    for arch in ARCHS:
        _, _, cfg, p = _pair(arch, _layers(arch))
        with pytest.raises(ValueError, match="GatePolicy"):
            DecodeEngine(cfg, p, max_len=64, device="cpu", shard=shard,
                         options=TP.DecodeOptions(policy=TP.QuestPolicy()))
        jc, jp, _, _ = _pair(arch, _layers(arch))
        tk = toks[:, :16]                 # whole gate blocks for the distill target
        batch = {"tokens": tk, "labels": np.roll(tk, -1, axis=1)}
        want, _ = get_api(jc).forward(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jc, mode="distill")
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        got, metrics = t_registry.get_api(cfg).forward(p, tb, cfg, mode="distill")
        assert set(metrics) == ({"ce"} if arch == "falcon_mamba_7b" else {"kl"})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        with H.one_rank_group(tmp_path / f"{arch}.store") as one:
            local = shard_params(p, cfg, one)
            got_sh, metrics_sh = t_registry.get_api(cfg).forward(local, tb, cfg,
                                                                 mode="distill", shard=one)
        assert torch.equal(got_sh, got) and metrics_sh.keys() == metrics.keys()


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_ask_for_cuda(arch):
    """Without a device the engine and the state allocators run on CUDA,
    and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, tcfg, tparams = _pair(arch, _layers(arch))
    api = t_registry.get_api(tcfg)
    for call in (lambda: DecodeEngine(tcfg, tparams, max_len=64),
                 lambda: api.init_decode_state(tcfg, 1, 64),
                 lambda: api.init_slot_state(tcfg, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
