"""The port's dry-run (``repro_torch.launch.{mesh,specs,dryrun}``) against
the JAX package's, on the CPU.

Held exactly, with no tolerance (every figure is a count):
  * ``SHAPES`` and ``shapes_for`` of every config equal the reference's
    field by field; ``param_counts`` and ``model_flops`` (copied) equal
    the reference's for every config and each of its shapes;
  * the full-size train state in the default mode, built by the port
    under ``FakeTensorMode``, has the bytes of the reference's
    ``jax.eval_shape(init_train_state)``; so does the ``decode_32k``
    decode state of every decoder (``init_decode_state``); a rank's train
    state at world sizes 2 and 16 (``shard_state``) has the bytes of the
    port's layouts (``local_shape`` of ``param_layout``) summed;
  * ``AbstractShard(0, 1)`` logs the collectives a real one-rank gloo
    ``Shard`` makes on the same step (reduced qwen3_0_6b distillation,
    reduced deepseek_moe_16b pretraining), kind, shape and bytes, in
    order; a reduced pretrain step counts the same FLOPs fake and real;
  * kernels #1, #2 (fp) and #6: each ``*_fake`` returns the plain
    version's shapes and dtypes and charges PERF.md §6's bound formulas
    (computed here); the six other kernels raise on a fake tensor; no
    fake tensor reaches a launching wrapper; a real CPU tensor still
    takes the plain version and charges nothing;
  * the peak tracker and the byte rules on hand-built op sequences;
  * ``run_cell`` on reduced configs at the local mesh and a (1, 2) mesh
    for each kind of shape, and ``main`` writing its JSON.
"""
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._pytree import tree_flatten

import repro.config as j_config
import repro.configs as j_configs
import torch_sharded_helpers as H
from repro.launch import specs as j_specs
from repro.models.registry import get_api as j_get_api
from repro.train import loop as j_loop
from repro_torch import config as t_config
from repro_torch import configs as t_configs
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.distributed import sharding
from repro_torch.kernels import block_sparse_decode as bsd
from repro_torch.kernels import fake, ops
from repro_torch.kernels import gate_gt_fwd as gt
from repro_torch.kernels import gate_select as gs
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import MeshSpec, batch_per_rank, make_production_mesh
from repro_torch.models.registry import get_api
from repro_torch.train import loop as t_loop

jax.config.update("jax_platform_name", "cpu")

RECORD_KEYS = {"ok", "arch", "shape", "mesh", "chips", "flops", "bytes", "bytes_flash",
               "collectives", "model_flops", "argument_size_in_bytes", "temp_size_in_bytes",
               "output_size_in_bytes", "t_compute", "t_memory", "t_collective", "bottleneck",
               "useful_flops_ratio", "kernels", "peak_bytes", "fits", "t_trace_s", "notes"}
DECODERS = [a for a in t_configs.ARCH_IDS if t_configs.get(a).is_decoder]


@pytest.fixture(scope="module")
def j_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices; the flags are put back at once, so nothing started
    later in this worker inherits them."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def leaf_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def j_leaf_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# shapes, counts, state bytes against the reference
# ---------------------------------------------------------------------------

def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_config.SHAPES.items()}
    for arch in t_configs.ARCH_IDS:
        assert [dataclasses.asdict(s) for s in t_configs.shapes_for(arch)] == \
            [dataclasses.asdict(s) for s in j_configs.shapes_for(arch)], arch


def test_param_counts_and_model_flops_equal_reference(j_dryrun):
    for arch in t_configs.ARCH_IDS:
        cfg, jcfg = t_configs.get(arch), j_configs.get(arch)
        assert dryrun.param_counts(cfg) == j_dryrun.param_counts(jcfg), arch
        for shp in t_configs.shapes_for(arch):
            assert dryrun.model_flops(cfg, shp) == j_dryrun.model_flops(
                jcfg, j_config.SHAPES[shp.name]), (arch, shp.name)


def rank_bytes_by_layout(state, cfg, world) -> int:
    """The bytes a rank holds by the port's layouts: every split leaf at
    ``local_shape`` of its ``param_layout``, the rest whole."""
    def one(path, t):
        lay = sharding.param_layout(path, tuple(t.shape), cfg, world)
        return math.prod(sharding.local_shape(t.shape, lay, world)) * t.element_size()
    total = sum(one(p, t) for p, t in t_loop._walk(state.params))
    for d in (state.gate, state.opt.m, state.opt.v, state.opt.ef):
        total += sum(one(p, t) for p, t in (d or {}).items())
    return total + leaf_bytes((state.opt.count, state.step))


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_train_state_bytes_equal_reference(arch):
    cfg, jcfg = t_configs.get(arch), j_configs.get(arch)
    tcfg = specs.default_train_cfg(cfg)
    jtcfg = j_specs.default_train_cfg(jcfg)
    assert tcfg.mode == jtcfg.mode
    ref = jax.eval_shape(lambda k: j_loop.init_train_state(k, jcfg, jtcfg),
                         jax.random.PRNGKey(0))
    with FakeTensorMode(allow_fallback_kernels=False):
        state = specs.abstract_train_state(cfg, tcfg)
        assert leaf_bytes(state) == j_leaf_bytes(ref)
        for world in (2, 16):
            local = t_loop.shard_state(state, cfg, sharding.AbstractShard(0, world))
            assert leaf_bytes(local) == rank_bytes_by_layout(state, cfg, world), world


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_state_bytes_equal_reference(arch):
    cfg, jcfg = t_configs.get(arch), j_configs.get(arch)
    shp = t_config.SHAPES["decode_32k"]
    ref = jax.eval_shape(lambda: j_get_api(jcfg).init_decode_state(
        jcfg, shp.global_batch, shp.seq_len))
    with FakeTensorMode(allow_fallback_kernels=False):
        state = get_api(cfg).init_decode_state(cfg, shp.global_batch, shp.seq_len,
                                               device="cpu")
        assert leaf_bytes(state) == j_leaf_bytes(ref)


def test_specs_need_fake_mode():
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        specs.abstract_params(t_configs.get("kimi_k2_1t_a32b"))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "llama_3_2_vision_11b", "hubert_xlarge"])
def test_abstract_batch_is_make_batch(arch):
    cfg = t_config.reduced(t_configs.get(arch))
    real = make_batch(cfg, 3, 32, DataState(0, 0), device="cpu")
    with FakeTensorMode():
        got = specs.abstract_batch(cfg, 3, 32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in real.items()}


def test_batch_per_rank_is_batch_pspecs_rule():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert [batch_per_rank(b, single) for b in (256, 32, 128, 1, 24)] == [16, 2, 8, 1, 24]
    assert [batch_per_rank(b, multi) for b in (256, 32, 128, 1, 48)] == [8, 1, 4, 1, 3]
    assert batch_per_rank(512, single, ep_major=True) == 2


# ---------------------------------------------------------------------------
# AbstractShard and the FLOP count against real steps
# ---------------------------------------------------------------------------

def _case(arch, mode):
    cfg = t_config.reduced(t_configs.get(arch)).replace(dtype="float32")
    return cfg, t_config.TrainConfig(mode=mode)


def _real_log(cfg, tcfg, store, monkeypatch):
    """The collectives a real one-rank gloo Shard makes on one step, as
    (kind, operand shape, operand bytes), recorded around the
    torch.distributed calls."""
    log = []
    real_gather, real_reduce = sharding.dist.all_gather_into_tensor, sharding.dist.all_reduce

    def gather(out, x, group=None):
        log.append(("all-gather", tuple(x.shape), x.nbytes))
        return real_gather(out, x, group=group)

    def reduce(y, op=None, group=None):
        log.append(("all-reduce", tuple(y.shape), y.nbytes))
        return real_reduce(y, op=op, group=group)
    with H.one_rank_group(store) as shard:
        state = t_loop.shard_state(
            t_loop.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg), cfg, shard)
        batch = make_batch(cfg, 2, 32, DataState(0, 0), device="cpu")
        monkeypatch.setattr(sharding.dist, "all_gather_into_tensor", gather)
        monkeypatch.setattr(sharding.dist, "all_reduce", reduce)
        t_loop.make_train_step(cfg, tcfg, shard)(state, batch)
        monkeypatch.undo()
    return log


@pytest.mark.parametrize("arch,mode", [("qwen3_0_6b", "distill"),
                                       ("deepseek_moe_16b", "pretrain")])
def test_abstract_shard_logs_the_real_collectives(arch, mode, tmp_path, monkeypatch):
    cfg, tcfg = _case(arch, mode)
    real = _real_log(cfg, tcfg, str(tmp_path / "store"), monkeypatch)
    shard = sharding.AbstractShard(0, 1)
    with FakeTensorMode(allow_fallback_kernels=False):
        state = specs.abstract_train_state(cfg, tcfg, shard)
        t_loop.make_train_step(cfg, tcfg, shard)(state, specs.abstract_batch(cfg, 2, 32))
    assert len(real) > 5
    assert [(c.kind, c.shape, c.nbytes) for c in shard.log] == real


def test_abstract_shard_refuses_real_tensors():
    shard = sharding.AbstractShard(0, 2)
    assert isinstance(shard, sharding.Shard)
    sharding.check_shard(shard)
    for call in (lambda: shard.all_sum(torch.ones(3)), lambda: shard.all_max(torch.ones(3)),
                 lambda: shard.all_gather(torch.ones(3), 0)):
        with pytest.raises(TypeError, match="FakeTensors only"):
            call()
    with FakeTensorMode():
        x = torch.empty((4, 6), dtype=torch.bfloat16)
        assert tuple(shard.all_gather(x, 1).shape) == (4, 12)
        assert tuple(shard.all_sum(x).shape) == (4, 6)
        assert shard.sum_ints([3, 5]) == (6, 10)
    assert [(c.kind, c.shape, c.nbytes) for c in shard.log] == [
        ("all-gather", (4, 6), 48), ("all-reduce", (4, 6), 48), ("all-reduce", (2,), 16)]


def test_pretrain_flops_fake_equal_real():
    cfg, tcfg = _case("qwen3_0_6b", "pretrain")
    state = t_loop.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    batch = make_batch(cfg, 2, 32, DataState(0, 0), device="cpu")
    with FlopCounterMode(display=False) as real:
        t_loop.make_train_step(cfg, tcfg)(state, batch)
    with FakeTensorMode(allow_fallback_kernels=False):
        fstate = specs.abstract_train_state(cfg, tcfg)
        ledger = fake.KernelLedger()
        with FlopCounterMode(display=False) as fk, fake.recording(ledger):
            t_loop.make_train_step(cfg, tcfg)(fstate, specs.abstract_batch(cfg, 2, 32))
    assert real.get_total_flops() > 0
    assert fk.get_total_flops() == real.get_total_flops()
    assert not ledger.calls                       # pretraining reaches no kernel


# ---------------------------------------------------------------------------
# the kernels' fake stand-ins
# ---------------------------------------------------------------------------

@pytest.fixture
def no_launch(monkeypatch):
    """Every launching wrapper raises: a fake tensor must never reach one."""
    def boom(*a, **k):
        raise AssertionError("a launching wrapper was called")
    for mod, names in ((gs, ("gate_select_cuda", "gate_select_paged_cuda")),
                       (bsd, ("sparse_decode_cuda", "sparse_decode_paged_cuda",
                              "sparse_decode_quant_cuda", "sparse_decode_paged_quant_cuda",
                              "sparse_decode_paged_splitk_cuda",
                              "sparse_decode_paged_splitk_quant_cuda")),
                       (gt, ("gate_gt_attention_cuda",))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)


def _fake_call(fn, *real_args, **kw):
    """fn on fake copies of ``real_args`` -> (outputs' shapes and dtypes,
    the ledger)."""
    mode = FakeTensorMode()
    ledger = fake.KernelLedger()
    with mode, fake.recording(ledger):
        args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in real_args]
        out = fn(*args, **kw)
    return _meta(out), ledger


def _meta(out):
    return [(tuple(t.shape), t.dtype) for t in tree_flatten(out)[0]]


GCFG = t_config.reduced(t_configs.get("qwen3_0_6b")).gate


def test_gate_select_fake(no_launch):
    g = torch.Generator().manual_seed(0)
    b, hkv, nb, dg = 2, 3, 40, 16
    qg = torch.randn(b, hkv, dg, generator=g).bfloat16()
    kg = torch.randn(b, hkv, nb, dg, generator=g).bfloat16()
    nv = torch.tensor([40, 17], dtype=torch.int32)
    plain = gs.gate_select_plain(qg, kg, nv, GCFG)
    meta, ledger = _fake_call(ops.gate_select, qg, kg, nv, GCFG)
    assert meta == _meta(plain)
    rows = b * hkv * nb
    assert ledger.calls == {"gate_select": 1}
    assert ledger.flops == 2 * rows * dg
    assert ledger.bytes == qg.nbytes + rows * dg * 2 + nv.nbytes + plain.nbytes


def test_sparse_decode_fake(no_launch):
    g = torch.Generator().manual_seed(1)
    b, hkv, grp, dh, s, bs, nsel = 2, 2, 4, 16, 128, 8, 5
    q = torch.randn(b, hkv, grp, dh, generator=g).bfloat16()
    k, v = (torch.randn(b, hkv, s, dh, generator=g).bfloat16() for _ in range(2))
    idx = torch.randint(0, s // bs, (b, hkv, nsel), generator=g, dtype=torch.int32)
    kv_len = torch.tensor([128, 70], dtype=torch.int32)
    plain = bsd.sparse_decode_plain(q, k, v, idx, kv_len, block_size=bs)
    meta, ledger = _fake_call(ops.sparse_decode, q, k, v, idx, kv_len, block_size=bs)
    assert meta == _meta(plain)
    tokens = b * hkv * nsel * bs
    assert ledger.calls == {"block_sparse_decode": 1}
    assert ledger.flops == 4 * grp * dh * tokens
    assert ledger.bytes == 2 * tokens * dh * 2 + 2 * q.nbytes + idx.nbytes + kv_len.nbytes


def test_gate_gt_attention_fake(no_launch):
    g = torch.Generator().manual_seed(2)
    b, l, h, hkv, dh, bs = 2, 32, 4, 2, 16, 8
    q = torch.randn(b, l, h, dh, generator=g).bfloat16()
    k, v = (torch.randn(b, l, hkv, dh, generator=g).bfloat16() for _ in range(2))
    seg = torch.zeros((b, l), dtype=torch.int32)
    plain = gt.gate_gt_attention_plain(q, k, v, block_size=bs, segment_ids=seg)
    meta, ledger = _fake_call(ops.gate_gt_attention, q, k, v, block_size=bs,
                              segment_ids=seg)
    assert meta == _meta(plain)
    assert ledger.calls == {"gate_gt_attention": 1}
    assert ledger.flops == 4 * dh * h * b * l * (l + 1) // 2
    assert ledger.bytes == (2 * q.nbytes + 2 * k.nbytes + b * h * l * (l // bs) * 4
                            + seg.nbytes)


def _paged_inputs():
    g = torch.Generator().manual_seed(3)
    s, hkv, grp, dh, bs, npt, pages = 2, 2, 2, 16, 8, 4, 9
    return dict(
        q=torch.randn(s, hkv, grp, dh, generator=g), qg=torch.randn(s, hkv, 16, generator=g),
        kgp=torch.randn(pages, hkv, 16, generator=g),
        kp=torch.randn(pages, hkv, bs, dh, generator=g),
        vp=torch.randn(pages, hkv, bs, dh, generator=g),
        k8=torch.zeros(pages, hkv, bs, dh, dtype=torch.int8), sc=torch.ones(pages, hkv, 1),
        kc8=torch.zeros(s, hkv, 32, dh, dtype=torch.int8), csc=torch.ones(s, hkv, 4),
        table=torch.zeros(s, npt, dtype=torch.int32),
        idx=torch.zeros(s, hkv, 2, dtype=torch.int32), nv=torch.ones(s, dtype=torch.int32))


OTHER_KERNELS = {
    "gate_select_paged": lambda t: ops.gate_select_paged(t["qg"], t["kgp"], t["table"],
                                                         t["nv"], GCFG),
    "block_sparse_decode_paged": lambda t: ops.paged_sparse_decode(
        t["q"], t["kp"], t["vp"], t["idx"], t["table"], t["nv"], block_size=8),
    "block_sparse_decode_paged_quant": lambda t: ops.paged_sparse_decode(
        t["q"], t["k8"], t["k8"], t["idx"], t["table"], t["nv"], block_size=8,
        k_scales=t["sc"], v_scales=t["sc"]),
    "block_sparse_decode_paged_splitk": lambda t: ops.paged_sparse_decode_splitk(
        t["q"], t["kp"], t["vp"], t["idx"], t["table"], t["nv"], block_size=8, num_splits=2),
    "block_sparse_decode_paged_splitk_quant": lambda t: ops.paged_sparse_decode_splitk(
        t["q"], t["k8"], t["k8"], t["idx"], t["table"], t["nv"], block_size=8, num_splits=2,
        k_scales=t["sc"], v_scales=t["sc"]),
    "block_sparse_decode_quant": lambda t: ops.sparse_decode(
        t["q"], t["kc8"], t["kc8"], t["idx"], t["nv"], block_size=8, k_scales=t["csc"],
        v_scales=t["csc"]),
}


def test_other_kernels_refuse_fake_tensors(no_launch):
    assert set(OTHER_KERNELS) | {"gate_select", "block_sparse_decode",
                                 "gate_gt_attention"} == set(ops.KERNELS)
    real = _paged_inputs()
    for name, call in OTHER_KERNELS.items():
        call(real)                                # real CPU tensors: the plain version
        mode = FakeTensorMode()
        with mode:
            fk = {k: mode.from_tensor(v) for k, v in real.items()}
            with pytest.raises(NotImplementedError, match=name):
                call(fk)


def test_real_cpu_tensors_take_the_plain_version_and_charge_nothing(no_launch):
    g = torch.Generator().manual_seed(4)
    qg = torch.randn(2, 2, 16, generator=g)
    kg = torch.randn(2, 2, 12, 16, generator=g)
    nv = torch.tensor([12, 5], dtype=torch.int32)
    ledger = fake.KernelLedger()
    ops.reset_launch_counts()
    with fake.recording(ledger):
        got = ops.gate_select(qg, kg, nv, GCFG)
    assert torch.equal(got, gs.gate_select_plain(qg, kg, nv, GCFG))
    assert not ledger.calls
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

def test_one_kernel_ledger_open_at_a_time():
    outer = fake.KernelLedger()
    with fake.recording(outer):
        fake.charge("gate_select", 2.0, 3.0)
        with pytest.raises(RuntimeError, match="already open"):
            with fake.recording(fake.KernelLedger()):
                pass
        fake.charge("gate_select", 2.0, 3.0)
    fake.charge("gate_select", 2.0, 3.0)   # no ledger open: charges nothing
    assert outer.calls == {"gate_select": 2} and (outer.flops, outer.bytes) == (4.0, 6.0)


def test_peak_tracker_on_a_known_sequence():
    with FakeTensorMode():
        arg = torch.empty(100, dtype=torch.float32)            # 400 B, live throughout
        counter = dryrun.OpCounter(seq_len=16, args=(arg,))
        with counter:
            a = torch.empty(1000)                              # 4400
            b = torch.empty(2000)                              # 12400
            del a                                              # 8400
            v = b.view(20, 100)                                # a view: no new storage
            d = torch.empty(3000)                              # 20400, the peak
            del b, v                                           # 12400
            e = torch.empty(500)                               # 14400
        assert counter.tracker.peak == 20400
        assert counter.tracker.live == 14400
        del d, e
        assert counter.tracker.live == 400


def test_byte_rules():
    with FakeTensorMode():
        x = torch.empty((64, 300), dtype=torch.float32)        # 76800 B
        counter = dryrun.OpCounter(seq_len=300, args=(x,))
        with counter:
            y = x + 1                                          # read x, write y
            assert counter.bytes == 2 * x.nbytes
            _ = y.view(300, 64).t()                            # views move nothing
            assert counter.bytes == 2 * x.nbytes
            ix = torch.empty(10, dtype=torch.int64)
            z = torch.index_select(y, 0, ix)                   # gather-like: 2 x output
            assert counter.bytes == 2 * x.nbytes + 2 * z.nbytes
            s = torch.empty((2, 256, 300), dtype=torch.float32)
            t = s * 2                                          # score-shaped output
        assert counter.score_bytes == t.nbytes
        assert counter.bytes == 2 * x.nbytes + 2 * z.nbytes + 2 * s.nbytes


# ---------------------------------------------------------------------------
# cells and the command line
# ---------------------------------------------------------------------------

SMALL_SHAPES = {"train": t_config.ShapeConfig("train_s", 64, 4, "train"),
                "prefill": t_config.ShapeConfig("prefill_s", 64, 2, "prefill"),
                "decode": t_config.ShapeConfig("decode_s", 256, 2, "decode")}


@pytest.mark.parametrize("mesh", ["local", MeshSpec(1, 1, 2)], ids=["local", "model2"])
@pytest.mark.parametrize("kind", list(SMALL_SHAPES))
def test_run_cell_on_a_reduced_config(kind, mesh):
    cfg = t_config.reduced(t_configs.get("qwen3_0_6b"))
    rec = dryrun.run_cell(cfg, SMALL_SHAPES[kind], mesh, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert RECORD_KEYS <= set(rec)
    assert rec["peak_bytes"] >= rec["argument_size_in_bytes"] > 0
    assert rec["bytes"] > 0 and rec["flops"] > 0 and rec["fits"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    local = mesh == "local"
    # a sharded engine's prefill and decode split attention, the MLP and
    # the vocabulary: collectives on the model axis of 2, none on the
    # local mesh
    assert (rec["collectives"]["_count"] == 0) == local
    expect = {"train": {"gate_gt_attention": 2},
              "prefill": {},
              "decode": {"gate_select": 2, "block_sparse_decode": 2} if local else {}}[kind]
    assert rec["kernels"] == expect


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "gemma_2b"])
def test_sharded_cells_hold_the_ranks_blocks(arch, kind):
    """A prefill and a decode cell on a model axis of 2: the rank's
    parameter argument holds every leaf at ``local_shape`` of its
    ``param_layout`` block (the gate's ``wq``/``wk`` whole), so its bytes
    are their sum. gemma_2b's single KV head (MQA) keeps its attention
    whole; its MLP and vocabulary split."""
    cfg = t_config.reduced(t_configs.get(arch))
    shard = sharding.AbstractShard(0, 2)
    with FakeTensorMode(allow_fallback_kernels=False):
        full = dict(t_loop._walk(specs.abstract_params(cfg)))
        _, args, got_shard = specs.cell_fn_and_specs(cfg, SMALL_SHAPES[kind], MeshSpec(1, 1, 2))
        rank = dict(t_loop._walk(args[0]))
        want = 0
        assert rank.keys() == full.keys() and got_shard.world == 2
        for path, t in full.items():
            lay = sharding.param_layout(path, tuple(t.shape), cfg, 2)
            if "/gate/" in path:
                lay = None
            shape = sharding.local_shape(t.shape, lay, 2)
            assert tuple(rank[path].shape) == shape, path
            want += math.prod(shape) * t.element_size()
        assert dryrun.storage_bytes(args[0]) == want < dryrun.storage_bytes(full)
    attn = (rank["blocks/0/attn/wq/w"].shape, rank["blocks/0/attn/wo/w"].shape)
    whole = (full["blocks/0/attn/wq/w"].shape, full["blocks/0/attn/wo/w"].shape)
    assert (attn == whole) == (cfg.n_kv_heads == 1)
    assert rank["blocks/0/mlp/wo/w"].shape[0] == cfg.d_ff // 2
    assert rank["embed/w"].shape[0] == cfg.vocab_size // 2


def test_fits_limit_is_the_same_on_every_host(monkeypatch):
    # a host with a card answers as one without: run_cell asks no device
    def no_query(*a, **kw):
        raise AssertionError("run_cell queried the card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_query)
    cfg = t_config.reduced(t_configs.get("qwen3_0_6b"))
    rec = dryrun.run_cell(cfg, SMALL_SHAPES["decode"], "local", verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["hbm_bytes"] == mesh_mod.HBM_BYTES == 85017493504
    assert rec["fits"] == (rec["peak_bytes"] <= mesh_mod.HBM_BYTES)


def test_run_cell_on_the_encoder_and_a_failed_cell():
    cfg = t_config.reduced(t_configs.get("hubert_xlarge"))
    rec = dryrun.run_cell(cfg, SMALL_SHAPES["prefill"], MeshSpec(1, 1, 2), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["collectives"]["_count"] > 0 and rec["kernels"] == {}
    bad = dryrun.run_cell(cfg, t_config.ShapeConfig("x", 64, 2, "bogus"), "local",
                          verbose=False)
    assert not bad["ok"] and bad["error"] == "ValueError: bogus" and "traceback" in bad


def test_main_writes_its_json(tmp_path, monkeypatch):
    real_get = t_configs.get
    monkeypatch.setattr(t_configs, "get", lambda a: t_config.reduced(real_get(a)))
    out = tmp_path / "r.json"
    argv = ["--arch", "qwen3-0-6b", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    recs = json.loads(out.read_text())
    assert set(recs) == {"qwen3_0_6b|decode_32k|single", "qwen3_0_6b|decode_32k|multi"}
    assert all(r["ok"] and RECORD_KEYS <= set(r) for r in recs.values())
    assert recs["qwen3_0_6b|decode_32k|multi"]["chips"] == 512
    assert dryrun.main(argv) == 0                 # cached: skipped


def test_abstract_shard_logs_all_to_all():
    """``AbstractShard.all_to_all`` returns the exchange's shape (even
    blocks, or the rows the splits say it receives) and logs the rank's
    operand as one "all-to-all"; a real tensor is refused."""
    shard = sharding.AbstractShard(0, 2)
    with pytest.raises(TypeError, match="FakeTensors only"):
        shard.all_to_all(torch.ones(4, 3))
    with FakeTensorMode():
        x = torch.empty((4, 6), dtype=torch.bfloat16)
        assert tuple(shard.all_to_all(x).shape) == (4, 6)
        assert tuple(shard.all_to_all(x, [1, 3], [2, 5]).shape) == (7, 6)
    assert [(c.kind, c.shape, c.nbytes) for c in shard.log] == [
        ("all-to-all", (4, 6), 48), ("all-to-all", (4, 6), 48)]


def test_moe_switches_at_full_size(monkeypatch):
    """deepseek_moe_16b x train_4k x multi (data 32 x model 16): on the
    default dispatch each rank's expert buffer holds its data replica's
    ceil(C / D) slots of the global capacity C, [E / M, 3840, d]; under
    the reference's ``REPRO_MOE_IMPL=shard_map`` the large-T body's
    [E / M, M * C_ll, d], with one dispatch all-to-all each way on the
    model axis a MoE layer (distillation runs the base without autograd),
    its bytes counted; ``REPRO_EP_MAJOR=1`` refuses the cell, whose 256
    rows do not split over the 512 ranks."""
    cfg = t_configs.get("deepseek_moe_16b")
    shape = t_config.SHAPES["train_4k"]
    e, k, d, cf = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.moe.capacity_factor
    mesh = make_production_mesh(multi_pod=True)
    n_data = mesh.pod * mesh.data
    tokens = shape.global_batch * shape.seq_len
    cap = math.ceil(tokens * k / e * cf)
    c_ll = math.ceil(tokens // (n_data * mesh.model) * k / e * cf)
    got = {}
    for switches in ({}, {"REPRO_MOE_IMPL": "shard_map"},
                     {"REPRO_MOE_IMPL": "shard_map", "REPRO_EP_MAJOR": "1"}):
        for key in ("REPRO_MOE_IMPL", "REPRO_EP_MAJOR"):
            monkeypatch.delenv(key, raising=False)
        for key, value in switches.items():
            monkeypatch.setenv(key, value)
        with H.recording_expert_buffers() as bufs:
            rec = dryrun.run_cell("deepseek_moe_16b", "train_4k", "multi", verbose=False)
        got[len(switches)] = rec, bufs
    (plain, plain_bufs), (sm, sm_bufs), (ep, _) = got[0], got[1], got[2]
    assert plain["ok"] and sm["ok"], (plain.get("traceback"), sm.get("traceback"))
    assert plain["moe_dispatch"] == "gspmd" and sm["moe_dispatch"] == "shard_map"
    assert set(plain_bufs) == {(e // mesh.model, -(-cap // n_data), d)}
    assert set(sm_bufs) == {(e // mesh.model, mesh.model * c_ll, d)}
    assert len(sm_bufs) == len(plain_bufs) > 0                  # a MoE layer each
    a2a = sm["collectives_by_axis"]["model"]["all-to-all"]
    assert a2a == len(sm_bufs) * 2 * e * c_ll * d * 2            # bf16 rows, each way
    assert plain["collectives_by_axis"]["model"]["all-to-all"] == 0
    assert plain["collectives_by_axis"]["data"]["all-to-all"] > 0   # the slot exchange
    assert not ep["ok"] and "EP-major" in ep["error"]


def test_ep_major_cell_on_a_reduced_config(monkeypatch):
    """Both switches on a reduced MoE train cell over data 2 x model 2:
    the rows split over the four ranks, only the experts and the logits
    split, the dispatch's all-to-alls on the model axis."""
    monkeypatch.setenv("REPRO_MOE_IMPL", "shard_map")
    monkeypatch.setenv("REPRO_EP_MAJOR", "1")
    cfg = t_config.reduced(t_configs.get("deepseek_moe_16b"))
    rec = dryrun.run_cell(cfg, t_config.ShapeConfig("train_s", 64, 8, "train"),
                          MeshSpec(1, 2, 2), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["ep_major"] and rec["moe_dispatch"] == "shard_map"
    assert rec["collectives_by_axis"]["model"]["all-to-all"] > 0
