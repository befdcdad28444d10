"""The port's split-K paged decode (TPU kernels 5 and 5q) and the sharded
engine's option checks, against the live JAX reference on the CPU.

Inputs come from a numpy seed and go through both packages:

  * ``sparse_decode_paged_splitk_plain`` against
    ``ref.paged_sparse_decode_splitk_ref`` and the Pallas
    ``block_sparse_decode_paged_splitk`` in interpret mode, in fp32, over
    fp pools (atol 1e-6 and 1e-5, the bounds of tests/test_paging.py's
    split-K test) and over int8 pools with f32 scale rows (atol 1e-5 for
    both, the bound of tests/test_quant.py's split-K test: dequantized
    values reach |6|, where 1e-6 is a few fp32 ulps), at num_splits 1, 2,
    3, nsel and nsel + 2 (empty segments). The selections carry -1 padding, one
    (slot, head) row with no valid key and a partial last block; the pages
    are shuffled under the table, and page 0, the trash page, holds values
    no selected block may read;
  * bf16 against the reference in bf16: both round the same fp32 math, so
    they may differ by one bf16 ulp of the output's largest element;
  * at num_splits=1 the split-K entry is ``sparse_decode_paged_plain``
    bitwise, as the reference's ref is its split-free twin;
  * ``DecodeEngine(shard=, options=DecodeOptions(split_k=))`` on a
    one-rank gloo group validates as the reference's
    ``DecodeOptions(kernel_impl="sharded", split_k=)`` does: the port
    takes the sharded paths from the engine's shard, not from an option.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.policy import DecodeOptions as JOptions
from repro.core.policy import DensePolicy as JDense
from repro.core.policy import GatePolicy as JGate
from repro.core.policy import QuestPolicy as JQuest
from repro.kernels import block_sparse_decode as j_bsd
from repro.kernels import ref as j_ref
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.core.policy import DecodeOptions as TOptions
from repro_torch.core.policy import DensePolicy as TDense
from repro_torch.core.policy import GatePolicy as TGate
from repro_torch.kernels import block_sparse_decode as t_bsd
from repro_torch.distributed.sharding import Shard
from repro_torch.kernels import ops as t_ops
from repro_torch.models import transformer as t_tf
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

HKV, PS, DH = 2, 8, 16


def _inputs(seed, s, g, npt, nsel, quant):
    """q, pools, scale rows (None for fp), ids, shuffled table, kv_len."""
    r = np.random.default_rng(seed)
    n_pages = s * npt + 1
    q = r.standard_normal((s, HKV, g, DH)).astype(np.float32)
    if quant:
        kp = r.integers(-127, 128, (n_pages, HKV, PS, DH)).astype(np.int8)
        vp = r.integers(-127, 128, (n_pages, HKV, PS, DH)).astype(np.int8)
        ks = r.uniform(0.002, 0.05, (n_pages, HKV, 1)).astype(np.float32)
        vs = r.uniform(0.002, 0.05, (n_pages, HKV, 1)).astype(np.float32)
        ks[0] = vs[0] = 1e6                          # the trash page's rows
    else:
        kp = r.standard_normal((n_pages, HKV, PS, DH)).astype(np.float32)
        vp = r.standard_normal((n_pages, HKV, PS, DH)).astype(np.float32)
        kp[0] = vp[0] = 1e6
        ks = vs = None
    kv_len = r.integers((npt - 1) * PS + 1, npt * PS, size=(s,)).astype(np.int32)
    pt = (1 + r.permutation(s * npt)).reshape(s, npt).astype(np.int32)
    idx = np.full((s, HKV, nsel), -1, np.int32)
    for i in range(s):
        for h in range(HKV):
            # the partial last block and up to nsel - 1 others, in any order
            n = r.integers(1, min(nsel, npt) + 1)
            idx[i, h, :n] = np.concatenate([[npt - 1], r.choice(npt - 1, n - 1,
                                                                replace=False)])
            idx[i, h] = r.permutation(idx[i, h])
    idx[0, 0] = -1                                   # a row with no valid key
    return q, kp, vp, ks, vs, idx, pt, kv_len


def _torch(x, dtype=None):
    if x is None:
        return None
    t = torch.tensor(x)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


SHAPES = [(3, 2, 4, 5), (2, 5, 6, 6), (1, 1, 3, 2)]    # (slots, G, npt, nsel)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("s,g,npt,nsel", SHAPES)
def test_splitk_plain_matches_ref_and_pallas(quant, s, g, npt, nsel):
    q, kp, vp, ks, vs, idx, pt, kv_len = _inputs(11, s, g, npt, nsel, quant)
    t_in = [_torch(x) for x in (q, kp, vp, idx, pt, kv_len)]
    t_sc = dict(k_scales=_torch(ks), v_scales=_torch(vs))
    j_in = [jnp.asarray(x) for x in (q, kp, vp, idx, pt, kv_len)]
    j_sc = dict(k_scales=None if ks is None else jnp.asarray(ks),
                v_scales=None if vs is None else jnp.asarray(vs))
    for ns in sorted({1, 2, 3, nsel, nsel + 2}):
        o_t = t_bsd.sparse_decode_paged_splitk_plain(*t_in, block_size=PS, num_splits=ns,
                                                     **t_sc)
        o_ref = j_ref.paged_sparse_decode_splitk_ref(*j_in, block_size=PS, num_splits=ns,
                                                     **j_sc)
        o_pal = j_bsd.block_sparse_decode_paged_splitk(*j_in, block_size=PS, num_splits=ns,
                                                       interpret=True, **j_sc)
        assert o_t.dtype == torch.float32 and o_t.shape == (s, HKV, g, DH)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_ref),
                                   atol=1e-5 if quant else 1e-6, rtol=0,
                                   err_msg=f"num_splits={ns} vs ref")
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_pal), atol=1e-5, rtol=0,
                                   err_msg=f"num_splits={ns} vs Pallas interpret")
        assert torch.equal(o_t[0, 0], torch.zeros_like(o_t[0, 0]))   # no valid key


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_splitk_plain_bf16_within_one_ulp_of_ref(quant):
    """bf16 q (and bf16 pools on the fp path): plain and reference do the
    same fp32 math and round it to bf16, so they may differ by one bf16
    ulp of max|o_ref| where an fp32 sum lands near a rounding boundary."""
    q, kp, vp, ks, vs, idx, pt, kv_len = _inputs(12, 3, 2, 6, 5, quant)
    bf = torch.bfloat16
    t_in = [_torch(q, bf), _torch(kp, bf), _torch(vp, bf), _torch(idx), _torch(pt),
            _torch(kv_len)]
    to_j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if x.dtype == bf
            else jnp.asarray(x.numpy()) for x in t_in]
    sc_t = dict(k_scales=_torch(ks), v_scales=_torch(vs))
    sc_j = dict(k_scales=None if ks is None else jnp.asarray(ks),
                v_scales=None if vs is None else jnp.asarray(vs))
    for ns in (2, 3, 7):
        o_t = t_bsd.sparse_decode_paged_splitk_plain(*t_in, block_size=PS, num_splits=ns,
                                                     **sc_t)
        o_j = np.asarray(j_ref.paged_sparse_decode_splitk_ref(
            *to_j, block_size=PS, num_splits=ns, **sc_j).astype(jnp.float32))
        assert o_t.dtype == bf
        top = float(np.abs(o_j).max())
        ulp = torch.finfo(bf).eps * 2.0 ** np.floor(np.log2(top))
        assert float(np.abs(o_t.float().numpy() - o_j).max()) <= ulp, ns


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_splitk_one_split_is_the_paged_decode_bitwise(quant):
    q, kp, vp, ks, vs, idx, pt, kv_len = _inputs(13, 3, 2, 4, 5, quant)
    t_in = [_torch(x) for x in (q, kp, vp, idx, pt, kv_len)]
    sc = dict(k_scales=_torch(ks), v_scales=_torch(vs))
    plain = t_bsd.sparse_decode_paged_plain(*t_in, block_size=PS, **sc)
    for ns in (1, 0):
        assert torch.equal(t_bsd.sparse_decode_paged_splitk_plain(
            *t_in, block_size=PS, num_splits=ns, **sc), plain)
    t_ops.reset_launch_counts()
    assert torch.equal(t_ops.paged_sparse_decode_splitk(*t_in, block_size=PS, num_splits=1,
                                                        **sc), plain)
    o2 = t_ops.paged_sparse_decode_splitk(*t_in, block_size=PS, num_splits=2, **sc)
    assert torch.equal(o2, t_bsd.sparse_decode_paged_splitk_plain(
        *t_in, block_size=PS, num_splits=2, **sc))
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)      # CPU: plain


@dataclasses.dataclass(frozen=True)
class _OtherPolicy:
    """Neither the gate nor dense: what the reference's QuestPolicy is to
    its sharded validation."""
    dense = False
    needs_gate = False


# (port DecodeOptions kwargs, engine built with a shard, reference kwargs):
# the port's engine and the reference's options both construct, or both
# raise ValueError
OPTION_CASES = {
    "default": ({}, False, {}),
    "sharded": ({}, True, dict(kernel_impl="sharded")),
    "sharded split_k=4": (dict(split_k=4), True, dict(kernel_impl="sharded", split_k=4)),
    "sharded dense": (dict(policy=TDense()), True,
                      dict(kernel_impl="sharded", policy=JDense())),
    "sharded gate int8": (dict(policy=TGate(), quantize="int8", split_k=2), True,
                          dict(kernel_impl="sharded", policy=JGate(), quantize="int8",
                               split_k=2)),
    "split_k=0": (dict(split_k=0), False, dict(split_k=0)),
    "sharded split_k=-1": (dict(split_k=-1), True, dict(kernel_impl="sharded", split_k=-1)),
    "split_k=2 unsharded": (dict(split_k=2), False, dict(split_k=2)),
    "sharded other policy": (dict(policy=_OtherPolicy()), True,
                             dict(kernel_impl="sharded", policy=JQuest())),
    "sharded budget 0": (dict(budget_override=0), True,
                         dict(kernel_impl="sharded", budget_override=0)),
}


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group's Shard, and the tiny config and weights."""
    store = tmp_path_factory.mktemp("group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    cfg = t_reduced(t_get("qwen3_0_6b"))
    try:
        yield Shard(), cfg, t_tf.init_lm(torch.Generator().manual_seed(0), cfg)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_decode_options_sharded_validation_matches_reference(case, one_rank):
    t_kw, sharded, j_kw = OPTION_CASES[case]
    shard, cfg, params = one_rank

    def build():
        return DecodeEngine(cfg, params, max_len=64, device="cpu",
                            shard=shard if sharded else None, options=TOptions(**t_kw))
    try:
        JOptions(**j_kw)
        j_err = None
    except ValueError as e:
        j_err = e
    if j_err is None:
        eng = build()
        assert eng.options.split_k == j_kw.get("split_k", 1)
        assert (eng.shard is not None) == (j_kw.get("kernel_impl") == "sharded")
    else:
        with pytest.raises(ValueError):
            build()


def test_splitk_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the CUDA wrappers raise; only ops routes to plain."""
    q, kp, vp, ks, vs, idx, pt, kv_len = _inputs(14, 2, 2, 4, 3, True)
    t_in = [_torch(x) for x in (q, kp, vp, idx, pt, kv_len)]
    with pytest.raises(ValueError, match="CUDA"):
        t_bsd.sparse_decode_paged_splitk_quant_cuda(*t_in, block_size=PS, num_splits=2,
                                                    k_scales=_torch(ks), v_scales=_torch(vs))
    fp = [t_in[0], t_in[0].new_zeros(kp.shape), t_in[0].new_zeros(vp.shape)] + t_in[3:]
    with pytest.raises(ValueError, match="CUDA"):
        t_bsd.sparse_decode_paged_splitk_cuda(*fp, block_size=PS, num_splits=2)
