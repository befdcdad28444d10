"""The port's int8 page pools against the live JAX reference, on the CPU.

Every input comes from a numpy seed and goes through both packages:

  * ``quantize_block``/``dequantize_block``: codes, scales and dequantized
    pages bitwise equal, exact .5 ties (half to even), garbage rows outside
    the valid region and an empty region (scale 1.0) included;
  * the plain fused-dequant decodes, contiguous (TPU body 2q,
    ``_kernel_quant``) and paged (4q, ``_kernel_paged_quant``), against
    ``ref.sparse_decode_ref``/``ref.paged_sparse_decode_ref`` with scales
    and the Pallas kernels in interpret mode: atol 1e-5 in fp32; page 0's
    scale row is never read;
  * the int8 pool helpers (``scatter_prefill``, ``append_token_paged_quant``
    with ``finalize_kg_paged(k_scale=)``, ``reset_kg_rows``,
    ``extract_pages``/``restore_pages``, ``gather_kv(scale_1l=)``): every
    stored code and scale bitwise equal; a freshly finalized Kg row is
    arithmetic (pool + projection + RoPE of the dequantized keys) and held
    to 1e-5, as in tests/test_torch_paging.py;
  * ``serve()`` with ``DecodeOptions(quantize="int8")`` against the
    reference's int8 ``serve()`` (GatePolicy on ragged requests, DensePolicy
    through the dense fallback, a tight pool that preempts): greedy tokens
    equal for every rid, logits within LOGIT_TOL, the scheduler and swap
    counters (``swapped_out_bytes`` included) equal; in the port, int8
    tight == int8 ample bitwise. Port int8 is held against reference int8,
    never against fp: one flipped token sends an int8 run away from fp.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capture_golden_policy as G
from repro.config import GateConfig
from repro.core.policy import DecodeOptions as JOptions
from repro.core.policy import DensePolicy as JDense
from repro.kernels import block_sparse_decode as j_bsd
from repro.kernels import ref as j_ref
from repro.models.registry import get_api
from repro.serve import paging as j_pg
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch import config as t_config
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import DecodeOptions as TOptions
from repro_torch.core.policy import DensePolicy as TDense
from repro_torch.kernels import block_sparse_decode as t_bsd
from repro_torch.kernels import ops as t_ops
from repro_torch.serve import paging as t_pg
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

# measured max |port - reference| of the serve cases below on a CPU run:
# 2.9e-4 (gate-ragged; dense 4.5e-7, preemption 7.6e-7). The fp engines
# agree to 7.3e-7; int8 adds the case where a 1-ulp difference in a key
# upstream flips one int8 code, a step of abs-max/127 in that element.
LOGIT_TOL = 1e-3
GATE = GateConfig(block_size=8, d_gate=16, token_budget=32)
L, HKV, PS, DH, DG = 2, 2, 8, 16, 16


def randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def eq(t, j):
    """Bitwise equality of a torch tensor and a jax/numpy array."""
    np.testing.assert_array_equal(t.detach().cpu().numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

def _ties():
    """Values that sit exactly on .5 once divided by the scale: the element
    127 makes the scale exactly 1.0, so x / scale == x."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -126.5, 126.5,
                  4.5, 5.5, -5.5, 7.0, 0.0, -127.0], np.float32)
    return x.reshape(1, 1, 4, 4), np.ones((1, 1, 4, 4), bool)


def _garbage():
    r = np.random.default_rng(3)
    x = randn(r, 3, 2, 8, 16)
    x[:, :, 5:] = 1e6                                  # outside the valid rows
    valid = np.broadcast_to(np.arange(8)[:, None] < 5, x.shape).copy()
    return x, valid


QUANT_CASES = {
    "normal": lambda: (randn(np.random.default_rng(0), 4, 2, 8, 16),
                       np.ones((4, 2, 8, 16), bool)),
    "half-ties": _ties,
    "invalid-garbage": _garbage,
    "empty-region": lambda: (randn(np.random.default_rng(1), 2, 3, 8, 4),
                             np.zeros((2, 3, 8, 4), bool)),
    "zeros": lambda: (np.zeros((2, 1, 8, 4), np.float32), np.ones((2, 1, 8, 4), bool)),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_block_bitwise_matches_jax(case):
    """Against the reference compiled as its pools run it (under jit, where
    XLA turns ``amax / 127.0`` into a multiply by the f32 reciprocal)."""
    x, valid = QUANT_CASES[case]()
    tq, tsc = t_pg.quantize_block(torch.tensor(x), torch.tensor(valid))
    jq, jsc = jax.jit(j_pg.quantize_block)(jnp.asarray(x), jnp.asarray(valid))
    assert tq.dtype == torch.int8 and tsc.dtype == torch.float32
    eq(tq, jq)
    eq(tsc, jsc)
    amax = np.max(np.where(valid, np.abs(x), 0), axis=(-2, -1))
    np.testing.assert_array_equal(
        tsc.numpy()[..., 0], np.where(amax > 0, amax * np.float32(1 / 127), 1))
    eq(t_pg.dequantize_block(tq, tsc), j_pg.dequantize_block(jq, jsc))
    if case == "half-ties":                          # round half to even
        np.testing.assert_array_equal(
            tq.numpy().reshape(-1), [127, 0, 2, 2, 0, -2, -2, 4, -126, 126, 4, 6, -6, 7,
                                     0, -127])
        assert float(tsc) == 1.0
    if case in ("empty-region", "zeros"):
        assert (tsc == 1.0).all()
    if case == "zeros":                              # dequantizes to exactly 0
        assert not tq.any()


# ---------------------------------------------------------------------------
# plain fused-dequant decodes (TPU bodies 2q and 4q)
# ---------------------------------------------------------------------------

def _quant_pool_inputs(seed=0, b=2, hkv=2, g=4, dh=32, nb=6, bs=8, nsel=4):
    """The shapes of tests/test_quant.py::_quant_pool_fixture, from numpy:
    int8 pools of nb+1 pages quantized per (page, head) by the reference,
    page amplitudes spread over 0.25..4 so that scale rows differ, a
    rolled page table and a selection holding each row's last block."""
    r = np.random.default_rng(seed)
    q = randn(r, b, hkv, g, dh)
    npool = nb + 1
    amp = r.uniform(0.25, 4.0, size=(npool, hkv, 1, 1)).astype(np.float32)
    kp, vp = randn(r, npool, hkv, bs, dh) * amp, randn(r, npool, hkv, bs, dh) * amp
    kv_len = np.array([nb * bs, nb * bs - 5][:b], np.int32)
    idx = np.full((b, hkv, nsel), -1, np.int32)
    for bi in range(b):
        for hi in range(hkv):
            n = r.integers(1, nsel + 1)
            idx[bi, hi, :n] = r.choice(nb, n, replace=False)
        idx[bi, :, 0] = (int(kv_len[bi]) - 1) // bs
    table = np.stack([1 + np.roll(np.arange(nb), k) for k in range(b)]).astype(np.int32)
    full = jnp.ones(kp.shape, bool)
    kq, ksc = (np.asarray(a) for a in j_pg.quantize_block(jnp.asarray(kp), full))
    vq, vsc = (np.asarray(a) for a in j_pg.quantize_block(jnp.asarray(vp), full))
    return q, kq, vq, ksc, vsc, idx, table, kv_len


@pytest.mark.parametrize("seed,g,nsel", [(0, 4, 4), (5, 2, 5), (6, 1, 1)])
def test_paged_quant_plain_matches_ref_and_pallas(seed, g, nsel):
    q, kq, vq, ksc, vsc, idx, table, kv_len = _quant_pool_inputs(seed, g=g, nsel=nsel)
    bs = kq.shape[2]
    t_in = dict(k_scales=torch.tensor(ksc), v_scales=torch.tensor(vsc))
    o_t = t_bsd.sparse_decode_paged_plain(*map(torch.tensor, (q, kq, vq, idx, table, kv_len)),
                                          block_size=bs, **t_in)
    j_in = tuple(map(jnp.asarray, (q, kq, vq, idx, table, kv_len)))
    j_sc = dict(k_scales=jnp.asarray(ksc), v_scales=jnp.asarray(vsc))
    o_ref = j_ref.paged_sparse_decode_ref(*j_in, block_size=bs, **j_sc)
    o_pal = j_bsd.block_sparse_decode_paged(*j_in, block_size=bs, interpret=True, **j_sc)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_pal), atol=1e-5, rtol=0)
    # the [P, Hkv] reading of the scale rows (the Pallas wrapper's reshape)
    # is the same function, and so is dequantizing the pools first
    o_2d = t_bsd.sparse_decode_paged_plain(
        *map(torch.tensor, (q, kq, vq, idx, table, kv_len)), block_size=bs,
        k_scales=torch.tensor(ksc[..., 0]), v_scales=torch.tensor(vsc[..., 0]))
    assert torch.equal(o_t, o_2d)
    kd, vd = (t_pg.dequantize_block(torch.tensor(a), torch.tensor(s))
              for a, s in ((kq, ksc), (vq, vsc)))
    o_first = t_bsd.sparse_decode_paged_plain(
        torch.tensor(q), kd, vd, *map(torch.tensor, (idx, table, kv_len)), block_size=bs)
    assert torch.equal(o_t, o_first)


def test_paged_quant_plain_never_reads_the_trash_page():
    """Page 0 is written by every idle slot at once, so its contents and
    scale row are undefined; no selected block maps to it."""
    q, kq, vq, ksc, vsc, idx, table, kv_len = _quant_pool_inputs(2)
    args = [torch.tensor(a) for a in (q, kq, vq, idx, table, kv_len)]
    sc = dict(k_scales=torch.tensor(ksc), v_scales=torch.tensor(vsc))
    want = t_bsd.sparse_decode_paged_plain(*args, block_size=8, **sc)
    args[1][0], args[2][0] = 127, -127
    sc["k_scales"][0], sc["v_scales"][0] = float("nan"), float("inf")
    assert torch.equal(t_bsd.sparse_decode_paged_plain(*args, block_size=8, **sc), want)


@pytest.mark.parametrize("seed,g,nsel", [(1, 4, 4), (9, 3, 6)])
def test_contiguous_quant_plain_matches_ref_and_pallas(seed, g, nsel):
    """2q: int8 caches [B, Hkv, S, Dh], one scale per cache block."""
    b, hkv, dh, nb, bs = 2, 2, 32, 6, 8
    r = np.random.default_rng(seed)
    q = randn(r, b, hkv, g, dh)
    amp = r.uniform(0.25, 4.0, size=(b, hkv, nb, 1, 1)).astype(np.float32)
    blk = [randn(r, b, hkv, nb, bs, dh) * amp for _ in range(2)]
    kv_len = np.array([nb * bs, nb * bs - 5], np.int32)
    idx = np.full((b, hkv, nsel), -1, np.int32)
    for bi in range(b):
        for hi in range(hkv):
            n = r.integers(1, nsel + 1)
            idx[bi, hi, :n] = r.choice(nb, n, replace=False)
        idx[bi, :, 0] = (int(kv_len[bi]) - 1) // bs
    (kq, ksc), (vq, vsc) = (
        (np.asarray(c).reshape(b, hkv, nb * bs, dh), np.asarray(s)[..., 0])
        for c, s in (j_pg.quantize_block(jnp.asarray(x), jnp.ones(x.shape, bool))
                     for x in blk))
    o_t = t_bsd.sparse_decode_plain(*map(torch.tensor, (q, kq, vq, idx, kv_len)),
                                    block_size=bs, k_scales=torch.tensor(ksc),
                                    v_scales=torch.tensor(vsc))
    j_in = tuple(map(jnp.asarray, (q, kq, vq, idx, kv_len)))
    j_sc = dict(k_scales=jnp.asarray(ksc), v_scales=jnp.asarray(vsc))
    o_ref = j_ref.sparse_decode_ref(*j_in, block_size=bs, **j_sc)
    o_pal = j_bsd.block_sparse_decode(*j_in, block_size=bs, interpret=True, **j_sc)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_pal), atol=1e-5, rtol=0)
    t_ops.reset_launch_counts()                      # CPU tensors: the plain path
    assert torch.equal(t_ops.sparse_decode(*map(torch.tensor, (q, kq, vq, idx, kv_len)),
                                           block_size=bs, k_scales=torch.tensor(ksc),
                                           v_scales=torch.tensor(vsc)), o_t)
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)


def test_quant_cuda_wrappers_refuse_cpu_tensors():
    q, kq, vq, ksc, vsc, idx, table, kv_len = map(torch.tensor, _quant_pool_inputs(4))
    with pytest.raises(ValueError, match="CUDA"):
        t_bsd.sparse_decode_paged_quant_cuda(q, kq, vq, idx, table, kv_len, block_size=8,
                                             k_scales=ksc, v_scales=vsc)
    with pytest.raises(ValueError, match="CUDA"):
        t_bsd.sparse_decode_quant_cuda(q, kq[:2], vq[:2], idx, kv_len, block_size=8,
                                       k_scales=ksc[:2, :, :1], v_scales=vsc[:2, :, :1])


# ---------------------------------------------------------------------------
# int8 pool helpers
# ---------------------------------------------------------------------------

def _q8_pools(r, n_pages=16):
    """Int8 pools holding quantized random pages, with their scale rows and
    a bf16-free Kg pool, as (port PagedPages, reference PagedPages)."""
    full = jnp.ones((L, n_pages, HKV, PS, DH), bool)
    kq, ksc = (np.asarray(a) for a in j_pg.quantize_block(
        jnp.asarray(randn(r, L, n_pages, HKV, PS, DH)), full))
    vq, vsc = (np.asarray(a) for a in j_pg.quantize_block(
        jnp.asarray(randn(r, L, n_pages, HKV, PS, DH) * 3), full))
    kg = randn(r, L, n_pages, HKV, DG)
    arrays = dict(k_pages=kq, v_pages=vq, kg_pages=kg, k_scale_pages=ksc,
                  v_scale_pages=vsc)
    return (t_pg.PagedPages(**{k: torch.tensor(v) for k, v in arrays.items()}),
            j_pg.PagedPages(**{k: jnp.asarray(v) for k, v in arrays.items()}))


FIELDS = ("k_pages", "v_pages", "kg_pages", "k_scale_pages", "v_scale_pages")


def _eq_live(tp, jp, fields=FIELDS):
    """Bitwise equality of every pool row except the trash page 0."""
    for f in fields:
        eq(getattr(tp, f)[:, 1:], getattr(jp, f)[:, 1:])


@pytest.mark.parametrize("length,ids", [(21, [5, 2, 9]), (24, [3, 11, 7, 1]), (5, [4])])
def test_scatter_prefill_int8_matches_jax(length, ids):
    r = np.random.default_rng(length + 100)
    s_max = 4 * PS
    kc, vc = randn(r, L, 1, HKV, s_max, DH), randn(r, L, 1, HKV, s_max, DH)
    kc[..., length:, :] = 50.0                      # past the prompt: must not scale
    kgc = randn(r, L, 1, HKV, s_max // PS, DG)
    tp, jp = _q8_pools(r)
    t_pg.scatter_prefill(tp, torch.tensor(kc), torch.tensor(vc), torch.tensor(kgc),
                         length, t_pg.pad_page_ids(ids), PS)
    jp = j_pg.scatter_prefill(jp, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kgc),
                              jnp.asarray(length, jnp.int32), j_pg.pad_page_ids(ids), PS)
    _eq_live(tp, jp)
    last = ids[(length - 1) // PS]
    assert float(tp.k_scale_pages[:, last].max()) < 50.0 / 127


def f32(x):
    """A torch tensor or jax array as a float32 numpy array (bf16 exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len,active", [
    ([7, 15, 3], [True, True, True]),      # two pages complete, one does not
    ([23, 0, 9], [True, False, True]),     # an idle slot routes to the null page
    ([0, 8, 31], [True, True, True]),      # a lone token; a page opens; 4th page fills
])
def test_append_token_paged_quant_matches_jax(cur_len, active, dtype):
    """The K/V append requantizes the trailing page (codes and scales
    bitwise); a completed page's Kg row comes from its dequantized fp32
    keys, projected by the gate weights in the working dtype. In bf16 the
    fp32 projection promotes as jnp.einsum does, and the row is held to
    one bf16 rounding."""
    r = np.random.default_rng(sum(cur_len) + 7)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    def both(x):
        return torch.tensor(x).to(tdt), jnp.asarray(x).astype(jdt)

    tgp, jgp = {}, {}
    for k, shp in (("wq", (HKV, 2 * DH, DG)), ("wk", (HKV, 3 * DH, DG))):
        tgp[k], jgp[k] = both(randn(r, *shp) * 0.2)
    tp, jp = _q8_pools(r)
    layer = [getattr(tp, f)[0] for f in FIELDS]
    jk, jv, jkg, jks, jvs = (getattr(jp, f)[0] for f in FIELDS)
    layer[2], jkg = layer[2].to(tdt), jkg.astype(jdt)
    cl, act = np.array(cur_len, np.int32), np.array(active)
    pt = np.stack([r.permutation(np.arange(1, 16))[:4] for _ in range(3)]).astype(np.int32)
    pt[1] = np.setdiff1d(np.arange(1, 16), pt[[0, 2]].ravel())[:4]     # distinct pages
    (tkr, jkr), (tvn, jvn) = both(randn(r, 3, HKV, DH)), both(randn(r, 3, HKV, DH) * 5)
    kg_before = layer[2].clone()
    t_pg.append_token_paged_quant(layer[0], layer[1], layer[2], layer[3], layer[4],
                                  tkr, tvn, torch.tensor(pt), torch.tensor(cl),
                                  torch.tensor(act), tgp,
                                  t_config.GateConfig(**dataclasses.asdict(GATE)))
    # jitted, as the reference's decode step runs it
    jk, jv, jkg, jks, jvs = jax.jit(functools.partial(
        j_pg.append_token_paged_quant, cfg=GATE))(
        jk, jv, jkg, jks, jvs, jkr, jvn, jnp.asarray(pt), jnp.asarray(cl),
        jnp.asarray(act), jgp)
    for t, j in zip((layer[0], layer[1], layer[3], layer[4]), (jk, jv, jks, jvs)):
        eq(t[1:], j[1:])                             # requantized pages, bitwise
    assert layer[2].dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    done = [pt[i, c // PS] for i, c in enumerate(cur_len) if act[i] and (c + 1) % PS == 0]
    for page in range(1, 16):
        if page in done:       # pooled + projected from the dequantized keys
            np.testing.assert_allclose(f32(layer[2][page]), f32(jkg[page]), atol=tol, rtol=tol)
            assert not torch.equal(layer[2][page], kg_before[page])
        else:
            np.testing.assert_array_equal(f32(layer[2][page]), f32(jkg[page]))
            assert torch.equal(layer[2][page], kg_before[page])
    for i, c in enumerate(cur_len):                  # the new row reads back
        if act[i]:
            page = pt[i, c // PS]
            got = t_pg.dequantize_block(layer[1][page], layer[4][page])[:, c % PS]
            np.testing.assert_allclose(got.numpy(), f32(tvn[i]),
                                       atol=float(layer[4][page].max()) / 2 + 1e-6)


def test_extract_restore_reset_gather_int8_match_jax():
    r = np.random.default_rng(12)
    tp, jp = _q8_pools(r)
    ids = [7, 3, 12]
    t_out = t_pg.extract_pages(tp, t_pg.pad_page_ids(ids))
    j_out = j_pg.extract_pages(jp, j_pg.pad_page_ids(ids))
    assert t_out[3] is None and t_out[4] is None
    assert t_out[0].dtype == torch.int8 and t_out[0].device.type == "cpu"
    for i in (0, 1, 2, 5, 6):
        eq(t_out[i], j_out[i])
    new = [9, 1, 14]
    t_pg.restore_pages(tp, t_out[0], t_out[1], t_out[2], t_pg.pad_page_ids(new),
                       k_scale=t_out[5], v_scale=t_out[6])
    jp = j_pg.restore_pages(jp, j_out[0], j_out[1], j_out[2], j_pg.pad_page_ids(new),
                            k_scale=j_out[5], v_scale=j_out[6])
    _eq_live(tp, jp)
    for a, b in zip(ids, new):                       # raw bytes and scale rows move
        for f in FIELDS:
            assert torch.equal(getattr(tp, f)[:, b], getattr(tp, f)[:, a])
    t_pg.reset_kg_rows(tp, t_pg.pad_page_ids([9, 14, 2]))
    jp = j_pg.reset_kg_rows(jp, j_pg.pad_page_ids([9, 14, 2]))
    _eq_live(tp, jp)
    assert not tp.k_scale_pages[:, [9, 14, 2]].any()
    assert not tp.v_scale_pages[:, [9, 14, 2]].any()
    pt = np.array([[5, 9, 2, 0], [4, 11, 0, 0], [13, 0, 0, 0]], np.int32)
    for f, s in (("k_pages", "k_scale_pages"), ("v_pages", "v_scale_pages")):
        eq(t_pg.gather_kv(getattr(tp, f)[1], torch.tensor(pt[:, :3]), getattr(tp, s)[1]),
           j_pg.gather_kv(getattr(jp, f)[1], jnp.asarray(pt[:, :3]), getattr(jp, s)[1]))


# ---------------------------------------------------------------------------
# serve() with int8 pools, against the reference's
# ---------------------------------------------------------------------------

PREEMPT = [(20, 12), (18, 10), (22, 9)]
CASES = {
    "gate-ragged": ([(21, 8), (37, 5), (16, 11), (29, 7), (21, 4)], dict(n_slots=3), False),
    "dense": ([(13, 6), (26, 4), (9, 8)], dict(n_slots=2), True),
    "preemption": (PREEMPT, dict(n_slots=3, num_pages=8), False),
}
COUNTERS = ("preemptions", "resumed", "admitted", "retired", "decode_steps",
            "peak_pages_used", "swapped_out_bytes", "swapped_in_bytes",
            "retired_preempted", "max_active_slots")


def _requests(vocab, specs, seed=2):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": m,
             "tokens": rng.integers(0, vocab, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate(specs)]


@pytest.fixture(scope="module")
def model():
    jcfg = G.tiny_cfg("budget")
    params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
    tcfg = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    tcfg = tcfg.replace(gate=dataclasses.replace(tcfg.gate, block_size=8, d_gate=16,
                                                 token_budget=32, threshold=2e-2))
    return jcfg, params, tcfg, params_from_numpy(jax.device_get(params), tcfg, "cpu")


def _port(model, dense=False):
    _, _, tcfg, tparams = model
    opts = TOptions(quantize="int8")
    if dense:
        opts = opts.replace(policy=TDense())
    return DecodeEngine(tcfg, tparams, max_len=64, options=opts, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_serve_int8_matches_jax(model, name):
    specs, kw, dense = CASES[name]
    jcfg, params, _, _ = model
    j_opts = JOptions(quantize="int8", policy=JDense()) if dense \
        else JOptions(quantize="int8")
    reqs = _requests(jcfg.vocab_size, specs)
    j_res = JaxEngine(jcfg, params, max_len=64, options=j_opts).serve(
        [dict(r) for r in reqs], collect_logits=True, **kw)
    t_ops.reset_launch_counts()
    t_res = _port(model, dense).serve([dict(r) for r in reqs], collect_logits=True, **kw)
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)
    assert t_res["stats"]["retired"] == len(specs)
    for rid in range(len(specs)):
        assert t_res[rid] == j_res[rid], f"rid {rid} tokens"
        np.testing.assert_allclose(t_res["logits"][rid], j_res["logits"][rid],
                                   atol=LOGIT_TOL, rtol=0)
    for key in COUNTERS:
        assert t_res["stats"][key] == j_res["stats"][key], key
    for rid, rho in j_res["stats"]["sparsity_by_rid"].items():
        assert t_res["stats"]["sparsity_by_rid"][rid] == pytest.approx(rho, abs=1e-6)
    if name == "preemption":
        assert t_res["stats"]["preemptions"] > 0
        assert t_res["stats"]["swapped_out_bytes"] == t_res["stats"]["swapped_in_bytes"]


def test_serve_int8_tight_equals_ample_bitwise_and_swaps_fewer_bytes(model):
    """Preempt -> swap the raw int8 bytes and scale rows -> resume into
    other pages is lossless; the swap moves int8 K/V (1 B) plus two f32
    scales per (page, head) where the fp32 pools move 4 B per element."""
    _, _, tcfg, tparams = model
    reqs = _requests(tcfg.vocab_size, PREEMPT)
    eng = _port(model)
    ample = eng.serve([dict(r) for r in reqs], n_slots=3, collect_logits=True)
    tight = eng.serve([dict(r) for r in reqs], n_slots=3, num_pages=8, collect_logits=True)
    st = tight["stats"]
    assert ample["stats"]["preemptions"] == 0 < st["preemptions"] == st["resumed"]
    for rid in range(len(PREEMPT)):
        assert tight[rid] == ample[rid]
        np.testing.assert_array_equal(tight["logits"][rid], ample["logits"][rid])
    fp = DecodeEngine(tcfg, tparams, max_len=64, device="cpu").serve(
        [dict(r) for r in reqs], n_slots=3, num_pages=8)
    assert fp["stats"]["preemptions"] == st["preemptions"]
    # bytes per swapped (layer, page, kv head), fp32 working dtype
    ps, dh, dg = tcfg.gate.block_size, tcfg.resolved_head_dim, tcfg.gate.d_gate
    rows = tcfg.num_layers * tcfg.n_kv_heads
    per_q8, per_fp = 2 * ps * dh + 4 * dg + 2 * 4, 4 * (2 * ps * dh + dg)
    n_pages = st["swapped_out_bytes"] // (rows * per_q8)
    assert n_pages > 0 and st["swapped_out_bytes"] == n_pages * rows * per_q8
    assert fp["stats"]["swapped_out_bytes"] == n_pages * rows * per_fp


def test_generate_ignores_quantize(model):
    """As in the reference, ``quantize`` is read by the paged path only:
    the contiguous ``generate`` stays the fp program."""
    _, _, tcfg, tparams = model
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 19)).astype(np.int32)
    a = DecodeEngine(tcfg, tparams, max_len=64, device="cpu").generate({"tokens": toks}, 5)
    b = _port(model).generate({"tokens": toks}, 5)
    assert torch.equal(a["tokens"], b["tokens"])
