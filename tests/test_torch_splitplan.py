"""The split plan of the port's block-sparse decode (TPU kernels #2 and #4,
and their int8 bodies 2q and 4q), on the CPU.

The CUDA body cuts each (b, kv-head)'s selected list into
``split_plan(B, Hkv, nsel, n_sm)`` segments, one CTA each, and combines
their flash partials with the split-K rescale. The plan must be a pure
function of those four numbers, never of kv_len, the pool or the page
table: the contiguous and the paged entry points, a tight and an ample
pool and shuffled pages then reduce the same segments in the same order,
bitwise. These tests hold:

  * the planner: deterministic, at least one segment, its segments
    covering ``[0, nsel)`` exactly and none empty;
  * the wrappers: what they hand the library (driven with a stand-in
    library that records its arguments) depends on the shapes only; the
    split-K wrappers (kernels 5 and 5q, the same body's paged instances)
    hand it the caller's num_splits instead;
  * the arithmetic: ``sparse_decode_paged_splitk_plain`` over the plan's
    segments equals ``sparse_decode_paged_plain`` within 1e-5 in fp32 (the
    split only reorders fp32 sums: the two-pass rescale is exact
    algebra), and both match the JAX reference (``ref.paged_sparse_decode_ref``
    and ``ref.paged_sparse_decode_splitk_ref``, the Pallas split-K kernel in
    interpret mode) at the bounds of tests/test_torch_splitk.py; over
    int8 pools with f32 scale rows too (the bounds of
    tests/test_torch_quant.py), and over int8 contiguous caches paged under
    a shuffled table against ``ref.sparse_decode_ref`` with scales.

Inputs come from a numpy seed.
"""
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import block_sparse_decode as j_bsd
from repro.kernels import ref as j_ref
from repro.serve import paging as j_pg
from repro_torch.kernels import block_sparse_decode as t_bsd
from repro_torch.kernels import build, ops

jax.config.update("jax_platform_name", "cpu")

# (B, Hkv, nsel, SMs): the main path on an H100, small and odd shapes,
# fewer entries than the plan's minimum, and a card with few SMs
PLAN_CASES = [(4, 8, 64, 132), (4, 8, 64, 114), (1, 8, 64, 132), (2, 2, 4, 132),
              (3, 1, 6, 132), (1, 1, 1, 132), (8, 8, 64, 132), (4, 8, 100, 132),
              (1, 2, 4096, 132), (2, 4, 33, 16), (16, 16, 64, 132), (1, 1, 7, 1)]


@pytest.mark.parametrize("b,hkv,nsel,n_sm", PLAN_CASES)
def test_split_plan_segments_cover_the_list(b, hkv, nsel, n_sm):
    ns = t_bsd.split_plan(b, hkv, nsel, n_sm)
    assert ns >= 1 and ns == t_bsd.split_plan(b, hkv, nsel, n_sm)
    segs = t_bsd.split_segments(nsel, ns)
    assert len(segs) == ns
    assert segs[0][0] == 0 and segs[-1][1] == nsel
    for (a0, a1), (b0, _) in zip(segs, segs[1:]):
        assert a1 == b0
    assert all(j1 > j0 for j0, j1 in segs)               # no empty segment
    # a split list gives each segment but the last at least the minimum
    if ns > 1:
        assert segs[0][1] - segs[0][0] >= t_bsd.SPLIT_MIN_ENTRIES


def test_split_plan_fills_the_card_at_the_main_path():
    """8 segments of 8 blocks at 4 x 8 heads x 64 blocks on 132 SMs: 256
    CTAs, about two an SM; a row with few entries keeps one segment."""
    assert t_bsd.split_plan(4, 8, 64, 132) == 8
    assert t_bsd.split_segments(64, 8) == [(8 * s, 8 * s + 8) for s in range(8)]
    assert t_bsd.split_plan(2, 2, 4, 132) == 1
    assert list(inspect.signature(t_bsd.split_plan).parameters) == ["batch", "hkv", "nsel",
                                                                    "n_sm"]


def test_split_segments_past_the_list_are_empty():
    """An explicit num_splits above nsel (a test or a sweep) leaves empty
    segments at the end, as the reference's padding does."""
    segs = t_bsd.split_segments(3, 5)
    assert segs == [(0, 1), (1, 2), (2, 3), (3, 3), (3, 3)]


class _Entry:
    """Stands in for a C entry point: records its arguments, returns 0."""
    argtypes = None

    def __init__(self, calls):
        self.calls = calls

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers of the sm90 body (fp and int8) driven on CPU tensors
    against a stand-in library; yields the list of calls it received."""
    calls = []
    lib = types.SimpleNamespace(block_sparse_decode_sm90_launch=_Entry(calls),
                                block_sparse_decode_sm90_paged_launch=_Entry(calls),
                                block_sparse_decode_sm90_quant_launch=_Entry(calls),
                                block_sparse_decode_sm90_paged_quant_launch=_Entry(calls))
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(t_bsd, "_check", lambda *a, **k: None)
    monkeypatch.setattr(t_bsd, "n_sm", lambda device: 132)
    monkeypatch.setattr(t_bsd.torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _case(seed, b, hkv, g, dh, npt, bs, nsel, n_pages, kv_len):
    r = np.random.default_rng(seed)
    q = torch.tensor(r.standard_normal((b, hkv, g, dh)).astype(np.float32))
    k = torch.tensor(r.standard_normal((b, hkv, npt * bs, dh)).astype(np.float32))
    kp = torch.tensor(r.standard_normal((n_pages, hkv, bs, dh)).astype(np.float32))
    idx = torch.tensor(r.integers(-1, npt, (b, hkv, nsel)).astype(np.int32))
    pt = torch.tensor(r.integers(0, n_pages, (b, npt)).astype(np.int32))
    return q, k, kp, idx, pt, torch.tensor(np.full((b,), kv_len, np.int32))


@pytest.mark.parametrize("b,hkv,nsel", [(4, 8, 64), (2, 2, 4), (1, 8, 33)])
def test_wrappers_plan_from_the_shapes_only(recorded, b, hkv, nsel):
    """The contiguous and paged wrappers hand the library the same
    num_splits for the same (B, Hkv, nsel), whatever kv_len, the cache
    length, the pool size and the page table; a workspace exactly when
    ns > 1; and an explicit num_splits passes through."""
    g, dh, bs = 2, 16, 8
    want = t_bsd.split_plan(b, hkv, nsel, 132)
    seen = set()
    for seed, npt, n_pages, kv_len in ((0, 9, 40, 70), (1, 12, 100, 5), (2, 9, 73, 72)):
        q, k, kp, idx, pt, lens = _case(seed, b, hkv, g, dh, npt, bs, nsel, n_pages, kv_len)
        recorded.clear()
        t_bsd.sparse_decode_cuda(q, k, k, idx, lens, block_size=bs)
        t_bsd.sparse_decode_paged_cuda(q, kp, kp, idx, pt, lens, block_size=bs)
        (c_args, p_args) = recorded
        # ints after the 7 (contiguous) / 8 (paged) pointers: B, H, G, Dh,
        # S or npt, nsel, bs, num_splits
        assert c_args[7:11] == p_args[8:12] == (b, hkv, g, dh)
        assert c_args[12:15] == p_args[13:16] == (nsel, bs, want)
        seen.add((c_args[14], p_args[15]))
        for wp in (c_args[6], p_args[7]):
            assert (wp != 0) == (want > 1)
    assert seen == {(want, want)}
    recorded.clear()
    t_bsd.sparse_decode_cuda(q, k, k, idx, lens, block_size=bs, num_splits=nsel + 3)
    assert recorded[0][14] == nsel + 3 and recorded[0][6] != 0
    with pytest.raises(ValueError, match="num_splits"):
        t_bsd.sparse_decode_cuda(q, k, k, idx, lens, block_size=bs, num_splits=0)


def _q8(x, bs, seed):
    """int8 codes of x [..., S, Dh] with one f32 scale per block of bs rows
    (random amplitudes, so scales differ from block to block)."""
    *lead, s, dh = x.shape
    gen = torch.Generator().manual_seed(seed)
    amp = 0.25 + 4 * torch.rand(*lead, s // bs, 1, 1, generator=gen)
    blk = x.reshape(*lead, s // bs, bs, dh) * amp
    amax = blk.abs().amax(dim=(-2, -1), keepdim=True)
    sc = amax / 127
    return torch.round(blk / sc).to(torch.int8).reshape(x.shape), sc[..., 0, 0]


@pytest.mark.parametrize("b,hkv,nsel", [(4, 8, 64), (2, 2, 4), (1, 8, 33)])
def test_quant_wrappers_plan_from_the_shapes_only(recorded, b, hkv, nsel):
    """The int8 twins (2q, 4q): the same num_splits for the same (B, Hkv,
    nsel) as the fp plan, whatever kv_len, the cache length, the pool size
    and the page table; the scales' pointers and, contiguous, the scales
    per (b, head) row handed over; a workspace exactly when ns > 1; an
    explicit num_splits passed through, 0 refused; as many arguments as
    the entry point declares."""
    g, dh, bs = 2, 16, 8
    want = t_bsd.split_plan(b, hkv, nsel, 132)
    seen = set()
    for seed, npt, n_pages, kv_len in ((0, 9, 40, 70), (1, 12, 100, 5), (2, 9, 73, 72)):
        q, k, kp, idx, pt, lens = _case(seed, b, hkv, g, dh, npt, bs, nsel, n_pages, kv_len)
        (kq, ks), (kpq, kps) = _q8(k, bs, seed), _q8(kp, bs, seed)
        kps = kps.reshape(n_pages, hkv, 1)
        recorded.clear()
        t_bsd.sparse_decode_quant_cuda(q, kq, kq, idx, lens, block_size=bs, k_scales=ks,
                                       v_scales=ks)
        t_bsd.sparse_decode_paged_quant_cuda(q, kpq, kpq, idx, pt, lens, block_size=bs,
                                             k_scales=kps, v_scales=kps)
        (c_args, p_args) = recorded
        # 9 (contiguous) / 10 (paged) pointers, the scales 4th and 5th; then
        # B, H, G, Dh, S and nsb or npt, nsel, bs, num_splits
        assert len(c_args) == 21 and len(p_args) == 21
        assert c_args[3:5] == (ks.data_ptr(),) * 2 and p_args[3:5] == (kps.data_ptr(),) * 2
        assert c_args[9:13] == p_args[10:14] == (b, hkv, g, dh)
        assert c_args[13:15] == (npt * bs, npt) and p_args[14] == npt
        assert c_args[15:18] == p_args[15:18] == (nsel, bs, want)
        seen.add((c_args[17], p_args[17]))
        for wp in (c_args[8], p_args[9]):
            assert (wp != 0) == (want > 1)
    assert seen == {(want, want)}
    recorded.clear()
    t_bsd.sparse_decode_paged_quant_cuda(q, kpq, kpq, idx, pt, lens, block_size=bs,
                                         k_scales=kps, v_scales=kps, num_splits=nsel + 3)
    assert recorded[0][17] == nsel + 3 and recorded[0][9] != 0
    for fn, args in ((t_bsd.sparse_decode_quant_cuda, (q, kq, kq, idx, lens)),
                     (t_bsd.sparse_decode_paged_quant_cuda, (q, kpq, kpq, idx, pt, lens))):
        sc = ks if fn is t_bsd.sparse_decode_quant_cuda else kps
        with pytest.raises(ValueError, match="num_splits"):
            fn(*args, block_size=bs, k_scales=sc, v_scales=sc, num_splits=0)



SM90_ENTRIES = ("block_sparse_decode_sm90_launch", "block_sparse_decode_sm90_paged_launch",
                "block_sparse_decode_sm90_quant_launch",
                "block_sparse_decode_sm90_paged_quant_launch")


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("nsel,num_splits", [(64, 4), (33, 4), (6, 4), (64, 1), (33, 36),
                                             (4, 7)])
def test_splitk_wrappers_take_the_callers_num_splits(recorded, monkeypatch, quant, nsel,
                                                     num_splits):
    """Kernels 5 and 5q launch the sm90 body's paged entry point (fp, or
    int8) at the caller's num_splits, never the split plan's (which differs
    in every case here), also where it does not divide nsel and at nsel +
    3; a workspace exactly when num_splits > 1; each call bumps the
    wrapper's own launch counter and no other; num_splits 0 is refused and
    launches nothing."""
    b, hkv, g, dh, bs, npt, n_pages = 4, 8, 2, 16, 8, 9, 40
    assert num_splits != t_bsd.split_plan(b, hkv, nsel, 132)
    q, _, kp, idx, pt, lens = _case(0, b, hkv, g, dh, npt, bs, nsel, n_pages, 70)
    lib = build.load("block_sparse_decode_sm90")
    per_entry = {name: [] for name in SM90_ENTRIES}
    for name, calls in per_entry.items():
        setattr(lib, name, _Entry(calls))
    sources = []
    monkeypatch.setattr(build, "load", lambda name: sources.append(name) or lib)
    if quant:
        kq, ks = _q8(kp, bs, 0)
        ks = ks.reshape(n_pages, hkv, 1)
        fn, kw = t_bsd.sparse_decode_paged_splitk_quant_cuda, dict(k_scales=ks, v_scales=ks)
        kp, entry, n_ptr = kq, SM90_ENTRIES[3], 10
        counter = "block_sparse_decode_paged_splitk_quant"
    else:
        fn, kw = t_bsd.sparse_decode_paged_splitk_cuda, {}
        counter, entry, n_ptr = "block_sparse_decode_paged_splitk", SM90_ENTRIES[1], 8
    ops.reset_launch_counts()
    fn(q, kp, kp, idx, pt, lens, block_size=bs, num_splits=num_splits, **kw)
    assert sources == ["block_sparse_decode_sm90"]
    assert {name: len(c) for name, c in per_entry.items()} == {
        name: int(name == entry) for name in SM90_ENTRIES}
    (args,) = per_entry[entry]
    # n_ptr pointers (the workspace last), then B, H, G, Dh, npt, nsel, bs,
    # num_splits
    assert args[n_ptr:n_ptr + 8] == (b, hkv, g, dh, npt, nsel, bs, num_splits)
    assert (args[n_ptr - 1] != 0) == (num_splits > 1)
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), counter: 1}
    with pytest.raises(ValueError, match="num_splits"):
        fn(q, kp, kp, idx, pt, lens, block_size=bs, num_splits=0, **kw)
    assert len(per_entry[entry]) == 1
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0), counter: 1}


HKV, PS, DH = 2, 8, 16


def _inputs(seed, s, g, npt, nsel):
    """q, fp pools (the trash page 0 at 1e6), ids with -1 padding and one
    (slot, head) row with no valid key, a shuffled table, kv_len with a
    partial last block."""
    r = np.random.default_rng(seed)
    n_pages = s * npt + 1
    q = r.standard_normal((s, HKV, g, DH)).astype(np.float32)
    kp = r.standard_normal((n_pages, HKV, PS, DH)).astype(np.float32)
    vp = r.standard_normal((n_pages, HKV, PS, DH)).astype(np.float32)
    kp[0] = vp[0] = 1e6
    kv_len = r.integers((npt - 1) * PS + 1, npt * PS, size=(s,)).astype(np.int32)
    pt = (1 + r.permutation(s * npt)).reshape(s, npt).astype(np.int32)
    idx = np.full((s, HKV, nsel), -1, np.int32)
    for i in range(s):
        for h in range(HKV):
            n = r.integers(1, min(nsel, npt) + 1)
            idx[i, h, :n] = np.concatenate([[npt - 1], r.choice(npt - 1, n - 1,
                                                                replace=False)])
            idx[i, h] = r.permutation(idx[i, h])
    idx[0, 0] = -1
    return q, kp, vp, idx, pt, kv_len


# (slots, G, npt, nsel, SMs): SM counts chosen so the plan splits
PLAIN_CASES = [(3, 2, 40, 32, 132), (2, 5, 24, 16, 132), (1, 2, 64, 64, 8),
               (4, 1, 20, 12, 132)]


@pytest.mark.parametrize("s,g,npt,nsel,n_sm", PLAIN_CASES)
def test_plain_over_the_plan_equals_the_paged_plain(s, g, npt, nsel, n_sm):
    """The split-K plain version over the plan's segments is the paged
    plain decode within 1e-5 (fp32; the split only reorders sums), and both
    match the JAX reference: the split-free ref within 1e-6, the split-K
    ref within 1e-6 and the Pallas split-K kernel in interpret mode within
    1e-5 (tests/test_torch_splitk.py's bounds); the row with no valid key
    is 0."""
    ns = t_bsd.split_plan(s, HKV, nsel, n_sm)
    assert ns > 1
    q, kp, vp, idx, pt, kv_len = _inputs(21, s, g, npt, nsel)
    t_in = [torch.tensor(x) for x in (q, kp, vp, idx, pt, kv_len)]
    j_in = [jnp.asarray(x) for x in (q, kp, vp, idx, pt, kv_len)]
    o_split = t_bsd.sparse_decode_paged_splitk_plain(*t_in, block_size=PS, num_splits=ns)
    o_one = t_bsd.sparse_decode_paged_plain(*t_in, block_size=PS)
    np.testing.assert_allclose(o_split.numpy(), o_one.numpy(), atol=1e-5, rtol=0)
    o_ref = np.asarray(j_ref.paged_sparse_decode_ref(*j_in, block_size=PS))
    o_ref_split = np.asarray(j_ref.paged_sparse_decode_splitk_ref(*j_in, block_size=PS,
                                                                  num_splits=ns))
    o_pal = np.asarray(j_bsd.block_sparse_decode_paged_splitk(*j_in, block_size=PS,
                                                              num_splits=ns, interpret=True))
    np.testing.assert_allclose(o_one.numpy(), o_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(o_split.numpy(), o_ref_split, atol=1e-6, rtol=0)
    np.testing.assert_allclose(o_split.numpy(), o_pal, atol=1e-5, rtol=0)
    assert torch.equal(o_split[0, 0], torch.zeros_like(o_split[0, 0]))


def _inputs_int8(seed, s, g, npt, nsel):
    """``_inputs``'s pools quantized: int8 codes of pages with amplitudes
    0.25..4, an f32 scale row [P, Hkv, 1] per page (the reference's
    ``quantize_block``); the trash page 0's codes 127 and scale rows 1e6."""
    q, kp, vp, idx, pt, kv_len = _inputs(seed, s, g, npt, nsel)
    r = np.random.default_rng(seed + 1)
    full = jnp.ones((1,) + kp.shape[1:], bool)
    pools = []
    for x in (kp, vp):
        x = x * r.uniform(0.25, 4.0, size=(x.shape[0], HKV, 1, 1)).astype(np.float32)
        c, sc = (np.array(a) for a in j_pg.quantize_block(jnp.asarray(x), full))
        c[0], sc[0] = 127, 1e6
        pools += [c, sc]
    return q, pools[0], pools[2], pools[1], pools[3], idx, pt, kv_len


@pytest.mark.parametrize("s,g,npt,nsel,n_sm", PLAIN_CASES)
def test_int8_plain_over_the_plan_equals_the_paged_plain(s, g, npt, nsel, n_sm):
    """The int8 twin (4q over the plan): the split-K plain version with the
    pools' scale rows over the plan's segments is the paged plain decode
    with them within 1e-5 (fp32), and both match the JAX reference: the
    split-free ref within 1e-5 (tests/test_torch_quant.py's bound), the
    split-K ref and the Pallas split-K kernel in interpret mode within 1e-5
    (tests/test_torch_splitk.py's int8 bounds); the row with no valid key
    is 0."""
    ns = t_bsd.split_plan(s, HKV, nsel, n_sm)
    assert ns > 1
    q, kq, vq, ks, vs, idx, pt, kv_len = _inputs_int8(23, s, g, npt, nsel)
    t_in = [torch.tensor(x) for x in (q, kq, vq, idx, pt, kv_len)]
    t_sc = dict(k_scales=torch.tensor(ks), v_scales=torch.tensor(vs))
    j_in = [jnp.asarray(x) for x in (q, kq, vq, idx, pt, kv_len)]
    j_sc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    o_split = t_bsd.sparse_decode_paged_splitk_plain(*t_in, block_size=PS, num_splits=ns,
                                                     **t_sc)
    o_one = t_bsd.sparse_decode_paged_plain(*t_in, block_size=PS, **t_sc)
    np.testing.assert_allclose(o_split.numpy(), o_one.numpy(), atol=1e-5, rtol=0)
    o_ref = np.asarray(j_ref.paged_sparse_decode_ref(*j_in, block_size=PS, **j_sc))
    o_ref_split = np.asarray(j_ref.paged_sparse_decode_splitk_ref(
        *j_in, block_size=PS, num_splits=ns, **j_sc))
    o_pal = np.asarray(j_bsd.block_sparse_decode_paged_splitk(
        *j_in, block_size=PS, num_splits=ns, interpret=True, **j_sc))
    np.testing.assert_allclose(o_one.numpy(), o_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_split.numpy(), o_ref_split, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_split.numpy(), o_pal, atol=1e-5, rtol=0)
    assert torch.equal(o_split[0, 0], torch.zeros_like(o_split[0, 0]))


@pytest.mark.parametrize("s,g,npt,nsel,n_sm", PLAIN_CASES)
def test_int8_contiguous_plain_over_the_plan(s, g, npt, nsel, n_sm):
    """2q over the plan: int8 contiguous caches with a scale per cache
    block, paged under a shuffled table (each page's scale row beside it).
    The split-K plain version over the plan's segments equals the
    contiguous plain decode with scales within 1e-5 (fp32), and that
    matches ``ref.sparse_decode_ref`` with the same scales within 1e-5
    (tests/test_torch_quant.py's bound)."""
    ns = t_bsd.split_plan(s, HKV, nsel, n_sm)
    q, kq, vq, ks, vs, idx, pt, kv_len = _inputs_int8(29, s, g, npt, nsel)
    # the contiguous caches and per-block scales the pools hold under pt
    kc, vc = (c[pt].transpose(0, 2, 1, 3, 4).reshape(s, HKV, npt * PS, DH) for c in (kq, vq))
    ksc, vsc = (sc[pt][..., 0].transpose(0, 2, 1) for sc in (ks, vs))      # [s, Hkv, npt]
    o_con = t_bsd.sparse_decode_plain(*map(torch.tensor, (q, kc, vc, idx, kv_len)),
                                      block_size=PS, k_scales=torch.tensor(ksc),
                                      v_scales=torch.tensor(vsc))
    o_split = t_bsd.sparse_decode_paged_splitk_plain(
        *map(torch.tensor, (q, kq, vq, idx, pt, kv_len)), block_size=PS, num_splits=ns,
        k_scales=torch.tensor(ks), v_scales=torch.tensor(vs))
    np.testing.assert_allclose(o_split.numpy(), o_con.numpy(), atol=1e-5, rtol=0)
    o_ref = np.asarray(j_ref.sparse_decode_ref(
        *map(jnp.asarray, (q, kc, vc, idx, kv_len)), block_size=PS,
        k_scales=jnp.asarray(np.ascontiguousarray(ksc)),
        v_scales=jnp.asarray(np.ascontiguousarray(vsc))))
    np.testing.assert_allclose(o_con.numpy(), o_ref, atol=1e-5, rtol=0)
    assert torch.equal(o_con[0, 0], torch.zeros_like(o_con[0, 0]))
