"""Parity of the port's paged pieces against the live JAX reference.

Every input comes from a numpy seed and goes through both packages:

  * ``gate_select_paged_plain`` against ``gate_select_paged_ref`` and the
    Pallas ``fused_gate_select_paged`` in interpret mode, over budget/
    threshold x force flags x ``max_selected`` None/3, with a shuffled page
    table whose entries past ``n_valid`` are the null page: ids exactly
    equal, a constructed exact tie included;
  * ``sparse_decode_paged_plain`` against ``ref.paged_sparse_decode_ref``
    and the Pallas ``block_sparse_decode_paged`` in interpret mode, with -1
    padding and a partial last block: atol 1e-5 in fp32;
  * the page-pool helpers (``scatter_prefill``, ``append_token_paged``,
    ``finalize_kg_paged``, ``extract_pages``/``restore_pages``,
    ``reset_kg_rows``, ``gather_kv``, ``gather_kg``): every moved value
    bitwise equal in fp32; a freshly finalized Kg row is computed (pool +
    projection + RoPE) and held to 1e-5, as ``core.kcache`` is;
  * ``lm_prefill`` with right-padded ``lengths``: logits within 1e-5, the
    Kg rows of blocks touching pad tokens zero;
  * the port's ``Scheduler`` and the reference's, driven by the same
    request stream under lazy and reserve admission, a watermark and
    forced growth: the same page tables, admissions and victims at every
    step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capture_golden_policy as G
from repro.config import GateConfig
from repro.kernels import block_sparse_decode as j_bsd
from repro.kernels import gate_select as j_gs
from repro.kernels import ref as j_ref
from repro.models.registry import get_api as j_get_api
from repro.serve import paging as j_pg
from repro.serve import scheduler as j_sch
from repro_torch import config as t_config
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import block_sparse_decode as t_bsd
from repro_torch.kernels import gate_select as t_gs
from repro_torch.kernels import ops as t_ops
from repro_torch.models import transformer as t_tf
from repro_torch.serve import paging as t_pg
from repro_torch.serve import scheduler as t_sch

jax.config.update("jax_platform_name", "cpu")

_GS = dict(block_size=8, d_gate=16, token_budget=32)
GS_CONFIGS = [
    GateConfig(**_GS, method="budget"),
    GateConfig(**_GS, method="budget", always_first_block=False),
    GateConfig(**_GS, method="budget", always_first_block=False,
               always_last_block=False),
    GateConfig(**_GS, method="threshold", threshold=5e-3),
    GateConfig(**_GS, method="threshold", threshold=2e-2,
               always_first_block=False, always_last_block=False),
]
GS_IDS = [f"{c.method}_ff{int(c.always_first_block)}_fl{int(c.always_last_block)}"
          for c in GS_CONFIGS]
L, P, HKV, PS, DH, DG = 2, 16, 2, 8, 16, 16


def tcfg(g: GateConfig):
    return t_config.GateConfig(**dataclasses.asdict(g))


def randn(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def eq(t, j):
    """Bitwise equality of a torch tensor and a jax/numpy array."""
    np.testing.assert_array_equal(t.detach().cpu().numpy(), np.asarray(j))


def page_table(r, s, npt, n_valid, n_pages=P):
    """Distinct shuffled physical pages (never the null page) for the
    first n_valid[i] logical blocks of each row; NULL past them."""
    pt = np.zeros((s, npt), np.int32)
    pool = r.permutation(np.arange(1, n_pages))
    at = 0
    for i in range(s):
        pt[i, :n_valid[i]] = pool[at:at + n_valid[i]]
        at += n_valid[i]
    return pt


# ---------------------------------------------------------------------------
# kernels: paged gate select, paged block-sparse decode (plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", GS_CONFIGS, ids=GS_IDS)
@pytest.mark.parametrize("max_selected", [None, 3])
def test_gate_select_paged_plain_matches_ref_and_pallas(cfg, max_selected):
    r = np.random.default_rng(31)
    s, npt, n_pages = 3, 6, 20
    n_valid = np.array([npt, 4, 1], np.int32)            # full, partial, 1
    pt = page_table(r, s, npt, n_valid, n_pages)
    qg = randn(r, s, HKV, DG)
    kg_pages = randn(r, n_pages, HKV, DG)
    t_idx = t_gs.gate_select_paged_plain(*map(torch.tensor, (qg, kg_pages, pt, n_valid)),
                                         tcfg(cfg), max_selected)
    j_args = (*map(jnp.asarray, (qg, kg_pages, pt, n_valid)), cfg, max_selected)
    eq(t_idx, j_gs.gate_select_paged_ref(*j_args))
    eq(t_idx, j_gs.fused_gate_select_paged(*j_args, interpret=True))
    assert t_idx.shape[-1] == t_gs.n_selected(tcfg(cfg), npt, max_selected)


@pytest.mark.parametrize("method", ["budget", "threshold"])
def test_gate_select_paged_plain_exact_ties(method):
    """Pages holding bit-equal Kg rows give bit-equal scores: the lower
    LOGICAL index wins, whatever the physical order."""
    cfg = GateConfig(**_GS, method=method, threshold=1e-3)
    r = np.random.default_rng(6)
    s, npt, n_pages = 2, 8, 17
    n_valid = np.array([8, 7], np.int32)
    pt = page_table(r, s, npt, n_valid, n_pages)
    qg = randn(r, s, HKV, DG)
    kg_pages = np.repeat(randn(r, 1, HKV, DG), n_pages, axis=0)   # all rows tie
    kg_pages[pt[0, 5]] *= 2.0                                   # one clear winner
    t_idx = t_gs.gate_select_paged_plain(*map(torch.tensor, (qg, kg_pages, pt, n_valid)),
                                         tcfg(cfg), 5)
    eq(t_idx, j_gs.fused_gate_select_paged(*map(jnp.asarray, (qg, kg_pages, pt, n_valid)),
                                           cfg, 5, interpret=True))


def _paged_decode_inputs(seed, s, g, npt, nsel, n_pages=P, dh=DH):
    r = np.random.default_rng(seed)
    q = randn(r, s, HKV, g, dh)
    kp = randn(r, n_pages, HKV, PS, dh)
    vp = randn(r, n_pages, HKV, PS, dh)
    kv_len = r.integers((npt - 1) * PS + 1, npt * PS, size=(s,)).astype(np.int32)
    pt = page_table(r, s, npt, np.full((s,), npt), n_pages)
    idx = np.full((s, HKV, nsel), -1, np.int32)
    for i in range(s):
        for h in range(HKV):
            n = r.integers(1, nsel + 1)
            idx[i, h, :n] = r.choice(npt, n, replace=False)
        idx[i, :, 0] = npt - 1                         # the partial last block
    idx[0, 0, 1:] = -1                                 # -1 padding
    return q, kp, vp, idx, pt, kv_len


@pytest.mark.parametrize("s,g,npt,nsel", [(3, 2, 4, 3), (2, 5, 6, 6), (1, 1, 2, 1)])
def test_sparse_decode_paged_plain_matches_ref_and_pallas(s, g, npt, nsel):
    ins = _paged_decode_inputs(7, s, g, npt, nsel, n_pages=s * npt + 1)
    o_t = t_bsd.sparse_decode_paged_plain(*map(torch.tensor, ins), block_size=PS)
    j_in = tuple(map(jnp.asarray, ins))
    o_ref = j_ref.paged_sparse_decode_ref(*j_in, block_size=PS)
    o_pal = j_bsd.block_sparse_decode_paged(*j_in, block_size=PS, interpret=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_pal), atol=1e-5, rtol=0)


def test_sparse_decode_paged_plain_equals_contiguous_on_gathered_view():
    """Paged decode == contiguous decode on the gather_kv view (the
    logical->physical translation is the only difference)."""
    q, kp, vp, idx, pt, kv_len = map(torch.tensor, _paged_decode_inputs(8, 3, 2, 4, 3))
    o_p = t_bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len, block_size=PS)
    o_c = t_bsd.sparse_decode_plain(q, t_pg.gather_kv(kp, pt), t_pg.gather_kv(vp, pt),
                                    idx, kv_len, block_size=PS)
    assert torch.equal(o_p, o_c)


def test_paged_cpu_dispatch_takes_plain_and_counts_no_launch():
    t_ops.reset_launch_counts()
    q, kp, vp, idx, pt, kv_len = map(torch.tensor, _paged_decode_inputs(9, 2, 2, 4, 3))
    assert torch.equal(t_ops.paged_sparse_decode(q, kp, vp, idx, pt, kv_len, block_size=PS),
                       t_bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len,
                                                       block_size=PS))
    cfg = tcfg(GS_CONFIGS[0])
    qg, kgp = torch.randn(2, HKV, DG), torch.randn(P, HKV, DG)
    nv = torch.tensor([4, 2], dtype=torch.int32)
    assert torch.equal(t_ops.gate_select_paged(qg, kgp, pt, nv, cfg),
                       t_gs.gate_select_paged_plain(qg, kgp, pt, nv, cfg))
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)
    assert set(t_ops.KERNELS) == {"gate_select", "block_sparse_decode",
                                  "gate_select_paged", "block_sparse_decode_paged",
                                  "block_sparse_decode_quant",
                                  "block_sparse_decode_paged_quant",
                                  "block_sparse_decode_paged_splitk",
                                  "block_sparse_decode_paged_splitk_quant",
                                  "gate_gt_attention"}


def test_paged_cuda_wrappers_refuse_cpu_tensors():
    q, kp, vp, idx, pt, kv_len = map(torch.tensor, _paged_decode_inputs(9, 2, 2, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        t_bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len, block_size=PS)
    with pytest.raises(ValueError, match="CUDA"):
        t_gs.gate_select_paged_cuda(torch.randn(2, HKV, DG), torch.randn(P, HKV, DG), pt,
                                    torch.tensor([4, 2], dtype=torch.int32),
                                    tcfg(GS_CONFIGS[0]))


# ---------------------------------------------------------------------------
# serve/paging.py pool helpers
# ---------------------------------------------------------------------------

def _pools(r, n_pages=P):
    k, v, kg = randn(r, L, n_pages, HKV, PS, DH), randn(r, L, n_pages, HKV, PS, DH), \
        randn(r, L, n_pages, HKV, DG)
    return (t_pg.PagedPages(*map(torch.tensor, (k, v, kg))),
            j_pg.PagedPages(*map(jnp.asarray, (k, v, kg))))


def _eq_pools(t, j):
    for tt, jj in zip(t, (j.k_pages, j.v_pages, j.kg_pages)):
        eq(tt, jj)


@pytest.mark.parametrize("length,ids", [
    (21, [5, 2, 9]),              # partial last page, exact page count
    (24, [3, 11, 7, 1]),          # whole pages, one reserved growth page
    (5, [4]),                     # one partial page
])
def test_scatter_prefill_matches_jax(length, ids):
    r = np.random.default_rng(length)
    s_max = 4 * PS                                   # a 4-page prefill bucket
    kc, vc = randn(r, L, 1, HKV, s_max, DH), randn(r, L, 1, HKV, s_max, DH)
    kgc = randn(r, L, 1, HKV, s_max // PS, DG)
    tp, jpp = _pools(r)
    t_pg.scatter_prefill(tp, torch.tensor(kc), torch.tensor(vc), torch.tensor(kgc),
                         length, t_pg.pad_page_ids(ids), PS)
    jpp = j_pg.scatter_prefill(jpp, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kgc),
                               jnp.asarray(length, jnp.int32), j_pg.pad_page_ids(ids), PS)
    # the null page may hold any of the padding writes: compare the rest
    _eq_pools([t[:, 1:] for t in tp[:3]], jpp._replace(
        k_pages=jpp.k_pages[:, 1:], v_pages=jpp.v_pages[:, 1:],
        kg_pages=jpp.kg_pages[:, 1:]))
    np.testing.assert_array_equal(t_pg.pad_page_ids(ids).numpy(),
                                  np.asarray(j_pg.pad_page_ids(ids)))


@pytest.mark.parametrize("cur_len,active", [
    ([7, 15, 3], [True, True, True]),      # two pages complete, one does not
    ([23, 0, 9], [True, False, True]),     # an idle slot routes to the null page
    ([0, 8, 31], [True, True, True]),      # a lone token; a page opens; 4th page fills
])
def test_append_token_and_finalize_kg_match_jax(cur_len, active):
    r = np.random.default_rng(sum(cur_len))
    tp_, jp_ = {}, {}
    for k, shp in (("wq", (HKV, 2 * DH, DG)), ("wk", (HKV, 3 * DH, DG))):
        w = randn(r, *shp) * 0.2
        tp_[k], jp_[k] = torch.tensor(w), jnp.asarray(w)
    (tk, tv, tkg, *_), jpp = _pools(r)
    tk, tv, tkg = tk[0], tv[0], tkg[0]                    # one layer's pools
    jk, jv, jkg = jpp.k_pages[0], jpp.v_pages[0], jpp.kg_pages[0]
    cl, act = np.array(cur_len, np.int32), np.array(active)
    pt = page_table(r, 3, 4, np.full((3,), 4))
    kr, vn = randn(r, 3, HKV, DH), randn(r, 3, HKV, DH)
    kg_before = tkg.clone()
    t_pg.append_token_paged(tk, tv, tkg, torch.tensor(kr), torch.tensor(vn), torch.tensor(pt),
                            torch.tensor(cl), torch.tensor(act), tp_, tcfg(GS_CONFIGS[0]))
    jk, jv, jkg = j_pg.append_token_paged(jk, jv, jkg, jnp.asarray(kr), jnp.asarray(vn),
                                          jnp.asarray(pt), jnp.asarray(cl), jnp.asarray(act),
                                          jp_, GS_CONFIGS[0])
    eq(tk[1:], jk[1:])
    eq(tv[1:], jv[1:])
    done = [pt[i, c // PS] for i, c in enumerate(cur_len) if act[i] and (c + 1) % PS == 0]
    for page in range(1, P):
        if page in done:       # pooled + projected: arithmetic, not a copy
            np.testing.assert_allclose(tkg[page].numpy(), np.asarray(jkg[page]),
                                       atol=1e-5, rtol=1e-5)
            assert not torch.equal(tkg[page], kg_before[page])
        else:                  # every other live row is written back unchanged
            eq(tkg[page], jkg[page])
            assert torch.equal(tkg[page], kg_before[page])


def test_extract_restore_reset_and_gathers_match_jax():
    r = np.random.default_rng(12)
    tp, jpp = _pools(r)
    ids = [7, 3, 12]
    tk, tv, tkg, *_ = t_pg.extract_pages(tp, t_pg.pad_page_ids(ids))
    jk, jv, jkg, *_ = j_pg.extract_pages(jpp, j_pg.pad_page_ids(ids))
    assert tk.device.type == "cpu" and tk.shape == (L, 4, HKV, PS, DH)
    for t, j in ((tk, jk), (tv, jv), (tkg, jkg)):
        eq(t, j)
    new = [9, 1, 14]
    t_pg.restore_pages(tp, tk, tv, tkg, t_pg.pad_page_ids(new))
    jpp = j_pg.restore_pages(jpp, jk, jv, jkg, j_pg.pad_page_ids(new))
    _eq_pools([t[:, 1:] for t in tp[:3]], jpp._replace(
        k_pages=jpp.k_pages[:, 1:], v_pages=jpp.v_pages[:, 1:],
        kg_pages=jpp.kg_pages[:, 1:]))
    for a, b in zip(ids, new):                       # the round trip moves bits
        assert torch.equal(tp.k_pages[:, b], tp.k_pages[:, a])
    t_pg.reset_kg_rows(tp, t_pg.pad_page_ids([9, 14, 2]))
    jpp = j_pg.reset_kg_rows(jpp, j_pg.pad_page_ids([9, 14, 2]))
    _eq_pools(tp, jpp)
    assert not tp.kg_pages[:, [9, 14, 2]].any()
    pt = page_table(r, 3, 4, np.array([4, 2, 1]))
    for pool in range(2):
        eq(t_pg.gather_kv(tp[pool][1], torch.tensor(pt)),
           j_pg.gather_kv(jpp[pool][1], jnp.asarray(pt)))
    eq(t_pg.gather_kg(tp.kg_pages[0], torch.tensor(pt)),
       j_pg.gather_kg(jpp.kg_pages[0], jnp.asarray(pt)))


def test_page_allocator_and_init_pages():
    al = t_pg.PageAllocator(6)
    a = al.alloc(3)
    assert al.alloc(3) is None and t_pg.NULL_PAGE not in a and al.min_free == 2
    al.free(a)
    assert set(al.alloc(3)) == set(a)                    # LIFO reuse
    with pytest.raises(ValueError):
        al.free([0])
    cfg = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    pools = t_pg.init_pages(cfg, 5, 2, device="cpu")
    assert pools.k_pages.shape == (2, 5, cfg.n_kv_heads, cfg.gate.block_size,
                                   cfg.resolved_head_dim)
    # eviction ghost rows extend the Kg pool only (ids 5 and 6 here)
    ghost = t_pg.init_pages(cfg, 5, 2, device="cpu", ghost_rows=2)
    assert ghost.kg_pages.shape == (2, 7) + pools.kg_pages.shape[2:]
    assert ghost.k_pages.shape == pools.k_pages.shape
    q8 = t_pg.init_pages(cfg, 5, 2, device="cpu", quantize="int8")
    assert q8.k_pages.dtype == q8.v_pages.dtype == torch.int8
    assert q8.k_pages.shape == pools.k_pages.shape
    for sc in (q8.k_scale_pages, q8.v_scale_pages):
        assert sc.dtype == torch.float32 and sc.shape == (2, 5, cfg.n_kv_heads, 1)
        assert not sc.any()
    assert q8.k_scale_pages.data_ptr() != q8.v_scale_pages.data_ptr()
    assert pools.k_scale_pages is None and q8.kmin_pages is None
    with pytest.raises(ValueError, match="quantize"):
        t_pg.init_pages(cfg, 5, 2, device="cpu", quantize="fp8")


# ---------------------------------------------------------------------------
# lm_prefill with right-padded lengths
# ---------------------------------------------------------------------------

def test_lm_prefill_lengths_matches_jax():
    jcfg = G.tiny_cfg("budget")
    tcfg_ = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    tcfg_ = tcfg_.replace(gate=dataclasses.replace(tcfg_.gate, **_GS, threshold=2e-2))
    params = j_get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.device_get(params), tcfg_, "cpu")
    width, lengths = 32, np.array([21, 32, 8], np.int32)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, width)).astype(np.int32)
    toks[np.arange(width)[None, :] >= lengths[:, None]] = 0          # right padding
    j_lg, j_st = j_get_api(jcfg).prefill(params, {"tokens": jnp.asarray(toks),
                                                  "lengths": jnp.asarray(lengths)},
                                         jcfg, width)
    t_lg, t_st = t_tf.lm_prefill(tparams, {"tokens": torch.tensor(toks),
                                           "lengths": torch.tensor(lengths)}, tcfg_, width)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), atol=1e-5, rtol=0)
    eq(t_st.cur_len, j_st.cur_len)
    eq(t_st.kg_n, j_st.kg_n)
    np.testing.assert_allclose(t_st.kg_cache.numpy(), np.asarray(j_st.kg_cache),
                               atol=1e-5, rtol=1e-5)
    for i, n in enumerate(lengths):                   # pad-touching rows are zero
        assert not t_st.kg_cache[:, i, :, n // PS:].any()
    for i, n in enumerate(lengths):                   # the real keys agree
        np.testing.assert_allclose(t_st.k_cache[:, i, :, :n].numpy(),
                                   np.asarray(j_st.k_cache[:, i, :, :n]), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the scheduler, against the reference's, step by step
# ---------------------------------------------------------------------------

def _drive(mod, specs, *, n_slots, num_pages, ps, admission, watermark):
    """The engine's host loop without the model: admissions, prepare_step
    (growth + preemption), complete_step. Returns per-step records and the
    final counters."""
    npt = max(mod.pages_needed(p, m, ps) for p, m, _ in specs)
    s = mod.Scheduler(n_slots, num_pages, ps, npt, admission=admission,
                      watermark=watermark)
    reqs = [mod.Request(rid=i, prompt=np.zeros(p, np.int32), max_new_tokens=m,
                        priority=pri) for i, (p, m, pri) in enumerate(specs)]
    for r in reqs:
        s.submit(r)
    steps, victims = [], []
    while s.has_work() and len(steps) < 500:
        adm = s.admissions()
        for r in adm:
            if r.swapped:
                r.swapped = False
            else:
                r.out_tokens.append(0)
            s.retire_if_done(r)
        fresh = s.prepare_step(lambda r: victims.append((len(steps), r.rid, r.swap_len)))
        released = s.drain_released()
        if not s.active.any():
            if not s.pending:
                break
            continue
        record = (s.page_table.tolist(), s.cur_len.tolist(),
                  [(r.rid, r.swapped) for r in adm], fresh, released)
        retired = s.complete_step(np.arange(n_slots, dtype=np.int32))
        steps.append(record + ([r.rid for r in retired],))
    counts = (s.n_admitted, s.n_resumed, s.n_retired, s.n_preemptions,
              s.admission_stalls, s.allocator.min_free)
    return steps, victims, counts, {r.rid: r.out_tokens for r in reqs}


@pytest.mark.parametrize("admission,watermark,num_pages,specs", [
    # forced growth past a tight pool: preemption, resume, mixed priorities
    ("lazy", 0, 9, [(20, 12, 0), (18, 10, 0), (22, 9, 0), (5, 20, 1)]),
    ("lazy", 2, 12, [(21, 8, 0), (37, 5, 0), (16, 11, 0), (29, 7, 0), (21, 4, 0),
                     (44, 6, 0)]),
    ("lazy", 1, 8, [(12, 14, 0), (12, 14, 0), (12, 14, 0), (1, 3, 2)]),
    ("reserve", 0, 10, [(24, 6, 0), (24, 6, 0), (9, 30, 0), (3, 1, 0)]),
])
def test_scheduler_matches_reference(admission, watermark, num_pages, specs):
    kw = dict(n_slots=3, num_pages=num_pages, ps=8, admission=admission,
              watermark=watermark)
    t_run = _drive(t_sch, specs, **kw)
    j_run = _drive(j_sch, specs, **kw)
    assert t_run == j_run
    if admission == "lazy" and watermark == 0:
        assert t_run[1], "the stream was meant to force a preemption"


def test_scheduler_serve_phase_counts():
    """The full-width serve phase of chip_smoke.py: 4 slots, prompts of
    16384/12345/8191/4097/1500/63 tokens, 32/24/40/16/48/8 new tokens,
    64-token pages. Both runs take 62 decode steps; the default pool
    peaks at 645 pages and never preempts; 644 pages preempt the 16384-token
    request once (257 content pages) and resume it once."""
    specs = [(p, m, 0) for p, m in zip([16384, 12345, 8191, 4097, 1500, 63],
                                       [32, 24, 40, 16, 48, 8])]
    npt = max(t_sch.pages_needed(p, m, 64) for p, m, _ in specs)
    for num_pages, victims in ((4 * npt + 1, []), (644, [(1, 0, 16385)])):
        steps, vic, counts, _ = _drive(t_sch, specs, n_slots=4, num_pages=num_pages,
                                       ps=64, admission="lazy", watermark=0)
        assert len(steps) == 62 and vic == victims
        assert counts[3] == counts[1] == len(victims)
        assert (num_pages - 1 - counts[5] == 645) == (not victims)
        assert _drive(j_sch, specs, n_slots=4, num_pages=num_pages, ps=64,
                      admission="lazy", watermark=0)[1] == vic
