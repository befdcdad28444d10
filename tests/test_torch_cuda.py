"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are built
from ``src/repro_torch/kernels/csrc`` at first use): they carry the
``cuda`` marker and skip with a reason where there is no card. Run them
on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the reference package; the plain
versions it compares against are themselves held against the JAX
reference on the CPU (tests/test_torch_kernels.py, test_torch_engine.py,
test_torch_paging.py, test_torch_serve.py, test_torch_quant.py,
test_torch_train.py).
"""
import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gate_ties
from repro_torch import config as t_config
from repro_torch.configs import get as t_get
from repro_torch.convert import params_to
from repro_torch.kernels import block_sparse_decode as bsd
from repro_torch.kernels import build
from repro_torch.kernels import gate_select as gs
from repro_torch.kernels import ops
from repro_torch.serve import paging as pg

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GS = dict(block_size=8, d_gate=16, token_budget=32)
GATES = [
    t_config.GateConfig(**_GS, method="budget"),
    t_config.GateConfig(**_GS, method="budget", always_first_block=False,
                        always_last_block=False),
    t_config.GateConfig(**_GS, method="threshold", threshold=5e-3),
    t_config.GateConfig(**_GS, method="threshold", threshold=2e-2,
                        always_first_block=False, always_last_block=False),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def ids_agree(k_idx, p_idx, scores, rel=1e-5):
    """Kernel ids == plain ids, except swaps of two blocks whose plain fp32
    scores differ by < ``rel`` relative. Returns the number of such swaps."""
    k_idx, p_idx, scores = (t.cpu().numpy() for t in (k_idx, p_idx, scores))
    swaps = 0
    for pos in zip(*np.nonzero(k_idx != p_idx)):
        row, a, b = pos[:-1], k_idx[pos], p_idx[pos]
        assert a >= 0 and b >= 0, (pos, a, b)
        sa, sb = scores[row + (a,)], scores[row + (b,)]
        assert abs(sa - sb) <= rel * max(abs(sa), abs(sb), 1e-30), (pos, sa, sb)
        swaps += 1
    return swaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", GATES, ids=range(len(GATES)))
@pytest.mark.parametrize("shape", [(3, 2, 16, 16), (4, 8, 257, 128)])
def test_gate_select_kernel_matches_plain(dev, dtype, cfg, shape):
    b, hkv, nb, dg = shape
    g = torch.Generator(device=dev).manual_seed(1)
    qg = torch.randn(b, hkv, dg, generator=g, device=dev).to(dtype)
    kg = torch.randn(b, hkv, nb, dg, generator=g, device=dev).to(dtype)
    nv = torch.tensor(([nb, nb // 2 + 1, 1] * b)[:b], dtype=torch.int32, device=dev)
    for ms in (None, 5):
        k_idx = gs.gate_select_cuda(qg, kg, nv, cfg, ms)
        p_idx = gs.gate_select_plain(qg, kg, nv, cfg, ms)
        torch.cuda.synchronize()
        assert k_idx.shape == p_idx.shape and k_idx.dtype == torch.int32
        ids_agree(k_idx, p_idx, gs.gate_scores_plain(qg, kg, nv, cfg))


def _sparse_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = nb * bs
    q = torch.randn(b, hkv, g, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype)
    r = np.random.default_rng(seed)
    idx = np.full((b, hkv, nsel), -1, np.int32)
    kv_len = r.integers(s - bs + 1, s, size=(b,)).astype(np.int32)
    for bi in range(b):
        for hi in range(hkv):
            n = r.integers(1, nsel + 1)
            idx[bi, hi, :n] = r.choice(nb, n, replace=False)
        idx[bi, :, 0] = (kv_len[bi] - 1) // bs
    idx[0, 0, :] = -1                                  # a row with no valid key
    return (q, k, v, torch.tensor(idx, device=dev),
            torch.tensor(kv_len, device=dev))


def _decode_limit(o_plain):
    """chip_smoke.py's limit for the decode kernel: 8 ulps of max|o_plain|
    in the output dtype, capped at 2e-2."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.decode_limit(o_plain)[0]


# shapes that take the fp decode body's other paths (block_sparse_decode_sm90.cu):
# query rows beyond one CTA's lane set go to g-chunk CTAs (G 16 x Dh 128:
# 4 of them in fp32, 2 in bf16); heads wider than 32 lanes x 4 chunks to
# column-slice CTAs (Dh 2048: 4 / 2 slices, a stage holding 2 / 4 rows of
# a block; fp32 G 2 x Dh 1024 takes both kinds); rows of Dh 10 (20 / 40
# bytes) fail the 16-byte test and take the plain stage fill; and 300
# selected entries, past the 256 ids a CTA keeps in shared memory, where
# a segment holds them all (num_splits 1 in the split-plan cases)
OTHER_PATH_SHAPES = [
    (2, 1, 16, 128, 6, 8, 4),
    (2, 1, 1, 2048, 6, 8, 4),
    (2, 1, 2, 1024, 6, 8, 4),
    (3, 2, 3, 10, 6, 8, 5),
    (2, 1, 2, 16, 320, 4, 300),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,dh,nb,bs,nsel", [
    (2, 2, 2, 16, 8, 8, 4),
    (3, 1, 5, 32, 6, 16, 6),
    (4, 8, 2, 128, 40, 64, 16),
    *OTHER_PATH_SHAPES,
])
def test_sparse_decode_kernel_matches_plain(dev, dtype, b, hkv, g, dh, nb, bs, nsel):
    q, k, v, idx, kv_len = _sparse_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel)
    o_k = bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=bs)
    o_p = bsd.sparse_decode_plain(q, k, v, idx, kv_len, block_size=bs)
    torch.cuda.synchronize()
    assert o_k.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(o_k.cpu().numpy(), o_p.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert float((o_k.float() - o_p.float()).abs().max()) <= _decode_limit(o_p)
    assert torch.equal(o_k[0, 0], torch.zeros_like(o_k[0, 0]))


# the fp decode body (#2 and #4) and its one-line faults: (source line,
# edit); the last two are faults of its split over the SMs
SM90_SOURCE = "block_sparse_decode_sm90.cu"
MUTANTS = {
    "no running-max rescale": ("const float alpha = exp2f(m - mx);",
                               "const float alpha = 1.f;"),
    "sum not rescaled": ("l = alpha * l + sum;", "l = l + sum;"),
    "scale x 1.05": ("s[t] = (t < nb) ? s[t] * scale2 : kNegInf;",
                     "s[t] = (t < nb) ? s[t] * scale2 * 1.05f : kNegInf;"),
    "last selected block skipped": ("while (j < j1) {", "while (j < j1 - 1) {"),
    "last key dropped from P.V": ("for (int t = 0; t < kBatch; ++t)  // p = 0 past nb",
                                  "for (int t = 0; t < kBatch - 1; ++t)  // p = 0 past nb"),
    "segment end one past the boundary": ("const int j1 = min(j0 + per, p.nsel);",
                                          "const int j1 = min(j0 + per + 1, p.nsel);"),
    "combine without the rescale": (
        "const float rs = (ls > 0.f) ? exp2f(pm[s * G] - m) : 0.f;",
        "const float rs = (ls > 0.f) ? 1.f : 0.f;"),
}


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_decode_limit_rejects_a_faulty_kernel(dev, mutant, tmp_path, monkeypatch):
    """The decode check of chip_smoke.py must reject a kernel with a fault
    in its mathematics. The inputs have the main path's shape and layer-0
    value scale: bf16 q, k, v ~ N(0, 1), so q.k/sqrt(Dh) ~ N(0, 1); 64
    blocks of 64 selected out of 257 per (b, kv-head), the 1-token last
    block among them, in random order. The outputs are then about 0.02, so
    a fixed 2e-2 limit would pass most of these faults; the limit of 8
    ulps of max|o_plain| must not. The correct kernel passes the same
    check on the same inputs. The kernel runs its split plan (8 segments
    on an H100), so the split and combine faults show."""
    old, new = MUTANTS[mutant]
    src = (build.CSRC / SM90_SOURCE).read_text()
    assert src.count(old) == 1, mutant
    cu = tmp_path / "mutant.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p

    b, hkv, g, dh, nb, bs, nsel = 4, 8, 2, 128, 257, 64, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, hkv, g, dh, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, hkv, nb * bs, dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, hkv, nb * bs, dh, generator=gen, device=dev).to(torch.bfloat16)
    r = np.random.default_rng(0)
    idx = np.stack([np.concatenate([[0, nb - 1], r.choice(np.arange(1, nb - 1),
                                                          nsel - 2, replace=False)])
                    for _ in range(b * hkv)])
    idx = np.stack([r.permutation(row) for row in idx]).reshape(b, hkv, nsel)
    idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    kv_len = torch.full((b,), (nb - 1) * bs + 1, dtype=torch.int32, device=dev)

    o_p = bsd.sparse_decode_plain(q, k, v, idx, kv_len, block_size=bs)
    lim = _decode_limit(o_p)
    o_k = bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=bs)
    good = float((o_k.float() - o_p.float()).abs().max())
    monkeypatch.setattr(build, "load", lambda name: lib)
    o_m = bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=bs)
    torch.cuda.synchronize()
    bad = float((o_m.float() - o_p.float()).abs().max())
    print(f"[{mutant}] max|o_plain| {float(o_p.float().abs().max()):.4f}, limit "
          f"{lim:.3e}: correct kernel {good:.3e}, faulty kernel {bad:.3e}")
    assert good <= lim
    assert bad > lim, f"{mutant}: error {bad} within the limit {lim}"


def _paged_table(r, s, npt, n_valid, n_pages):
    """Shuffled distinct physical pages for each row's first n_valid
    logical blocks, the null page 0 past them."""
    pt = np.zeros((s, npt), np.int32)
    pool = r.permutation(np.arange(1, n_pages))
    at = 0
    for i in range(s):
        pt[i, :n_valid[i]] = pool[at:at + n_valid[i]]
        at += n_valid[i]
    return pt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", GATES, ids=range(len(GATES)))
@pytest.mark.parametrize("shape", [(3, 2, 16, 16), (4, 8, 257, 128)])
def test_gate_select_paged_kernel_matches_plain(dev, dtype, cfg, shape):
    s, hkv, npt, dg = shape
    n_pages = s * npt + 1
    g = torch.Generator(device=dev).manual_seed(2)
    qg = torch.randn(s, hkv, dg, generator=g, device=dev).to(dtype)
    kgp = torch.randn(n_pages, hkv, dg, generator=g, device=dev).to(dtype)
    nv_np = np.array(([npt, npt // 2 + 1, 1] * s)[:s], np.int32)
    pt = torch.tensor(_paged_table(np.random.default_rng(2), s, npt, nv_np, n_pages),
                      device=dev)
    nv = torch.tensor(nv_np, device=dev)
    for ms in (None, 5):
        k_idx = gs.gate_select_paged_cuda(qg, kgp, pt, nv, cfg, ms)
        p_idx = gs.gate_select_paged_plain(qg, kgp, pt, nv, cfg, ms)
        torch.cuda.synchronize()
        assert k_idx.shape == p_idx.shape and k_idx.dtype == torch.int32
        ids_agree(k_idx, p_idx, gs.gate_scores_plain(
            qg, kgp[pt.long()].transpose(1, 2), nv, cfg))


# exact ties (tests/gate_ties.py): integer qg and Kg rows drawn from a few
# distinct ones, so every score is exact in any summation order and many
# blocks tie; the kernels' ids must then be bitwise the plain versions'
TIE_NB = [1, 2, 31, 32, 33, 255, 256, 257, 1024, 8192]


def _check_gate_ties(dev, dtype, nb, dg, seed=0, hkv=2, b=3):
    """#1 and #3 on the exact-tie inputs (``b`` rows: n_valid full, partial
    and 1, repeated; ``hkv`` kv heads), k 1, 64 and nb, both force flags on and both off:
    budget ids bitwise those of the plain versions, threshold ids through
    ids_agree, and the paged kernel over shuffled pages bitwise equal to it
    over pages in order. Raises AssertionError at the first difference."""
    nv_np = gate_ties.n_valid(b, nb)
    nv = torch.tensor(nv_np, device=dev)
    on = lambda x: torch.tensor(x, device=dev).to(dtype)
    qg, kg = map(on, gate_ties.contiguous(seed, b, hkv, nb, dg))
    qp, pool, table = gate_ties.paged(seed + 1, b, hkv, nb, dg, nv_np, shuffle=False)
    _, pool_s, table_s = gate_ties.paged(seed + 1, b, hkv, nb, dg, nv_np)
    qp, pool, pool_s = map(on, (qp, pool, pool_s))
    table, table_s = (torch.tensor(t, device=dev) for t in (table, table_s))
    for method in ("budget", "threshold"):
        for force in (True, False):
            cfg = t_config.GateConfig(**_GS, method=method, threshold=5e-3,
                                      always_first_block=force, always_last_block=force)
            for ms in sorted(k for k in {1, 64, nb} if k <= nb):
                k_idx = gs.gate_select_cuda(qg, kg, nv, cfg, ms)
                p_idx = gs.gate_select_plain(qg, kg, nv, cfg, ms)
                g_idx = gs.gate_select_paged_cuda(qp, pool, table, nv, cfg, ms)
                s_idx = gs.gate_select_paged_cuda(qp, pool_s, table_s, nv, cfg, ms)
                pg_idx = gs.gate_select_paged_plain(qp, pool, table, nv, cfg, ms)
                torch.cuda.synchronize()
                case = (method, force, ms)
                assert torch.equal(g_idx, s_idx), case
                if method == "budget":
                    assert torch.equal(k_idx, p_idx), case
                    assert torch.equal(g_idx, pg_idx), case
                else:
                    ids_agree(k_idx, p_idx, gs.gate_scores_plain(qg, kg, nv, cfg))
                    ids_agree(g_idx, pg_idx, gs.gate_scores_plain(
                        qp, pg.gather_kg(pool, table), nv, cfg))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dg", [16, 128])
@pytest.mark.parametrize("nb", TIE_NB)
def test_gate_select_exact_ties_bitwise(dev, dtype, dg, nb):
    _check_gate_ties(dev, dtype, nb, dg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_select_scalar_path(dev, dtype):
    """Rows whose bytes are not a multiple of 16 (Dg 10), or a Kg base one
    element past a 16-byte boundary, take the kernel's one-element chunks:
    the same checks on exact ties, and ids bitwise those of aligned copies."""
    _check_gate_ties(dev, dtype, 257, 10)
    nv_np = gate_ties.n_valid(3, 257)
    nv = torch.tensor(nv_np, device=dev)
    qg, kg = (torch.tensor(x, device=dev).to(dtype)
              for x in gate_ties.contiguous(3, 3, 2, 257, 128))
    qp, pool, table = gate_ties.paged(4, 3, 2, 257, 128, nv_np)
    qp, pool = (torch.tensor(x, device=dev).to(dtype) for x in (qp, pool))
    table = torch.tensor(table, device=dev)
    for cfg in GATES:
        a = gs.gate_select_cuda(qg, kg, nv, cfg, 64)
        u = gs.gate_select_cuda(qg, _unaligned(kg), nv, cfg, 64)
        ap = gs.gate_select_paged_cuda(qp, pool, table, nv, cfg, 64)
        up = gs.gate_select_paged_cuda(qp, _unaligned(pool), table, nv, cfg, 64)
        torch.cuda.synchronize()
        assert torch.equal(a, u) and torch.equal(ap, up)


def test_gate_select_limits(dev):
    """nb = MAX_BLOCKS at Dg = MAX_DG (the largest shared-memory plan) runs
    and gives the plain version's ids bitwise on exact ties, k = nb; past
    either limit both wrappers refuse with a ValueError."""
    nb, dg = gs.MAX_BLOCKS, gs.MAX_DG
    cfg = GATES[0]
    nv_np = gate_ties.n_valid(3, nb)
    nv = torch.tensor(nv_np, device=dev)
    qg, kg = (torch.tensor(x, device=dev).to(torch.bfloat16)
              for x in gate_ties.contiguous(5, 3, 1, nb, dg))
    qp, pool, table = gate_ties.paged(6, 3, 1, nb, dg, nv_np)
    qp, pool = (torch.tensor(x, device=dev).to(torch.bfloat16) for x in (qp, pool))
    table = torch.tensor(table, device=dev)
    k_idx = gs.gate_select_cuda(qg, kg, nv, cfg, nb)
    g_idx = gs.gate_select_paged_cuda(qp, pool, table, nv, cfg, nb)
    torch.cuda.synchronize()
    assert torch.equal(k_idx, gs.gate_select_plain(qg, kg, nv, cfg, nb))
    assert torch.equal(g_idx, gs.gate_select_paged_plain(qp, pool, table, nv, cfg, nb))
    del kg, pool
    with pytest.raises(ValueError, match="limits"):
        gs.gate_select_cuda(qg, torch.zeros(3, 1, nb + 1, dg, dtype=qg.dtype, device=dev),
                            nv, cfg)
    with pytest.raises(ValueError, match="limits"):
        gs.gate_select_cuda(torch.zeros(3, 1, dg + 8, dtype=qg.dtype, device=dev),
                            torch.zeros(3, 1, 8, dg + 8, dtype=qg.dtype, device=dev), nv, cfg)
    with pytest.raises(ValueError, match="limits"):
        gs.gate_select_paged_cuda(qp, torch.zeros(2, 1, dg, dtype=qg.dtype, device=dev),
                                  torch.zeros(3, nb + 1, dtype=torch.int32, device=dev),
                                  nv, cfg)


# gate_select.cu's one-line faults: (source line, edit)
GATE_SOURCE = "gate_select.cu"
GATE_MUTANTS = {
    "ties taken by the higher index": (
        "return ko > km || (ko == km && (uint32_t)o < (uint32_t)me);",
        "return ko > km || (ko == km && (uint32_t)o > (uint32_t)me);"),
    "cutoff > as >=": ("return key > cut ? j : -1;", "return key >= cut ? j : -1;"),
    "== K* survivor count one short": ("if (rank < k_left) orow[g + rank]",
                                       "if (rank + 1 < k_left) orow[g + rank]"),
    "visibility < nv as <= nv": ("vis[u] = j < nb && j < nv;", "vis[u] = j < nb && j <= nv;"),
    "last pin at nv": ("if (force_last && j == nv - 1) r = kBig;",
                       "if (force_last && j == nv) r = kBig;"),
    "scale dropped": ("s[j] = vis[u] ? acc[u] * scale : kNegInf;",
                      "s[j] = vis[u] ? acc[u] : kNegInf;"),
}


@pytest.mark.parametrize("mutant", list(GATE_MUTANTS))
def test_gate_checks_reject_a_faulty_kernel(dev, mutant, tmp_path, monkeypatch):
    """The exact-tie checks (_check_gate_ties at the main path's nb 257, Dg
    128, bf16) must reject a gate-select kernel with a one-line fault in
    either instance; the correct kernel passes the same checks."""
    old, new = GATE_MUTANTS[mutant]
    src = (build.CSRC / GATE_SOURCE).read_text()
    assert src.count(old) == 1, mutant
    cu = tmp_path / "mutant_gate.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant_gate.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _check_gate_ties(dev, torch.bfloat16, 257, 128)
    monkeypatch.setattr(build, "load", lambda name: lib)
    with pytest.raises(AssertionError) as caught:
        _check_gate_ties(dev, torch.bfloat16, 257, 128)
    print(f"[{mutant}] rejected: {str(caught.value).splitlines()[0]}")


def _paged_inputs(dev, dtype, s, hkv, g, dh, npt, bs, nsel, seed=0):
    """A pool of s*npt+1 pages under a shuffled table, random selections
    with the partial last block, -1 padding and one row with no valid key."""
    q, k, v, idx, kv_len = _sparse_inputs(dev, dtype, s, hkv, g, dh, npt, bs, nsel, seed)
    r = np.random.default_rng(seed + 1)
    n_pages = s * npt + 1
    pt = _paged_table(r, s, npt, np.full((s,), npt), n_pages)
    kp = torch.zeros(n_pages, hkv, bs, dh, dtype=dtype, device=dev)
    vp = torch.zeros_like(kp)
    for i in range(s):                      # the contiguous caches, paged
        for j in range(npt):
            kp[pt[i, j]] = k[i, :, j * bs:(j + 1) * bs]
            vp[pt[i, j]] = v[i, :, j * bs:(j + 1) * bs]
    return q, kp, vp, idx, torch.tensor(pt, device=dev), kv_len, (k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", [
    (2, 2, 2, 16, 8, 8, 4),
    (3, 1, 5, 32, 6, 16, 6),
    (4, 8, 2, 128, 257, 64, 64),           # the main path's shapes
])
def test_sparse_decode_paged_kernel_matches_plain(dev, dtype, s, hkv, g, dh, npt, bs, nsel):
    q, kp, vp, idx, pt, kv_len, (k, v) = _paged_inputs(dev, dtype, s, hkv, g, dh, npt,
                                                       bs, nsel)
    o_k = bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs)
    o_p = bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len, block_size=bs)
    torch.cuda.synchronize()
    assert o_k.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(o_k.cpu().numpy(), o_p.cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert float((o_k.float() - o_p.float()).abs().max()) <= _decode_limit(o_p)
    assert torch.equal(o_k[0, 0], torch.zeros_like(o_k[0, 0]))
    # the same blocks read in place from the contiguous caches: same kernel
    # body, same arithmetic, bitwise the same output
    assert torch.equal(o_k, bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=bs))


PAGED_MUTANT = ("return max(page_table[(size_t)b * npt + blk], 0);", "return blk;")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", [
    (2, 2, 2, 16, 8, 8, 4),
    (3, 1, 5, 32, 6, 16, 6),
    (4, 8, 2, 128, 257, 64, 64),           # the main path's shapes
    *OTHER_PATH_SHAPES,
])
def test_sparse_decode_split_plan_cases(dev, dtype, s, hkv, g, dh, npt, bs, nsel):
    """#2 and #4 at the planned split and at 1, 2, nsel and nsel + 3 segments
    (more segments than selected entries: the empty ones drop out of the
    combine), on the same inputs as above plus a kv_len inside the first
    block (every selected block past it masked): each within the limit of
    its plain version, the (slot, head) row with no valid key 0 in every
    segment, and the paged kernel bitwise the contiguous one."""
    q, kp, vp, idx, pt, kv_len, (k, v) = _paged_inputs(dev, dtype, s, hkv, g, dh, npt,
                                                       bs, nsel)
    short = kv_len.clone()
    short[1:] = bs // 2 + 1                 # rows 1.. end inside their first block
    first = idx.clone()
    first[1:, :, -1] = 0                    # ... which each of their heads selects
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"planned splits {bsd.split_plan(s, hkv, nsel, n_sm)} on {n_sm} SMs")
    for lens, ids in ((kv_len, idx), (short, first)):
        o_p = bsd.sparse_decode_plain(q, k, v, ids, lens, block_size=bs)
        for ns in (None, 1, 2, nsel, nsel + 3):
            o_k = bsd.sparse_decode_cuda(q, k, v, ids, lens, block_size=bs, num_splits=ns)
            o_g = bsd.sparse_decode_paged_cuda(q, kp, vp, ids, pt, lens, block_size=bs,
                                               num_splits=ns)
            torch.cuda.synchronize()
            _check_decode(o_k, o_p, dtype)
            assert torch.equal(o_k, o_g), ns


def _unaligned(t):
    """A contiguous copy of t whose base lies one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    u = buf[1:].view(t.shape)
    u.copy_(t)
    assert u.is_contiguous() and u.data_ptr() % 16
    return u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 128])
def test_sparse_decode_unaligned_base_takes_the_plain_fill(dev, dtype, dh):
    """K/V (or pools) whose base is not 16-byte aligned fail the body's
    16-byte test, so their stages are filled by plain loads in place of
    cp.async (Dh 16: rows padded to whole chunks; Dh 128: unpadded). The
    stages then hold the same values, so the output is bitwise that of
    aligned copies, contiguous and paged, at 1, 2 and the planned
    segments, and within the limit of the plain version."""
    q, kp, vp, idx, pt, kv_len, (k, v) = _paged_inputs(dev, dtype, 3, 2, 2, dh, 6, 16, 5)
    ku, vu, kpu, vpu = (_unaligned(t) for t in (k, v, kp, vp))
    o_p = bsd.sparse_decode_plain(q, k, v, idx, kv_len, block_size=16)
    for ns in (None, 1, 2):
        o = bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=16, num_splits=ns)
        o_u = bsd.sparse_decode_cuda(q, ku, vu, idx, kv_len, block_size=16, num_splits=ns)
        o_g = bsd.sparse_decode_paged_cuda(q, kpu, vpu, idx, pt, kv_len, block_size=16,
                                           num_splits=ns)
        torch.cuda.synchronize()
        _check_decode(o_u, o_p, dtype)
        assert torch.equal(o, o_u), ns
        assert torch.equal(o, o_g), ns


def test_paged_decode_limit_rejects_logical_id_as_page(dev, tmp_path, monkeypatch):
    """A paged decode kernel that reads the LOGICAL block id as the
    physical page fails chip_smoke.py's 8-ulp limit on a shuffled table at
    the main path's shape; the correct kernel passes it."""
    old, new = PAGED_MUTANT
    src = (build.CSRC / SM90_SOURCE).read_text()
    assert src.count(old) == 1
    cu = tmp_path / "mutant_paged.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant_paged.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, torch.bfloat16, 4, 8, 2, 128,
                                                  257, 64, 64, seed=3)
    o_p = bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len, block_size=64)
    lim = _decode_limit(o_p)
    o_k = bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len, block_size=64)
    good = float((o_k.float() - o_p.float()).abs().max())
    monkeypatch.setattr(build, "load", lambda name: lib)
    o_m = bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len, block_size=64)
    torch.cuda.synchronize()
    bad = float((o_m.float() - o_p.float()).abs().max())
    print(f"[logical id as page] limit {lim:.3e}: correct kernel {good:.3e}, "
          f"faulty kernel {bad:.3e}")
    assert good <= lim < bad


def _counts(**launched):
    """Every kernel's launch count: 0 except the ones given."""
    return {**dict.fromkeys(ops.KERNELS, 0), **launched}


def _tiny_cfg():
    cfg = t_config.reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return cfg.replace(gate=dataclasses.replace(cfg.gate, block_size=8, d_gate=16,
                                                token_budget=32))


def test_engine_cuda_serve_matches_cpu_and_counts_launches(dev):
    """serve() on the card equals serve() on the CPU (tiny config, fp32),
    with an ample and a tight pool, and every decode step's layers went
    through the two paged kernels."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg()
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    r = np.random.default_rng(4)
    reqs = [{"rid": i, "max_new_tokens": m,
             "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate([(20, 12), (18, 10), (22, 9)])]
    gpu = DecodeEngine(cfg, params_to(params, dev), max_len=64)
    cpu = DecodeEngine(cfg, params, max_len=64, device="cpu")
    for pool in (None, 8):
        want = cpu.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
        ops.reset_launch_counts()
        got = gpu.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
        steps = got["stats"]["decode_steps"]
        assert ops.launch_counts() == _counts(gate_select_paged=cfg.num_layers * steps,
                                              block_sparse_decode_paged=cfg.num_layers * steps)
        assert (got["stats"]["preemptions"] > 0) == (pool is not None)
        for i in range(len(reqs)):
            assert got[i] == want[i]
            np.testing.assert_allclose(got["logits"][i], want["logits"][i], atol=1e-4)


def test_engine_cuda_matches_cpu_and_counts_launches(dev):
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg()
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41))
    cpu = DecodeEngine(cfg, params, max_len=64, device="cpu").generate(
        {"tokens": toks}, 13)
    gpu_params = params_to(params, dev)
    ops.reset_launch_counts()
    eng = DecodeEngine(cfg, gpu_params, max_len=64)
    res = eng.generate({"tokens": toks}, 13)
    assert ops.launch_counts() == _counts(gate_select=2 * 12, block_sparse_decode=2 * 12)
    np.testing.assert_array_equal(res["tokens"].cpu().numpy(), cpu["tokens"].numpy())



# ---------------------------------------------------------------------------
# int8 pools: the fused-dequant decode kernels (TPU bodies 2q and 4q)
# ---------------------------------------------------------------------------

def _quantize(x, bs, seed):
    """x [..., S, Dh] fp -> (int8 codes of x times a per-block amplitude in
    0.25..4, f32 scales [..., S // bs]): one scale per block of bs rows, so
    scale rows differ from block to block by up to 16x."""
    *lead, s, dh = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed)
    amp = 0.25 * 16 ** torch.rand(*lead, s // bs, 1, 1, generator=gen, device=x.device)
    blk = x.float().reshape(*lead, s // bs, bs, dh) * amp
    q, sc = pg.quantize_block(blk, torch.ones((), dtype=torch.bool, device=x.device))
    return q.reshape(x.shape), sc[..., 0]


def _quant_sparse_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel, seed=0):
    q, k, v, idx, kv_len = _sparse_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel, seed)
    (kq, ks), (vq, vs) = _quantize(k, bs, seed + 1), _quantize(v, bs, seed + 2)
    return q, kq, vq, ks, vs, idx, kv_len


def _quant_paged_inputs(dev, dtype, s, hkv, g, dh, npt, bs, nsel, seed=0):
    """The int8 twin of ``_paged_inputs``: the contiguous int8 caches paged
    under a shuffled table, each page's scale row beside it; the trash
    page 0 holds codes and a scale row that no selected block may read."""
    q, kq, vq, ks, vs, idx, kv_len = _quant_sparse_inputs(dev, dtype, s, hkv, g, dh, npt,
                                                          bs, nsel, seed)
    n_pages = s * npt + 1
    pt = _paged_table(np.random.default_rng(seed + 1), s, npt, np.full((s,), npt), n_pages)
    kp = torch.full((n_pages, hkv, bs, dh), 127, dtype=torch.int8, device=dev)
    vp = kp.clone()
    ksp = torch.full((n_pages, hkv, 1), float("nan"), device=dev)
    vsp = ksp.clone()
    for i in range(s):
        for j in range(npt):
            kp[pt[i, j]] = kq[i, :, j * bs:(j + 1) * bs]
            vp[pt[i, j]] = vq[i, :, j * bs:(j + 1) * bs]
            ksp[pt[i, j], :, 0], vsp[pt[i, j], :, 0] = ks[i, :, j], vs[i, :, j]
    return (q, kp, vp, ksp, vsp, idx, torch.tensor(pt, device=dev), kv_len,
            (kq, vq, ks, vs))


def _check_decode(o_k, o_p, dtype):
    assert o_k.dtype == dtype and torch.isfinite(o_k).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(o_k.cpu().numpy(), o_p.cpu().numpy(), atol=1e-5, rtol=1e-5)
    else:
        assert float((o_k.float() - o_p.float()).abs().max()) <= _decode_limit(o_p)
    assert torch.equal(o_k[0, 0], torch.zeros_like(o_k[0, 0]))


QUANT_SHAPES = [(2, 2, 2, 16, 8, 8, 4), (3, 1, 5, 32, 6, 16, 6),
                (4, 8, 2, 128, 257, 64, 64)]       # the main path's shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,dh,nb,bs,nsel", QUANT_SHAPES)
def test_sparse_decode_quant_kernel_matches_plain(dev, dtype, b, hkv, g, dh, nb, bs, nsel):
    """2q: int8 caches, one f32 scale per cache block."""
    q, kq, vq, ks, vs, idx, kv_len = _quant_sparse_inputs(dev, dtype, b, hkv, g, dh, nb,
                                                          bs, nsel)
    o_k = bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len, block_size=bs,
                                       k_scales=ks, v_scales=vs)
    o_p = bsd.sparse_decode_plain(q, kq, vq, idx, kv_len, block_size=bs,
                                  k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    _check_decode(o_k, o_p, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", QUANT_SHAPES)
def test_sparse_decode_paged_quant_kernel_matches_plain(dev, dtype, s, hkv, g, dh, npt, bs,
                                                        nsel):
    """4q: int8 pools, a scale row per physical page. Also: the same blocks
    read by 2q from the contiguous caches give the same bits, and shuffling
    the physical pages (and their scale rows) under the table changes
    nothing."""
    q, kp, vp, ksp, vsp, idx, pt, kv_len, (kq, vq, ks, vs) = _quant_paged_inputs(
        dev, dtype, s, hkv, g, dh, npt, bs, nsel)
    o_k = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                             k_scales=ksp, v_scales=vsp)
    o_p = bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                        k_scales=ksp, v_scales=vsp)
    torch.cuda.synchronize()
    _check_decode(o_k, o_p, dtype)
    assert torch.equal(o_k, bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len,
                                                         block_size=bs, k_scales=ks,
                                                         v_scales=vs))
    n_pages = kp.shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      1 + torch.randperm(n_pages - 1,
                                         generator=torch.Generator().manual_seed(1))]).to(dev)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n_pages, device=dev)
    o_s = bsd.sparse_decode_paged_quant_cuda(
        q, kp[inv], vp[inv], idx, perm[pt.long()].int(), kv_len, block_size=bs,
        k_scales=ksp[inv], v_scales=vsp[inv].reshape(n_pages, hkv))
    assert torch.equal(o_k, o_s)


# the int8 twins of OTHER_PATH_SHAPES (int8 chunks are 8 codes, so a row
# of 32 lanes x 4 chunks is 1024 codes): g-chunk CTAs (G 16 x Dh 128, 2 of
# them); column-slice CTAs (G 1 x Dh 2048: 2 slices, a stage holding 8 rows
# of a block; G 2 x Dh 2048 takes both kinds); rows of Dh 10 and 24 (not
# whole 16-byte copies) take the plain stage fill into padded rows; and
# 300 selected entries, past the 256 ids (and scales) a CTA keeps in
# shared memory, where a segment holds them all
QUANT_OTHER_PATH_SHAPES = [
    (2, 1, 16, 128, 6, 8, 4),
    (2, 1, 1, 2048, 6, 8, 4),
    (2, 1, 2, 2048, 6, 8, 4),
    (3, 2, 3, 10, 6, 8, 5),
    (2, 2, 2, 24, 6, 8, 4),
    (2, 1, 2, 16, 320, 4, 300),
]


def _shuffled_pages(pt, *pools):
    """(table, *pools) with the pools' physical pages permuted under a
    remapped table, the trash page 0 left in place."""
    n_pages = pools[0].shape[0]
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      1 + torch.randperm(n_pages - 1,
                                         generator=torch.Generator().manual_seed(1))]
                     ).to(pt.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n_pages, device=pt.device)
    return (perm[pt.long()].int(), *(t[inv] for t in pools))


def _shuffled_quant(kp, vp, ksp, vsp, pt):
    """``_shuffled_pages`` over int8 pools and their scale rows, the V scale
    rows as [P, Hkv]."""
    pt_s, kp_s, vp_s, ksp_s, vsp_s = _shuffled_pages(pt, kp, vp, ksp, vsp)
    return kp_s, vp_s, ksp_s, vsp_s.reshape(kp.shape[0], -1), pt_s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", [*QUANT_SHAPES, *QUANT_OTHER_PATH_SHAPES])
def test_sparse_decode_quant_split_plan_cases(dev, dtype, s, hkv, g, dh, npt, bs, nsel):
    """2q and 4q at the planned split and at 1, 2, nsel and nsel + 3
    segments (the empty ones drop out of the combine), also with a kv_len
    inside the first block (every selected block past it masked, its
    scales never used): each within the limit of the plain version, the
    row with no valid key 0, 4q bitwise 2q on the same blocks, and 4q
    bitwise itself over shuffled pages (the trash page's codes 127 and
    scale rows NaN)."""
    q, kp, vp, ksp, vsp, idx, pt, kv_len, (kq, vq, ks, vs) = _quant_paged_inputs(
        dev, dtype, s, hkv, g, dh, npt, bs, nsel)
    kp_s, vp_s, ksp_s, vsp_s, pt_s = _shuffled_quant(kp, vp, ksp, vsp, pt)
    short = kv_len.clone()
    short[1:] = bs // 2 + 1
    first = idx.clone()
    first[1:, :, -1] = 0
    for lens, ids in ((kv_len, idx), (short, first)):
        o_p = bsd.sparse_decode_plain(q, kq, vq, ids, lens, block_size=bs, k_scales=ks,
                                      v_scales=vs)
        for ns in (None, 1, 2, nsel, nsel + 3):
            o_c = bsd.sparse_decode_quant_cuda(q, kq, vq, ids, lens, block_size=bs,
                                               k_scales=ks, v_scales=vs, num_splits=ns)
            o_g = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, ids, pt, lens, block_size=bs,
                                                     k_scales=ksp, v_scales=vsp, num_splits=ns)
            o_s = bsd.sparse_decode_paged_quant_cuda(q, kp_s, vp_s, ids, pt_s, lens,
                                                     block_size=bs, k_scales=ksp_s,
                                                     v_scales=vsp_s, num_splits=ns)
            torch.cuda.synchronize()
            _check_decode(o_c, o_p, dtype)
            assert torch.equal(o_c, o_g), ns
            assert torch.equal(o_g, o_s), ns


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 128])
def test_sparse_decode_quant_unaligned_base_takes_the_plain_fill(dev, dtype, dh):
    """int8 caches (or pools) one byte past a 16-byte boundary fail the
    16-byte test and are filled by plain loads: bitwise the output of
    aligned copies, contiguous and paged, at 1, 2 and the planned
    segments, and within the limit of the plain version."""
    q, kp, vp, ksp, vsp, idx, pt, kv_len, (kq, vq, ks, vs) = _quant_paged_inputs(
        dev, dtype, 3, 2, 2, dh, 6, 16, 5)
    ku, vu, kpu, vpu = (_unaligned(t) for t in (kq, vq, kp, vp))
    kw = dict(block_size=16, k_scales=ks, v_scales=vs)
    o_p = bsd.sparse_decode_plain(q, kq, vq, idx, kv_len, **kw)
    for ns in (None, 1, 2):
        o = bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len, num_splits=ns, **kw)
        o_u = bsd.sparse_decode_quant_cuda(q, ku, vu, idx, kv_len, num_splits=ns, **kw)
        o_g = bsd.sparse_decode_paged_quant_cuda(q, kpu, vpu, idx, pt, kv_len, block_size=16,
                                                 k_scales=ksp, v_scales=vsp, num_splits=ns)
        torch.cuda.synchronize()
        _check_decode(o_u, o_p, dtype)
        assert torch.equal(o, o_u), ns
        assert torch.equal(o, o_g), ns


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_decode_quant_full_code_range(dev, dtype):
    """Blocks whose raw codes cover -128..127 (each code 32 times in a
    64 x 128 block of V, and in K but for four columns) at scale 1, where
    the arithmetic is exact
    in both versions, so kernel and plain must agree bitwise, contiguous
    and paged. With q = 0 every valid key has p = 1 and o is the mean of
    the block's 64 V rows (integer sums, one division by 64): every code
    of V. With q one-hot per query row at a large weight, each row's
    softmax is one key (the next score is 181 lower: its exp is 0 in
    fp32), the key with the largest code in that row's column; the four
    rows' columns hold -128..-65, -64..-1, 0..63 and 64..127, so a code
    read with the wrong sign or offset picks another key."""
    b, hkv, g, dh, bs, nb = 2, 2, 4, 128, 64, 3
    r = np.random.default_rng(7)
    codes = np.tile(np.arange(-128, 128), bs * dh // 256)
    kc, vc = (np.stack([r.permutation(codes).reshape(bs, dh)
                        for _ in range(b * hkv * nb)]) for _ in range(2))
    for blk in kc:                   # column j of every block: 64 distinct codes
        for j in range(g):
            blk[:, 17 * j] = r.permutation(np.arange(64 * j - 128, 64 * j - 64))
    kq, vq = (torch.tensor(x.reshape(b, hkv, nb * bs, dh), dtype=torch.int8, device=dev)
              for x in (kc, vc))
    ones = torch.ones(b, hkv, nb, device=dev)
    idx = torch.tensor([[[1, -1], [2, 0]], [[0, 2], [1, -1]]], dtype=torch.int32, device=dev)
    kv_len = torch.full((b,), nb * bs, dtype=torch.int32, device=dev)
    # the same caches paged: page 1 + (b * nb + blk), scale rows of 1
    pt = torch.arange(b * nb, dtype=torch.int32, device=dev).reshape(b, nb) + 1
    kp, vp = (torch.cat([torch.zeros(1, hkv, bs, dh, dtype=torch.int8, device=dev),
                         x.reshape(b, hkv, nb, bs, dh).transpose(1, 2).reshape(b * nb, hkv,
                                                                              bs, dh)])
              for x in (kq, vq))
    sp = torch.ones(b * nb + 1, hkv, 1, device=dev)
    hot = torch.zeros(b, hkv, g, dh, device=dev)
    for j in range(g):
        hot[:, :, j, 17 * j] = 2048.0
    for q in (torch.zeros(b, hkv, g, dh, device=dev).to(dtype), hot.to(dtype)):
        o_p = bsd.sparse_decode_plain(q, kq, vq, idx, kv_len, block_size=bs, k_scales=ones,
                                      v_scales=ones)
        for ns in (None, 1, 2):
            o_c = bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len, block_size=bs,
                                               k_scales=ones, v_scales=ones, num_splits=ns)
            o_g = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                                     k_scales=sp, v_scales=sp, num_splits=ns)
            torch.cuda.synchronize()
            assert torch.equal(o_c, o_p), (ns, float((o_c.float() - o_p.float()).abs().max()))
            assert torch.equal(o_g, o_c), ns


# one-line faults in the int8 instances of the sm90 body: (source line,
# edit)
QUANT_MUTANTS = {
    "scale of the logical page": ("if (Paged) return (size_t)phys * p.H + h;",
                                  "if (Paged) return (size_t)blk * p.H + h;"),
    "K scale applied to V": ("return make_float2(p.k_scales[si], p.v_scales[si]);",
                             "return make_float2(p.k_scales[si], p.k_scales[si]);"),
    "V scale applied twice": ("lane_axpy<KV, NCH>(acc, s[t] * sc.y,",
                              "lane_axpy<KV, NCH>(acc, s[t] * sc.y * sc.y,"),
    "K scale applied twice": ("const float scale2 = scale0 * sc.x;",
                              "const float scale2 = scale0 * sc.x * sc.x;"),
}


@pytest.mark.parametrize("mutant", list(QUANT_MUTANTS))
def test_quant_decode_limit_rejects_a_faulty_kernel(dev, mutant, tmp_path, monkeypatch):
    """chip_smoke.py's 8-ulp limit rejects an int8 paged decode kernel with
    a one-line fault in its dequant, at the main path's shape with bf16 q,
    page amplitudes that differ by up to 16x and a shuffled table, at the
    split plan; the correct kernel passes the same check."""
    old, new = QUANT_MUTANTS[mutant]
    src = (build.CSRC / SM90_SOURCE).read_text()
    assert src.count(old) == 1, mutant
    cu = tmp_path / "mutant_quant.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant_quant.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    q, kp, vp, ksp, vsp, idx, pt, kv_len, _ = _quant_paged_inputs(
        dev, torch.bfloat16, 4, 8, 2, 128, 257, 64, 64, seed=3)
    ksp[0], vsp[0] = 1.0, 1.0          # a finite trash row: a misread shows as an error
    kw = dict(block_size=64, k_scales=ksp, v_scales=vsp)
    o_p = bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len, **kw)
    lim = _decode_limit(o_p)
    o_k = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, idx, pt, kv_len, **kw)
    good = float((o_k.float() - o_p.float()).abs().max())
    monkeypatch.setattr(build, "load", lambda name: lib)
    o_m = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, idx, pt, kv_len, **kw)
    torch.cuda.synchronize()
    bad = float((o_m.float() - o_p.float()).abs().max())
    print(f"[{mutant}] max|o_plain| {float(o_p.float().abs().max()):.4f}, limit "
          f"{lim:.3e}: correct kernel {good:.3e}, faulty kernel {bad:.3e}")
    assert good <= lim
    assert not bad <= lim, f"{mutant}: error {bad} within the limit {lim}"


def test_engine_cuda_int8_serve_matches_cpu_and_counts_launches(dev):
    """int8 serve() on the card equals int8 serve() on the CPU (tiny
    config, fp32 working dtype) with an ample and a tight pool; every
    decode step's layers went through the int8 paged decode, never the fp
    one. Logits within 1e-3, tests/test_torch_quant.py's tolerance for a
    flipped int8 code."""
    from repro_torch.core.policy import DecodeOptions
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg()
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    r = np.random.default_rng(4)
    reqs = [{"rid": i, "max_new_tokens": m,
             "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate([(20, 12), (18, 10), (22, 9)])]
    opts = DecodeOptions(quantize="int8")
    gpu = DecodeEngine(cfg, params_to(params, dev), max_len=64, options=opts)
    cpu = DecodeEngine(cfg, params, max_len=64, options=opts, device="cpu")
    for pool in (None, 8):
        want = cpu.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
        ops.reset_launch_counts()
        got = gpu.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
        n = cfg.num_layers * got["stats"]["decode_steps"]
        assert ops.launch_counts() == _counts(gate_select_paged=n,
                                              block_sparse_decode_paged_quant=n)
        assert (got["stats"]["preemptions"] > 0) == (pool is not None)
        assert got["stats"]["swapped_out_bytes"] == want["stats"]["swapped_out_bytes"]
        for i in range(len(reqs)):
            assert got[i] == want[i]
            np.testing.assert_allclose(got["logits"][i], want["logits"][i], atol=1e-3)



# ---------------------------------------------------------------------------
# the rest of the decode API: id lists of the other policies and budgets
# ---------------------------------------------------------------------------

def _policy_lists(idx, form, seed=0):
    """Reshape a kernel id list [B, Hkv, k] into what the other policies
    and the budget mask hand the decode kernels: "order" the ids in a
    shuffled, non-index order (Quest's and the oracle's score order);
    "holes" -1 entries in the middle of the list (SlidingWindowPolicy's
    sink/window duplicates), the list widened to keep every id; "tail" the
    ids in score order, then a -1 tail past a per-row cap (the per-request
    budget mask)."""
    r = np.random.default_rng(seed)
    ids = idx.cpu().numpy()
    b, hkv, k = ids.shape
    width = 2 * k if form == "holes" else k
    out = np.full((b, hkv, width), -1, np.int32)
    for bi in range(b):
        cap = r.integers(1, k + 1)
        for hi in range(hkv):
            row = r.permutation(ids[bi, hi][ids[bi, hi] >= 0])
            if form == "holes":
                slots = np.sort(r.choice(np.arange(1, width), len(row) - 1, replace=False)) \
                    if len(row) > 1 else np.zeros((0,), int)
                out[bi, hi, np.concatenate([[0], slots])[:len(row)]] = row
            elif form == "tail":
                out[bi, hi, :min(cap, len(row))] = row[:cap]
            else:
                out[bi, hi, :len(row)] = row
    return torch.tensor(out, device=idx.device)


LIST_FORMS = ["order", "holes", "tail"]
LIST_SHAPES = [(3, 2, 2, 16, 8, 8, 4), (4, 8, 2, 128, 257, 64, 64)]   # and the main path's


@pytest.mark.parametrize("form", LIST_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,dh,nb,bs,nsel", LIST_SHAPES)
def test_decode_kernels_on_policy_lists(dev, form, dtype, b, hkv, g, dh, nb, bs, nsel):
    """#2, #4 and 4q against their plain versions on the id lists of the
    other policies: ids out of index order, -1 holes in the middle of a
    list, and a budget-masked -1 tail."""
    q, k, v, idx, kv_len = _sparse_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel)
    lists = _policy_lists(idx, form)
    o_k = bsd.sparse_decode_cuda(q, k, v, lists, kv_len, block_size=bs)
    _check_decode(o_k, bsd.sparse_decode_plain(q, k, v, lists, kv_len, block_size=bs),
                  dtype)
    q, kp, vp, _, pt, kv_len, _ = _paged_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel)
    o_k = bsd.sparse_decode_paged_cuda(q, kp, vp, lists, pt, kv_len, block_size=bs)
    _check_decode(o_k, bsd.sparse_decode_paged_plain(q, kp, vp, lists, pt, kv_len,
                                                     block_size=bs), dtype)
    q, kp, vp, ksp, vsp, _, pt, kv_len, _ = _quant_paged_inputs(dev, dtype, b, hkv, g, dh,
                                                                nb, bs, nsel)
    o_k = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, lists, pt, kv_len, block_size=bs,
                                             k_scales=ksp, v_scales=vsp)
    _check_decode(o_k, bsd.sparse_decode_paged_plain(q, kp, vp, lists, pt, kv_len,
                                                     block_size=bs, k_scales=ksp,
                                                     v_scales=vsp), dtype)


def test_engine_cuda_quest_cached_equals_recompute(dev):
    """Quest with the incremental metadata cache and Quest recomputing the
    min/max every step give bitwise the same tokens and logits on the
    card; only the sparse decode launches (no gate select), and the
    tokens are the CPU run's."""
    from repro_torch.core.policy import DecodeOptions, QuestPolicy, QuestRecomputePolicy
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg()
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41))
    gpu_params = params_to(params, dev)
    runs = []
    for pol in (QuestPolicy(), QuestRecomputePolicy()):
        eng = DecodeEngine(cfg, gpu_params, max_len=64, options=DecodeOptions(policy=pol))
        tok, st = eng.prefill({"tokens": toks})
        ops.reset_launch_counts()
        out = []
        for _ in range(12):
            tok, lg, st, _ = eng._step(gpu_params, st, tok)
            out.append((tok.clone(), lg.clone()))
        assert ops.launch_counts() == _counts(block_sparse_decode=cfg.num_layers * 12)
        runs.append(out)
    for (ta, la), (tb, lb) in zip(*runs):
        assert torch.equal(ta, tb) and torch.equal(la, lb)
    cpu = DecodeEngine(cfg, params, max_len=64, device="cpu",
                       options=DecodeOptions(policy=QuestPolicy())).generate(
        {"tokens": toks}, 13)
    res = DecodeEngine(cfg, gpu_params, max_len=64,
                       options=DecodeOptions(policy=QuestPolicy())).generate(
        {"tokens": toks}, 13)
    np.testing.assert_array_equal(res["tokens"].cpu().numpy(), cpu["tokens"].numpy())


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_cuda_quest_and_schedule_serve_match_cpu(dev, quantize):
    """Quest serve and a staged gate serve (dense prefix, select, reuse,
    correction on 4 layers) with request budgets, on the card against the
    CPU, ample and tight pools: equal tokens, and the launches the stages
    predict (gate select only at selecting layers, the paged decode at
    every non-dense layer)."""
    from repro_torch.core.policy import DecodeOptions, QuestPolicy, SelectionSchedule
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg().replace(num_layers=4)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    r = np.random.default_rng(4)
    reqs = [{"rid": i, "max_new_tokens": m,
             "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate([(20, 12), (18, 10), (22, 9)])]
    reqs[1]["budget"] = 16
    decode = ("block_sparse_decode_paged_quant" if quantize else
              "block_sparse_decode_paged")
    sched = SelectionSchedule(dense_first_n=1, select_layer=1, correction_layers=(3,))
    for opts, per_step in ((DecodeOptions(policy=QuestPolicy(), quantize=quantize),
                            {decode: 4}),
                           (DecodeOptions(schedule=sched, quantize=quantize),
                            {"gate_select_paged": 2, decode: 3})):
        gpu = DecodeEngine(cfg, params_to(params, dev), max_len=64, options=opts)
        cpu = DecodeEngine(cfg, params, max_len=64, options=opts, device="cpu")
        for pool in (None, 8):
            want = cpu.serve(reqs, n_slots=3, num_pages=pool)
            ops.reset_launch_counts()
            got = gpu.serve(reqs, n_slots=3, num_pages=pool)
            steps = got["stats"]["decode_steps"]
            assert ops.launch_counts() == _counts(**{k: v * steps
                                                     for k, v in per_step.items()})
            assert (got["stats"]["preemptions"] > 0) == (pool is not None)
            for i in range(len(reqs)):
                assert got[i] == want[i]


# ---------------------------------------------------------------------------
# split-K paged decode (TPU kernels 5 and 5q) and the sharded paths
# ---------------------------------------------------------------------------

SPLITK_SHAPES = [(2, 2, 2, 16, 8, 8, 4), (3, 1, 5, 32, 6, 16, 6),
                 (4, 8, 2, 128, 257, 64, 64)]      # the main path's shapes


def _splits(nsel):
    """num_splits cases: a few, one entry each, and more splits than
    entries (empty segments)."""
    return sorted({2, 3, 4, nsel, nsel + 3})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", SPLITK_SHAPES)
def test_sparse_decode_paged_splitk_kernel_matches_plain(dev, dtype, s, hkv, g, dh, npt, bs,
                                                        nsel):
    """5: the split-K kernel against its plain version over shuffled pages
    with -1 padding, a partial last block and a (slot, head) row with no
    valid key, which gives 0 at every num_splits."""
    q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, dtype, s, hkv, g, dh, npt, bs, nsel)
    for ns in _splits(nsel):
        o_k = bsd.sparse_decode_paged_splitk_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                                  num_splits=ns)
        o_p = bsd.sparse_decode_paged_splitk_plain(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                                   num_splits=ns)
        torch.cuda.synchronize()
        _check_decode(o_k, o_p, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", SPLITK_SHAPES)
def test_sparse_decode_paged_splitk_quant_kernel_matches_plain(dev, dtype, s, hkv, g, dh, npt,
                                                              bs, nsel):
    """5q: int8 pools under a shuffled table, scale rows per physical page
    (the trash page's codes 127 and scales NaN), at every num_splits."""
    q, kp, vp, ksp, vsp, idx, pt, kv_len, _ = _quant_paged_inputs(dev, dtype, s, hkv, g, dh,
                                                                  npt, bs, nsel)
    kw = dict(block_size=bs, k_scales=ksp, v_scales=vsp)
    for ns in _splits(nsel):
        o_k = bsd.sparse_decode_paged_splitk_quant_cuda(q, kp, vp, idx, pt, kv_len,
                                                        num_splits=ns, **kw)
        o_p = bsd.sparse_decode_paged_splitk_plain(q, kp, vp, idx, pt, kv_len, num_splits=ns,
                                                   **kw)
        torch.cuda.synchronize()
        _check_decode(o_k, o_p, dtype)


def test_splitk_wrappers_count_and_route(dev):
    """ops routes num_splits=1 to the single-pass kernel and > 1 to the
    split-K kernels; one wrapper call counts one launch."""
    q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, torch.bfloat16, 2, 2, 2, 16, 8, 8, 4)
    ops.reset_launch_counts()
    ops.paged_sparse_decode_splitk(q, kp, vp, idx, pt, kv_len, block_size=8, num_splits=1)
    ops.paged_sparse_decode_splitk(q, kp, vp, idx, pt, kv_len, block_size=8, num_splits=3)
    assert ops.launch_counts() == _counts(block_sparse_decode_paged=1,
                                          block_sparse_decode_paged_splitk=1)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", SPLITK_SHAPES)
def test_splitk_kernels_are_the_paged_body_bitwise(dev, quant, dtype, s, hkv, g, dh, npt,
                                                   bs, nsel):
    """5 at num_splits = n is ``sparse_decode_paged_cuda(num_splits=n)`` bit
    for bit, and 5q ``sparse_decode_paged_quant_cuda(num_splits=n)``: one
    body at the same segment boundaries, for n in 1, 2, 3, 4, 8 and nsel +
    3 (empty segments), over the pools and over their pages shuffled under
    a remapped table."""
    if quant:
        q, kp, vp, ksp, vsp, idx, pt, kv_len, _ = _quant_paged_inputs(dev, dtype, s, hkv, g,
                                                                      dh, npt, bs, nsel)
        pt_s, kp_s, vp_s, ksp_s, vsp_s = _shuffled_pages(pt, kp, vp, ksp, vsp)
        pools = [(pt, kp, vp, dict(k_scales=ksp, v_scales=vsp)),
                 (pt_s, kp_s, vp_s, dict(k_scales=ksp_s, v_scales=vsp_s))]
        split = bsd.sparse_decode_paged_splitk_quant_cuda
        single = bsd.sparse_decode_paged_quant_cuda
    else:
        q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, dtype, s, hkv, g, dh, npt, bs, nsel)
        pt_s, kp_s, vp_s = _shuffled_pages(pt, kp, vp)
        pools = [(pt, kp, vp, {}), (pt_s, kp_s, vp_s, {})]
        split, single = bsd.sparse_decode_paged_splitk_cuda, bsd.sparse_decode_paged_cuda
    for ns in (1, 2, 3, 4, 8, nsel + 3):
        want = single(q, kp, vp, idx, pt, kv_len, block_size=bs, num_splits=ns, **pools[0][3])
        for table, k, v, kw in pools:
            o5 = split(q, k, v, idx, table, kv_len, block_size=bs, num_splits=ns, **kw)
            o4 = single(q, k, v, idx, table, kv_len, block_size=bs, num_splits=ns, **kw)
            torch.cuda.synchronize()
            assert torch.equal(o5, want), ns
            assert torch.equal(o4, want), ns


# one-line faults in the body of block_sparse_decode_sm90.cu that the
# split-K kernels run, each driven through 5 or 5q at 4 splits: (source
# line, edit, int8 pools?)
SPLITK_MUTANTS = {
    "combine without the rescale": (
        "const float rs = (ls > 0.f) ? exp2f(pm[s * G] - m) : 0.f;",
        "const float rs = (ls > 0.f) ? 1.f : 0.f;", False),
    "rescale not masked by l > 0": (
        "const float rs = (ls > 0.f) ? exp2f(pm[s * G] - m) : 0.f;",
        "const float rs = exp2f(pm[s * G] - m);", False),
    "segment end one past the boundary": (
        "const int j1 = min(j0 + per, p.nsel);",
        "const int j1 = min(j0 + per + 1, p.nsel);", False),
    "V scale applied twice (5q)": (
        "lane_axpy<KV, NCH>(acc, s[t] * sc.y,",
        "lane_axpy<KV, NCH>(acc, s[t] * sc.y * sc.y,", True),
}


@pytest.mark.parametrize("mutant", list(SPLITK_MUTANTS))
def test_splitk_decode_limit_rejects_a_faulty_kernel(dev, mutant, tmp_path, monkeypatch):
    """chip_smoke.py's 8-ulp limit rejects a split-K kernel with a one-line
    fault in its segments or its combine, at the main path's shape with 4
    splits, bf16 and a shuffled table (one (slot, head) row has no valid
    key, so every segment of it is empty); the correct kernel passes."""
    old, new, quant = SPLITK_MUTANTS[mutant]
    src = (build.CSRC / SM90_SOURCE).read_text()
    assert src.count(old) == 1, mutant
    cu = tmp_path / "mutant_splitk.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant_splitk.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    if quant:
        q, kp, vp, ksp, vsp, idx, pt, kv_len, _ = _quant_paged_inputs(
            dev, torch.bfloat16, 4, 8, 2, 128, 257, 64, 64, seed=3)
        ksp[0], vsp[0] = 1.0, 1.0
        kw = dict(block_size=64, num_splits=4, k_scales=ksp, v_scales=vsp)
        kernel = bsd.sparse_decode_paged_splitk_quant_cuda
    else:
        q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, torch.bfloat16, 4, 8, 2, 128, 257,
                                                      64, 64, seed=3)
        kw = dict(block_size=64, num_splits=4)
        kernel = bsd.sparse_decode_paged_splitk_cuda
    o_p = bsd.sparse_decode_paged_splitk_plain(q, kp, vp, idx, pt, kv_len, **kw)
    lim = _decode_limit(o_p)
    o_k = kernel(q, kp, vp, idx, pt, kv_len, **kw)
    good = float((o_k.float() - o_p.float()).abs().max())
    monkeypatch.setattr(build, "load", lambda name: lib)
    o_m = kernel(q, kp, vp, idx, pt, kv_len, **kw)
    torch.cuda.synchronize()
    bad = float((o_m.float() - o_p.float()).abs().max())
    print(f"[{mutant}] max|o_plain| {float(o_p.float().abs().max()):.4f}, limit "
          f"{lim:.3e}: correct kernel {good:.3e}, faulty kernel {bad:.3e}")
    assert good <= lim
    assert not bad <= lim, f"{mutant}: error {bad} within the limit {lim}"


@pytest.fixture(scope="module")
def nccl_shard(tmp_path_factory):
    """A one-rank NCCL process group on this card for the module's sharded
    tests (one rendezvous through a file store), torn down after them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    import torch.distributed as dist
    from repro_torch.distributed.sharding import Shard
    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield Shard()
    finally:
        dist.destroy_process_group()


def _tiny_requests(cfg):
    r = np.random.default_rng(4)
    return [{"rid": i, "max_new_tokens": m,
             "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate([(20, 12), (18, 10), (22, 9)])]


@pytest.mark.parametrize("quant,split_k,pool", [(None, 1, None), (None, 2, None),
                                                (None, 2, 8), ("int8", 2, None),
                                                ("int8", 2, 8)])
def test_engine_cuda_sharded_serve_matches_cpu(nccl_shard, quant, split_k, pool):
    """Head-sharded serve() through a one-rank NCCL group on the card
    equals the unsharded serve() on the CPU (tiny config, fp32): tokens
    equal, logits within 1e-4 (1e-3 for int8 pools), swap bytes equal;
    every decode step's layers went through the split-K decode when
    split_k > 1, the single-pass one otherwise."""
    from repro_torch.core.policy import DecodeOptions
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg()
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    reqs = _tiny_requests(cfg)
    cpu = DecodeEngine(cfg, params, max_len=64, device="cpu",
                       options=DecodeOptions(quantize=quant))
    gpu = DecodeEngine(cfg, params_to(params, "cuda"), max_len=64, shard=nccl_shard,
                       options=DecodeOptions(quantize=quant, split_k=split_k))
    want = cpu.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
    ops.reset_launch_counts()
    got = gpu.serve(reqs, n_slots=3, num_pages=pool, collect_logits=True)
    n = cfg.num_layers * got["stats"]["decode_steps"]
    decode = "block_sparse_decode_paged" + ("_splitk" if split_k > 1 else "") \
        + ("_quant" if quant else "")
    assert ops.launch_counts() == _counts(gate_select_paged=n, **{decode: n})
    assert (got["stats"]["preemptions"] > 0) == (pool is not None)
    for key in ("swapped_out_bytes", "preemptions", "decode_steps"):
        assert got["stats"][key] == want["stats"][key], key
    for i in range(len(reqs)):
        assert got[i] == want[i]
        np.testing.assert_allclose(got["logits"][i], want["logits"][i],
                                   atol=1e-3 if quant else 1e-4)


@pytest.mark.parametrize("method", ["budget", "threshold"])
def test_engine_cuda_sequence_sharded_generate_matches_cpu(nccl_shard, method):
    """Sequence-sharded generate() through a one-rank NCCL group on the
    card: the tokens of the unsharded CPU run (the one rank holds the whole
    cache; the collectives still run through the group). The threshold
    gate gets a budget of all 8 blocks: the sharded path caps its
    candidates at the local cap, the unsharded one at the budget, and the
    two agree where neither binds (as in the reference's own check)."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    cfg = _tiny_cfg()
    cfg = cfg.replace(gate=dataclasses.replace(cfg.gate, method=method, threshold=2e-2,
                                               token_budget=32 if method == "budget" else 64))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41))
    cpu = DecodeEngine(cfg, params, max_len=64, device="cpu").generate({"tokens": toks}, 13)
    ops.reset_launch_counts()
    gpu = DecodeEngine(cfg, params_to(params, "cuda"), max_len=64,
                       shard=nccl_shard).generate({"tokens": toks}, 13)
    assert ops.launch_counts() == _counts()          # the sharded path is plain ops
    np.testing.assert_array_equal(gpu["tokens"].cpu().numpy(), cpu["tokens"].numpy())


# ---------------------------------------------------------------------------
# gate distillation: the gate-GT flash forward (TPU kernel 6) and training
# ---------------------------------------------------------------------------

def _gt_inputs(dev, dtype, b, l, h, hkv, dh, bs, seg_cuts=None, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, l, h, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, l, hkv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, l, hkv, dh, generator=gen, device=dev).to(dtype)
    seg = None
    if seg_cuts is not None:
        s = np.zeros((b, l), np.int32)
        for row in range(b):
            for c in seg_cuts:
                s[row, min(c + row, l - 1):] += 1
        seg = torch.tensor(s, device=dev)
    return q, k, v, seg


def gt_errors(o_k, bm_k, o_p, bm_p):
    """-> (o err, o limit, NEG_INF places equal, blockmax err, blockmax
    limit) under the kernel-6 limits: o within 8 ulps of max|o_plain| in
    the output dtype (the decode limit); blockmax exactly -1e30 in the
    same places, elsewhere within 1e-4 of max|blockmax|."""
    assert o_k.dtype == o_p.dtype and o_k.shape == o_p.shape and bm_k.shape == bm_p.shape
    o_err = float((o_k.float() - o_p.float()).abs().max())
    dead_k, dead_p = bm_k <= -1e29, bm_p <= -1e29
    same = torch.equal(dead_k, dead_p) and bool((bm_k[dead_k] == -1e30).all())
    live = ~dead_p
    bm_err = float((bm_k[live] - bm_p[live]).abs().max())
    return o_err, _decode_limit(o_p), same, bm_err, 1e-4 * float(bm_p[live].abs().max())


def check_gt(o_k, bm_k, o_p, bm_p):
    o_err, o_lim, same, bm_err, bm_lim = gt_errors(o_k, bm_k, o_p, bm_p)
    assert o_err <= o_lim and same and bm_err <= bm_lim, (o_err, o_lim, same, bm_err, bm_lim)
    return o_err, bm_err


GT_CUDA_SHAPES = [
    # b, l, h, hkv, dh, bs: the CPU sweep's, the tiny config's, a row tile
    # cut short (l % 64 != 0), odd GQA groups (one head a CTA in the bf16
    # body), and the training shape at batch 1
    (1, 64, 2, 1, 32, 16), (2, 128, 4, 2, 64, 32), (2, 128, 8, 2, 64, 64),
    (1, 256, 4, 4, 128, 64), (2, 72, 4, 2, 16, 8), (3, 200, 4, 2, 32, 8),
    (1, 192, 6, 2, 64, 16), (1, 4096, 16, 8, 128, 64),
    # head dim 256 (gemma_2b: 8 heads on one KV head), an even and an odd
    # group, both one head a CTA at Dh 256, one with a row tile cut short
    (1, 256, 8, 1, 256, 64), (2, 200, 3, 1, 256, 8),
    # 128-key blocks (a pair of 64-key tiles) at every head dim, granite's
    # MQA group (48 heads, head pairs) and the training widths
    (1, 256, 2, 1, 16, 128), (2, 384, 4, 2, 32, 128), (1, 256, 4, 2, 64, 128),
    (1, 512, 48, 1, 128, 128), (1, 256, 8, 1, 256, 128), (1, 2048, 16, 8, 128, 128),
    # zamba2_1_2b's shared block in distillation: 32 KV heads of one query
    # head at Dh 64 (one head a CTA)
    (2, 1024, 32, 32, 64, 64),
]


def _short_docs(l, seed=0):
    """Cuts of documents 64..200 tokens long over ``l``: whole (query
    tile, key tile) pairs share no document, and the bf16 body skips them."""
    r = np.random.default_rng(seed)
    cuts, c = [], 0
    while True:
        c += int(r.integers(64, 201))
        if c >= l:
            return cuts
        cuts.append(c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("segments", [False, True, "short docs"])
@pytest.mark.parametrize("b,l,h,hkv,dh,bs", GT_CUDA_SHAPES)
def test_gate_gt_kernel_matches_plain(dev, dtype, segments, b, l, h, hkv, dh, bs):
    from repro_torch.kernels import gate_gt_fwd as gt
    cuts = None
    if segments == "short docs":
        cuts = _short_docs(l)
    elif segments:      # cut mid-block, at a block edge, one-token documents
        cuts = [bs // 2 + 1, 2 * bs, 2 * bs + 1, l // 2 + 3, l - 2]
    q, k, v, seg = _gt_inputs(dev, dtype, b, l, h, hkv, dh, bs, cuts)
    o_k, bm_k = gt.gate_gt_attention_cuda(q, k, v, block_size=bs, segment_ids=seg)
    o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=bs, q_chunk=1024,
                                           segment_ids=seg)
    torch.cuda.synchronize()
    o_err, bm_err = check_gt(o_k, bm_k, o_p, bm_p)
    print(f"gate_gt {dtype} seg={segments} {(b, l, h, hkv, dh, bs)}: o err {o_err:.3e}, "
          f"blockmax err {bm_err:.3e}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_gt_row_whose_first_tiles_hold_other_documents(dev, dtype):
    """The rows of one long last document start at 300 (mid tile) and at
    320 (a tile edge): their first key tiles hold only other documents, so
    m stays -1e30 until their own keys, and the pairs before are skipped
    where they share no document at all."""
    from repro_torch.kernels import gate_gt_fwd as gt
    l = 1024
    q, k, v, _ = _gt_inputs(dev, dtype, 2, l, 4, 2, 64, 64)
    s = np.zeros((2, l), np.int32)
    s[0, 300:] = 1
    s[1, 70:320] = 1
    s[1, 320:] = 2
    seg = torch.tensor(s, device=dev)
    o_k, bm_k = gt.gate_gt_attention_cuda(q, k, v, block_size=64, segment_ids=seg)
    o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=64, q_chunk=1024,
                                           segment_ids=seg)
    torch.cuda.synchronize()
    check_gt(o_k, bm_k, o_p, bm_p)
    assert bool((bm_k[0, :, 300:, :4] == -1e30).all())


def test_gate_gt_refuses_bf16_block_sizes_outside_its_tiles(dev):
    """The bf16 body takes block sizes 8, 16, 32, 64 and 128 only: 12 raises
    and launches nothing; fp32 still takes it (its CUDA-core body)."""
    from repro_torch.kernels import gate_gt_fwd as gt
    q, k, v, _ = _gt_inputs(dev, torch.bfloat16, 1, 96, 2, 1, 32, 12)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="block size 12"):
        gt.gate_gt_attention_cuda(q, k, v, block_size=12)
    assert ops.launch_counts() == _counts()
    q, k, v = (t.float() for t in (q, k, v))
    o_k, bm_k = gt.gate_gt_attention_cuda(q, k, v, block_size=12)
    check_gt(o_k, bm_k, *gt.gate_gt_attention_plain(q, k, v, block_size=12))


def test_gate_gt_ops_routes_and_counts(dev):
    q, k, v, seg = _gt_inputs(dev, torch.float32, 2, 96, 4, 2, 32, 16, [10, 40])
    ops.reset_launch_counts()
    o, bm = ops.gate_gt_attention(q, k, v, block_size=16, segment_ids=seg.long())
    assert ops.launch_counts() == _counts(gate_gt_attention=1)
    o_p, bm_p = ops.gate_gt_attention(q.cpu(), k.cpu(), v.cpu(), block_size=16,
                                      segment_ids=seg.cpu())
    check_gt(o.cpu(), bm.cpu(), o_p, bm_p)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.gate_gt_attention(q.requires_grad_(), k, v, block_size=16)
    with pytest.raises(NotImplementedError, match="softcap"):
        ops.gate_gt_attention(q.detach(), k, v, block_size=16, logit_softcap=30.0)
    assert ops.launch_counts() == _counts(gate_gt_attention=1)


def test_train_steps_cuda_match_cpu_and_count_launches(dev):
    """Three distill steps of the tiny config (fp32) on the card and on the
    CPU from the same state (chip_smoke.py's small-input agreement): KL
    history and gate parameters agree, and every forward's layers went
    through kernel 6 and nothing else."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    _, kl_err, g_err, counts, want = chip_smoke.small_train_agreement(dev)
    assert counts == want
    assert kl_err <= 1e-4
    assert g_err <= 1e-4


# kernel 6 on a rank's heads under a training Shard (sharding.py: whole KV
# head groups, Hkv / world of them): qwen3_0_6b (16 / 8 x 128) at world
# sizes 2 and 8, zamba2_1_2b's shared block (32 / 32 x 64) at 2 and 32,
# deepseek_moe_16b (16 / 16 x 128) at 4
GT_LOCAL_SHAPES = [(2, 1024, 8, 4, 128, 64), (2, 1024, 2, 1, 128, 64),
                   (2, 1024, 16, 16, 64, 64), (2, 1024, 1, 1, 64, 64),
                   (1, 2048, 4, 4, 128, 64)]


@pytest.mark.parametrize("b,l,h,hkv,dh,bs", GT_LOCAL_SHAPES)
def test_gate_gt_kernel_on_local_heads_matches_plain(dev, b, l, h, hkv, dh, bs):
    """Kernel 6 (bf16) at the head counts a rank holds, packed segments."""
    from repro_torch.kernels import gate_gt_fwd as gt
    q, k, v, seg = _gt_inputs(dev, torch.bfloat16, b, l, h, hkv, dh, bs, _short_docs(l))
    o_k, bm_k = gt.gate_gt_attention_cuda(q, k, v, block_size=bs, segment_ids=seg)
    o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=bs, q_chunk=1024,
                                           segment_ids=seg)
    torch.cuda.synchronize()
    o_err, bm_err = check_gt(o_k, bm_k, o_p, bm_p)
    print(f"gate_gt local heads {(b, l, h, hkv, dh, bs)}: o err {o_err:.3e}, blockmax err "
          f"{bm_err:.3e}")


@pytest.mark.parametrize("arch,mode", [("qwen3_0_6b", "distill"), ("zamba2_1_2b", "distill"),
                                       ("deepseek_moe_16b", "pretrain")])
def test_sharded_train_step_one_rank_nccl_is_unsharded(nccl_shard, arch, mode):
    """Two steps of a reduced() model (bf16) under the one-rank NCCL shard
    bitwise the unsharded steps: metrics, every parameter and moment;
    kernel 6 on every gated layer of every sharded distill forward."""
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.train import loop as tl
    kw = {"num_layers": 5} if arch == "zamba2_1_2b" else {}
    cfg = t_config.reduced(t_get(arch), **kw)
    tcfg = t_config.TrainConfig(mode=mode, steps=2,
                                optim=t_config.OptimConfig(warmup_steps=1, total_steps=2))
    seed = tl.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, tcfg)
    batches = [make_batch(cfg, 2, 64, DataState(0, i), device="cuda") for i in range(2)]
    runs = {}
    for name, shard in (("plain", None), ("sharded", nccl_shard)):
        state = seed if shard is None else tl.shard_state(seed, cfg, shard)
        step = tl.make_train_step(cfg, tcfg, shard)
        ops.reset_launch_counts()
        hist = []
        for batch in batches:
            state, m = step(state, batch)
            hist.append({k: float(v) for k, v in m.items()})
        counts = ops.launch_counts()
        if shard is not None:
            state = tl.gather_state(state, cfg, shard)
        runs[name] = (hist, state, counts)
    (p_hist, p_state, p_counts), (s_hist, s_state, s_counts) = runs["plain"], runs["sharded"]
    gated = 2 if arch == "zamba2_1_2b" else cfg.num_layers
    assert s_counts == p_counts == _counts(gate_gt_attention=2 * gated if mode == "distill"
                                           else 0)
    assert s_hist == p_hist
    for a, b in ((s_state.params, p_state.params), (s_state.opt.m, p_state.opt.m),
                 (s_state.opt.v, p_state.opt.v)):
        pa, pb = dict(tl._walk(a)), dict(tl._walk(b))
        assert pa.keys() == pb.keys() and all(torch.equal(pa[k], t) for k, t in pb.items())


def test_pretrain_step_cuda_matches_cpu(dev):
    """One pretrain loss and gradient of every family's reduced() model
    (fp32) on the card against the CPU (chip_smoke.py's phase-2 pretrain
    agreement): the loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest entry, the unread leaves zero on both, and no
    kernel launched."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    rows = chip_smoke.small_pretrain_agreement(dev)
    assert [r[0] for r in rows] == list(chip_smoke.SMALL_PRETRAIN)
    for arch, loss_err, g_err, zeros_ok, n, counts in rows:
        print(f"{arch}: loss rel diff {loss_err:.3e}, {n} leaves within {g_err:.3e}")
        assert counts == _counts(), arch
        assert loss_err <= 1e-5 and g_err <= 1e-4 and zeros_ok, arch


# one-line faults in kernel 6's bf16 tensor-core body: (source line, edit)
GT_MUTANTS = {
    "acc not rescaled": ("rescale(acc[hp][dt], alpha[0], alpha[1]);",
                         "rescale(acc[hp][dt], 1.f, 1.f);"),
    "l not rescaled": ("l[hp][i] = alpha[i] * l[hp][i] + ps;", "l[hp][i] = l[hp][i] + ps;"),
    "diagonal masked": ("const bool keep = kpos <= qpos && kpos < Lk",
                        "const bool keep = kpos < qpos && kpos < Lk"),
    "segments ignored": (" && (!mixed || qsg[e >> 1] == ksg[col]);", ";"),
    "scale x 1.0005": ("s[hp][n][e] *= scale;", "s[hp][n][e] *= scale * 1.0005f;"),
    "unread blocks left at 0": (
        "bm[(((size_t)b * H + h0 + hp) * Lq + q0 + r) * nb + jb] = kNegInf;",
        "bm[(((size_t)b * H + h0 + hp) * Lq + q0 + r) * nb + jb] = 0.f;"),
    "skip drops a pair sharing one document": ("return qlo <= r.y && r.x <= qhi;",
                                               "return qlo < r.y && r.x <= qhi;"),
}


@pytest.mark.parametrize("mutant", list(GT_MUTANTS))
def test_gate_gt_limits_reject_a_faulty_kernel(dev, mutant, tmp_path, monkeypatch):
    """The kernel-6 limits of chip_smoke.py must reject a kernel with a
    one-line fault, on bf16 inputs of the training shape's widths (16/8
    heads x 128, block 64) with packed documents; the correct kernel
    passes the same check on the same inputs."""
    from repro_torch.kernels import gate_gt_fwd as gt
    old, new = GT_MUTANTS[mutant]
    src = (build.CSRC / "gate_gt_fwd.cu").read_text()
    assert src.count(old) == 1, mutant
    cu = tmp_path / "mutant.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p

    q, k, v, seg = _gt_inputs(dev, torch.bfloat16, 2, 1024, 16, 8, 128, 64,
                              [100, 128, 129, 600])
    o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=64, q_chunk=1024,
                                           segment_ids=seg)
    good = gt_errors(*gt.gate_gt_attention_cuda(q, k, v, block_size=64, segment_ids=seg),
                     o_p, bm_p)
    monkeypatch.setattr(build, "load", lambda name: lib)
    bad = gt_errors(*gt.gate_gt_attention_cuda(q, k, v, block_size=64, segment_ids=seg),
                    o_p, bm_p)
    torch.cuda.synchronize()
    print(f"[{mutant}] correct kernel (o err, limit, NEG_INF same, blockmax err, limit) "
          f"{good}; faulty kernel {bad}")
    assert good[0] <= good[1] and good[2] and good[3] <= good[4]
    assert not (bad[0] <= bad[1] and bad[2] and bad[3] <= bad[4]), mutant


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_gt_block_128_half_live_blocks(dev, dtype):
    """128-key blocks whose two 64-key tiles differ: a block whose first
    tile shares no document with a query tile (skipped by the bf16 body)
    keeps its max over the live tile; one whose second tile lies past the
    query tile's last row keeps its max over the first; a block with
    neither tile read is exactly -1e30."""
    from repro_torch.kernels import gate_gt_fwd as gt
    l, bs = 512, 128
    q, k, v, _ = _gt_inputs(dev, dtype, 2, l, 4, 2, 64, bs)
    s = np.zeros((2, l), np.int32)
    s[0, 64:] = 1                        # row 0: documents [0, 64), [64, 512)
    s[1, 64:200] = 1
    s[1, 200:] = 2
    seg = torch.tensor(s, device=dev)
    for sg in (None, seg):          # the packed case last: its bm_k is checked below
        o_k, bm_k = gt.gate_gt_attention_cuda(q, k, v, block_size=bs, segment_ids=sg)
        o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=bs, q_chunk=1024,
                                               segment_ids=sg)
        torch.cuda.synchronize()
        check_gt(o_k, bm_k, o_p, bm_p)
    # rows 64..127 of row 0: block 0 live over keys 64..row only (its
    # first tile, keys 0..63, holds only the other document)
    assert bool((bm_k[0, :, 64:128, 0] > -1e29).all())
    # rows 0..63: block 1 lies past them
    assert bool((bm_k[:, :, :64, 1:] == -1e30).all())


def test_gate_gt_refuses_shapes_outside_its_instances(dev):
    """What kernel 6 still refuses, each with a ValueError and no launch:
    a head dim outside ``HEAD_DIMS`` (512) and a block past ``MAX_BLOCK``
    (256), in either dtype."""
    from repro_torch.kernels import gate_gt_fwd as gt
    ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = _gt_inputs(dev, dtype, 1, 256, 2, 1, 512, 64)
        with pytest.raises(ValueError, match="head dim 512"):
            gt.gate_gt_attention_cuda(q, k, v, block_size=64)
        q, k, v, _ = _gt_inputs(dev, dtype, 1, 512, 2, 1, 64, 256)
        with pytest.raises(ValueError, match="block size 256"):
            gt.gate_gt_attention_cuda(q, k, v, block_size=256)
    assert ops.launch_counts() == _counts()


# ---------------------------------------------------------------------------
# the other dense configs' decode groups (gemma_2b, granite_20b,
# deepseek_coder_33b)
# ---------------------------------------------------------------------------

# (G, Dh) -> the planner's (gp, ngc) by K/V type: granite_20b's MQA group
# 48 x 128, gemma_2b's 8 x 256, deepseek_coder_33b's 7 x 128
CONFIG_GROUPS = {
    (48, 128): {"float32": (4, 12), "bfloat16": (8, 6), "int8": (8, 6)},
    (8, 256): {"float32": (2, 4), "bfloat16": (4, 2), "int8": (4, 2)},
    (7, 128): {"float32": (4, 2), "bfloat16": (8, 1), "int8": (8, 1)},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,dh", list(CONFIG_GROUPS))
def test_config_groups_decode_all_instances(dev, dtype, g, dh):
    """#2, #4, 2q, 4q, 5 and 5q at the configs' (G, Dh), one KV head, 64-key
    blocks: each within the limit of its plain version, the row with no
    valid key 0; #4 bitwise #2; 5(n) and 5q(n) bitwise #4(n) and 4q(n) at
    1, 4 and nsel + 3 splits; the planner's cut as predicted."""
    s, hkv, npt, bs, nsel = 3, 1, 20, 64, 8
    name = str(dtype).split(".")[-1]
    for kv, quant in ((name, False), ("int8", True)):
        plan = bsd.group_plan(g, dh, bs, dtype, quant)
        assert plan["ok"] and (plan["gp"], plan["ngc"]) == CONFIG_GROUPS[(g, dh)][kv], plan
        print(f"G {g} x Dh {dh}, {name} q, {kv} K/V: {plan}")
    q, kp, vp, idx, pt, kv_len, (k, v) = _paged_inputs(dev, dtype, s, hkv, g, dh, npt,
                                                       bs, nsel)
    o2 = bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=bs)
    _check_decode(o2, bsd.sparse_decode_plain(q, k, v, idx, kv_len, block_size=bs), dtype)
    o4 = bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs)
    _check_decode(o4, bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len,
                                                    block_size=bs), dtype)
    assert torch.equal(o2, o4)
    for ns in (1, 4, nsel + 3):
        o5 = bsd.sparse_decode_paged_splitk_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                                 num_splits=ns)
        _check_decode(o5, bsd.sparse_decode_paged_splitk_plain(
            q, kp, vp, idx, pt, kv_len, block_size=bs, num_splits=ns), dtype)
        assert torch.equal(o5, bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len,
                                                            block_size=bs, num_splits=ns))
    q, kp, vp, ksp, vsp, idx, pt, kv_len, (kq, vq, ks, vs) = _quant_paged_inputs(
        dev, dtype, s, hkv, g, dh, npt, bs, nsel)
    o2q = bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len, block_size=bs,
                                       k_scales=ks, v_scales=vs)
    _check_decode(o2q, bsd.sparse_decode_plain(q, kq, vq, idx, kv_len, block_size=bs,
                                               k_scales=ks, v_scales=vs), dtype)
    quant = dict(k_scales=ksp, v_scales=vsp)
    o4q = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                             **quant)
    _check_decode(o4q, bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len,
                                                     block_size=bs, **quant), dtype)
    assert torch.equal(o2q, o4q)
    for ns in (1, 4, nsel + 3):
        o5q = bsd.sparse_decode_paged_splitk_quant_cuda(q, kp, vp, idx, pt, kv_len,
                                                        block_size=bs, num_splits=ns, **quant)
        _check_decode(o5q, bsd.sparse_decode_paged_splitk_plain(
            q, kp, vp, idx, pt, kv_len, block_size=bs, num_splits=ns, **quant), dtype)
        assert torch.equal(o5q, bsd.sparse_decode_paged_quant_cuda(
            q, kp, vp, idx, pt, kv_len, block_size=bs, num_splits=ns, **quant))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_refuses_shapes_past_its_shared_memory(dev, dtype, quant):
    """The decode body's one limit on (G, Dh): its shared memory. A head of
    16384 elements needs more than 227 KB at G 1 in every dtype, so the
    plan says so and the launch raises, counting nothing; G 64 x Dh 128
    (more rows than any config) fits."""
    assert bsd.group_plan(64, 128, 64, dtype, quant)["ok"]
    plan = bsd.group_plan(1, 16384, 64, dtype, quant)
    assert not plan["ok"] and plan["smem"] > 227 * 1024, plan
    q, k, v, idx, kv_len = _sparse_inputs(dev, dtype, 1, 1, 1, 16384, 2, 64, 2)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="kernel launch"):
        if quant:
            (kq, ks), (vq, vs) = _quantize(k, 64, 1), _quantize(v, 64, 2)
            bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len, block_size=64,
                                         k_scales=ks, v_scales=vs)
        else:
            bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=64)
    assert ops.launch_counts() == _counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb", [257, 8192])
def test_gate_select_exact_ties_mqa(dev, dtype, nb):
    """#1 and #3 at one KV head (the MQA configs: B x Hkv CTAs), on exact
    ties at d_gate 128: budget ids bitwise the plain versions'."""
    _check_gate_ties(dev, dtype, nb, 128, hkv=1)


# faults of the 128-key block's carried max: (source line, edit)
GT_BLOCK128_MUTANTS = {
    "block max of the last tile only": ("if (kTpb > 1) bmc[hp][i] = fmaxf(bmc[hp][i], mx);",
                                        "if (kTpb > 1) bmc[hp][i] = mx;"),
    "block max written per tile": ("if (kTpb > 1 && j / kTpb != cjb) {",
                                   "if (kTpb > 1) {"),
}


@pytest.mark.parametrize("mutant", list(GT_BLOCK128_MUTANTS))
def test_gate_gt_block_128_limits_reject_a_faulty_carry(dev, mutant, tmp_path, monkeypatch):
    """The kernel-6 limits reject a bf16 body whose 128-key block max does
    not carry over the block's two tiles, on the training widths (16/8
    heads x 128) with packed documents; the correct kernel passes."""
    from repro_torch.kernels import gate_gt_fwd as gt
    old, new = GT_BLOCK128_MUTANTS[mutant]
    src = (build.CSRC / "gate_gt_fwd.cu").read_text()
    assert src.count(old) == 1, mutant
    cu = tmp_path / "mutant.cu"
    cu.write_text(src.replace(old, new))
    so = tmp_path / "mutant.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    q, k, v, seg = _gt_inputs(dev, torch.bfloat16, 2, 1024, 16, 8, 128, 128,
                              [100, 128, 129, 600])
    o_p, bm_p = gt.gate_gt_attention_plain(q, k, v, block_size=128, q_chunk=1024,
                                           segment_ids=seg)
    good = gt_errors(*gt.gate_gt_attention_cuda(q, k, v, block_size=128, segment_ids=seg),
                     o_p, bm_p)
    monkeypatch.setattr(build, "load", lambda name: lib)
    bad = gt_errors(*gt.gate_gt_attention_cuda(q, k, v, block_size=128, segment_ids=seg),
                    o_p, bm_p)
    torch.cuda.synchronize()
    print(f"[{mutant}] correct kernel {good}; faulty kernel {bad}")
    assert good[0] <= good[1] and good[2] and good[3] <= good[4]
    assert not (bad[0] <= bad[1] and bad[2] and bad[3] <= bad[4]), mutant


# ---------------------------------------------------------------------------
# the pressure paths: eviction's ghost rows and clamped tables
# ---------------------------------------------------------------------------

def _ghost_table(table, n_pages, r, share=0.4):
    """Move a share of each row's live table entries to ghost ids >= the
    pool's ``n_pages`` rows (the trailing live block stays), as eviction
    does; returns (the ghost-holding table, the source row of each ghost)."""
    table = table.copy()
    src = []
    for i in range(table.shape[0]):
        live = np.nonzero(table[i])[0][:-1]
        for j in r.permutation(live)[:int(np.ceil(share * len(live)))]:
            src.append(table[i, j])
            table[i, j] = n_pages + len(src) - 1
    return table, np.asarray(src, np.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb", [2, 33, 257, 1024])
def test_gate_select_paged_over_ghost_rows_bitwise(dev, dtype, nb):
    """#3 over a Kg pool extended by ghost rows, through a table holding
    ghost ids: on the exact-tie inputs (tests/gate_ties.py) its ids are
    bitwise its plain version's on the same pool and table, and bitwise
    its own over the pool before the rows moved."""
    b, hkv, dg = 3, 2, 128
    nv_np = gate_ties.n_valid(b, nb)
    qg, pool, table = gate_ties.paged(5, b, hkv, nb, dg, nv_np)
    ghost_table, src = _ghost_table(table, pool.shape[0], np.random.default_rng(nb))
    assert (ghost_table >= pool.shape[0]).any()
    ghost_pool = np.concatenate([pool, pool[src]])          # the parked rows
    on = lambda x: torch.tensor(x, device=dev)
    nv = on(nv_np)
    for method in ("budget", "threshold"):
        cfg = t_config.GateConfig(**_GS, method=method, threshold=5e-3)
        for ms in sorted(k for k in {1, 64, nb} if k <= nb):
            k_idx = gs.gate_select_paged_cuda(on(qg).to(dtype), on(ghost_pool).to(dtype),
                                              on(ghost_table), nv, cfg, ms)
            p_idx = gs.gate_select_paged_plain(on(qg).to(dtype), on(ghost_pool).to(dtype),
                                               on(ghost_table), nv, cfg, ms)
            base = gs.gate_select_paged_cuda(on(qg).to(dtype), on(pool).to(dtype),
                                             on(table), nv, cfg, ms)
            torch.cuda.synchronize()
            assert torch.equal(k_idx, base), (method, ms)
            if method == "budget":
                assert torch.equal(k_idx, p_idx), (method, ms)
            else:
                ids_agree(k_idx, p_idx, gs.gate_scores_plain(
                    on(qg).to(dtype), pg.gather_kg(on(ghost_pool).to(dtype),
                                                   on(ghost_table)), nv, cfg))


@pytest.mark.parametrize("kernel", ["paged", "paged_quant", "splitk", "splitk_quant"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hkv,g,dh,npt,bs,nsel", [
    (3, 1, 5, 32, 6, 16, 6),
    (4, 8, 2, 128, 257, 64, 64),           # the main path's shapes
])
def test_decode_kernels_over_clamped_ghost_table(dev, kernel, dtype, s, hkv, g, dh, npt,
                                                 bs, nsel):
    """#4, 4q, 5 and 5q (4 splits) read through an eviction's clamped table
    (ghost ids -> the pool's last page, selected and unselected): within
    the decode limit of their plain versions on the same clamped table,
    which holds no id past the pool."""
    quant = kernel.endswith("quant")
    if quant:
        q, kp, vp, ksp, vsp, idx, pt, kv_len, _ = _quant_paged_inputs(
            dev, dtype, s, hkv, g, dh, npt, bs, nsel)
        scales = dict(k_scales=ksp, v_scales=vsp)
    else:
        q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, dtype, s, hkv, g, dh, npt, bs,
                                                      nsel)
        scales = {}
    n_pages = kp.shape[0]
    ghost, _ = _ghost_table(pt.cpu().numpy(), n_pages, np.random.default_rng(npt))
    pt_kv = torch.clamp_max(torch.tensor(ghost, device=dev), n_pages - 1)
    assert int(pt_kv.max()) < n_pages and (ghost >= n_pages).any()
    if kernel.startswith("splitk"):
        wrapper = (bsd.sparse_decode_paged_splitk_quant_cuda if quant
                   else bsd.sparse_decode_paged_splitk_cuda)
        o_k = wrapper(q, kp, vp, idx, pt_kv, kv_len, block_size=bs, num_splits=4, **scales)
        o_p = bsd.sparse_decode_paged_splitk_plain(q, kp, vp, idx, pt_kv, kv_len,
                                                   block_size=bs, num_splits=4, **scales)
    else:
        wrapper = (bsd.sparse_decode_paged_quant_cuda if quant
                   else bsd.sparse_decode_paged_cuda)
        o_k = wrapper(q, kp, vp, idx, pt_kv, kv_len, block_size=bs, **scales)
        o_p = bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt_kv, kv_len, block_size=bs,
                                            **scales)
    torch.cuda.synchronize()
    _check_decode(o_k, o_p, dtype)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_cuda_eviction_serve_replays_and_matches(dev, quantize):
    """serve(eviction=...) on the card (tiny config, fp32) under a resident
    cap that forces fault -> restore -> replay: replays > 0, #3 and the
    decode kernel launched layers x (decode steps + replays) times, the
    tokens equal to the CPU eviction run's (logits within 1e-4, int8 1e-3)
    and, over fp pools, bitwise the card's own run without eviction."""
    from repro_torch.core.policy import DecodeOptions
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import DecodeEngine
    from repro_torch.serve.eviction import EvictionConfig
    cfg = _tiny_cfg()
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    r = np.random.default_rng(3)
    reqs = [{"rid": i, "max_new_tokens": m,
             "tokens": r.integers(0, cfg.vocab_size, size=(p,)).astype(np.int32)}
            for i, (p, m) in enumerate([(61, 10), (45, 12), (30, 9)])]
    opts = DecodeOptions(quantize=quantize)
    gpu = DecodeEngine(cfg, params_to(params, dev), max_len=128, options=opts)
    cpu = DecodeEngine(cfg, params, max_len=128, options=opts, device="cpu")
    ev = EvictionConfig(max_resident_pages=3)
    want = cpu.serve(reqs, n_slots=3, collect_logits=True, eviction=ev)
    ample = gpu.serve(reqs, n_slots=3, collect_logits=True)
    ops.reset_launch_counts()
    got = gpu.serve(reqs, n_slots=3, collect_logits=True, eviction=ev)
    st = got["stats"]
    assert st["replay_steps"] > 0 and st["errors"] == {}
    for key in ("evictions", "page_restores", "replay_steps", "decode_steps"):
        assert st[key] == want["stats"][key], key
    n = cfg.num_layers * (st["decode_steps"] + st["replay_steps"])
    decode = "block_sparse_decode_paged" + ("_quant" if quantize else "")
    assert ops.launch_counts() == _counts(gate_select_paged=n, **{decode: n})
    for i in range(len(reqs)):
        assert got[i] == want[i]
        np.testing.assert_allclose(got["logits"][i], want["logits"][i],
                                   atol=1e-3 if quantize else 1e-4)
        if quantize is None:
            assert got[i] == ample[i]
            np.testing.assert_array_equal(got["logits"][i], ample["logits"][i])


# ---------------------------------------------------------------------------
# the MoE and vision families' shapes: the decode groups G 1 (deepseek_moe_16b,
# MHA 16 x 128), G 4 (llama_3_2_vision_11b, 32 / 8 x 128) and G 8 (kimi_k2,
# 64 / 8 x 128) at batch 4, 257 blocks of 64, 64 selected; the gate select at
# 16 and 8 KV heads; moe_mlp on the card with capacity drops
# ---------------------------------------------------------------------------

FAMILY_SHAPES = {"g1": (4, 16, 1, 128, 257, 64, 64), "g4": (4, 8, 4, 128, 257, 64, 64),
                 "g8": (4, 8, 8, 128, 257, 64, 64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(FAMILY_SHAPES))
def test_family_group_decode_kernels_match_plain(dev, dtype, shape):
    """#2, #4, 2q, 4q, 5 and 5q against their plain versions at the
    family's group (the split plan, ``group_plan`` and, at G 1, the int8
    loop's lane mapping at one query row); #4 bitwise #2 over the same
    blocks, 4q bitwise 2q, 5 / 5q bitwise #4 / 4q at the same split count."""
    b, hkv, g, dh, nb, bs, nsel = FAMILY_SHAPES[shape]
    q, k, v, idx, kv_len = _sparse_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel)
    o2 = bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=bs)
    _check_decode(o2, bsd.sparse_decode_plain(q, k, v, idx, kv_len, block_size=bs), dtype)
    q, kp, vp, idx, pt, kv_len, _ = _paged_inputs(dev, dtype, b, hkv, g, dh, nb, bs, nsel)
    o4 = bsd.sparse_decode_paged_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs)
    _check_decode(o4, bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len,
                                                    block_size=bs), dtype)
    assert torch.equal(o4, o2)
    for ns in (2, 4, 8, nsel + 3):
        o5 = bsd.sparse_decode_paged_splitk_cuda(q, kp, vp, idx, pt, kv_len, block_size=bs,
                                                 num_splits=ns)
        _check_decode(o5, bsd.sparse_decode_paged_splitk_plain(
            q, kp, vp, idx, pt, kv_len, block_size=bs, num_splits=ns), dtype)
        assert torch.equal(o5, bsd.sparse_decode_paged_cuda(
            q, kp, vp, idx, pt, kv_len, block_size=bs, num_splits=ns)), ns
    q, kp, vp, ksp, vsp, idx, pt, kv_len, (kq, vq, ks, vs) = _quant_paged_inputs(
        dev, dtype, b, hkv, g, dh, nb, bs, nsel)
    o2q = bsd.sparse_decode_quant_cuda(q, kq, vq, idx, kv_len, block_size=bs, k_scales=ks,
                                       v_scales=vs)
    _check_decode(o2q, bsd.sparse_decode_plain(q, kq, vq, idx, kv_len, block_size=bs,
                                               k_scales=ks, v_scales=vs), dtype)
    kw = dict(block_size=bs, k_scales=ksp, v_scales=vsp)
    o4q = bsd.sparse_decode_paged_quant_cuda(q, kp, vp, idx, pt, kv_len, **kw)
    _check_decode(o4q, bsd.sparse_decode_paged_plain(q, kp, vp, idx, pt, kv_len, **kw), dtype)
    assert torch.equal(o4q, o2q)
    for ns in (2, 4, 8, nsel + 3):
        o5q = bsd.sparse_decode_paged_splitk_quant_cuda(q, kp, vp, idx, pt, kv_len,
                                                        num_splits=ns, **kw)
        _check_decode(o5q, bsd.sparse_decode_paged_splitk_plain(
            q, kp, vp, idx, pt, kv_len, num_splits=ns, **kw), dtype)
        assert torch.equal(o5q, bsd.sparse_decode_paged_quant_cuda(
            q, kp, vp, idx, pt, kv_len, num_splits=ns, **kw)), ns
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv", [16, 8])
def test_family_heads_gate_select_matches_plain(dev, dtype, hkv):
    """#1 and #3 at batch 4 over 16 KV heads (deepseek_moe_16b: 64 CTAs a
    step) and 8 (kimi, the vision model), 257 blocks of Dg 128: random
    inputs (ids equal up to near-tie swaps, #3 bitwise #1 over the same
    rows paged), then exact ties bitwise."""
    b, nb, dg = 4, 257, 128
    g = torch.Generator(device=dev).manual_seed(3)
    qg = torch.randn(b, hkv, dg, generator=g, device=dev).to(dtype)
    kg = torch.randn(b, hkv, nb, dg, generator=g, device=dev).to(dtype)
    nv = torch.tensor([nb, nb // 2 + 1, 1, nb - 3], dtype=torch.int32, device=dev)
    pt = torch.arange(1, b * nb + 1, dtype=torch.int32, device=dev).reshape(b, nb)
    pool = torch.cat([torch.zeros(1, hkv, dg, dtype=dtype, device=dev),
                      kg.transpose(1, 2).reshape(b * nb, hkv, dg)])
    for cfg in GATES:
        cfg = dataclasses.replace(cfg, block_size=64, d_gate=dg, token_budget=4096)
        k_idx = gs.gate_select_cuda(qg, kg, nv, cfg)
        p_idx = gs.gate_select_plain(qg, kg, nv, cfg)
        kp_idx = gs.gate_select_paged_cuda(qg, pool, pt, nv, cfg)
        torch.cuda.synchronize()
        scores = gs.gate_scores_plain(qg, kg, nv, cfg)
        ids_agree(k_idx, p_idx, scores)
        ids_agree(kp_idx, gs.gate_select_paged_plain(qg, pool, pt, nv, cfg), scores)
        assert torch.equal(kp_idx, k_idx)
    _check_gate_ties(dev, dtype, nb, dg, hkv=hkv, b=b)


@pytest.mark.parametrize("tokens", [4, 64])
def test_moe_mlp_cuda_matches_cpu(dev, tokens):
    """deepseek_moe_16b's router (64 experts, top 6, 2 shared, capacity
    1.25) at d 256 in fp32: decode's 4 rows (one slot an expert) and 64
    rows; assignments drop at capacity in both. The keep mask equal to the
    CPU's, the output within 1e-4, the aux loss too."""
    from repro_torch.models import moe
    mcfg = t_config.MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=128,
                              capacity_factor=1.25)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 256, mcfg, dtype="float32")
    x = torch.randn(tokens, 256, generator=gen)
    pc = params_to(p, dev)
    keeps = []
    for params, xs in ((p, x), (pc, x.to(dev))):
        _, top_i, _ = moe.route(xs, params["router"]["w"], mcfg.top_k)
        keeps.append(moe.dispatch(top_i, mcfg)[2].cpu())
    assert torch.equal(keeps[0], keeps[1]) and not keeps[0].all()
    y_c, aux_c = moe.moe_mlp(p, x, mcfg)
    y_g, aux_g = moe.moe_mlp(pc, x.to(dev), mcfg)
    torch.cuda.synchronize()
    assert float((y_g.cpu() - y_c).abs().max()) <= 1e-4
    assert abs(float(aux_g) - float(aux_c)) <= 1e-6
