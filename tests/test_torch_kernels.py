"""Kernel-module parity of the PyTorch port against the JAX reference.

The plain PyTorch versions of the two ported kernels run on the CPU
against BOTH the reference's jnp oracle and its Pallas kernel in interpret
mode, on the same numpy-seeded inputs:

  * ``gate_select_plain`` vs ``gate_select_ref`` and
    ``fused_gate_select(interpret=True)`` over the five gate-select
    configs of ``tests/test_layout.py`` (budget/threshold x force flags),
    n_valid full/partial/1: ids exactly equal;
  * ``sparse_decode_plain`` vs ``sparse_decode_ref`` and
    ``ops.sparse_decode(impl="pallas_interpret")`` with -1 padding and a
    partial last block: atol 1e-5.

The dispatch in ``repro_torch.kernels.ops`` takes the plain version for a
CPU tensor and never counts a CUDA launch there. The CUDA kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gate_ties
from repro.config import GateConfig
from repro.kernels import gate_select as j_gs
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch import config as t_config
from repro_torch.kernels import block_sparse_decode as t_bsd
from repro_torch.kernels import gate_select as t_gs
from repro_torch.kernels import ops as t_ops

jax.config.update("jax_platform_name", "cpu")

# the five configs of tests/test_layout.py::GS_CONFIGS
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


def tcfg(g: GateConfig):
    return t_config.GateConfig(**dataclasses.asdict(g))


@pytest.mark.parametrize("cfg", GS_CONFIGS, ids=GS_IDS)
@pytest.mark.parametrize("max_selected", [None, 3])
def test_gate_select_plain_matches_ref_and_pallas(cfg, max_selected):
    b, hkv, nb, dg = 3, 2, 16, 16
    r = np.random.default_rng(17)
    qg = r.standard_normal((b, hkv, dg)).astype(np.float32)
    kg = r.standard_normal((b, hkv, nb, dg)).astype(np.float32)
    n_valid = np.array([nb, 9, 1], np.int32)            # full, partial, 1
    t_idx = t_gs.gate_select_plain(torch.tensor(qg), torch.tensor(kg),
                                   torch.tensor(n_valid), tcfg(cfg), max_selected)
    j_args = (jnp.asarray(qg), jnp.asarray(kg), jnp.asarray(n_valid), cfg,
              max_selected)
    np.testing.assert_array_equal(t_idx.numpy(),
                                  np.asarray(j_gs.gate_select_ref(*j_args)))
    np.testing.assert_array_equal(
        t_idx.numpy(), np.asarray(j_gs.fused_gate_select(*j_args, interpret=True)))
    assert t_gs.n_selected(tcfg(cfg), nb, max_selected) == \
        j_gs.n_selected(cfg, nb, max_selected) == t_idx.shape[-1]


# (method, nb, max_selected, force flags): the two original cases (random
# normal qg, Kg rows each repeated 4 times), then the tie-heavy integer
# inputs of tests/gate_ties.py at nb <= 257, k 1, 64 and nb
TIE_CASES = [("budget", None, None, None), ("threshold", None, None, None)] + [
    (method, nb, k, force)
    for method in ("budget", "threshold") for force in (True, False)
    for nb in (1, 2, 33, 257) for k in sorted({1, 64, nb}) if k <= nb]
TIE_IDS = ["budget", "threshold"] + [
    f"{m}-nb{nb}-k{k}-force{int(f)}" for m, nb, k, f in TIE_CASES[2:]]


@pytest.mark.parametrize("method,nb,max_selected,force", TIE_CASES, ids=TIE_IDS)
def test_gate_select_plain_exact_ties(method, nb, max_selected, force):
    """Bit-equal scores: the lower block index first, and ids exactly equal
    across the plain version, the jnp reference and the Pallas kernel,
    contiguous and paged (the card holds the CUDA kernels to the same plain
    versions on the same inputs, tests/test_torch_cuda.py)."""
    if nb is None:                 # duplicated Kg rows, random normal values
        cfg = GateConfig(**_GS, method=method, threshold=1e-3)
        r = np.random.default_rng(5)
        qg = r.standard_normal((2, 2, 16)).astype(np.float32)
        kg = np.repeat(r.standard_normal((2, 2, 4, 16)).astype(np.float32), 4, axis=2)
        n_valid = np.array([16, 11], np.int32)
        t_idx = t_gs.gate_select_plain(torch.tensor(qg), torch.tensor(kg),
                                       torch.tensor(n_valid), tcfg(cfg), 6)
        j_idx = j_gs.fused_gate_select(jnp.asarray(qg), jnp.asarray(kg),
                                       jnp.asarray(n_valid), cfg, 6, interpret=True)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        return
    cfg = GateConfig(**_GS, method=method, threshold=5e-3,
                     always_first_block=force, always_last_block=force)
    b, hkv, dg = 3, 2, 16
    nv = gate_ties.n_valid(b, nb)
    qg, kg = gate_ties.contiguous(7, b, hkv, nb, dg)
    t_idx = t_gs.gate_select_plain(torch.tensor(qg), torch.tensor(kg),
                                   torch.tensor(nv), tcfg(cfg), max_selected)
    j_args = (jnp.asarray(qg), jnp.asarray(kg), jnp.asarray(nv), cfg, max_selected)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_gs.gate_select_ref(*j_args)))
    np.testing.assert_array_equal(
        t_idx.numpy(), np.asarray(j_gs.fused_gate_select(*j_args, interpret=True)))
    qg, pool, table = gate_ties.paged(8, b, hkv, nb, dg, nv)
    t_idx = t_gs.gate_select_paged_plain(torch.tensor(qg), torch.tensor(pool),
                                         torch.tensor(table), torch.tensor(nv),
                                         tcfg(cfg), max_selected)
    j_args = tuple(map(jnp.asarray, (qg, pool, table, nv))) + (cfg, max_selected)
    np.testing.assert_array_equal(t_idx.numpy(),
                                  np.asarray(j_gs.gate_select_paged_ref(*j_args)))
    np.testing.assert_array_equal(
        t_idx.numpy(), np.asarray(j_gs.fused_gate_select_paged(*j_args, interpret=True)))


def _sparse_inputs(seed, b, hkv, g, dh, nb, bs, nsel):
    r = np.random.default_rng(seed)
    s = nb * bs
    q = r.standard_normal((b, hkv, g, dh)).astype(np.float32)
    k = r.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = r.standard_normal((b, hkv, s, dh)).astype(np.float32)
    idx = np.full((b, hkv, nsel), -1, np.int32)
    kv_len = r.integers(s - bs + 1, s, size=(b,)).astype(np.int32)  # partial last
    for bi in range(b):
        for hi in range(hkv):
            n = r.integers(1, nsel + 1)
            idx[bi, hi, :n] = r.choice(nb, n, replace=False)
        idx[bi, :, 0] = (kv_len[bi] - 1) // bs                     # last block
    idx[0, 0, 1:] = -1                                             # -1 padding
    return q, k, v, idx, kv_len


@pytest.mark.parametrize("b,hkv,g,dh,nb,bs,nsel", [
    (2, 2, 2, 16, 8, 8, 4),        # tiny_cfg decode shape
    (1, 3, 4, 32, 6, 16, 6),       # every block selectable
    (3, 1, 5, 16, 5, 4, 2),        # odd group
])
def test_sparse_decode_plain_matches_ref_and_pallas(b, hkv, g, dh, nb, bs, nsel):
    q, k, v, idx, kv_len = _sparse_inputs(23, b, hkv, g, dh, nb, bs, nsel)
    o_t = t_bsd.sparse_decode_plain(*map(torch.tensor, (q, k, v, idx, kv_len)),
                                    block_size=bs)
    j_in = tuple(map(jnp.asarray, (q, k, v, idx, kv_len)))
    o_ref = j_ref.sparse_decode_ref(*j_in, block_size=bs)
    o_pal = j_ops.sparse_decode(*j_in, block_size=bs, impl="pallas_interpret")
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_pal), atol=1e-5, rtol=0)


def test_sparse_decode_plain_all_padding_gives_zero():
    q, k, v, idx, kv_len = _sparse_inputs(3, 1, 2, 2, 16, 4, 8, 3)
    idx[:] = -1
    o = t_bsd.sparse_decode_plain(*map(torch.tensor, (q, k, v, idx, kv_len)),
                                  block_size=8)
    assert torch.equal(o, torch.zeros_like(o))


def test_cpu_dispatch_takes_plain_and_counts_no_launch():
    t_ops.reset_launch_counts()
    q, k, v, idx, kv_len = map(torch.tensor, _sparse_inputs(4, 2, 2, 2, 16, 8, 8, 4))
    out = t_ops.sparse_decode(q, k, v, idx, kv_len, block_size=8)
    assert torch.equal(out, t_bsd.sparse_decode_plain(q, k, v, idx, kv_len,
                                                      block_size=8))
    cfg = tcfg(GS_CONFIGS[0])
    qg, kg = torch.randn(2, 2, 16), torch.randn(2, 2, 8, 16)
    nv = torch.tensor([8, 3], dtype=torch.int32)
    assert torch.equal(t_ops.gate_select(qg, kg, nv, cfg),
                       t_gs.gate_select_plain(qg, kg, nv, cfg))
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, idx, kv_len = map(torch.tensor, _sparse_inputs(4, 2, 2, 2, 16, 8, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        t_bsd.sparse_decode_cuda(q, k, v, idx, kv_len, block_size=8)
    with pytest.raises(ValueError, match="CUDA"):
        t_gs.gate_select_cuda(torch.randn(2, 2, 16), torch.randn(2, 2, 8, 16),
                              torch.tensor([8, 3], dtype=torch.int32),
                              tcfg(GS_CONFIGS[0]))


def test_build_names_libraries_by_source_and_flags(monkeypatch):
    """A library's name hashes its source and the nvcc flags, so an edited
    source or flag rebuilds."""
    from repro_torch.kernels import build
    paths = {name: build.lib_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so" for p in paths.values())
    assert build.lib_path("gate_select") == paths["gate_select"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX",))
    assert build.lib_path("gate_select") != paths["gate_select"]


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    real_is_file = build.Path.is_file
    monkeypatch.setattr(build.Path, "is_file",
                        lambda self: False if self.name == "nvcc" else real_is_file(self))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
