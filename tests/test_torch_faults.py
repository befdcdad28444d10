"""Fault injection, the tiered swap space and failure isolation of the
port's ``serve`` on the CPU, against the live JAX package.

* ``FaultInjector``: the same plan fires on the same calls, with the same
  counters and refusals.
* ``HostSwapSpace``: the same operations on the same entries (the port's
  as CPU tensors, the reference's as numpy arrays) give the same stats
  field by field after every step; the disk tier's round trip is bitwise
  (bf16 entries included, stored as their bit pattern); capacity errors,
  transient retries and the permanent-fault budget raise and count as the
  reference's do.
* Every fault site of ``serve`` (``page_alloc``, ``swap_put``,
  ``swap_pop`` during an eviction replay, ``logits``), the step-limit and
  admission-stall watchdogs and a fault storm over every site: the port
  returns the JAX engine's errors (rid -> reason), its partial tokens for
  every rid, and its counters, and every request that did not fail is
  bitwise equal to the port's own fault-free run.
* ``offload_step_model`` and ``OffloadedKV``: against the reference with
  both modules' HBM and PCIe constants set equal by ``monkeypatch``.

The reduced qwen3_0_6b (2 layers, float32, gate block 8) and the weights
of ``tests/test_torch_eviction.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
import repro.serve.offload as j_off
from repro.config import reduced as j_reduced
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.eviction import EvictionConfig as JEviction
from repro.serve.faults import FaultInjector as JFaults
import repro_torch.serve.offload as t_off
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.eviction import EvictionConfig
from repro_torch.serve.faults import FaultInjector

jax.config.update("jax_platform_name", "cpu")


def cfgs(token_budget=32):
    gate = dict(block_size=8, d_gate=16, token_budget=token_budget, method="budget",
                threshold=2e-2)
    j = j_reduced(j_configs.get("qwen3_0_6b")).replace(dtype="float32")
    t = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return (j.replace(gate=dataclasses.replace(j.gate, **gate)),
            t.replace(gate=dataclasses.replace(t.gate, **gate)))


def requests(cfg, specs, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rid": i, "max_new_tokens": mn,
             "tokens": rng.integers(0, cfg.vocab_size, size=(pl,)).astype(np.int32)}
            for i, (pl, mn) in enumerate(specs)]


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

def test_fault_injector_matches_jax():
    plan = {"swap_put": [0, 2], "page_alloc": {1}, "disk_read": range(1, 3)}
    t, j = FaultInjector(plan), JFaults(plan)
    assert t.SITES == j.SITES
    seq = ["swap_put"] * 4 + ["page_alloc"] * 3 + ["disk_read"] * 4 + ["logits"]
    assert [t.fire(s) for s in seq] == [j.fire(s) for s in seq]
    assert t.stats() == j.stats()
    assert t.plan == j.plan
    for bad, msg in (({"warp_core": [0]}, "unknown fault site"),
                     ({"swap_put": [-1]}, "negative")):
        with pytest.raises(ValueError, match=msg):
            FaultInjector(bad)
        with pytest.raises(ValueError, match=msg):
            JFaults(bad)
    with pytest.raises(ValueError, match="unknown fault site"):
        t.fire("warp_core")


# ---------------------------------------------------------------------------
# tiered swap space
# ---------------------------------------------------------------------------

def _entry(seed=0, pages=2, dtype=torch.float32):
    """(port SwapEntry of CPU tensors, the reference's of numpy arrays)."""
    rng = np.random.default_rng(seed)
    shp = (2, pages, 2, 8, 4)
    k = torch.from_numpy(rng.normal(size=shp).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.normal(size=shp).astype(np.float32)).to(dtype)
    kg = torch.from_numpy(rng.normal(size=(2, pages, 2, 16)).astype(np.float32)).to(dtype)
    te = t_off.SwapEntry(k=k, v=v, kg=kg, token=7, cur_len=13)
    if dtype == torch.bfloat16:          # numpy has no bf16: the same bytes as int16
        je = j_off.SwapEntry(*(x.view(torch.int16).numpy() for x in (k, v, kg)),
                             token=7, cur_len=13)
    else:
        je = j_off.SwapEntry(k=k.numpy(), v=v.numpy(), kg=kg.numpy(), token=7, cur_len=13)
    return te, je


def _page(te):
    return (t_off.PageEntry(k=te.k[:, :1].clone(), v=te.v[:, :1].clone(),
                            kg=te.kg[:, :1].clone()))


def _same_stats(t, j):
    assert t.stats() == j.stats()
    assert (t.bytes_out, t.bytes_in, t.swapped_out, t.swapped_in, len(t)) == \
        (j.bytes_out, j.bytes_in, j.swapped_out, j.swapped_in, len(j))


def _equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swap_disk_tier_roundtrip_matches_jax(tmp_path, dtype):
    (a, ja), (b, jb) = _entry(1, dtype=dtype), _entry(2, dtype=dtype)
    cap = t_off.HostSwapSpace._nbytes(a) + 1              # room for exactly one
    assert cap == j_off.HostSwapSpace._nbytes(ja) + 1
    t = t_off.HostSwapSpace(t_off.SwapConfig(host_capacity_bytes=cap,
                                             disk_dir=str(tmp_path / "port")))
    j = j_off.HostSwapSpace(j_off.SwapConfig(host_capacity_bytes=cap,
                                             disk_dir=str(tmp_path / "jax")))
    pe = _page(a)
    jpe = j_off.PageEntry(k=ja.k[:, :1], v=ja.v[:, :1], kg=ja.kg[:, :1])
    for key, te, je in (("a", a, ja), ("b", b, jb), (("page", 0, 1), pe, jpe)):
        t.put(key, te)                                    # demotes the oldest
        j.put(key, je)
        _same_stats(t, j)
    assert t.stats()["disk_entries"] == 2 and t.host_bytes <= cap
    for key, want in (("a", a), (("page", 0, 1), pe), ("b", b)):
        got = t.pop(key)                                  # disk promotions
        j.pop(key)
        _equal(got, want)
        _same_stats(t, j)
    assert t.promotions == 2 and len(t) == 0 and t.disk_bytes == t.host_bytes == 0
    assert not list((tmp_path / "port").iterdir())        # popped files removed


def test_swap_capacity_and_lookup_errors_match_jax(tmp_path):
    (e, je) = _entry()
    for mod, entry in ((t_off, e), (j_off, je)):
        space = mod.HostSwapSpace(mod.SwapConfig(host_capacity_bytes=10))   # no disk tier
        with pytest.raises(mod.SwapCapacityError, match="no disk tier"):
            space.put("x", entry)
        assert "x" not in space and space.host_bytes == 0
    nb = t_off.HostSwapSpace._nbytes(e)
    t = t_off.HostSwapSpace(t_off.SwapConfig(host_capacity_bytes=nb + 1,
                                             disk_dir=str(tmp_path / "p"),
                                             disk_capacity_bytes=nb + 1))
    j = j_off.HostSwapSpace(j_off.SwapConfig(host_capacity_bytes=nb + 1,
                                             disk_dir=str(tmp_path / "j"),
                                             disk_capacity_bytes=nb + 1))
    for seed, key in ((1, "a"), (2, "b")):
        t.put(key, _entry(seed)[0])
        j.put(key, _entry(seed)[1])
    _same_stats(t, j)
    with pytest.raises(t_off.SwapCapacityError, match="disk swap tier full"):
        t.put("c", _entry(3)[0])                          # b cannot demote
    with pytest.raises(j_off.SwapCapacityError, match="disk swap tier full"):
        j.put("c", _entry(3)[1])
    _same_stats(t, j)
    _equal(t.pop("b"), _entry(2)[0])                      # the undo kept "b"
    t.discard("a")                                        # from the disk tier
    j.pop("b")
    j.discard("a")
    _same_stats(t, j)
    assert t.disk_bytes == 0 and len(t) == 0
    with pytest.raises(t_off.SwapLookupError, match=r"no swap entry for key 7"):
        t.pop(7)
    with pytest.raises(KeyError):
        t.pop(("page", 1, 2))
    t.put(3, e)
    with pytest.raises(ValueError, match=r"already resident.*3"):
        t.put(3, e)
    with pytest.raises(ValueError, match="host"):
        t.put(4, e._replace(k=e.k.to("meta")))


@pytest.mark.parametrize("plan,retries,disk,raises", [
    ({"swap_put": [0], "swap_pop": [0]}, 2, False, False),      # transient
    ({"disk_write": [0], "disk_read": [0]}, 1, True, False),    # transient, disk
    ({"swap_put": range(4)}, 3, False, True),                   # permanent
    ({"disk_write": range(2)}, 1, True, True),                  # permanent, disk
])
def test_swap_retries_match_jax(tmp_path, plan, retries, disk, raises):
    e, je = _entry()
    kw = dict(retries=retries)
    if disk:      # host cap under the entry: put and pop take the disk tier
        kw.update(host_capacity_bytes=10)
    t = t_off.HostSwapSpace(t_off.SwapConfig(**kw, disk_dir=str(tmp_path / "p") if disk
                                             else None), faults=FaultInjector(plan))
    j = j_off.HostSwapSpace(j_off.SwapConfig(**kw, disk_dir=str(tmp_path / "j") if disk
                                             else None), faults=JFaults(plan))
    if raises:
        n = retries + 1
        with pytest.raises(t_off.SwapIOError, match=f"after {n} attempts"):
            t.put("a", e)
        with pytest.raises(j_off.SwapIOError, match=f"after {n} attempts"):
            j.put("a", je)
        assert "a" not in t
        t.put("b", e)                                      # the plan is spent
        j.put("b", je)
    else:
        t.put("a", e)
        j.put("a", je)
        _equal(t.pop("a"), e)
        j.pop("a")
    _same_stats(t, j)
    assert t.faults.stats() == j.faults.stats()
    assert t.retries_used == j.retries_used > 0


# ---------------------------------------------------------------------------
# serve() under injected faults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jcfg, tcfg = cfgs()
    p = get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return p, params_from_numpy(jax.device_get(p), tcfg, "cpu")


SPECS3 = [(20, 8), (18, 7), (22, 6)]
HALF = [(40, 25), (38, 24), (41, 22)]
# name -> (token budget, specs, prompt seed, serve kwargs, fault plan or None,
#          EvictionConfig kwargs or None, pool: "half" of the fault-free
#          run's peak or None)
FAULT_CASES = {
    "alloc": (32, SPECS3, 0, dict(n_slots=2), {"page_alloc": [1, 4, 6]}, None, None),
    "swap-put-permanent": (16, HALF, 0, dict(n_slots=3), {"swap_put": range(4)}, None,
                           "half"),
    "logits": (32, SPECS3[:2], 0, dict(n_slots=2), {"logits": [1]}, None, None),
    "restore-fault": (32, [(61, 10)], 3, dict(n_slots=1), {"swap_pop": range(4)},
                      dict(max_resident_pages=3), None),
    "step-limit": (32, [(12, 10), (14, 9)], 0, dict(n_slots=2, max_steps=3), None, None,
                   None),
    "admission-stall": (32, [(12, 4)], 0, dict(n_slots=1), {"page_alloc": range(64)},
                        None, None),
    "storm-alloc": (32, SPECS3, 0, dict(n_slots=2), {"page_alloc": range(0, 40, 2)},
                    None, None),
    "storm-put": (32, SPECS3, 0, dict(n_slots=2),
                  {"page_alloc": [2], "swap_put": range(8)}, None, None),
    "storm-mixed": (32, SPECS3, 0, dict(n_slots=2),
                    {"swap_put": [0], "swap_pop": [0], "page_alloc": [2, 3]}, None, None),
    "storm-logits": (32, SPECS3, 0, dict(n_slots=2), {"logits": [0, 2, 4]}, None, None),
    "storm-evict": (16, HALF, 0, dict(n_slots=3),
                    {"page_alloc": [5, 9], "swap_put": [3], "swap_pop": [1], "logits": [7]},
                    dict(), "half"),
}
COUNTERS = ("failed", "retired", "errors", "preemptions", "resumed", "evictions",
            "page_restores", "replay_steps", "faults", "swap", "decode_steps")


@pytest.mark.parametrize("name", list(FAULT_CASES))
def test_serve_fault_sites_match_jax(params, name):
    budget, specs, seed, kw, plan, ev_kw, pool = FAULT_CASES[name]
    jcfg, tcfg = cfgs(budget)
    reqs = requests(jcfg, specs, seed)
    eng = DecodeEngine(tcfg, params[1], max_len=128, device="cpu")
    clean = eng.serve([dict(r) for r in reqs], collect_logits=True,
                      **{k: v for k, v in kw.items() if k != "max_steps"})
    kw = dict(kw)
    if pool == "half":
        kw["num_pages"] = 1 + (clean["stats"]["peak_pages_used"] + 1) // 2
    j_kw, t_kw = dict(kw), dict(kw)
    if plan is not None:
        j_kw["faults"], t_kw["faults"] = JFaults(plan), FaultInjector(plan)
    if ev_kw is not None:
        j_kw["eviction"], t_kw["eviction"] = JEviction(**ev_kw), EvictionConfig(**ev_kw)
    j_res = JaxEngine(jcfg, params[0], max_len=128).serve([dict(r) for r in reqs], **j_kw)
    res = eng.serve([dict(r) for r in reqs], collect_logits=True, **t_kw)
    st = res["stats"]
    for key in COUNTERS:
        assert st[key] == j_res["stats"][key], key
    assert st["retired"] + st["failed"] == len(reqs)
    for r in reqs:
        rid = r["rid"]
        assert res[rid] == j_res[rid], f"rid {rid} tokens"
        if rid in st["errors"]:
            assert len(res[rid]) < r["max_new_tokens"]          # partial
            continue
        assert res[rid] == clean[rid], f"rid {rid} drifted"
        np.testing.assert_array_equal(res["logits"][rid], clean["logits"][rid])
    if name not in ("alloc", "storm-mixed"):
        assert st["failed"] > 0
    want = {"swap-put-permanent": {"swap_put_failed"}, "logits": {"non_finite_logits"},
            "restore-fault": {"restore_failed"}, "step-limit": {"step_limit"},
            "admission-stall": {"admission_stall"}}.get(name)
    if want is not None:
        assert set(st["errors"].values()) == want
    if name == "admission-stall":
        assert res[0] == []                                      # never admitted


# ---------------------------------------------------------------------------
# offload economics on the card's constants
# ---------------------------------------------------------------------------

def test_offload_constants_are_the_h100s():
    assert t_off.HBM_BW == 3.35e12
    assert t_off.PCIE_BW == 64e9


def test_offload_model_matches_jax(monkeypatch):
    monkeypatch.setattr(j_off, "HBM_BW", t_off.HBM_BW)
    monkeypatch.setattr(j_off, "PCIE_BW", t_off.PCIE_BW)
    jcfg, tcfg = j_configs.get("qwen3_0_6b"), t_get("qwen3_0_6b")
    for seq in (4096, 32768, 524288, 2 ** 21):
        assert t_off.offload_step_model(tcfg, seq) == j_off.offload_step_model(jcfg, seq)
    m = t_off.offload_step_model(tcfg, 32768)
    # the Kg cache stays under 1% of the KV cache at b=64 (paper, section 3.2)
    assert m["kg_over_kv"] < 0.01
    assert m["t_sparse_hbm_s"] < m["t_dense_hbm_s"] / 4
    # over PCIe Gen5 x16 against 3.35 TB/s, offload beats dense HBM only
    # past 1 - 64e9/3.35e12 ~ 98.1% sparsity: not at 32k with a 4k budget
    assert not m["offload_beats_dense"]
    assert t_off.offload_step_model(tcfg, 2 ** 21)["offload_beats_dense"]


def test_offloaded_kv_fetch_matches_jax():
    rng = np.random.default_rng(0)
    b, s, hkv, dh, bs = 2, 256, 2, 16, 16
    k = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dh)).astype(np.float32)
    kg = np.zeros((b, hkv, s // bs, 8), np.float32)
    idx = rng.integers(-1, s // bs, size=(b, hkv, 3)).astype(np.int32)
    t_store = t_off.OffloadedKV(torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(kg), bs)
    j_store = j_off.OffloadedKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kg), bs)
    tk, tv, t2 = t_store.fetch(torch.from_numpy(idx))
    jk, jv, j2 = j_store.fetch(jnp.asarray(idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert t2.fetched_blocks == j2.fetched_blocks == 3
