"""End-to-end parity of the PyTorch port against the live JAX reference.

The ``ct_budget`` / ``ct_threshold`` rollouts of
``tests/capture_golden_policy.py`` (tiny qwen3 config in float32, a 2 x 41
prompt, 12 greedy decode steps, MAX_LEN 64) run through the JAX
``DecodeEngine`` and through ``repro_torch``'s ``DecodeEngine(device=
"cpu")`` on the same parameters (JAX ``init_params`` -> numpy ->
``repro_torch.convert``) and the same numpy-seeded prompt. Greedy tokens
must be equal, logits within 1e-4 (measured max abs difference on a CPU
run: 5.8e-7 for both methods), and the measured sparsity within 1e-6
(measured: equal).

Also the port's guards: no file of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports jax or the reference package, no library
attention kernel or ``torch.compile`` in the port, the engine refuses to
start without a card unless the CPU is named, and the CPU path never
launches a CUDA kernel.
"""
import ast
import os

import jax
import numpy as np
import pytest
import torch

import capture_golden_policy as G
from repro.core.policy import default_options as j_default_options
from repro.models.registry import get_api
from repro.serve.engine import DecodeEngine as JaxEngine
from repro_torch.config import reduced as t_reduced
from repro_torch.configs import get as t_get
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import default_options as t_default_options
from repro_torch.kernels import ops as t_ops
from repro_torch.serve.engine import DecodeEngine

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def torch_tiny_cfg(method):
    """The port's twin of ``capture_golden_policy.tiny_cfg``."""
    import dataclasses
    cfg = t_reduced(t_get("qwen3_0_6b")).replace(dtype="float32")
    return cfg.replace(gate=dataclasses.replace(
        cfg.gate, block_size=8, d_gate=16, token_budget=32, method=method,
        threshold=2e-2))


def _rollout_jax(cfg, params, toks, **options):
    opts = j_default_options(cfg).replace(**options)
    eng = JaxEngine(cfg, params, max_len=G.MAX_LEN, options=opts)
    tok, st = eng.prefill({"tokens": jax.numpy.asarray(toks)})
    lgs, tks, rhos = [], [], []
    for _ in range(G.N_STEPS):
        tok, lg, st, aux = eng._step(params, st, tok)
        lgs.append(np.asarray(lg, np.float32))
        tks.append(np.asarray(tok, np.int32))
        rhos.append(float(aux["sparsity"]))
    return np.stack(lgs), np.stack(tks), np.asarray(rhos)


def _rollout_torch(cfg, params, toks, **options):
    opts = t_default_options(cfg).replace(**options)
    eng = DecodeEngine(cfg, params, max_len=G.MAX_LEN, options=opts, device="cpu")
    tok, st = eng.prefill({"tokens": toks})
    lgs, tks, rhos = [], [], []
    for _ in range(G.N_STEPS):
        tok, lg, st, aux = eng._step(params, st, tok)
        lgs.append(lg.numpy())
        tks.append(tok.numpy())
        rhos.append(float(aux["sparsity"]))
    return np.stack(lgs), np.stack(tks), np.asarray(rhos)


@pytest.mark.parametrize("method,options", [
    ("budget", {}), ("threshold", {}),
    # 20 tokens at block 8 rounds UP to 3 blocks (the config's 32 is 4)
    ("budget", {"budget_override": 20}), ("threshold", {"budget_override": 20}),
    # telemetry off: the same tokens and logits, sparsity reported as 0
    ("budget", {"measure_sparsity": False})],
    ids=["budget", "threshold", "budget-override20", "threshold-override20",
         "budget-no-telemetry"])
def test_ct_rollout_matches_jax(method, options):
    jcfg = G.tiny_cfg(method)
    tcfg = torch_tiny_cfg(method)
    params = get_api(jcfg).init_params(jax.random.PRNGKey(G.PARAM_SEED), jcfg)
    toks = np.random.default_rng(G.PROMPT_SEED).integers(
        0, jcfg.vocab_size, G.PROMPT_SHAPE).astype(np.int32)
    j_lg, j_tk, j_rho = _rollout_jax(jcfg, params, toks, **options)
    t_params = params_from_numpy(jax.device_get(params), tcfg, "cpu")
    t_ops.reset_launch_counts()                      # CPU tensors: the plain path
    t_lg, t_tk, t_rho = _rollout_torch(tcfg, t_params, toks, **options)
    np.testing.assert_array_equal(t_tk, j_tk)
    np.testing.assert_allclose(t_lg, j_lg, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_rho, j_rho, atol=1e-6, rtol=0)
    assert t_ops.launch_counts() == dict.fromkeys(t_ops.KERNELS, 0)


@pytest.mark.parametrize("override", [None, 1, 7, 8, 9, 20, 32, 33, 4096])
def test_decode_options_max_selected_matches_jax(override):
    """The override in tokens -> selected-list width in blocks, rounded up."""
    jcfg, tcfg = G.tiny_cfg("budget"), torch_tiny_cfg("budget")
    j = j_default_options(jcfg).replace(budget_override=override)
    t = t_default_options(tcfg).replace(budget_override=override)
    assert t.max_selected(tcfg) == j.max_selected(jcfg)


@pytest.mark.parametrize("override", [0, -8])
def test_decode_options_rejects_nonpositive_budget(override):
    with pytest.raises(ValueError, match="budget_override"):
        t_default_options(torch_tiny_cfg("budget")).replace(budget_override=override)


def test_engine_generate_matches_step_loop():
    """generate() is prefill + (n-1) steps; sparsity_stats reads the last."""
    cfg = torch_tiny_cfg("budget")
    from repro_torch.models.transformer import init_lm
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
    eng = DecodeEngine(cfg, params, max_len=G.MAX_LEN, device="cpu")
    assert not eng.sparsity_stats()["measured"]
    res = eng.generate({"tokens": toks}, 6)
    tok, st = eng.prefill({"tokens": toks})
    loop = [tok]
    for _ in range(5):
        tok, _, st, _ = eng._step(params, st, tok)
        loop.append(tok)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  torch.stack(loop, 1).numpy())
    assert res["tokens"].shape == (2, 6)
    assert res["final_len"].tolist() == [53, 53]
    stats = eng.sparsity_stats()
    assert stats["measured"] and 0.0 < stats["sparsity"] < 1.0


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _port_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = list(_port_files()) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 15
    names = {os.path.relpath(f, PORT) for f in files}
    assert {"models/mamba.py", "models/ssm_lm.py", "models/hybrid.py",
            "serve/slotstate.py", "models/common.py", "models/moe.py",
            "models/transformer.py", "models/registry.py", "configs/hubert_xlarge.py",
            "configs/__init__.py", "data/pipeline.py", "optim/adamw.py",
            "train/loop.py", "convert.py", "checkpoint/manager.py", "launch/train.py",
            "serve/engine.py", "launch/serve.py", "examples/quickstart.py",
            "examples/serve_sparse.py", "examples/serve_stream.py",
            "examples/distill_and_eval.py", "distributed/sharding.py",
            "models/attn_core.py", "launch/mesh.py", "launch/specs.py",
            "launch/dryrun.py"} <= names
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{os.path.relpath(f, ROOT)}: {mod}")
    assert not bad, bad


def test_port_uses_no_library_kernels():
    for f in _port_files():
        src = open(f).read()
        for word in ("scaled_dot_product_attention", "torch.compile",
                     "flash_attn", "xformers"):
            assert word not in src, f"{os.path.relpath(f, ROOT)} uses {word}"


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_tiny_cfg("budget")
    from repro_torch.models.transformer import init_lm
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cfg, params, max_len=G.MAX_LEN)
    DecodeEngine(cfg, params, max_len=G.MAX_LEN, device="cpu")    # named: fine


@pytest.mark.parametrize("entry", ["params_from_numpy", "init_decode_state",
                                   "init_pages"])
def test_loaders_without_device_raise_when_no_cuda(monkeypatch, entry):
    """The weight loader and the state and page-pool allocators default to
    CUDA too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.paging import init_pages
    jcfg, tcfg = G.tiny_cfg("budget"), torch_tiny_cfg("budget")
    if entry == "params_from_numpy":
        tree = jax.device_get(get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg))
        call = lambda **kw: params_from_numpy(tree, tcfg, **kw)   # noqa: E731
    elif entry == "init_pages":
        call = lambda **kw: init_pages(tcfg, 9, tcfg.num_layers, **kw)  # noqa: E731
    else:
        call = lambda **kw: init_decode_state(tcfg, 2, G.MAX_LEN, **kw)  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")                                      # named: fine
    leaf = (out["embed"]["w"] if entry == "params_from_numpy"
            else out.k_pages if entry == "init_pages" else out.k_cache)
    assert leaf.device.type == "cpu"
