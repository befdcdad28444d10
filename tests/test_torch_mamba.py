"""The port's Mamba blocks (``repro_torch.models.mamba``) against the live
JAX reference, in float32 on the CPU.

Both blocks at ``reduced()`` widths (d_model 64, d_inner 128, state 8,
chunk 16; Mamba2 with 2 heads of 64), weights from the reference's
``init_lm`` converted by ``convert.params_from_numpy``, inputs from numpy
seeds:

- ``mamba1_full`` / ``mamba2_full`` outputs and final ``(conv, h)``
  states, at a length that is a multiple of the chunk, one that is not,
  a length shorter than one chunk, and a right-padded ``lengths`` batch;
- ``mamba1_step`` / ``mamba2_step`` from random states;
- the port's own full-sequence vs token-by-token consistency (the
  reference's ``tests/test_models.py::test_mamba_full_vs_step_parity``).

The port scans each Mamba1 chunk by log-depth doubling where the
reference calls ``jax.lax.associative_scan``, and contracts Mamba2's
chunk terms in another order, so the results agree within fp32
rounding, not bitwise: RTOL / ATOL below, about 1e-5 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as j_configs
from repro.config import reduced as j_reduced
from repro.models import mamba as j_mamba
from repro.models.registry import get_api
from repro_torch import configs as t_configs
from repro_torch.config import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba as t_mamba

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-5          # fp32, the two scans' rounding
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4   # full vs step (the reference's own test)
ARCHS = {"falcon_mamba_7b": 1, "zamba2_1_2b": 2}


@functools.lru_cache(maxsize=None)
def _block(arch):
    """(reference cfg, reference layer-0 mixer params, port cfg, port
    mixer params): the reference's init_lm, converted as a whole tree."""
    jcfg = j_reduced(j_configs.get(arch)).replace(dtype="float32")
    tcfg = t_reduced(t_configs.get(arch)).replace(dtype="float32")
    params = jax.device_get(get_api(jcfg).init_params(jax.random.PRNGKey(3), jcfg))
    tp = params_from_numpy(params, tcfg, "cpu")
    if jcfg.family == "hybrid":
        jp = jax.tree.map(lambda a: a[0, 0], params["units"]["mixer"])
        return jcfg, jp, tcfg, tp["units"][0][0]["mixer"]
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["mixer"])
    return jcfg, jp, tcfg, tp["blocks"][0]["mixer"]


def _fns(version):
    if version == 1:
        return (j_mamba.mamba1_full, j_mamba.mamba1_step,
                t_mamba.mamba1_full, t_mamba.mamba1_step)
    return (j_mamba.mamba2_full, j_mamba.mamba2_step,
            t_mamba.mamba2_full, t_mamba.mamba2_step)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _state_dims(cfg):
    """(conv width, hidden-state shape) of one layer's recurrent state."""
    if cfg.ssm.version == 1:
        di = cfg.ssm.expand * cfg.d_model
        return di, (di, cfg.ssm.state_dim)
    di, hd, nh, n = t_mamba._m2_dims(cfg)
    return di + 2 * n, (nh, hd, n)


@pytest.mark.parametrize("length,lengths", [(32, None), (37, None), (9, None),
                                            (40, (40, 23, 5))],
                         ids=["two-chunks", "ragged-tail", "under-a-chunk", "lengths"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_matches_reference(arch, length, lengths):
    """y everywhere (at the real positions of a ``lengths`` batch) and the
    final conv window and hidden state, which the pads must not touch."""
    jcfg, jp, tcfg, tp = _block(arch)
    j_full, _, t_full, _ = _fns(ARCHS[arch])
    b = 3 if lengths else 2
    x = np.random.default_rng(length).standard_normal(
        (b, length, tcfg.d_model)).astype(np.float32) * 0.5
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    jy, (jconv, jh) = j_full(jp, jnp.asarray(x), jcfg, lengths=jl)
    ty, (tconv, th) = t_full(tp, torch.tensor(x), tcfg, lengths=tl)
    valid = (np.ones((b, length), bool) if lengths is None
             else np.arange(length)[None, :] < np.asarray(lengths)[:, None])
    _close(ty[torch.tensor(valid)], np.asarray(jy)[valid], what="y")
    _close(tconv, jconv, what="conv window")
    _close(th, jh, what="h")
    assert th.dtype == torch.float32 and tuple(th.shape) == jh.shape
    if lengths is not None:
        # the pads are an exact identity: a row's states equal its unpadded run's
        i = 2
        y1, (c1, h1) = t_full(tp, torch.tensor(x[i:i + 1, :lengths[i]]), tcfg)
        np.testing.assert_array_equal(tconv[i].numpy(), c1[0].numpy())
        _close(th[i], h1[0].numpy(), what="padded row's h")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_step_matches_reference(arch):
    """One token from random conv windows and hidden states, three times
    in a row; the inputs are left unwritten."""
    jcfg, jp, tcfg, tp = _block(arch)
    _, j_step, _, t_step = _fns(ARCHS[arch])
    rng = np.random.default_rng(7)
    width, hshape = _state_dims(tcfg)
    conv = rng.standard_normal((2, tcfg.ssm.conv_dim - 1, width)).astype(np.float32)
    h = rng.standard_normal((2,) + hshape).astype(np.float32)
    jc, jh = jnp.asarray(conv), jnp.asarray(h)
    tc, th = torch.tensor(conv), torch.tensor(h)
    for t in range(3):
        x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jy, (jc, jh) = j_step(jp, jnp.asarray(x1), jcfg, jc, jh)
        tc_in, th_in = tc.clone(), th.clone()
        ty, (tc2, th2) = t_step(tp, torch.tensor(x1), tcfg, tc, th)
        assert torch.equal(tc, tc_in) and torch.equal(th, th_in)      # not written
        tc, th = tc2, th2
        _close(ty, jy, what=f"y step {t}")
        _close(tc, jc, what=f"conv step {t}")
        _close(th, jh, what=f"h step {t}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_vs_step_consistency(arch):
    """The port's chunked full-sequence scan equals its own token-by-token
    recurrence (2 x 32 tokens, two chunks), with the reference's own
    tolerance for this check; the final states too."""
    _, _, tcfg, tp = _block(arch)
    _, _, t_full, t_step = _fns(ARCHS[arch])
    x = torch.tensor(np.random.default_rng(11).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32) * 0.5)
    y_full, (c_full, h_full) = t_full(tp, x, tcfg)
    width, hshape = _state_dims(tcfg)
    conv = torch.zeros((2, tcfg.ssm.conv_dim - 1, width))
    h = torch.zeros((2,) + hshape)
    ys = []
    for t in range(32):
        y1, (conv, h) = t_step(tp, x[:, t:t + 1], tcfg, conv, h)
        ys.append(y1[:, 0])
    _close(torch.stack(ys, dim=1), y_full.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL,
           what=f"{arch} full vs step")
    _close(conv, c_full.numpy(), what="conv window")
    _close(h, h_full.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL, what="h")


def test_scan_chunk_is_the_sequential_recurrence():
    """The log-depth doubling of one chunk against the plain loop
    h_t = a_t h_{t-1} + b_t (and the running product of a), at a chunk
    length that is not a power of two."""
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.uniform(0.2, 1.0, (2, 13, 3, 4)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((2, 13, 3, 4)).astype(np.float32))
    aa, bb = t_mamba._scan_chunk(a.clone(), b.clone())
    h, p = torch.zeros_like(a[:, 0]), torch.ones_like(a[:, 0])
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        p = p * a[:, t]
        np.testing.assert_allclose(bb[:, t].numpy(), h.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(aa[:, t].numpy(), p.numpy(), rtol=1e-6, atol=1e-6)
