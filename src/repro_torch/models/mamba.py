"""Mamba blocks, PyTorch: v1 (selective scan, falcon-mamba-7b) and v2 (the
SSD chunked form, zamba2).

Port of the JAX package's ``models/mamba.py``. Attention-free: the
SeerAttention-R gate has no KV cache to select from here. The reference
computes these in jnp, not in Pallas, so they are plain PyTorch on either
device. Both sequence paths walk the sequence in chunks with the state
carried between them, and both have a one-token recurrent step with O(1)
state. Differences of idiom, not of result:

  * Mamba1 forms its discretised decay and input (``[B, chunk, di, n]``)
    per chunk inside the chunk loop, where the reference builds them for
    the whole sequence; the element arithmetic is the same. The chunk's
    scan is a log-depth (Hillis-Steele) doubling over the chunk in place
    of ``jax.lax.associative_scan``: log2(chunk) rounds of whole-chunk
    tensor ops, the same monoid, a different order of its products.
  * Mamba2's SSD chunk contracts the state update as (x * tail) against B
    over the chunk, and its inter-chunk term as (C . h) times exp(cum),
    so no ``[B, chunk, nh, hd, n]`` tensor is built.
  * So the results equal the reference's within fp32 rounding, not
    bitwise; the CPU tests state the tolerance.
  * Both sequence paths are differentiable (training): Mamba1's chunk
    scan switches to out-of-place doubling rounds where autograd records
    (``_scan_chunk``), Mamba2's SSD chunk is out of place throughout.
    The SSD chunk's causal decay mask is applied before its exp, not
    after: the same forward values, and a finite gradient where the
    reference's (``jnp.where`` after ``jnp.exp``) is NaN, i.e. wherever
    a masked decay overflows, which a reduced or full hybrid config
    reaches (tests/test_torch_train_recurrent.py).

A step never writes its input state: it returns new conv windows and new
hidden states, so a replayed step can re-run from the same input.

Under a ``Shard`` (``mamba1_full``/``mamba2_full``/``stack_train`` in
training and at a sharded engine's prefill, ``mamba1_step``/
``mamba2_step``/``stack_step`` at its decode) a mixer is tensor-parallel
over ``d_inner`` (Mamba1: channels; Mamba2: whole heads), with the
layout and the collectives of ``distributed.sharding``; the scans are
per channel or per head and run on the rank's alone, and so does the
state a step carries.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import (copy_to_model, part, reduce_from_model,
                                              sync_grad_parts)
from repro_torch.models.common import (_randn, init_linear, init_rmsnorm, linear,
                                       remat, rms_norm, torch_dtype)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Mamba1 (selective scan)
# ---------------------------------------------------------------------------

def _dt_rank(d_model: int) -> int:
    return -(-d_model // 16)


def init_mamba1(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random Mamba1 parameters on ``gen.device``; ``dt_bias``, ``A_log``
    (S4D-real: log(1..n) for every channel) and ``D`` stay float32 in any
    working dtype, as in the reference."""
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    dtr = _dt_rank(d)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    return {
        "in_proj": init_linear(gen, d, 2 * di, cfg.dtype),
        "conv_w": (_randn(gen, (cfg.ssm.conv_dim, di))
                   / math.sqrt(cfg.ssm.conv_dim)).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": init_linear(gen, di, dtr + 2 * n, cfg.dtype),
        "dt_proj": init_linear(gen, dtr, di, cfg.dtype),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
        .expand(di, n).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": init_linear(gen, di, d, cfg.dtype),
    }


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x [B, L, C]; w [K, C]: the sum of the K
    shifted products, in the reference's order."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:l] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + l] * w[i]
    return out + b


def _scan_chunk(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t over axis 1 from h = 0:
    (prod a, h) at every t. a, b [B, Q, ...] float32, consumed. Each
    doubling round combines every t with t - d, (a1, b1) then (a2, b2) ->
    (a1 a2, a2 b1 + b2), into the other buffer of a ping-pong pair; where
    autograd records (grad enabled and a or b requiring grad), into new
    tensors instead, with the same products in the same order."""
    q = a.shape[1]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        d = 1
        while d < q:
            a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                    torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                              dim=1))
            d *= 2
        return a, b
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    d = 1
    while d < q:
        a2[:, :d] = a[:, :d]
        b2[:, :d] = b[:, :d]
        torch.mul(a[:, d:], a[:, :-d], out=a2[:, d:])
        torch.addcmul(b[:, d:], a[:, d:], b[:, :-d], out=b2[:, d:])
        a, a2, b, b2 = a2, a, b2, b
        d *= 2
    return a, b


def _ssm_scan_chunked(dt: torch.Tensor, xc: torch.Tensor, b_in: torch.Tensor,
                      c_in: torch.Tensor, a_mat: torch.Tensor, h0: torch.Tensor,
                      chunk: int):
    """Selective scan h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t;
    y_t = sum_n C_t[n] h_t[:, n].

    dt, xc [B, L, di] float32; b_in, c_in [B, L, n] float32; a_mat [di, n]
    (= -exp(A_log)); h0 [B, di, n]. Returns y [B, L, di], h_final. Per
    chunk the decay and input [B, chunk, di, n] are formed, scanned and
    dropped. A non-multiple L is right-padded with dt = 0, the scan's
    identity (decay exp(0) = 1, input 0): exact on h_final; the padded y
    rows are sliced off."""
    bsz, l, di = dt.shape
    pad = (-l) % chunk
    if pad:
        dt, xc, b_in, c_in = (F.pad(t, (0, 0, 0, pad)) for t in (dt, xc, b_in, c_in))
    h = h0
    y = torch.empty((bsz, l + pad, di), dtype=torch.float32, device=dt.device)
    for s in range(0, l + pad, chunk):
        dt_c = dt[:, s:s + chunk]
        da = torch.exp(dt_c[..., None] * a_mat)                        # [B,Q,di,n]
        bx = (dt_c * xc[:, s:s + chunk])[..., None] * b_in[:, s:s + chunk, None, :]
        aa, bb = _scan_chunk(da, bx)
        del da, bx
        h_t = torch.addcmul(bb, aa, h[:, None])                        # aa * h + bb
        del aa, bb
        y[:, s:s + chunk] = torch.einsum("bldn,bln->bld", h_t, c_in[:, s:s + chunk])
        h = h_t[:, -1].clone()
        del h_t
    return y[:, :l], h


def _conv_tail(seq: torch.Tensor, k: int, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The K-1 rows ENDING at each row's true length: the decode-time conv
    window. With ``lengths`` the rows are gathered at ``lengths - (K-1) +
    i``, the positions left of the sequence ZERO (the causal conv's
    implicit left padding), so a bucketed right-padded prefill hands
    decode exactly the window an unpadded one would."""
    if lengths is None:
        return seq[:, -(k - 1):].clone()
    idx = (lengths.to(torch.int64)[:, None] - (k - 1)
           + torch.arange(k - 1, device=seq.device)[None, :])          # [B, K-1]
    tail = torch.gather(seq, 1, idx.clamp_min(0)[..., None].expand(-1, -1, seq.shape[-1]))
    return torch.where(idx[..., None] >= 0, tail, torch.zeros((), dtype=seq.dtype,
                                                               device=seq.device))


def _mask_dt(dt: torch.Tensor, lengths: Optional[torch.Tensor], l: int) -> torch.Tensor:
    """Zero dt at right-pad positions (bucketed prefill): the discretised
    decay becomes exp(0) = 1 and the input injection 0, so pad tokens are
    an EXACT identity on the recurrent state. dt [B, L, ...]."""
    if lengths is None:
        return dt
    valid = (torch.arange(l, device=dt.device)[None, :]
             < lengths.to(dt.device)[:, None])                          # [B, L]
    valid = valid.reshape(valid.shape + (1,) * (dt.ndim - 2))
    return torch.where(valid, dt, torch.zeros((), dtype=dt.dtype, device=dt.device))


def mamba1_full(p: Params, x: torch.Tensor, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None, shard=None):
    """x [B, L, d] -> (y [B, L, d], (conv_state [B, K-1, di], h [B, di, n]
    float32)).

    ``lengths`` [B] (optional): the true lengths of right-padded rows. Pad
    positions inject nothing into the scan and the conv state is gathered
    at the true tail, so the returned states resume decode as if the pads
    never existed; y at pad positions is garbage (callers read
    ``lengths - 1``). Under a training ``shard`` ``p`` holds the rank's
    channels (di / world of them, the states too): ``x_proj``'s partial
    sums are summed over ranks before the [dt | B | C] split, y after
    ``out_proj``."""
    bsz, l, d = x.shape
    shard = part(shard, cfg.ssm.expand * d)
    di = p["D"].shape[0]
    n = cfg.ssm.state_dim
    dtr = _dt_rank(d)
    xs, z = linear(p["in_proj"], copy_to_model(x, shard)).split(di, dim=-1)
    xc = F.silu(_causal_conv_full(xs, p["conv_w"], p["conv_b"]))
    dbc = linear(p["x_proj"], xc)
    if shard is not None:
        dbc = copy_to_model(reduce_from_model(dbc, shard), shard)
    dt_in, b_in, c_in = dbc.split([dtr, n, n], dim=-1)
    dt = F.softplus(linear(p["dt_proj"], dt_in).float() + p["dt_bias"])   # [B,L,di]
    dt = _mask_dt(dt, lengths, l)
    a_mat = -torch.exp(p["A_log"])                                         # [di, n]
    if h0 is None:
        h0 = torch.zeros((bsz, di, n), dtype=torch.float32, device=x.device)
    xcf = xc.float()
    y, h = _ssm_scan_chunked(dt, xcf, b_in.float(), c_in.float(), a_mat, h0,
                             min(cfg.ssm.chunk_size, l))
    del dt
    y = y + p["D"] * xcf
    y = (y * F.silu(z.float())).to(x.dtype)
    conv_state = _conv_tail(xs, cfg.ssm.conv_dim, lengths)
    return reduce_from_model(linear(p["out_proj"], y), shard), (conv_state, h)


def mamba1_step(p: Params, x1: torch.Tensor, cfg: ModelConfig,
                conv_state: torch.Tensor, h: torch.Tensor, shard=None):
    """x1 [B, 1, d]; conv_state [B, K-1, di]; h [B, di, n]. Returns (y
    [B, 1, d], (new conv_state, new h)); the inputs are not written.
    Under a serving ``shard`` (no autograd) ``p``, the mixer of the
    engine's per-rank tree (``distributed.sharding.decode_params``), and
    the states hold the rank's channels: ``x_proj``'s
    partial sums are summed over ranks before the [dt | B | C] split, y
    after ``out_proj``."""
    d = x1.shape[-1]
    shard = part(shard, cfg.ssm.expand * d)
    di = p["D"].shape[0]
    n = cfg.ssm.state_dim
    dtr = _dt_rank(d)
    xs, z = linear(p["in_proj"], x1)[:, 0].split(di, dim=-1)              # [B, di]
    window = torch.cat([conv_state, xs[:, None]], dim=1)                   # [B,K,di]
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"])
    dbc = linear(p["x_proj"], xc)
    if shard is not None:
        dbc = shard.all_sum(dbc)
    dt_in, b_in, c_in = dbc.split([dtr, n, n], dim=-1)
    dt = F.softplus((dt_in @ p["dt_proj"]["w"]).float() + p["dt_bias"])   # [B, di]
    a_mat = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a_mat)                                  # [B,di,n]
    bx = (dt * xc.float())[..., None] * b_in.float()[:, None, :]
    h_new = da * h + bx
    y = torch.einsum("bdn,bn->bd", h_new, c_in.float())
    y = y + p["D"] * xc.float()
    y = (y * F.silu(z.float())).to(x1.dtype)
    return _out(p, y, shard)[:, None], (window[:, 1:], h_new)


def _out(p: Params, y: torch.Tensor, shard) -> torch.Tensor:
    """A step's ``out_proj``, summed over the ranks of a serving ``shard``."""
    y = linear(p["out_proj"], y)
    return y if shard is None else shard.all_sum(y)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked matmul algorithm)
# ---------------------------------------------------------------------------

def _m2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, head dim 64, heads, state dim)."""
    di = cfg.ssm.expand * cfg.d_model
    hd = 64
    nh = cfg.ssm.n_ssm_heads or di // hd
    return di, hd, nh, cfg.ssm.state_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random Mamba2 parameters on ``gen.device``; ``in_proj`` emits [z
    (di), x (di), B (n), C (n), dt (nh)]; ``A_log``, ``dt_bias`` and ``D``
    stay float32, as in the reference."""
    d = cfg.d_model
    di, hd, nh, n = _m2_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    return {
        "in_proj": init_linear(gen, d, 2 * di + 2 * n + nh, cfg.dtype),
        "conv_w": (_randn(gen, (cfg.ssm.conv_dim, di + 2 * n))
                   / math.sqrt(cfg.ssm.conv_dim)).to(dt),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(di, cfg.dtype, dev),
        "out_proj": init_linear(gen, di, d, cfg.dtype),
    }


def _ssd_chunks(xh: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                loga: torch.Tensor, h0: torch.Tensor, chunk: int):
    """SSD chunked algorithm (matmul inner ops).

    xh [B, L, nh, hd] (dt-scaled inputs); bmat, cmat [B, L, n] (one group,
    shared across heads); loga [B, L, nh] (log decay dt * A, <= 0); h0
    [B, nh, hd, n]. Returns y [B, L, nh, hd], h_final. A non-multiple L
    is right-padded with the SSD identity (x = 0, B = 0, log decay 0):
    exact on h_final; the padded y rows are sliced off."""
    bsz, l, nh, hd = xh.shape
    pad = (-l) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bmat, cmat, loga = (F.pad(t, (0, 0, 0, pad)) for t in (bmat, cmat, loga))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    h = h0
    ys = []
    for s in range(0, l + pad, chunk):
        xc, bc, cc = xh[:, s:s + chunk], bmat[:, s:s + chunk], cmat[:, s:s + chunk]
        cum = torch.cumsum(loga[:, s:s + chunk], dim=1)                # [B,Q,nh]
        # intra-chunk: scores[t,s] = (C_t . B_s) * exp(cum_t - cum_s), t >= s
        cb = torch.einsum("btn,bsn->bts", cc, bc)                      # [B,Q,Q]
        decay = cum[:, :, None, :] - cum[:, None, :, :]                # [B,Q,Q,nh]
        # masked before the exp: the same values as the reference's
        # where(tri, exp(decay), 0), whose gradient is 0 * inf = NaN where
        # the masked decay (t < s, positive) overflows; this one's is 0
        lmask = torch.exp(torch.where(tri[None, :, :, None], decay, -math.inf))
        y = torch.einsum("btsh,bshd->bthd", cb[..., None] * lmask, xc)
        del decay, lmask
        # inter-chunk: y_t += exp(cum_t) * (C_t . h_prev)
        y = y + torch.einsum("btn,bhdn->bthd", cc, h) * torch.exp(cum)[..., None]
        # state: h' = exp(cum_Q) h + sum_s exp(cum_Q - cum_s) x_s B_s
        tail = torch.exp(cum[:, -1:, :] - cum)                         # [B,Q,nh]
        dstate = torch.einsum("bshd,bsn->bhdn", xc * tail[..., None], bc)
        h = torch.exp(cum[:, -1])[..., None, None] * h + dstate
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :l], h


def mamba2_full(p: Params, x: torch.Tensor, cfg: ModelConfig,
                h0: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None, shard=None):
    """x [B, L, d] -> (y [B, L, d], (conv_state [B, K-1, di + 2n] of the raw
    pre-conv inputs, h [B, nh, hd, n] float32)). ``lengths``: the
    bucketed-prefill contract of ``mamba1_full`` (loga = 0 adds nothing to
    the chunk's cumsum, the dt-scaled input is 0). Under a training
    ``shard`` ``p`` holds the rank's heads (nh / world; di, the states and
    the conv channels of x with them) and all of B and C, whose
    ``in_proj`` columns and conv channels sum their gradients over ranks;
    the gated norm's mean square is over all ranks, y summed after
    ``out_proj``."""
    bsz, l, d = x.shape
    _, hd, nh, n = _m2_dims(cfg)
    shard = part(shard, nh)
    nh = p["D"].shape[0]
    di = nh * hd
    w_in, conv_w, conv_b = p["in_proj"]["w"], p["conv_w"], p["conv_b"]
    if shard is not None:
        w_in = sync_grad_parts(w_in, shard, 1, [(2 * di, 2 * n)])
        conv_w = sync_grad_parts(conv_w, shard, 1, [(di, 2 * n)])
        conv_b = sync_grad_parts(conv_b, shard, 0, [(di, 2 * n)])
    zxbcdt = linear({"w": w_in}, copy_to_model(x, shard))
    z, xs, bc, dt_in = zxbcdt.split([di, di, 2 * n, nh], dim=-1)
    raw_xbc = zxbcdt[..., di:2 * di + 2 * n]
    xbc = F.silu(_causal_conv_full(raw_xbc, conv_w, conv_b))
    xs, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])                          # [B,L,nh]
    dt = _mask_dt(dt, lengths, l)
    loga = dt * -torch.exp(p["A_log"])                                     # [B,L,nh]
    xsf = xs.reshape(bsz, l, nh, hd).float()
    if h0 is None:
        h0 = torch.zeros((bsz, nh, hd, n), dtype=torch.float32, device=x.device)
    y, h = _ssd_chunks(xsf * dt[..., None], bmat.float(), cmat.float(), loga, h0,
                       min(cfg.ssm.chunk_size, l))
    y = (y + p["D"][:, None] * xsf).reshape(bsz, l, di)
    y = y * F.silu(z.float())
    y = rms_norm(p["norm"], y.to(x.dtype), cfg.norm_eps, shard)
    conv_state = _conv_tail(raw_xbc, cfg.ssm.conv_dim, lengths)
    return reduce_from_model(linear(p["out_proj"], y), shard), (conv_state, h)


def mamba2_step(p: Params, x1: torch.Tensor, cfg: ModelConfig,
                conv_state: torch.Tensor, h: torch.Tensor, shard=None):
    """x1 [B, 1, d]; conv_state [B, K-1, di + 2n]; h [B, nh, hd, n].
    Returns (y [B, 1, d], (new conv_state, new h)); the inputs are not
    written. Under a serving ``shard`` (no autograd) ``p`` and the states
    hold the rank's heads (di, x's conv channels with them) and all of B
    and C: the gated norm's mean square is over all ranks, y summed after
    ``out_proj``."""
    bsz = x1.shape[0]
    _, hd, nh, n = _m2_dims(cfg)
    shard = part(shard, nh)
    nh = p["D"].shape[0]
    di = nh * hd
    zxbcdt = linear(p["in_proj"], x1)[:, 0]
    z, dt_in = zxbcdt[:, :di], zxbcdt[:, 2 * di + 2 * n:]
    raw = zxbcdt[:, di:2 * di + 2 * n]                                     # [B, di+2n]
    window = torch.cat([conv_state, raw[:, None]], dim=1)
    xbc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"])
    xs, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt_in.float() + p["dt_bias"])                          # [B,nh]
    da = torch.exp(dt * -torch.exp(p["A_log"]))                            # [B,nh]
    xsf = xs.reshape(bsz, nh, hd).float()
    h_new = da[..., None, None] * h + \
        torch.einsum("bhd,bn->bhdn", xsf * dt[..., None], bmat.float())
    y = torch.einsum("bhdn,bn->bhd", h_new, cmat.float())
    y = (y + p["D"][:, None] * xsf).reshape(bsz, di)
    y = y * F.silu(z.float())
    y = rms_norm(p["norm"], y.to(x1.dtype), cfg.norm_eps, shard)
    return _out(p, y, shard)[:, None], (window[:, 1:], h_new)


# ---------------------------------------------------------------------------
# layer stacks (the recurrent families' Python loops in place of lax.scan)
# ---------------------------------------------------------------------------

def stack_full(blocks, x: torch.Tensor, cfg: ModelConfig, full_fn,
               lengths: Optional[torch.Tensor] = None, shard=None):
    """Pre-norm residual Mamba layers over a sequence: each block's
    ``{"ln", "mixer"}`` through ``full_fn`` (``mamba1_full`` or
    ``mamba2_full``; each mixer over the rank's channels or heads under a
    serving ``shard``). Returns (x, [conv_state], [h]), one a layer."""
    convs, hs = [], []
    for bp in blocks:
        y, (conv, h) = full_fn(bp["mixer"], rms_norm(bp["ln"], x, cfg.norm_eps), cfg,
                               lengths=lengths, shard=shard)
        x = x + y
        convs.append(conv)
        hs.append(h)
    return x, convs, hs


def stack_train(blocks, x: torch.Tensor, cfg: ModelConfig, full_fn,
                shard=None) -> torch.Tensor:
    """The training forward of the same layers: x + full_fn(ln(x)) for
    each block, under the config's ``remat`` (``common.remat``: a
    checkpoint a layer, where autograd records), no states kept; each
    mixer tensor-parallel under a ``shard``."""
    def layer(bp, x):
        return x + full_fn(bp["mixer"], rms_norm(bp["ln"], x, cfg.norm_eps), cfg,
                           shard=shard)[0]
    layer = remat(layer, cfg)
    for bp in blocks:
        x = layer(bp, x)
    return x


def stack_step(blocks, x1: torch.Tensor, cfg: ModelConfig, step_fn, conv, h,
               shard=None):
    """The same layers for one token: block i steps from ``conv[i]`` and
    ``h[i]`` (slot or batch axis first), under a serving ``shard`` over the
    rank's channels or heads. Returns (x1, [new conv], [new h])."""
    convs, hs = [], []
    for i, bp in enumerate(blocks):
        y, (c2, h2) = step_fn(bp["mixer"], rms_norm(bp["ln"], x1, cfg.norm_eps), cfg,
                              conv[i], h[i], shard)
        x1 = x1 + y
        convs.append(c2)
        hs.append(h2)
    return x1, convs, hs
