"""Mixture-of-Experts FFN (DeepSeekMoE / Kimi-K2 style), PyTorch port.

Port of the JAX package's ``models/moe.py`` scatter path: shared plus
routed fine-grained experts, top-k softmax routing, sort/scatter
dispatch (not the GShard [T, E, C] one-hot einsum):

  1. fp32 router logits -> softmax -> top-k expert ids per token (lower
     index first on ties, as ``jax.lax.top_k``), weights renormalised by
     ``max(sum, 1e-9)``; flatten to N = T * k assignments;
  2. each assignment's rank within its expert from a STABLE sort over the
     flattened [T, k] order;
  3. scatter into an [E, C + 1, d] buffer, C = max(1, ceil(N / E *
     capacity_factor)) for each call: an assignment at rank >= C goes to
     the trash row C and contributes zero;
  4. the batched per-expert GLU over [E, C, d] (three einsums over all E
     experts);
  5. gather back by (expert, slot), weight by the router, sum over k, add
     the shared experts.

The routed experts couple the rows of one call through their capacity:
at decode the rows are the batch (or the serving slots, active or not),
so a row's output depends on which other rows picked the same experts,
as in the reference. The aux load-balance loss is the Switch
``E * sum_e f_e * P_e * router_aux_coef``.

Training differentiates through the router (the renormalised top-k
weights and the aux loss's probabilities) and the experts, as
``jax.grad`` of the reference does; the capacity drops and the tie order
are the same with or without autograd.

The experts run as plain batched matmuls: the reference computes them
outside any Pallas kernel, so there is no TPU kernel here to port.

Training under a ``Shard`` is expert-parallel (``moe_mlp(shard=)``, the
reference's decode-size ``moe_mlp_sharded`` scheme): the rows and the
router are replicated, so every rank routes, counts the capacity and
drops exactly as the unsharded call does; a rank holds ``E / world``
experts and computes only the rows assigned to them, the shared experts
split their hidden units, and one sum over ranks combines.

Decode under a sharded engine's ``Shard`` is expert-parallel too
(``moe_mlp(..., gather=True)``, which the engine's decode and prefill
bodies pick): the rank holds and computes its ``E / world`` experts
only, but the combine is an exact gather of every rank's expert outputs
(``Shard.all_gather`` on the expert axis, ``[E, C, d]``) followed by the
unsharded weighting and sum over top-k; the shared experts split their
hidden units with one sum, as in training. The routed part is so bitwise
the unsharded call's wherever the per-expert matmuls are, and the shared
experts' sum reorders fp32 additions at more than one rank. The gather
carries ``E * C * d`` elements a call, about ``capacity_factor * T *
top_k * d``.

Rows split over a data axis (``moe_mlp(..., data=)``: training's
replicas, or ``generate``'s rows over data) keep the GLOBAL routing of
the reference's one call over every row (``dispatch="gspmd"``): the
router's top-k ids are gathered over the data group (small ints), the
capacity and each assignment's rank within its expert are computed on
the global rows, and each replica then computes its own rows only, so
the drops are the single-device call's. The router loss's token
fractions count the global assignments and its probability mass is the
replicas' (equal-sized) means averaged. Each replica's buffer keeps the
global capacity's slots, about D times the rows it fills (the
reference's GSPMD buffer splits its capacity over data instead).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.core.sparsity import ranked_top_k
from repro_torch.distributed.sharding import copy_to_model, part, reduce_from_model
from repro_torch.models.common import _randn, glu_mlp, init_glu_mlp, torch_dtype

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, d_model: int, mcfg: MoEConfig,
             activation: str = "swiglu", dtype="bfloat16") -> Params:
    """Random MoE parameters drawn from ``gen`` on its device; the router
    stays fp32 whatever ``dtype`` is."""
    del activation
    e, f = mcfg.n_experts, mcfg.expert_d_ff
    dt = torch_dtype(dtype)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(f)
    # scaled in place: one fp32 draw at a time (a kimi_k2 layer's experts
    # are 5.6 G values each)
    p: Params = {
        "router": {"w": _randn(gen, (d_model, e)).mul_(s_in)},
        "wi_gate": _randn(gen, (e, d_model, f)).mul_(s_in).to(dt),
        "wi_up": _randn(gen, (e, d_model, f)).mul_(s_in).to(dt),
        "wo": _randn(gen, (e, f, d_model)).mul_(s_out).to(dt),
    }
    if mcfg.n_shared_experts:
        p["shared"] = init_glu_mlp(gen, d_model, mcfg.n_shared_experts * f, dtype)
    return p


def route(x: torch.Tensor, router_w: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, d] -> (probs [T, E] f32, top ids [T, k] int64, renormalised
    top weights [T, k] f32)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    top_p, top_i = ranked_top_k(probs, k)
    top_w = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return probs, top_i, top_w


def capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    """Slots per expert for one call of ``n_tokens`` rows."""
    n = n_tokens * mcfg.top_k
    return max(1, int(math.ceil(n / mcfg.n_experts * mcfg.capacity_factor)))


def _expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert [E] int64 (a scatter-add: no host sync, which
    ``torch.bincount`` makes on a CUDA tensor)."""
    return torch.zeros(n_experts, dtype=torch.int64, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def _rank_within_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """flat_e [N] expert ids -> [N] occurrence rank of each id (0-based),
    in the flattened order (a stable sort)."""
    n = flat_e.shape[0]
    sort_idx = torch.argsort(flat_e, stable=True)
    counts = _expert_counts(flat_e, n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=flat_e.device) - offsets[flat_e[sort_idx]]
    return torch.empty_like(rank_sorted).scatter_(0, sort_idx, rank_sorted)


def dispatch(top_i: torch.Tensor, mcfg: MoEConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """top ids [T, k] -> (flat expert ids [N], slots [N] (the trash row
    ``cap`` for a dropped assignment), keep mask [N], cap)."""
    cap = capacity(top_i.shape[0], mcfg)
    flat_e = top_i.reshape(-1)
    rank = _rank_within_expert(flat_e, mcfg.n_experts)
    keep = rank < cap
    slot = torch.where(keep, rank, cap)
    return flat_e, slot, keep, cap


def expert_glu(p: Params, xb: torch.Tensor, activation: str) -> torch.Tensor:
    """The batched per-expert GLU: [E, C, d] -> [E, C, d]."""
    g = torch.einsum("ecd,edf->ecf", xb, p["wi_gate"])
    u = torch.einsum("ecd,edf->ecf", xb, p["wi_up"])
    act = F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", act * u, p["wo"])


def _expert_rows(p: Params, x: torch.Tensor, local_e: torch.Tensor, slot: torch.Tensor,
                 cap: int, k: int, activation: str) -> torch.Tensor:
    """The experts ``p`` holds over their assigned rows: x [T, d], each of
    its T * k assignments at (``local_e``, ``slot``) -> [E_p, cap, d]. The
    kept (expert, slot) pairs are distinct; the trash row ``cap`` takes
    the dropped ones (and another rank's) in any order and is never read
    back."""
    buf = torch.zeros((p["wi_gate"].shape[0], cap + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    buf[local_e, slot] = x.repeat_interleave(k, dim=0)
    return expert_glu(p, buf[:, :cap], activation)


def _local_experts(flat_e: torch.Tensor, shard, e_loc: int):
    """(expert ids within rank ``shard.rank``'s block [e0, e0 + e_loc),
    clamped; which assignments are its own)."""
    local_e = flat_e - shard.rank * e_loc
    mine = (local_e >= 0) & (local_e < e_loc)
    return local_e.clamp(0, e_loc - 1), mine


def moe_mlp(p: Params, x: torch.Tensor, mcfg: MoEConfig,
            activation: str = "swiglu", shard=None,
            gather: bool = False, data=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] tokens -> (y [T, d] in x's dtype, aux loss f32 scalar).
    Under a training ``shard`` the routed experts are this rank's block
    ``p["wi_gate"]`` [E / world, ...] (expert parallelism where the world
    size divides E) and the shared experts a block of their hidden units;
    y is the sum over ranks. With ``gather`` (decode, no autograd) the
    routed experts are the rank's block as well, gathered exactly into
    the unsharded [E, cap, d] outputs, whose weighting and sum over top-k
    are the unsharded call's; the shared experts split as in training.
    Over a ``data`` shard x is the replica's rows (the same count on every
    replica, in global row order by data rank) and the routing is the
    global rows' (the module docstring)."""
    t, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    probs, top_i, top_w = route(x, p["router"]["w"], k)
    if data is None:
        flat_e, slot, keep, cap = dispatch(top_i, mcfg)
        all_e = flat_e
    else:
        all_e, slot, keep, cap = dispatch(data.all_gather(top_i, 0), mcfg)
        mine = slice(data.rank * t * k, (data.rank + 1) * t * k)
        flat_e, slot, keep = all_e[mine], slot[mine], keep[mine]
    ep = part(shard, e)
    sp = part(shard, mcfg.n_shared_experts * mcfg.expert_d_ff) if "shared" in p else None
    e_loc = p["wi_gate"].shape[0]
    if gather:
        if ep is None:
            yb = _expert_rows(p, x, flat_e, slot, cap, k, activation)
        else:
            local_e, mine = _local_experts(flat_e, ep, e_loc)
            yb = ep.all_gather(_expert_rows(p, x, local_e, torch.where(mine, slot, cap),
                                            cap, k, activation), 0)
        local_e, ep, xe = flat_e, None, x
    else:
        xe = copy_to_model(x, shard) if (ep or sp) else x
        if ep is not None:
            # this rank's experts; another rank's assignment goes to the
            # trash row with weight 0
            local_e, mine = _local_experts(flat_e, ep, e_loc)
            slot = torch.where(mine, slot, cap)
            keep = keep & mine
            top_w = copy_to_model(top_w, ep)
        else:
            local_e = flat_e
        yb = _expert_rows(p, xe if ep is not None else x, local_e, slot, cap, k, activation)
    # a dropped assignment's weight is 0: the reference zeroes its row,
    # then weights it (the buffers are freed as soon as they are read, the
    # prefill's hold T * k rows of d)
    w = torch.where(keep, top_w.reshape(-1).to(yb.dtype), 0)
    y_rep = yb[local_e, torch.clamp_max(slot, cap - 1)]
    del yb
    # in place unless autograd records the product (its backward reads
    # y_rep for the router weights' gradient)
    y_rep = y_rep * w[:, None] if torch.is_grad_enabled() else y_rep.mul_(w[:, None])
    y = y_rep.reshape(t, k, d).sum(dim=1)
    if "shared" in p:
        ys = glu_mlp(p["shared"], xe if sp is not None else x, activation)
        if ep is not None and sp is not None:
            y = reduce_from_model(y + ys, ep)
        else:
            y = reduce_from_model(y, ep) + reduce_from_model(ys, sp)
    else:
        y = reduce_from_model(y, ep)
    frac = _expert_counts(all_e, e).float() / all_e.shape[0]
    pmass = probs.mean(dim=0)
    if data is not None:
        pmass = reduce_from_model(pmass, data) / data.world
    aux = e * torch.sum(frac * pmass) * mcfg.router_aux_coef
    return y.to(x.dtype), aux
