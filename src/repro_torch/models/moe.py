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
the global rows, so the drops are the single-device call's. The
capacity's slots split over data as the reference's GSPMD buffer
(``moe_buffer: P(MODEL, dpa, None)``) does: data rank q owns slots
``[q*cs, min(C, (q+1)*cs))``, ``cs = ceil(C / D)``, of each expert its
model rank holds, and computes only those, an ``[E / M, cs, d]`` buffer
(``_slot_ranges``). Every rank holds the global table, so the counts of
one ``all_to_all`` over the data group, carrying each kept assignment's
row to its slot's owner, need no exchange of their own; a reverse one
returns the outputs, and the token's replica weights and sums them over
top-k. The router loss's token fractions count the global assignments
and its probability mass is the replicas' (equal-sized) means averaged.

``dispatch="shard_map"`` with a model ``Shard`` takes the reference's
explicit expert-parallel bodies (``moe_mlp_sharded``; ``dispatch_branch``
picks one by the reference's conditions), whose capacity is local to a
shard's rows: a different function from the single-device call wherever
capacity binds. Large T (a model rank's block of the replica's rows
reaches E / top_k): each model rank routes its block, scatters into [E,
C, d], and one ``all_to_all`` over the model group brings its experts'
rows [E / M, M * C, d] (``_all_to_all_experts``), a reverse one the
outputs; the rows are then gathered back over the model group.
Decode-size T: the rows replicated over the model group, each rank its
experts with the capacity of the replica's rows, combined by a sum in
training and by the exact gather at decode. EP-major (an EP-major model
shard, ``sharding.ep_view``: x is the rank's own rows of the data x
model world): the large-T exchange on
those rows, the shared experts whole. The router loss's fractions and
mass are averaged over the model group, then over data.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.config import MoEConfig
from repro_torch.core.sparsity import ranked_top_k
from repro_torch.distributed.sharding import (all_to_all, copy_to_model, gather_rows, part,
                                              reduce_from_model)
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


class _SlotPlan(NamedTuple):
    """One exchange of assignments over a group (``_slot_plan``): the
    rank's own assignments it sends, ordered by destination (indices into
    its ``T * k``), with the rows to each rank; the group's assignments it
    receives, in global order (indices into the gathered ``W * T * k``),
    with the rows from each rank."""
    send: torch.Tensor
    send_counts: List[int]
    recv: torch.Tensor
    recv_counts: List[int]


def _slot_plan(handled: torch.Tensor, dest: torch.Tensor, group, n: int,
               spread: int = 1) -> _SlotPlan:
    """The exchange that carries every ``handled`` assignment of the
    gathered table (``W * n`` entries, rank r's at ``[r*n, (r+1)*n)``) from
    its rank to rank ``dest`` of ``group``. Every rank holds the whole
    table, so the counts need no exchange of their own (a host sync reads
    them). On the dry-run's fake tensors, where the table holds no values,
    the rank's ``n / spread`` handled assignments are taken as spread
    evenly over the group."""
    w, r = group.world, group.rank
    if isinstance(handled, FakeTensor):
        per = -(-n // (spread * w))
        idx = torch.arange(per * w, device=handled.device) % n
        return _SlotPlan(idx, [per] * w, idx + r * n, [per] * w)
    own = slice(r * n, (r + 1) * n)
    mine = torch.nonzero(handled[own]).squeeze(1)
    order = torch.argsort(dest[own][mine], stable=True)
    send = mine[order]
    recv = torch.nonzero(handled & (dest == r)).squeeze(1)
    counts = torch.stack([torch.bincount(dest[own][send], minlength=w),
                          torch.bincount(recv // n, minlength=w)]).tolist()
    return _SlotPlan(send, counts[0], recv, counts[1])


def _slot_ranges(p: Params, x: torch.Tensor, all_e: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor, cap: int, k: int, activation: str, ep, data,
                 gather: bool) -> torch.Tensor:
    """The routed experts over the data axis with the capacity's slots
    split over it (the reference's ``moe_buffer: P(MODEL, dpa, None)``):
    data rank ``q`` owns slots ``[q*cs, min(C, (q+1)*cs))``, ``cs =
    ceil(C / D)``, of each expert its model rank holds, and computes only
    those rows, an ``[E / M, cs, d]`` buffer. ``all_e``/``slot``/``keep``
    are the global table (every replica's ``T * k`` assignments in data
    rank order), so one all-to-all over the data group carries each kept
    assignment's row to its slot's owner, the expert GLU runs there, and
    the reverse carries the output back. Returns the expert outputs of
    the replica's ``T * k`` assignments [T * k, d], zero where dropped:
    in training those of this model rank's experts only (zero elsewhere;
    the caller sums over the model group); with ``gather`` (decode, no
    autograd) every expert's, the owner's outputs first gathered exactly
    over the model group, so that the weighting and the sum over top-k
    are the unsharded call's."""
    n, d = x.shape[0] * k, x.shape[1]
    e_loc = p["wi_gate"].shape[0]
    cs = -(-cap // data.world)
    q = slot // cs
    block = all_e // e_loc
    mine = keep if ep is None else keep & (block == ep.rank)
    fwd = _slot_plan(mine, q, data, n, 1 if ep is None else ep.world)
    rows = x.repeat_interleave(k, dim=0)[fwd.send]
    got = all_to_all(rows, data, fwd.send_counts, fwd.recv_counts)
    buf = torch.zeros((e_loc, cs, d), dtype=x.dtype, device=x.device)
    at = (all_e[fwd.recv] - block[fwd.recv] * e_loc, slot[fwd.recv] - data.rank * cs)
    buf[at] = got
    yb = expert_glu(p, buf, activation)
    y_rep = torch.zeros((n, d), dtype=yb.dtype, device=yb.device)
    if gather and ep is not None:
        full = ep.all_gather(yb, 0)                       # [E, cs, d]: every expert's
        back = _slot_plan(keep, q, data, n)
        out = full[all_e[back.recv], slot[back.recv] - data.rank * cs]
        y_rep[back.send] = data.all_to_all(out, back.recv_counts, back.send_counts)
    else:
        y_rep[fwd.send] = all_to_all(yb[at], data, fwd.recv_counts, fwd.send_counts)
    return y_rep


def _all_to_all_experts(p: Params, x: torch.Tensor, router_w: torch.Tensor,
                        mcfg: MoEConfig, activation: str, shard
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's explicit dispatch over ``x`` [t, d], the rows this
    model rank routes alone (``moe_mlp_sharded``'s large-T and EP-major
    bodies): the capacity from those t rows, a local scatter into [E, C,
    d], the dispatch all-to-all over the model group to this rank's
    experts [E / M, M * C, d] (the capacity concatenated in source rank
    order), the GLU, the reverse all-to-all, the local gather and combine.
    Returns (y [t, d], the token fractions [E], the probability mass [E]),
    both of this rank's rows."""
    t, d = x.shape
    e, k, m = mcfg.n_experts, mcfg.top_k, shard.world
    probs, top_i, top_w = route(x, router_w, k)
    flat_e, slot, keep, cap = dispatch(top_i, mcfg)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, slot] = x.repeat_interleave(k, dim=0)
    be = all_to_all(buf[:, :cap], shard)                  # [M (source), E / M, C, d]
    be = be.view(m, e // m, cap, d).transpose(0, 1).reshape(e // m, m * cap, d)
    yb = expert_glu(p, be, activation)
    yb = yb.view(e // m, m, cap, d).transpose(0, 1)
    yb = all_to_all(yb, shard).view(e, cap, d)            # the experts in rank order
    w = torch.where(keep, top_w.reshape(-1).to(yb.dtype), 0)
    y = (yb[flat_e, torch.clamp_max(slot, cap - 1)] * w[:, None]).reshape(t, k, d).sum(dim=1)
    return y, _expert_counts(flat_e, e).float() / flat_e.shape[0], probs.mean(dim=0)


def _mean_over(x: torch.Tensor, *groups) -> torch.Tensor:
    """The mean of ``x`` over each group in turn (equal shares: the
    reference's ``pmean``), differentiable as ``reduce_from_model``."""
    for g in groups:
        if g is not None:
            x = reduce_from_model(x, g) / g.world
    return x


def dispatch_branch(t: int, mcfg: MoEConfig, shard) -> str:
    """Which of the reference's ``moe_mlp_sharded`` bodies a call of ``t``
    rows takes under ``dispatch="shard_map"`` and a model ``shard``
    (``"ep"`` for an EP-major shard, ``"large"`` or ``"decode"``), or
    ``"gspmd"``."""
    if shard is not None and shard.ep_major and mcfg.dispatch != "shard_map":
        raise ValueError("moe: the EP-major layout needs dispatch='shard_map'")
    if mcfg.dispatch != "shard_map" or shard is None:
        return "gspmd"
    if mcfg.n_experts % shard.world:
        raise ValueError(f"moe dispatch='shard_map': {mcfg.n_experts} experts do not divide "
                         f"the model axis's {shard.world} ranks")
    if shard.ep_major:
        return "ep"
    m = shard.world
    return "large" if t % m == 0 and (t // m) * mcfg.top_k >= mcfg.n_experts else "decode"


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
    global rows' with the capacity's slots split over data (the module
    docstring). ``mcfg.dispatch == "shard_map"`` with a ``shard`` takes
    the reference's ``moe_mlp_sharded`` bodies instead (``dispatch_branch``);
    under an EP-major ``shard`` (``sharding.ep_view``) x is this rank's
    rows of the data x model world and the shared experts whole."""
    t, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    branch = dispatch_branch(t, mcfg, shard)
    if branch in ("ep", "large"):
        return _moe_all_to_all(p, x, mcfg, activation, shard, data, branch)
    local = branch == "decode"            # the replica's own routing and capacity
    probs, top_i, top_w = route(x, p["router"]["w"], k)
    if data is None or local:
        flat_e, slot, keep, cap = dispatch(top_i, mcfg)
        all_e = flat_e
    else:
        all_e, slot, keep, cap = dispatch(data.all_gather(top_i, 0), mcfg)
    ep = part(shard, e)
    sp = part(shard, mcfg.n_shared_experts * mcfg.expert_d_ff) if "shared" in p else None
    e_loc = p["wi_gate"].shape[0]
    if data is not None and not local:
        xe = x if gather or not (ep or sp) else copy_to_model(x, shard)
        w = top_w if gather or ep is None else copy_to_model(top_w, ep)
        y_rep = _slot_ranges(p, xe if ep is not None else x, all_e, slot, keep, cap, k,
                             activation, ep, data, gather)
        mine = slice(data.rank * t * k, (data.rank + 1) * t * k)
        w = torch.where(keep[mine], w.reshape(-1).to(y_rep.dtype), 0)
        y_rep = y_rep * w[:, None]
        if gather:
            ep = None
        flat_e = all_e[mine]
    elif gather:
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
    if data is None or local:
        # a dropped assignment's weight is 0: the reference zeroes its row,
        # then weights it (the buffers are freed as soon as they are read,
        # the prefill's hold T * k rows of d)
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
    if local:
        frac = _mean_over(_expert_counts(flat_e, e).float() / flat_e.shape[0], data)
    else:
        frac = _expert_counts(all_e, e).float() / all_e.shape[0]
    pmass = _mean_over(probs.mean(dim=0), data)
    aux = e * torch.sum(frac * pmass) * mcfg.router_aux_coef
    return y.to(x.dtype), aux


def _moe_all_to_all(p: Params, x: torch.Tensor, mcfg: MoEConfig, activation: str, shard,
                    data, branch: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's large-T and EP-major bodies (``dispatch_branch``).
    Large T: x [T, d] is replicated over the model group, so model rank m
    takes its row block ``[m T / M, (m+1) T / M)`` (the counterpart of the
    reference's resplit of the d-sharded activations), routes and
    dispatches it alone, and the rows return to every rank by a gather;
    the shared experts split their hidden units with one sum. EP-major: x
    is already this rank's rows, and the shared experts run whole. The
    router loss's fractions and mass are averaged over the model group,
    then over data."""
    e = mcfg.n_experts
    sp = None
    if branch == "large":
        sp = part(shard, mcfg.n_shared_experts * mcfg.expert_d_ff) if "shared" in p else None
        xr = copy_to_model(x, shard)         # each rank's rows' gradient, summed
        tl = x.shape[0] // shard.world
        # (the whole x at one rank: no narrow, so that autograd sums x's
        # gradients in the unsharded call's order)
        xf = xr if tl == x.shape[0] else xr.narrow(0, shard.rank * tl, tl)
        y, frac, pmass = _all_to_all_experts(p, xf,
                                             copy_to_model(p["router"]["w"], shard),
                                             mcfg, activation, shard)
        y = gather_rows(y, shard)
    else:
        y, frac, pmass = _all_to_all_experts(p, x, p["router"]["w"], mcfg, activation, shard)
    if "shared" in p:
        y = y + reduce_from_model(glu_mlp(p["shared"], xr if sp is not None else x,
                                          activation), sp)
    frac = _mean_over(frac, shard, data)
    pmass = _mean_over(pmass, shard, data)
    aux = e * torch.sum(frac * pmass) * mcfg.router_aux_coef
    return y.to(x.dtype), aux
