"""The dry-run: one H100's share of every (arch x shape x mesh) cell, over
fake tensors, with its roofline.

The port's counterpart of the JAX package's ``launch/dryrun.py``. There,
each cell's step is lowered and compiled for a 256- or 512-device mesh
and XLA's memory and cost analyses are read. Here, each cell's step
(``launch/specs.py``) runs once under
``torch._subclasses.fake_tensor.FakeTensorMode`` on rank 0's arguments at
full size: every op computes shapes and dtypes only, so a 1T-parameter
cell traces in seconds on a CPU with no card. Eager PyTorch runs each op
as its own kernel, and the trace sees every op, every layer of the
Python loop included (so the reference's ``probe_costs``/``probe_unit``,
which make up for XLA costing a scan body once, have no counterpart).
What one rank would hold and do is counted on the way:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count (the
    matmul-class ops: mm, bmm, addmm, baddbmm, attention; elementwise ops
    are not counted), plus the hand-written kernels' own operations;
  * ``bytes``: over the non-view aten ops, the bytes of the tensors each
    reads plus those it writes (an op that only aliases its input, or
    only allocates, moves none), with the reference's slice correction
    (``dus_gather_byte_correction``): a gather-like op (``index_select``,
    ``gather``, ``index.Tensor``, ``embedding``) is charged twice its
    output, a scatter-like one (``index_copy_``, ``index_put_``,
    ``scatter_``, ``copy_``) twice its update; plus the kernels' own bytes
    (PERF.md §6's bound formulas). L2 hits make it an upper bound;
  * ``bytes_flash``: ``bytes`` less the outputs of score shape (the
    reference's ``scorelike_bytes`` rule, [..., >= 256 rows, seq/2 ..
    seq keys]): what a flash attention would save the plain one (B18);
  * ``peak_bytes``: the most bytes of live tensor storage during the step,
    counted from the arguments (``argument_size_in_bytes``, the rank's
    state and batch) plus each storage an op creates, from its creation
    until it is freed (autograd's saved tensors keep theirs alive);
    ``temp_size_in_bytes`` is the peak less the arguments,
    ``output_size_in_bytes`` the storages the step returns that it made;
  * ``collectives``: the ``AbstractShard``s' logs (the model axis, the
    data axis, and the pod x data x model world of a batch-1 decode),
    bytes per kind (the rank's operand, as the reference's
    ``collective_bytes`` sums), with ``_count`` and ``total``; and
    ``collectives_by_axis``, the same per axis;
  * ``kernels``: calls per hand-written kernel (their ``*_fake``
    stand-ins; ``kernels/fake.py``).

The reference's ``collective_bytes``, ``dus_gather_byte_correction`` and
``scorelike_bytes`` read HLO text, which the port has not: the rules
above are their counterparts. ``param_counts`` and ``model_flops`` are
the reference's, copied. The roofline terms are seconds on one H100 at
its data sheet's rates (``launch/mesh.py``): computed, not measured;
``fits`` is ``peak_bytes`` within the card's HBM.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \\
        [--out dryrun_torch_results.json] [--force]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.kernels import fake
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS_BF16, MeshSpec

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_ALLOCATING = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "empty_permuted"}
_GATHER_LIKE = {"index_select", "gather", "index", "embedding"}
# scatter-like ops and the position of their update operand
_SCATTER_LIKE = {"index_copy_": 3, "index_copy": 3, "index_put_": 2, "index_put": 2,
                 "_index_put_impl_": 2, "scatter_": 3, "scatter": 3}


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree: Any, exclude: Iterable[int] = ()) -> int:
    """Bytes of the distinct storages under ``tree`` (a tensor shared by two
    leaves, or a view, counted once), less those whose id is in
    ``exclude``. Works on real and on fake tensors alike."""
    seen = set(exclude)
    total = 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class PeakTracker:
    """Live bytes of tensor storage, and their peak: ``add`` a storage when
    it is made, and a weak reference takes it off when it is freed."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def add(self, st) -> None:
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)


class OpCounter(TorchDispatchMode):
    """Bytes moved, score-shaped bytes and live storage of every aten op
    run while it is on the stack (see the module docstring for the
    rules). ``seq_len`` picks the score shape; ``args`` are the step's
    arguments, live from the start."""

    def __init__(self, seq_len: int, args: Any):
        super().__init__()
        self.seq_len = seq_len
        self.bytes = 0.0
        self.score_bytes = 0.0
        self.tracker = PeakTracker()
        for t in _tensors(args):
            self.tracker.add(t.untyped_storage())

    def _is_score(self, t: torch.Tensor) -> bool:
        d = t.shape
        return (len(d) >= 3 and self.seq_len // 2 <= d[-1] <= self.seq_len
                and d[-2] >= 256)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        for t in fresh:
            self.tracker.add(t.untyped_storage())
        name = func.overloadpacket.__name__
        mutable = func._schema.is_mutable
        if name in _ALLOCATING or (not mutable and not fresh):
            return out                      # allocation only, or an alias of an input
        if name in _GATHER_LIKE:
            n = 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTER_LIKE:
            pos = _SCATTER_LIKE[name]
            upd = args[pos] if len(args) > pos else kwargs.get("source", kwargs.get("src"))
            n = 2 * _nbytes(upd) if isinstance(upd, torch.Tensor) else 0
        elif name == "copy_":
            n = _nbytes(args[0]) + _nbytes(args[1])
        else:
            n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += n
        self.score_bytes += sum(_nbytes(t) for t in fresh if self._is_score(t))
        return out


# ---------------------------------------------------------------------------
# analytic model FLOPs (the reference's, copied)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for pretrain-mode training,
    2*N_active*D for distill-mode training (gate-only backward: the base
    forward dominates) and prefill, 2*N_active per token for decode."""
    n_dense, n_active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        distill = cfg.gate.enabled and cfg.has_attention and cfg.is_decoder
        return (2.0 if distill else 6.0) * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch          # one decode token


def param_counts(cfg):
    """(total params, active params) — active excludes non-routed experts."""
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    dh = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        di = cfg.ssm.expand * d
        n = cfg.ssm.state_dim
        dtr = -(-d // 16)
        per = d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * n + di * d
        return emb + L * per, emb + L * per
    attn = d * (h + 2 * hkv) * dh + h * dh * d
    if cfg.family == "moe":
        e, k, sh, f = (cfg.moe.n_experts, cfg.moe.top_k,
                       cfg.moe.n_shared_experts, cfg.moe.expert_d_ff)
        expert = 3 * d * f
        mlp_total = e * expert + 3 * d * sh * f
        mlp_active = k * expert + 3 * d * sh * f
        total = emb + L * (attn + mlp_total) + L * d * e
        active = emb + L * (attn + mlp_active) + L * d * e
        return total, active
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        n = cfg.ssm.state_dim
        nh = di // 64
        per_m = d * (2 * di + 2 * n + nh) + di * d
        n_units = L // cfg.hybrid_period
        shared = attn + 3 * d * cfg.d_ff
        tot = emb + L * per_m + shared
        act = emb + L * per_m + n_units * shared        # shared block reused
        return tot, act
    mlp = 3 * d * cfg.d_ff if cfg.activation in ("swiglu", "geglu") else 2 * d * cfg.d_ff
    if cfg.family == "vlm":
        n_units = L // cfg.cross_attn_period
        n_self = n_units * (cfg.cross_attn_period - 1)
        tot = emb + n_self * (attn + mlp) + n_units * (attn + mlp)
        return tot, tot
    return emb + L * (attn + mlp), emb + L * (attn + mlp)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def resolve_mesh(mesh_kind: Union[str, MeshSpec]) -> MeshSpec:
    """"single" (16 x 16), "multi" (2 x 16 x 16), "local" (1 x 1) or a
    MeshSpec."""
    if isinstance(mesh_kind, MeshSpec):
        return mesh_kind
    if mesh_kind == "local":
        return mesh_mod.make_local_mesh()
    if mesh_kind in ("single", "multi"):
        return mesh_mod.make_production_mesh(multi_pod=mesh_kind == "multi")
    raise ValueError(f"unknown mesh {mesh_kind!r}: single, multi, local or a MeshSpec")


def collective_summary(log: Sequence) -> Dict[str, int]:
    """An ``AbstractShard`` log -> bytes per kind, ``_count`` and ``total``
    (the reference's ``collective_bytes`` keys)."""
    out = {c: 0 for c in _COLLECTIVES}
    for c in log:
        out[c.kind] += c.nbytes
    out["_count"] = len(log)
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec) -> Dict:
    """Run one cell's step once under FakeTensorMode and count it: the
    record's measured part (no roofline)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import specs
    with FakeTensorMode(allow_fallback_kernels=False):
        fn, args, axes = specs.cell_fn_specs_axes(cfg, shape, mesh)
        arg_bytes = storage_bytes(args)
        arg_ids = {id(t.untyped_storage()) for t in _tensors(args)}
        ledger = fake.KernelLedger()
        counter = OpCounter(shape.seq_len, args)
        with FlopCounterMode(display=False) as flops, counter, fake.recording(ledger):
            out = fn(*args)
        peak = counter.tracker.peak
        out_bytes = storage_bytes(out, exclude=arg_ids)
        del fn, args, out
    axes = [a for a in axes if a is not None]
    coll = collective_summary([c for a in axes for c in a.log])
    return {"flops": float(flops.get_total_flops()) + ledger.flops,
            "bytes": counter.bytes + ledger.bytes,
            "bytes_flash": counter.bytes - counter.score_bytes + ledger.bytes,
            "collectives": coll,
            "collectives_by_axis": {a.axis: collective_summary(a.log) for a in axes},
            "kernels": dict(ledger.calls),
            "argument_size_in_bytes": arg_bytes,
            "temp_size_in_bytes": peak - arg_bytes,
            "output_size_in_bytes": out_bytes,
            "peak_bytes": peak}


def run_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
             mesh_kind: Union[str, MeshSpec], verbose: bool = True) -> Dict:
    """One record: ``arch`` a config name (or a ModelConfig), ``shape`` a
    name of ``SHAPES`` (or a ShapeConfig), ``mesh_kind`` as
    ``resolve_mesh`` takes it. A failure gives ``ok`` False with
    ``error`` and ``traceback``."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = resolve_mesh(mesh_kind)
    label = mesh_kind if isinstance(mesh_kind, str) else repr(mesh_kind)
    rec = {"arch": cfg.arch_id, "shape": shape.name, "mesh": label, "chips": mesh.size,
           "ok": False}
    t0 = time.perf_counter()
    try:
        from repro_torch.launch import specs
        rec.update(trace_cell(cfg, shape, mesh))
        rec["t_trace_s"] = round(time.perf_counter() - t0, 2)
        mflops = model_flops(cfg, shape)
        rec.update({
            "ok": True,
            "model_flops": mflops,
            "t_compute": rec["flops"] / PEAK_FLOPS_BF16,
            "t_memory": rec["bytes"] / HBM_BW,
            "t_collective": rec["collectives"]["total"] / LINK_BW,
            "hbm_bytes": HBM_BYTES,
            "fits": rec["peak_bytes"] <= HBM_BYTES,
            "notes": specs.cell_notes(cfg, shape, mesh) + [
                "roofline terms computed from H100 data-sheet constants, not measured; "
                "HBM bytes: the total_memory of an H100 80GB HBM3"],
        })
        terms = {k: rec[f"t_{k}"] for k in ("compute", "memory", "collective")}
        rec["bottleneck"] = max(terms, key=terms.get)
        rec["useful_flops_ratio"] = ((mflops / mesh.size) / rec["flops"]
                                     if rec["flops"] else 0.0)
        if verbose:
            print(f"[{cfg.arch_id} x {shape.name} x {label}] OK trace={rec['t_trace_s']:.1f}s "
                  f"flops/rank={rec['flops']:.3e} bytes/rank={rec['bytes']:.3e} "
                  f"coll={rec['collectives']['total']:.3e} peak={rec['peak_bytes'] / 1e9:.2f}GB "
                  f"fits={rec['fits']} bottleneck={rec['bottleneck']}")
    except Exception as e:  # noqa: BLE001 - a failed cell is a record, the sweep goes on
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{cfg.arch_id} x {shape.name} x {label}] FAIL: {rec['error']}")
    return rec


def load_results(path: str) -> Dict[str, Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="dryrun_torch_results.json")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for aid in configs.ARCH_IDS:
            for shp in configs.shapes_for(aid):
                for m in meshes:
                    cells.append((aid, shp.name, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for m in meshes:
            cells.append((configs.canon(args.arch), args.shape, m))

    results = load_results(args.out)
    for aid, shp, m in cells:
        key = f"{aid}|{shp}|{m}"
        if not args.force and results.get(key, {}).get("ok"):
            print(f"[{key}] cached OK, skip")
            continue
        results[key] = run_cell(aid, shp, m)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
