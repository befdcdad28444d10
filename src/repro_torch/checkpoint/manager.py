"""Checkpointing in the reference's layout: the JAX package's files, leaf
order and shapes, so each package restores the other's checkpoints.

Layout (the JAX package's ``checkpoint/manager.py``):

    <dir>/step_<N>/
        manifest.json        step, n_leaves, meta, dtypes, shapes
        <leaf-idx>.npy       one file per leaf; bfloat16 stored as uint16

A tree is any nesting of dicts, lists, tuples and NamedTuples of tensors;
``None`` holds no leaf. It is written as the reference holds it:
``convert.stack_layers`` stacks the per-layer leaves back to [L, ...]
(the layer lists of every family's parameters, the gate's
``blocks/<i>/...`` keys and the AdamW moments over them; a vision
model's self layers to [n_units, n_self, ...], for which the model's
``cfg`` is passed), and the leaves go in ``jax.tree_util``'s flatten
order: dict keys sorted, NamedTuple fields in order. Restore reads into
the structure of a ``like`` tree, unstacks, and puts each leaf on the
device of its ``like`` leaf. A training state's tree is
``train.loop.checkpoint_tree``'s (pretraining's moments nested like the
parameters).

Fault-tolerance contract used by ``train.loop``:
  * atomic publish (write ``.tmp_step_<N>``, rename to ``step_<N>``): a
    crash mid-save never corrupts the latest checkpoint;
  * the data-iterator position and seed are saved in ``meta``;
  * the async writer copies the leaves to the host on the caller's thread
    (ordered after the step that made them) and writes them on another;
  * under a training ``Shard`` the tree written is the full one, which
    every rank gathers and rank 0 alone writes (``train.loop``); every
    rank restores it whole onto its ``device`` and slices it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
             torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
             torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
             torch.bool: "bool"}
_TORCH = {v: k for k, v in _NP_NAMES.items()}


def _flatten(tree: Any) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flatten(t)]
    raise TypeError(f"checkpoint: unsupported tree node {type(tree).__name__}")


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(t, leaves) for t in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    raise TypeError(f"checkpoint: unsupported tree node {type(like).__name__}")


def _map(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every tensor."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(t, fn) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(t, fn) for t in tree)
    raise TypeError(f"checkpoint: unsupported tree node {type(tree).__name__}")


def _savable(tree: Any, cfg=None) -> List[Tuple[np.ndarray, str]]:
    """The reference's leaves of ``tree``, on the host, in its order."""
    host = _map(tree, lambda t: t.detach().cpu())
    return [_to_savable(t) for t in _flatten(convert.stack_layers(host, cfg))]


def _to_savable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    name = _NP_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_savable(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(_TORCH[name])


def _write(ckpt_dir: str, step: int, savable, meta: Optional[Dict]) -> str:
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        # the structure is re-derived from a `like` tree at restore time
        "n_leaves": len(savable),
        "meta": meta or {},
        "dtypes": [name for _, name in savable],
        "shapes": [list(a.shape) for a, _ in savable],
    }
    for i, (arr, _) in enumerate(savable):
        np.save(os.path.join(tmp, f"{i}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[Dict] = None, *,
         cfg=None) -> str:
    """Write ``tree`` (the model config ``cfg`` gives a vision model's unit
    stacks) as ``<ckpt_dir>/step_<step>``; returns its path."""
    return _write(ckpt_dir, step, _savable(tree, cfg), meta)


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training."""

    def __init__(self, ckpt_dir: str, *, cfg=None):
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None):
        self.wait()
        # the device -> host copy on the caller's thread orders it after
        # the step that produced the leaves
        savable = _savable(tree, self.cfg)
        self._thread = threading.Thread(target=_write,
                                        args=(self.ckpt_dir, step, savable, meta))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, *, cfg=None,
            device=None) -> Tuple[Any, Dict]:
    """Read ``step_<step>`` into the structure of ``like`` (``cfg`` as at
    ``save``); each leaf goes to ``device``, or without one to the device
    of the ``like`` leaf in its place (a ``like`` of meta tensors, the
    full shapes of a sharded state, needs ``device``), in its saved
    dtype. Returns (tree, meta)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    # the reference's structure of `like`, on the meta device: no copy
    ref_like = convert.stack_layers(_map(like, lambda t: t.detach().to("meta")), cfg)
    like_leaves = _flatten(ref_like)
    if len(like_leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"model {len(like_leaves)}")
    for i, (shape, ref) in enumerate(zip(manifest["shapes"], like_leaves)):
        if list(ref.shape) != shape:
            raise ValueError(f"checkpoint leaf {i} has shape {shape}, model "
                             f"{list(ref.shape)}")
    leaves = [_from_savable(np.load(os.path.join(path, f"{i}.npy")), dt)
              for i, dt in enumerate(manifest["dtypes"])]
    return (convert.unstack_layers(_unflatten(ref_like, iter(leaves)), like, cfg,
                                   device=device),
            manifest["meta"])
