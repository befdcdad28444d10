"""The dry-run's meshes and the H100's roofline constants.

The port's counterpart of the JAX package's ``launch/mesh.py``. A mesh
here is a shape only (``MeshSpec``): making one touches no device and
starts no process group. Its axes keep the reference's names and sizes:

  * ``model`` is the port's ``Shard``, tensor parallelism over a
    ``torch.distributed`` group (``distributed/sharding.py``): the size of
    a cell's ``AbstractShard`` and of the collectives it logs;
  * ``data`` (and ``pod``) are data-parallel replicas, one data
    ``AbstractShard`` of pod x data ranks: they divide the global batch
    (``batch_per_rank``, the reference's ``batch_pspecs`` rule, shared
    with ``sharding.data_rows``), carry the gradient all-reduce and, in
    pretraining, the ZeRO-1 moments and their parameter all-gather, and a
    batch they do not divide splits its decode sequence over every rank.

The roofline's rates are one NVIDIA H100 SXM's, from NVIDIA's data
sheet (dense rates without sparsity, at the full 700 W power limit).
``HBM_BYTES``, the limit of ``fits``, is the ``total_memory`` that
``torch.cuda.get_device_properties`` reports on an NVIDIA H100 80GB
HBM3 (700 W): one number on every host, with a card or without. A
model axis of 16 spans two 8-card NVLink domains, and the data axes span
nodes, so the collective term, which assumes NVLink's rate for every
rank and every axis, is a lower bound there.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.distributed.sharding import replica_rows

PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12                  # HBM bytes/s a card
HBM_BYTES = 85017493504           # HBM bytes a card (total_memory of an H100 80GB HBM3)
LINK_BW = 450e9                   # NVLink bytes/s a card, each way


@dataclass(frozen=True)
class MeshSpec:
    """A device mesh as axis sizes: ``pod`` x ``data`` x ``model`` cards."""
    pod: int = 1
    data: int = 1
    model: int = 1

    @property
    def size(self) -> int:
        return self.pod * self.data * self.model


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """(data 16, model 16), or (pod 2, data 16, model 16)."""
    return MeshSpec(2, 16, 16) if multi_pod else MeshSpec(1, 16, 16)


def make_local_mesh() -> MeshSpec:
    """One card with the production axis names: the model axis is 1, so
    the cell's step runs without a shard."""
    return MeshSpec(1, 1, 1)


def batch_per_rank(batch_size: int, mesh: MeshSpec, ep_major: bool = False) -> int:
    """A rank's rows of a ``batch_size`` batch: the reference's
    ``batch_pspecs`` rule. Divided by the data-parallel axes (pod x data)
    where they divide it, else by ``data`` alone where that divides it,
    else whole. EP-major folds the model axis in too where the batch
    divides all of them."""
    dp = mesh.pod * mesh.data
    if ep_major and batch_size % (dp * mesh.model) == 0:
        return batch_size // (dp * mesh.model)
    if batch_size % dp == 0:
        return replica_rows(batch_size, dp)
    return replica_rows(batch_size, mesh.data)

