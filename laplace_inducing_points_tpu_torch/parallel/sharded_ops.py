"""Curvature operators with the example axis split over a mesh.

Counterpart of ``laplace_inducing_points_tpu/parallel/sharded_ops.py``. The
GGN's per-example structure (``Σ_i J_iᵀ H_i J_i``) makes it data-parallel:
the point set ``Z`` is split over the devices of the mesh's data axis, each
device runs the same operator code of ``core.operators`` on its shard with a
replica of the state, and the partial sums are added on the first device
(the all-reduce that XLA inserts for the reference). The recalibration
``N/M`` is the whole set's on every shard. The mesh changes where the work
runs, not what it computes.
"""

from __future__ import annotations

from typing import Optional

import torch

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, shard_batch


def _shards(state, Z: torch.Tensor, mesh: Mesh, axis: str):
    """``(replica, shard of Z)`` for each device along ``axis`` with a
    non-empty shard."""
    return [(rep, z) for rep, z in zip(mesh.replicate(state, axis), shard_batch(Z, mesh, axis))
            if len(z)]


def sharded_ggn_matmat(state, Z: torch.Tensor, V: torch.Tensor, mesh: Mesh,
                       full_set_size: Optional[int] = None,
                       axis: str = DATA_AXIS) -> torch.Tensor:
    """``(P, D) -> (P, D)`` GGN probe sweep (jvp, loss Hessian, vjp on each
    shard), example axis over the mesh; the result on the first device."""
    M = Z.shape[0]
    scale = (full_set_size or M) / M
    root = mesh.axis_devices(axis)[0]
    parts = []
    for rep, z in _shards(state, Z, mesh, axis):
        ggn = ops.GGNOperator(lin=ops.linearize_model(rep, z), scale=scale)
        parts.append(ggn.matmat(V.to(rep.device)).to(root))
    return sum(parts)


def sharded_curvature_matmat(state, Z: torch.Tensor, V: torch.Tensor, mesh: Mesh,
                             alpha: float, full_set_size: Optional[int] = None,
                             axis: str = DATA_AXIS) -> torch.Tensor:
    """(GGN + αI) probe sweep, example-sharded."""
    root = mesh.axis_devices(axis)[0]
    return sharded_ggn_matmat(state, Z, V, mesh, full_set_size, axis) + alpha * V.to(root)


def sharded_dense_wt(state, Z: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                     scale: float = 1.0) -> list[torch.Tensor]:
    """The rows ``Wᵀ`` with the example axis split over the mesh: one
    ``(m_i·K, D)`` block per device along ``axis``, in order, each on its
    device (their concatenation is ``dense_wt(state, Z)``)."""
    return [ops.dense_wt(rep, z, scale=scale) for rep, z in _shards(state, Z, mesh, axis)]


def sharded_gram(state, Z: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Dense ``WᵀW`` from row-sharded ``Wᵀ``: the rows are exchanged so that
    device k holds every row's k-th slice of the parameter axis, each device
    forms the Gram of its slice with the ``syrk`` kernel, and the partial
    Grams are added on the first device."""
    rows = sharded_dense_wt(state, Z, mesh, axis)
    devices = mesh.axis_devices(axis)
    root = devices[0]
    D, n = rows[0].shape[1], len(devices)
    parts = []
    for k in range(n):
        lo, hi = D * k // n, D * (k + 1) // n
        if hi > lo:
            strip = torch.cat([r[:, lo:hi].to(devices[k]) for r in rows])
            parts.append(syrk(strip).to(root))
    return sum(parts)


def shard_probes(probes: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> list[torch.Tensor]:
    """The probe axis split over the mesh: one block of probes per device."""
    return shard_batch(probes, mesh, axis)
