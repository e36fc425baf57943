"""Device meshes and batch sharding, in one process.

Counterpart of ``laplace_inducing_points_tpu/parallel/mesh.py``. A
:class:`Mesh` is an ordered list of ``torch.device``s laid out over named
axes: ``DATA_AXIS`` (the batch or example axis) and ``MODEL_AXIS`` (reserved,
size 1 by default). It may list one device more than once, so one GPU (or
the CPU) can stand in for several. Where the reference lets XLA partition one
program, the port splits a tensor's leading axis into one chunk per device
along the data axis (:func:`shard_batch`), runs the same code on each chunk
with a replica of the state (:meth:`Mesh.replicate`) and adds the partial
results on the first device. The mesh changes where the work runs, not what
it computes.
"""

from __future__ import annotations

import copy
import math
import weakref
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """Devices over named axes, row-major: ``devices[i]`` sits at the index of
    ``i`` in an array of ``shape``."""

    def __init__(self, devices: Sequence[torch.device], axis_names: tuple[str, ...],
                 shape: tuple[int, ...]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for a shape of "
                             f"{len(self.shape)} axes")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"shape {self.shape} does not hold {len(self.devices)} devices")
        # per-device copies of a module, for shards that run side by side
        self._copies: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names}, "
                f"shape={self.shape})")

    def axis_devices(self, axis: str = DATA_AXIS) -> tuple[torch.device, ...]:
        """The devices along ``axis``, at index 0 of every other axis: one per
        shard of a tensor split over ``axis``."""
        k = self.axis_names.index(axis)
        strides = [math.prod(self.shape[j + 1:]) for j in range(len(self.shape))]
        return tuple(self.devices[i * strides[k]] for i in range(self.shape[k]))

    def module_copies(self, module: torch.nn.Module,
                      axis: str = DATA_AXIS) -> list[torch.nn.Module]:
        """One copy of ``module`` for each device along ``axis`` (made once and
        kept while ``module`` lives): ``torch.func.functional_call`` swaps the
        tensors of the module it runs, so shards running side by side need
        modules of their own."""
        devices = self.axis_devices(axis)
        copies = self._copies.get(module)
        if copies is None or len(copies) != len(devices):
            copies = [copy.deepcopy(module).to(d) for d in devices]
            self._copies[module] = copies
        return copies

    def replicate(self, state, axis: str = DATA_AXIS) -> list:
        """``state`` (a ``ModelState``) on each device along ``axis``: the
        weights and statistics copied there, the module a copy of its own."""
        from laplace_inducing_points_tpu_torch.models.state import ModelState
        copies = self.module_copies(state.model, axis)
        return [ModelState(model, state.flat_params.to(d), state.model_kind,
                           {k: t.to(d) for k, t in state.batch_stats.items()})
                for d, model in zip(self.axis_devices(axis), copies)]


def make_mesh(devices: Optional[Sequence] = None,
              axis_names: tuple[str, ...] = (DATA_AXIS,),
              shape: Optional[tuple[int, ...]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible GPU), 1-D over the
    data axis unless ``shape`` says otherwise. ``devices`` may repeat a
    device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes the visible GPUs, and CUDA is not "
                               "available: pass the devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(devices, axis_names, shape)


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: its leading axis split over ``axis``, or
    replicated on every device along the data axis (``axis`` None)."""
    mesh: Mesh
    axis: Optional[str]

    def place(self, t: torch.Tensor) -> list[torch.Tensor]:
        """The shards of ``t``, one per device (``torch.tensor_split``: the
        first ``len(t) % n`` shards one row longer), or its copies."""
        if self.axis is None:
            return [t.to(d) for d in self.mesh.axis_devices(DATA_AXIS)]
        devices = self.mesh.axis_devices(self.axis)
        return [part.to(d) for part, d in zip(torch.tensor_split(t, len(devices)), devices)]


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Sharding:
    """Shard the leading (batch) axis of a tensor across the mesh."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """The shards of each tensor (or numpy array) of a batch, leading axis
    split over ``axis``: ``(x, y)`` gives ``(x shards, y shards)``."""
    sharding = batch_sharding(mesh, axis)
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, axis) for b in batch)
    return sharding.place(torch.as_tensor(batch))


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros along ``axis`` to a multiple of ``multiple``;
    returns ``(padded, original size)``."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n
