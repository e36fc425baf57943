"""Model state: the module, its flat weight vector, its BatchNorm statistics,
its likelihood kind and, after MAP training, the trainer's Adam state.

Replaces the reference's ``TrainState``
(``laplace_inducing_points_tpu/models/state.py``). The module only defines
the network's structure; its weights are ``flat_params`` and its statistics
``batch_stats`` (the counterpart of the reference's ``batch_stats``
collection, ``:20-22``), applied through ``torch.func.functional_call``
(``core.operators.model_outputs``). ``opt_state`` is the counterpart of the
``TrainState``'s ``opt_state`` and ``step``: ``None`` on the serving path,
an :class:`AdamState` where the state came from ``training.map.train_map``
or from a train-state checkpoint, from which a resumed MAP run continues.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from laplace_inducing_points_tpu_torch.core.params import FlatSpec

MODEL_KINDS = ("classifier", "regressor")


@dataclass
class AdamState:
    """The MAP trainer's Adam state as optax keeps it: the step ``count``
    (Adam's bias correction and the learning-rate schedule both read it) and
    the first and second moments ``mu`` and ``nu`` of each leaf the optimizer
    holds (the flat weights, then a regressor's ``logvar``)."""
    count: int
    mu: tuple[torch.Tensor, ...]
    nu: tuple[torch.Tensor, ...]


@dataclass
class ModelState:
    model: nn.Module
    flat_params: torch.Tensor          # (D,) f32, in ravel_pytree order
    model_kind: str
    # BatchNorm statistics keyed like the module's buffers ("BasicBlock_0.
    # BatchNorm_1.var", ...); None: the module's own initial ones (mean 0,
    # var 1); empty for a model without BatchNorm
    batch_stats: Optional[dict[str, torch.Tensor]] = None
    opt_state: Optional[AdamState] = None
    spec: FlatSpec = field(init=False)

    def __post_init__(self):
        if self.model_kind not in MODEL_KINDS:
            raise ValueError(f"unknown model_kind {self.model_kind!r}")
        self.spec = FlatSpec.from_module(self.model)
        if self.flat_params.shape != (self.spec.num_params,):
            raise ValueError(f"flat_params has shape {tuple(self.flat_params.shape)}; "
                             f"the model needs ({self.spec.num_params},)")
        if self.flat_params.dtype != torch.float32:
            raise TypeError(f"flat_params must be float32, got {self.flat_params.dtype}")
        for p in self.model.parameters():
            if p.device != self.flat_params.device:
                raise ValueError(f"model is on {p.device} but flat_params on "
                                 f"{self.flat_params.device}")
        buffers = dict(self.model.named_buffers())
        if self.batch_stats is None:
            self.batch_stats = {name: b.detach().clone() for name, b in buffers.items()}
        if set(self.batch_stats) != set(buffers):
            raise ValueError(f"batch_stats has the keys {sorted(self.batch_stats)}; "
                             f"the model's statistics are {sorted(buffers)}")
        for name, t in self.batch_stats.items():
            if t.shape != buffers[name].shape or t.device != self.flat_params.device:
                raise ValueError(f"batch_stats[{name!r}] is {tuple(t.shape)} on {t.device}; "
                                 f"the model needs {tuple(buffers[name].shape)} on "
                                 f"{self.flat_params.device}")

    @property
    def device(self) -> torch.device:
        return self.flat_params.device

    @property
    def step(self) -> int:
        """MAP steps taken: the Adam count, 0 without an optimizer state."""
        return self.opt_state.count if self.opt_state is not None else 0

    @property
    def logvar(self) -> torch.Tensor | float:
        """The regressor's learned observation log-variance; 0 otherwise."""
        if self.model_kind == "regressor":
            return self.model.logvar.detach()
        return 0.0
