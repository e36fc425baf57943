"""Model state: the module, its flat weight vector, its BatchNorm statistics
and its likelihood kind.

Replaces the reference's ``TrainState``
(``laplace_inducing_points_tpu/models/state.py``) on the serving path: there
is no optimizer. The module only defines the network's structure; its
weights are ``flat_params`` and its statistics ``batch_stats`` (the
counterpart of the reference's ``batch_stats`` collection, ``:20-22``),
applied through ``torch.func.functional_call``
(``core.operators.model_outputs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from laplace_inducing_points_tpu_torch.core.params import FlatSpec

MODEL_KINDS = ("classifier", "regressor")


@dataclass
class ModelState:
    model: nn.Module
    flat_params: torch.Tensor          # (D,) f32, in ravel_pytree order
    model_kind: str
    # BatchNorm statistics keyed like the module's buffers ("BasicBlock_0.
    # BatchNorm_1.var", ...); None: the module's own initial ones (mean 0,
    # var 1); empty for a model without BatchNorm
    batch_stats: Optional[dict[str, torch.Tensor]] = None
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
    def logvar(self) -> torch.Tensor | float:
        """The regressor's learned observation log-variance; 0 otherwise."""
        if self.model_kind == "regressor":
            return self.model.logvar.detach()
        return 0.0
