"""Model state: the module, its flat weight vector and its likelihood kind.

Replaces the reference's ``TrainState``
(``laplace_inducing_points_tpu/models/state.py``) on the serving path: there
is no optimizer. The module only defines the network's structure; its
weights are ``flat_params``, applied through ``torch.func.functional_call``
(``core.operators.model_outputs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from laplace_inducing_points_tpu_torch.core.params import FlatSpec

MODEL_KINDS = ("classifier", "regressor")


@dataclass
class ModelState:
    model: nn.Module
    flat_params: torch.Tensor          # (D,) f32, in ravel_pytree order
    model_kind: str
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

    @property
    def device(self) -> torch.device:
        return self.flat_params.device

    @property
    def logvar(self) -> torch.Tensor | float:
        """The regressor's learned observation log-variance; 0 otherwise."""
        if self.model_kind == "regressor":
            return self.model.logvar.detach()
        return 0.0
