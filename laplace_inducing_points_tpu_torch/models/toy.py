"""Toy models: small MLP regressor / classifier.

Counterpart of ``laplace_inducing_points_tpu/models/toy.py:14-45``: a GELU
MLP with a learned homoscedastic ``logvar`` for regression and a tanh MLP for
classification. Flax infers input widths at init; here ``in_features`` is
given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laplace_inducing_points_tpu_torch.models.layers import Dense


class SimpleRegressor(nn.Module):
    """GELU MLP returning ``(mu, logvar)``.

    ``logvar`` is a parameter of the Gaussian likelihood, not of the
    function: it is excluded from the flat curvature vector
    (``core.params.EXCLUDED_COLLECTIONS``). Flax's ``nn.gelu`` is the tanh
    approximation.
    """

    def __init__(self, num_hidden: int, num_layers: int, in_features: int):
        super().__init__()
        widths = [in_features] + [num_hidden] * num_layers
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.add_module(f"Dense_{num_layers}", Dense(widths[-1], 1))
        self.logvar = nn.Parameter(torch.zeros(()))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor):
        h = x
        for i in range(self.num_layers):
            h = F.gelu(getattr(self, f"Dense_{i}")(h), approximate="tanh")
        return getattr(self, f"Dense_{self.num_layers}")(h), self.logvar


class SimpleClassifier(nn.Module):
    """tanh MLP emitting ``num_classes`` logits."""

    def __init__(self, num_hidden: int, num_layers: int, num_classes: int,
                 in_features: int):
        super().__init__()
        widths = [in_features] + [num_hidden] * num_layers
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.add_module(f"Dense_{num_layers}", Dense(widths[-1], num_classes))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            h = torch.tanh(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.num_layers}")(h)
