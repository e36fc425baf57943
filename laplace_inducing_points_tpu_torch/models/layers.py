"""Dense and convolution layers that keep Flax's parameter layouts.

The flat parameter vector is shared with the JAX package entry for entry
(``core/params.py``), so the layers store their weights as Flax does —
``Dense``: ``kernel (in, out)``; ``Conv``: ``kernel`` HWIO — and permute to
PyTorch's layout at call time. Parameter names (``bias``, ``kernel``) and
submodule names (``Conv_0``, ``Dense_1``, ...) follow Flax's, so
``FlatSpec.from_module`` orders them as ``ravel_pytree`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``x @ kernel + bias`` over the last axis."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features))
        self.kernel = nn.Parameter(torch.zeros(in_features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Conv(nn.Module):
    """Flax ``nn.Conv(padding="VALID")`` on NCHW activations, HWIO kernel."""

    def __init__(self, in_channels: int, features: int, window: tuple[int, int]):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features))
        self.kernel = nn.Parameter(torch.zeros(*window, in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias)
