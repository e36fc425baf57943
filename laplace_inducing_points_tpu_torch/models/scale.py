"""Scale models at full width: LeNet-5 (D = 61,706), the wide tanh MLP
(D = 235,146 for ``configs/scale/mlp_mnist.yml``) and ResNet1M
(D = 1,084,586).

Counterpart of ``laplace_inducing_points_tpu/models/scale.py``. The reference
takes NHWC input; these modules compute in NCHW and permute back to NHWC
where the order of a flatten matters, so ``Dense_0``'s rows mean the same in
both packages. Submodules carry Flax's names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ``Dense_0``, ...), so ``FlatSpec.from_module`` orders the
parameters as ``ravel_pytree`` does. ``train`` selects BatchNorm's batch
statistics (the MAP step) over the stored ones (everything else).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laplace_inducing_points_tpu_torch.models.layers import BatchNorm, Conv, Dense


class LeNet5(nn.Module):
    """LeNet-5 for 28×28×1 NHWC inputs, padded to 32×32."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(1, 6, (5, 5))
        self.Conv_1 = Conv(6, 16, (5, 5))
        self.Dense_0 = Dense(16 * 5 * 5, 120)
        self.Dense_1 = Dense(120, 84)
        self.Dense_2 = Dense(84, 10)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[None]
        x = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2))
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class LargeClassifier(nn.Module):
    """Wide tanh MLP over the NHWC-flattened input (``:34-49``): ``num_layers``
    hidden layers of widths ``num_hidden``, then ``num_classes`` logits."""

    def __init__(self, input_shape: Sequence[int], num_hidden: Sequence[int],
                 num_layers: int, num_classes: int):
        super().__init__()
        self.input_shape = tuple(input_shape)
        widths = [math.prod(self.input_shape), *num_hidden[:num_layers]]
        for j in range(num_layers):
            self.add_module(f"Dense_{j}", Dense(widths[j], widths[j + 1]))
        self.add_module(f"Dense_{num_layers}", Dense(widths[-1], num_classes))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if tuple(x.shape) == self.input_shape:
            x = x.reshape(-1)
        else:
            x = x.reshape(x.shape[0], -1)
        for j in range(self.num_layers):
            x = torch.tanh(getattr(self, f"Dense_{j}")(x))
        return getattr(self, f"Dense_{self.num_layers}")(x)


class BasicBlock(nn.Module):
    """Residual block (``:52-71``): two 3×3 SAME convs with BatchNorm, and a
    1×1 projection shortcut with BatchNorm (``Conv_2``, ``BatchNorm_2``, made
    after the main branch as Flax names them) where the shape changes."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_channels, channels, (3, 3), (stride, stride), "SAME",
                           use_bias=False)
        self.BatchNorm_0 = BatchNorm(channels)
        self.Conv_1 = Conv(channels, channels, (3, 3), padding="SAME", use_bias=False)
        self.BatchNorm_1 = BatchNorm(channels)
        # the main branch keeps the shape exactly when the stride is 1 and the
        # channels stay (SAME padding)
        self.project = stride != 1 or in_channels != channels
        if self.project:
            self.Conv_2 = Conv(in_channels, channels, (1, 1), (stride, stride), "SAME",
                               use_bias=False)
            self.BatchNorm_2 = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = self.BatchNorm_2(self.Conv_2(x), train) if self.project else x
        return F.relu(y + residual)


class ResNet1M(nn.Module):
    """~1M-parameter ResNet (``:74-96``): a 3×3 stem of 32 channels, then
    stages of 3 BasicBlocks at widths 32, 64 and 128 (the first block of the
    last two at stride 2), a global mean over H and W and ``Dense_0``. A
    1-channel input is tiled to 3 channels."""

    STAGES = ((32, 1), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1),
              (128, 2), (128, 1), (128, 1))

    def __init__(self, num_classes: int):
        super().__init__()
        self.Conv_0 = Conv(3, 32, (3, 3), padding="SAME", use_bias=False)
        self.BatchNorm_0 = BatchNorm(32)
        in_channels = 32
        for i, (channels, stride) in enumerate(self.STAGES):
            self.add_module(f"BasicBlock_{i}", BasicBlock(in_channels, channels, stride))
            in_channels = channels
        self.Dense_0 = Dense(in_channels, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.dim() == 3:
            x = x[None]
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), train))
        for i in range(len(self.STAGES)):
            x = getattr(self, f"BasicBlock_{i}")(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))
