"""LeNet-5 at full width (D = 61,706).

Counterpart of ``laplace_inducing_points_tpu/models/scale.py:16-31``. The
reference takes NHWC input, pads 2 pixels to 32×32 and flattens the last
feature map in NHWC order; this module computes in NCHW and permutes back to
NHWC before the flatten, so ``Dense_0``'s rows mean the same in both.
``LargeClassifier`` and ``ResNet1M`` are not ported yet (ROADMAP, Queue A).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from laplace_inducing_points_tpu_torch.models.layers import Conv, Dense


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
