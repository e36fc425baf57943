"""LeNet-5 written out from its layer equations, for 28x28x1 NHWC images.

The image is zero-padded to 32x32, then: a 5x5 VALID convolution to 6
channels, ReLU, 2x2 mean pooling; a 5x5 VALID convolution to 16 channels,
ReLU, 2x2 mean pooling; the 5x5x16 map flattened in (H, W, C) order; dense
layers 400 -> 120 -> 84 -> 10 with ReLUs between. Kernels are stored as
Flax stores them (convolutions HWIO, dense (in, out)), so the flat weight
vector that the benchmark draws means the same here and in the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INPUT_SHAPE = (28, 28, 1)
NUM_CLASSES = 10

# (path, shape) of every weight leaf; the flat vector holds them sorted by path
LEAVES = sorted([
    (("Conv_0", "kernel"), (5, 5, 1, 6)), (("Conv_0", "bias"), (6,)),
    (("Conv_1", "kernel"), (5, 5, 6, 16)), (("Conv_1", "bias"), (16,)),
    (("Dense_0", "kernel"), (400, 120)), (("Dense_0", "bias"), (120,)),
    (("Dense_1", "kernel"), (120, 84)), (("Dense_1", "bias"), (84,)),
    (("Dense_2", "kernel"), (84, 10)), (("Dense_2", "bias"), (10,)),
])
# BatchNorm statistics (name, channels): LeNet-5 has none
STATS: list[tuple[str, int]] = []


def _conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias)


def forward(p: dict, stats: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits ``(B, 10)`` of images ``x (B, 28, 28, 1)``; ``p`` maps
    ``"Conv_0.kernel"``-style names to leaves."""
    h = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2))
    h = F.avg_pool2d(torch.relu(_conv(h, p["Conv_0.kernel"], p["Conv_0.bias"])), 2)
    h = F.avg_pool2d(torch.relu(_conv(h, p["Conv_1.kernel"], p["Conv_1.bias"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ p["Dense_0.kernel"] + p["Dense_0.bias"])
    h = torch.relu(h @ p["Dense_1.kernel"] + p["Dense_1.bias"])
    return h @ p["Dense_2.kernel"] + p["Dense_2.bias"]


def forward_flops() -> int:
    """Multiply-adds of one image's forward pass, times two: the
    convolutions and the dense layers (pooling, biases and ReLUs left out)."""
    conv0 = 28 * 28 * 6 * (5 * 5 * 1)
    conv1 = 10 * 10 * 16 * (5 * 5 * 6)
    dense = 400 * 120 + 120 * 84 + 84 * 10
    return 2 * (conv0 + conv1 + dense)
