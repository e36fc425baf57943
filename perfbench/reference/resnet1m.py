"""ResNet1M written out from its layer equations, for 32x32x3 NHWC images,
with its BatchNorms in eval mode.

A 3x3 SAME convolution to 32 channels (no bias), BatchNorm, ReLU; nine basic
blocks at widths 32, 32, 32, 64, 64, 64, 128, 128, 128, the first of the
64- and 128-wide stages at stride 2; a mean over H and W; a dense layer
128 -> 10. A basic block is ``relu(BN(conv3x3(relu(BN(conv3x3_s(x))))) + r)``
with ``r = BN(conv1x1_s(x))`` where the shape changes, else ``r = x``.

SAME padding is XLA's: the output has ``ceil(n / stride)`` positions and the
odd pixel of padding goes to the high side (a 3x3 stride-2 window on an even
size pads (0, 1), not (1, 1)). BatchNorm in eval mode is
``(x - mean) / sqrt(var + 1e-5) * scale + bias`` with the stored statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INPUT_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
STAGES = ((32, 1), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1),
          (128, 2), (128, 1), (128, 1))
EPSILON = 1e-5


def _layout():
    leaves, stats = [(("Conv_0", "kernel"), (3, 3, 3, 32))], ["BatchNorm_0"]
    widths = {"BatchNorm_0": 32}
    c_in = 32
    for i, (c, s) in enumerate(STAGES):
        b = f"BasicBlock_{i}"
        leaves += [((b, "Conv_0", "kernel"), (3, 3, c_in, c)),
                   ((b, "Conv_1", "kernel"), (3, 3, c, c))]
        norms = ["BatchNorm_0", "BatchNorm_1"]
        if s != 1 or c_in != c:
            leaves.append(((b, "Conv_2", "kernel"), (1, 1, c_in, c)))
            norms.append("BatchNorm_2")
        for n in norms:
            stats.append(f"{b}.{n}")
            widths[f"{b}.{n}"] = c
        c_in = c
    for n in stats:
        path = tuple(n.split("."))
        leaves += [((*path, "bias"), (widths[n],)), ((*path, "scale"), (widths[n],))]
    leaves += [(("Dense_0", "kernel"), (128, 10)), (("Dense_0", "bias"), (10,))]
    return sorted(leaves), [(n, widths[n]) for n in stats]


# (path, shape) of every weight leaf, sorted by path as the flat vector holds
# them; (name, channels) of every BatchNorm's statistics
LEAVES, STATS = _layout()


def _pad_same(size: int, window: int, stride: int) -> tuple[int, int]:
    total = max((math.ceil(size / stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    k = kernel.shape[0]
    lo, hi = _pad_same(x.shape[-1], k, stride)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), kernel.permute(3, 2, 0, 1), None, stride)


def _bn(x: torch.Tensor, p: dict, stats: dict, name: str) -> torch.Tensor:
    mul = p[f"{name}.scale"] / torch.sqrt(stats[f"{name}.var"] + EPSILON)
    return ((x - stats[f"{name}.mean"][:, None, None]) * mul[:, None, None]
            + p[f"{name}.bias"][:, None, None])


def forward(p: dict, stats: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits ``(B, 10)`` of images ``x (B, 32, 32, 3)``; ``p`` maps
    ``"BasicBlock_3.Conv_2.kernel"``-style names to leaves, ``stats`` maps
    ``"BasicBlock_3.BatchNorm_2.mean"``-style names to the statistics."""
    h = torch.relu(_bn(_conv(x.permute(0, 3, 1, 2), p["Conv_0.kernel"], 1), p, stats,
                       "BatchNorm_0"))
    c_in = 32
    for i, (c, s) in enumerate(STAGES):
        b = f"BasicBlock_{i}"
        y = torch.relu(_bn(_conv(h, p[f"{b}.Conv_0.kernel"], s), p, stats, f"{b}.BatchNorm_0"))
        y = _bn(_conv(y, p[f"{b}.Conv_1.kernel"], 1), p, stats, f"{b}.BatchNorm_1")
        if s != 1 or c_in != c:
            h = _bn(_conv(h, p[f"{b}.Conv_2.kernel"], s), p, stats, f"{b}.BatchNorm_2")
        h = torch.relu(y + h)
        c_in = c
    return h.mean(dim=(2, 3)) @ p["Dense_0.kernel"] + p["Dense_0.bias"]


def forward_flops() -> int:
    """Multiply-adds of one image's forward pass, times two: the
    convolutions and the dense layer (BatchNorm, ReLUs, additions and the mean
    left out)."""
    macs, size, c_in = 32 * 32 * 32 * (3 * 3 * 3), 32, 32
    for c, s in STAGES:
        size //= s
        macs += size * size * c * (3 * 3 * c_in) + size * size * c * (3 * 3 * c)
        if s != 1 or c_in != c:
            macs += size * size * c * c_in
        c_in = c
    return 2 * (macs + 128 * 10)
