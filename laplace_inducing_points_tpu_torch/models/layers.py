"""Dense, convolution and batch-norm layers that keep Flax's parameter layouts.

The flat parameter vector is shared with the JAX package entry for entry
(``core/params.py``), so the layers store their weights as Flax does —
``Dense``: ``kernel (in, out)``; ``Conv``: ``kernel`` HWIO; ``BatchNorm``:
``scale`` and ``bias`` — and permute to PyTorch's layout at call time.
Parameter names and submodule names (``Conv_0``, ``BatchNorm_1``, ...)
follow Flax's, so ``FlatSpec.from_module`` orders them as ``ravel_pytree``
does. A ``BatchNorm``'s statistics ``mean`` and ``var`` are buffers: Flax's
``batch_stats`` collection, outside the flat vector.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable

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


def same_padding(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis, ``(low, high)``: the
    output has ``ceil(size / stride)`` positions and the odd pixel goes to the
    high side, so a 3×3 stride-2 window pads (0, 1) at an even size where
    ``padding=1`` would pad (1, 1)."""
    total = max((math.ceil(size / stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Flax ``nn.Conv`` on NCHW activations with an HWIO kernel: ``padding``
    ``"VALID"`` or ``"SAME"`` (XLA's, :func:`same_padding`), ``strides`` and
    an optional bias."""

    def __init__(self, in_channels: int, features: int, window: tuple[int, int],
                 strides: tuple[int, int] = (1, 1), padding: str = "VALID",
                 use_bias: bool = True):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)
        self.kernel = nn.Parameter(torch.zeros(*window, in_channels, features))
        self.window, self.strides, self.padding = tuple(window), tuple(strides), padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.padding == "SAME":
            (h_lo, h_hi), (w_lo, w_hi) = (same_padding(n, k, s) for n, k, s in
                                          zip(x.shape[-2:], self.window, self.strides))
            if h_lo == h_hi and w_lo == w_hi:
                pad = (h_lo, w_lo)
            else:
                x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, self.strides, pad)


# Set by the data-parallel MAP step in each shard's thread: a train-mode
# BatchNorm then normalises with the moments of the whole batch, as Flax's
# BatchNorm does under the reference's SPMD program.
_BATCH_MOMENTS = contextvars.ContextVar("batch_moments", default=None)


@contextlib.contextmanager
def batch_moments(reduce: Callable):
    """Within the block (and this thread), every train-mode
    :class:`BatchNorm` passes its shard's channel moments ``(E[x], E[x²],
    count)`` to ``reduce`` and normalises with the ``(E[x], E[x²])`` it
    returns: those of the whole batch."""
    token = _BATCH_MOMENTS.set(reduce)
    try:
        yield
    finally:
        _BATCH_MOMENTS.reset(token)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the channel axis of NCHW activations
    (``momentum`` 0.99, ``epsilon`` 1e-5).

    Eval mode normalises with the stored statistics. Train mode normalises
    with the batch's mean and biased variance over (N, H, W), computed as
    Flax does (``E[x²] − E[x]²``, clipped at 0), and writes
    ``momentum·old + (1 − momentum)·batch`` into the ``mean`` and ``var``
    buffers — with the biased variance, where ``F.batch_norm``'s running update
    would use the unbiased one. Under ``torch.func.functional_call`` those
    buffers are the tensors the caller passed in. Inside :func:`batch_moments`
    the moments are the whole batch's, across the shards.
    """

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = nn.Parameter(torch.ones(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.epsilon = momentum, epsilon

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, mean2 = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
            reduce = _BATCH_MOMENTS.get()
            if reduce is not None:
                mean, mean2 = reduce(mean, mean2, x.numel() // x.shape[1])
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1.0 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
