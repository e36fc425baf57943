"""Every input of a run, made from ``--seed`` on the run's device: the weights,
the BatchNorm statistics, the synthetic images, and a generator per purpose.
The program and the reference are handed the same tensors."""

from __future__ import annotations

import math

import torch

# one independent stream of random numbers per purpose
WEIGHTS, IMAGES, TEST_IMAGES, DRAWS, WARMUP, SAMPLE, KERNELS = range(7)


def generator(device: torch.device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    """A generator on ``device`` for one purpose (and one request) of a run;
    ``seed`` may be any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream * 7919 + index * 104729) % 2**63)
    return g


def weights(net, seed: int, device: torch.device) -> torch.Tensor:
    """The flat float32 weights in ``net.LEAVES`` order, lecun-normal: each
    kernel ``N(0, 1/fan_in)`` with ``fan_in`` the product of all but its last
    axis, BatchNorm scales 1, biases 0. One draw on the device."""
    D = sum(math.prod(shape) for _, shape in net.LEAVES)
    flat = torch.randn(D, generator=generator(device, seed, WEIGHTS), device=device)
    offset = 0
    for path, shape in net.LEAVES:
        size = math.prod(shape)
        leaf = flat[offset:offset + size]
        if path[-1] == "kernel":
            leaf.mul_(1.0 / math.sqrt(math.prod(shape[:-1])))
        else:
            leaf.fill_(1.0 if path[-1] == "scale" else 0.0)
        offset += size
    return flat


def batch_stats(net, device: torch.device) -> dict:
    """Each BatchNorm's statistics at their initial values: mean 0, variance
    1, keyed ``"<layer>.mean"`` and ``"<layer>.var"``."""
    out = {}
    for name, channels in net.STATS:
        out[f"{name}.mean"] = torch.zeros(channels, device=device)
        out[f"{name}.var"] = torch.ones(channels, device=device)
    return out


def images(n: int, shape, num_classes: int, seed: int, stream: int,
           device: torch.device) -> torch.Tensor:
    """``(n, h, w, c)`` synthetic images in [0, 1]: each of ``num_classes``
    classes a smooth spatial pattern ``0.5 + 0.5 sin(f x + phi) cos(f y - phi)``
    (``f = 0.2 + 0.15 k``, ``phi = 0.7 k``), plus noise of deviation 0.15,
    clipped; the class of each image drawn uniformly."""
    h, w, c = shape
    g = generator(device, seed, stream)
    y = torch.randint(0, num_classes, (n,), generator=g, device=device)
    k = torch.arange(num_classes, device=device, dtype=torch.float32)[:, None, None]
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    freq, phase = 0.2 + 0.15 * k, 0.7 * k
    patterns = 0.5 + 0.5 * torch.sin(freq * xx + phase) * torch.cos(freq * yy - phase)
    x = patterns[y][..., None].expand(n, h, w, c)
    noise = torch.randn((n, h, w, c), generator=g, device=device)
    return torch.clamp(x + 0.15 * noise, 0.0, 1.0).contiguous()
