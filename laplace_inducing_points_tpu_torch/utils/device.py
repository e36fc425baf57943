"""Device resolution and the f32 precision policy.

There is no silent default to the CPU: asking for ``cuda`` on a machine
without a GPU raises.

The precision contract of the reference (``pdot``,
``laplace_inducing_points_tpu/core/operators.py:44``): Gram, posterior
algebra and posterior-sample contractions run in true f32. On CUDA, PyTorch
lets cuDNN run f32 convolutions in TF32 by default (about three decimal
digits), which would put LeNet5's jvp/jacrev in TF32; ``set_f32_policy``
turns TF32 off for both matmuls and convolutions. The entry points call it.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name``; ``cuda`` without a usable GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r}: use 'cpu' or 'cuda'")
    return device


def set_f32_policy() -> str:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions; returns a line
    that says so, for the entry point to print."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return ("[precision] f32 policy: TF32 off "
            f"(cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
