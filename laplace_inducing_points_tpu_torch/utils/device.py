"""Device resolution, the f32 precision policy and the convolution policy.

There is no silent default to the CPU: asking for ``cuda`` on a machine
without a GPU raises.

The precision contract of the reference (``pdot``,
``laplace_inducing_points_tpu/core/operators.py:44``): Gram, posterior
algebra and posterior-sample contractions run in true f32. On CUDA, PyTorch
lets cuDNN run f32 convolutions in TF32 by default (about three decimal
digits), which would put LeNet5's jvp/jacrev in TF32; ``set_f32_policy``
turns TF32 off for both matmuls and convolutions. The entry points call it.

With TF32 off cuDNN still picks its algorithm by shape, and at some shapes
(small example blocks, the batch folding of ``vmap``) it takes Winograd or FFT
transforms whose float32 error is far above round-off, and engines whose
weight gradients differ from run to run. :func:`set_conv_policy` excludes
both: ``torch.backends.cudnn.deterministic`` drops the nondeterministic
engines, and ``cudnn_errata.json`` (read by cuDNN's frontend through
``CUDNN_ERRATA_JSON_FILE`` when the process builds its first convolution
plan) blocks the Winograd and FFT engines by their ids. ``models.layers.Conv``
applies it wherever a convolution runs; the entry points apply it first.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

CUDNN_ERRATA = Path(__file__).resolve().with_name("cudnn_errata.json")


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name``; ``cuda`` without a usable GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r}: use 'cpu' or 'cuda'")
    return device


def set_f32_policy() -> str:
    """Turn TF32 off for CUDA matmuls and apply the convolution policy
    (:func:`set_conv_policy`); returns a line that says so, for the entry
    point to print."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    set_conv_policy()
    return ("[precision] f32 policy: TF32 off "
            f"(cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}); convolutions: cuDNN "
            f"deterministic={torch.backends.cudnn.deterministic}, Winograd and FFT engines "
            f"blocked ({CUDNN_ERRATA.name})")


def set_conv_policy() -> None:
    """Keep every cuDNN float32 convolution at round-off and deterministic:
    TF32 off, deterministic engines only, no autotuning, and the Winograd and
    FFT engines of ``cudnn_errata.json`` blocked.

    cuDNN reads the errata file once, when the process builds its first
    convolution plan, so the variable must name it before then: this sets it
    when it is unset and raises when it names another file."""
    named = os.environ.get("CUDNN_ERRATA_JSON_FILE")
    if named is None:
        os.environ["CUDNN_ERRATA_JSON_FILE"] = str(CUDNN_ERRATA)
    elif named != str(CUDNN_ERRATA):
        raise RuntimeError(
            f"CUDNN_ERRATA_JSON_FILE names {named}: the port's convolution policy needs "
            f"{CUDNN_ERRATA} (cuDNN reads one errata file per process)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
