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

A policy set too late is out of force without a sign: a process that built a
cuDNN convolution plan before the variable was set runs without the errata,
and a cuDNN that numbers its engines other than 9.2 does not block them. So
the first time the policy is applied on a CUDA device in a process,
:func:`check_conv_policy` runs a probe convolution at a shape where cuDNN's
own choice is Winograd and raises if its float32 result is not at round-off.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

CUDNN_ERRATA = Path(__file__).resolve().with_name("cudnn_errata.json")

# The probe: LeNet5's second convolution, (4, 6, 14, 14) * (16, 6, 5, 5),
# through a fixed map to 10 outputs, its weight Jacobian by vmap over the 4
# examples of jacrev, as the rows of a block of 4 build it. cuDNN's own choice
# runs it on winograd_nonfused, 2.4e-4 from float64; under the policy it reads
# 7.7e-8 (NVIDIA H100, cuDNN 9.2; chip_smoke.py phase 32). The limit sits
# between: 130x the policy's error, a twenty-fourth of Winograd's.
PROBE_LIMIT = 1e-5
# CUDA device ("cuda:0") -> (the probe's error, its seconds) once it passed in
# this process: the policy is process state, and so is its check
PROBED: dict[str, tuple[float, float]] = {}


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name``; ``cuda`` without a usable GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r}: use 'cpu' or 'cuda'")
    return device


def set_f32_policy(device: Optional[torch.device] = None) -> str:
    """Turn TF32 off for CUDA matmuls and apply the convolution policy
    (:func:`set_conv_policy`, checked on ``device`` when it is a CUDA
    device); returns a line that says so, for the entry point to print."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    set_conv_policy(device)
    return ("[precision] f32 policy: TF32 off "
            f"(cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}); convolutions: cuDNN "
            f"deterministic={torch.backends.cudnn.deterministic}, Winograd and FFT engines "
            f"blocked ({CUDNN_ERRATA.name})")


def set_conv_policy(device: Optional[torch.device] = None) -> None:
    """Keep every cuDNN float32 convolution at round-off and deterministic:
    TF32 off, deterministic engines only, no autotuning, and the Winograd and
    FFT engines of ``cudnn_errata.json`` blocked.

    cuDNN reads the errata file once, when the process builds its first
    convolution plan, so the variable must name it before then: this sets it
    when it is unset and raises when it names another file. On a CUDA
    ``device`` the first call of the process checks that the policy is in
    force (:func:`check_conv_policy`, raises if not); on the CPU, where cuDNN
    does not run, nothing is checked."""
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
    if device is not None and device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        if f"cuda:{index}" not in PROBED:
            check_conv_policy(torch.device("cuda", index))


def probe_error(device: torch.device) -> float:
    """The probe convolution's float32 result on ``device`` (under the cuDNN
    settings in force) against the same computation in float64 with cuDNN
    off, relative Frobenius; whatever the caller's grad mode, inference mode
    or autocast."""
    from torch.func import jacrev, vmap
    rng = np.random.default_rng(0)       # numpy: torch's draws refuse an enclosing vmap
    x, w, A = (torch.from_numpy(a) for a in (
        rng.random((4, 6, 14, 14)), 0.2 * rng.standard_normal((16, 6, 5, 5)),
        rng.standard_normal((10, 16 * 10 * 10)) / 40.0))

    def jacobian(dtype):
        xd, wd, Ad = (t.to(device, dtype) for t in (x, w, A))
        return vmap(jacrev(lambda ww, xi: Ad @ F.conv2d(xi[None], ww).reshape(-1)),
                    in_dims=(None, 0))(wd, xd)

    with torch.inference_mode(False), torch.enable_grad(), \
            torch.autocast(device.type, enabled=False):
        got = jacobian(torch.float32)
        with torch.backends.cudnn.flags(enabled=False, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            ref = jacobian(torch.float64)
    return float(torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref))


def check_conv_policy(device: torch.device) -> float:
    """Run the probe on ``device`` and raise ``RuntimeError`` when its error
    is above ``PROBE_LIMIT``: the policy is not in force there, and nothing
    falls back. Records the error and the seconds in ``PROBED``; returns the
    error."""
    start = time.perf_counter()
    err = probe_error(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - start
    if not err <= PROBE_LIMIT:
        raise RuntimeError(
            f"the convolution policy is not in force on {device}: its probe convolution "
            f"reads {err:.1e} from float64, above the limit {PROBE_LIMIT:g} (under the policy "
            "~7e-8, on cuDNN's Winograd engines ~2e-4). Likely causes: a cuDNN convolution "
            "ran in this process before CUDNN_ERRATA_JSON_FILE named "
            f"{CUDNN_ERRATA} (cuDNN reads it at its first convolution plan: import the port "
            "and call utils.device.set_f32_policy() before any other convolution, or start "
            "the process with the variable set), or this cuDNN "
            f"({torch.backends.cudnn.version()}) numbers its engines other than cuDNN 9.2, "
            "whose engine ids the errata file lists")
    PROBED[str(device)] = (err, seconds)
    return err
