"""SYRK ``C = A Aᵀ`` in true FP32: the hand-written Hopper kernel, its plain
version and its gradient.

Replaces the Pallas kernel ``_syrk_pallas``
(``laplace_inducing_points_tpu/ops/pallas/syrk.py:71``). The kernel is
``csrc/syrk.cu``: one block per lower-triangle 64×64 tile, the whole
contraction axis looped inside the block, FFMA with a Kahan-compensated
two-level sum, and a mirrored epilogue that makes ``C`` exactly symmetric.
Its source note says what bounds it on an H100.

The wrapper is a ``torch.autograd.Function`` with the reference's custom VJP
(``_syrk_diff_bwd``, ``syrk.py:122``): ``dA = (Ĉ + Ĉᵀ) A``, one launch of the
NN kernel of ``csrc/matmul.cu`` over the long axis. ``syrk.launches`` counts
the forward's launches, ``syrk.backward_launches`` the backward's.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import nn


def syrk_plain(A: torch.Tensor) -> torch.Tensor:
    """``A Aᵀ`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, A.T)


def syrk_vjp(A: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``C = A Aᵀ``: ``dA = (Ĉ + Ĉᵀ) A``."""
    dA = nn((ct + ct.T).contiguous(), A)
    if A.device.type == "cuda":
        syrk.backward_launches += 1
    return dA


class _Syrk(torch.autograd.Function):
    @staticmethod
    def forward(A):
        if A.device.type == "cpu":
            return syrk_plain(A)
        d, D = A.shape
        C = torch.empty((d, d), dtype=torch.float32, device=A.device)
        with torch.cuda.device(A.device):
            status = load_library().lip_syrk_f32(A.data_ptr(), C.data_ptr(), d, D,
                                                 stream_of(A))
        raise_on_status(status, "syrk")
        syrk.launches += 1
        return C

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return syrk_vjp(*ctx.saved_tensors, ct)


def syrk(A: torch.Tensor) -> torch.Tensor:
    """Gram ``A Aᵀ`` of a ``(d, D)`` f32 matrix, ``(d, d)`` and symmetric."""
    check_matrix("A", A)
    return _Syrk.apply(A)


syrk.launches = syrk.backward_launches = 0
