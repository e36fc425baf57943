"""SYRK ``C = A Aᵀ`` in true FP32: the hand-written Hopper kernel and its plain
version.

Replaces the Pallas kernel ``_syrk_pallas``
(``laplace_inducing_points_tpu/ops/pallas/syrk.py:71``). The kernel is
``csrc/syrk.cu``: one block per lower-triangle 64×64 tile, the whole
contraction axis looped inside the block, FFMA with a Kahan-compensated
two-level sum, and a mirrored epilogue that makes ``C`` exactly symmetric.
Its source note says what bounds it on an H100.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)


def syrk_plain(A: torch.Tensor) -> torch.Tensor:
    """``A Aᵀ`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, A.T)


def syrk(A: torch.Tensor) -> torch.Tensor:
    """Gram ``A Aᵀ`` of a ``(d, D)`` f32 matrix, ``(d, d)`` and symmetric."""
    check_matrix("A", A)
    if A.device.type == "cpu":
        return syrk_plain(A)
    d, D = A.shape
    C = torch.empty((d, d), dtype=torch.float32, device=A.device)
    lib = load_library()
    with torch.cuda.device(A.device):
        status = lib.lip_syrk_f32(A.data_ptr(), C.data_ptr(), d, D, stream_of(A))
    raise_on_status(status, "syrk")
    syrk.launches += 1
    return C


syrk.launches = 0
