"""Long-contraction FP32 products ``A Bᵀ`` and ``A B``: the hand-written Hopper
kernels and their plain versions.

* ``matmul_nt`` replaces ``_matmul_nt_pallas``
  (``laplace_inducing_points_tpu/ops/pallas/matmul.py:68``): ``(m, D)·(n, D)ᵀ``
  contracting the long shared axis without forming ``Bᵀ`` — the sample
  projection ``U = ε Rᵀ``.
* ``matmul_nn`` replaces ``_matmul_nn_pallas``
  (``laplace_inducing_points_tpu/ops/pallas/matmul.py:153``): a small
  ``(m, z)`` times a long ``(z, D)`` — the sample push-back ``(·) R``.

Both kernels live in ``csrc/matmul.cu`` (64×64 output tiles, 32-wide
contraction strips in shared memory, FFMA with a Kahan-compensated two-level
sum; the source note says what bounds them on an H100). On a CPU tensor the
wrappers compute the plain version; on a CUDA tensor they launch the kernel
or raise.
"""

from __future__ import annotations

import torch

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)


def _check_pair(A: torch.Tensor, B: torch.Tensor) -> None:
    check_matrix("A", A)
    check_matrix("B", B)
    if A.device != B.device:
        raise ValueError(f"A is on {A.device} but B is on {B.device}")


def matmul_nt_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, B.T)


def matmul_nn_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` through ``torch.matmul`` (f32; TF32 must be off on CUDA)."""
    return torch.matmul(A, B)


def matmul_nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` for ``A (m, D)`` and ``B (n, D)``: ``(m, n)``."""
    _check_pair(A, B)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"contraction mismatch: {tuple(A.shape)} x {tuple(B.shape)}ᵀ")
    if A.device.type == "cpu":
        return matmul_nt_plain(A, B)
    (m, D), n = A.shape, B.shape[0]
    C = torch.empty((m, n), dtype=torch.float32, device=A.device)
    lib = load_library()
    with torch.cuda.device(A.device):
        status = lib.lip_matmul_nt_f32(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                       m, n, D, stream_of(A))
    raise_on_status(status, "matmul_nt")
    matmul_nt.launches += 1
    return C


def matmul_nn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` for ``A (m, z)`` and ``B (z, D)``: ``(m, D)``."""
    _check_pair(A, B)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(A.shape)} x {tuple(B.shape)}")
    if A.device.type == "cpu":
        return matmul_nn_plain(A, B)
    (m, z), D = A.shape, B.shape[1]
    C = torch.empty((m, D), dtype=torch.float32, device=A.device)
    lib = load_library()
    with torch.cuda.device(A.device):
        status = lib.lip_matmul_nn_f32(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                       m, z, D, stream_of(A))
    raise_on_status(status, "matmul_nn")
    matmul_nn.launches += 1
    return C


matmul_nt.launches = 0
matmul_nn.launches = 0
