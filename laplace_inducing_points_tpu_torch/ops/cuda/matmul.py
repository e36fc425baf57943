"""Long-contraction FP32 products ``A Bᵀ`` and ``A B``: the hand-written Hopper
kernels, their plain versions and their gradients.

* ``matmul_nt`` replaces ``_matmul_nt_pallas``
  (``laplace_inducing_points_tpu/ops/pallas/matmul.py:68``): ``(m, D)·(n, D)ᵀ``
  contracting the long shared axis without forming ``Bᵀ`` — the sample
  projection ``U = ε Rᵀ`` and the cross-Gram ``Gxz = Rx Rzᵀ``.
* ``matmul_nn`` replaces ``_matmul_nn_pallas``
  (``laplace_inducing_points_tpu/ops/pallas/matmul.py:153``): a small
  ``(m, z)`` times a long ``(z, D)`` — the sample push-back ``(·) R`` and the
  backward passes of ``syrk`` and ``matmul_nt``.

Both kernels live in ``csrc/matmul.cu`` (64×64 output tiles, 32-wide
contraction strips in shared memory, FFMA with a Kahan-compensated two-level
sum; the source note says what bounds them on an H100). On a CPU tensor the
wrappers compute the plain version; on a CUDA tensor they launch the kernel
or raise.

Each wrapper is a ``torch.autograd.Function`` with the reference's custom VJP
(``_matmul_nt_bwd`` ``:105``, ``_matmul_nn_bwd`` ``:190``). The backward
contractions run over the same long axis, so they go through the same true-f32
kernels, never ``torch.matmul``; only the short operand is ever transposed into
a contiguous copy. ``wrapper.launches`` counts the forward's kernel launches,
``wrapper.backward_launches`` those of its backward.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

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


def nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` of checked operands: the plain version on the CPU, one launch
    of the NT kernel on CUDA. Counts nothing and records no gradient."""
    if A.device.type == "cpu":
        return matmul_nt_plain(A, B)
    (m, D), n = A.shape, B.shape[0]
    C = torch.empty((m, n), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        status = load_library().lip_matmul_nt_f32(A.data_ptr(), B.data_ptr(),
                                                  C.data_ptr(), m, n, D, stream_of(A))
    raise_on_status(status, "matmul_nt")
    return C


def nn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` of checked operands: the plain version on the CPU, one launch
    of the NN kernel on CUDA. Counts nothing and records no gradient."""
    if A.device.type == "cpu":
        return matmul_nn_plain(A, B)
    (m, z), D = A.shape, B.shape[1]
    C = torch.empty((m, D), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        status = load_library().lip_matmul_nn_f32(A.data_ptr(), B.data_ptr(),
                                                  C.data_ptr(), m, z, D, stream_of(A))
    raise_on_status(status, "matmul_nn")
    return C


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def matmul_nt_vjp(A, B, ct, need_a: bool = True, need_b: bool = True):
    """Cotangents of ``C = A Bᵀ``: ``dA = Ĉ B``, ``dB = Ĉᵀ A``, each one NN
    product over the long axis; a gradient not needed is not computed."""
    ct = ct.contiguous()
    dA = nn(ct, B) if need_a else None
    dB = nn(ct.T.contiguous(), A) if need_b else None
    if _on_cuda(ct):
        matmul_nt.backward_launches += int(need_a) + int(need_b)
    return dA, dB


def matmul_nn_vjp(A, B, ct, need_a: bool = True, need_b: bool = True):
    """Cotangents of ``C = A B``: ``dA = Ĉ Bᵀ`` (an NT product over the long
    axis) and ``dB = Aᵀ Ĉ`` (an NN product)."""
    ct = ct.contiguous()
    dA = nt(ct, B) if need_a else None
    dB = nn(A.T.contiguous(), ct) if need_b else None
    if _on_cuda(ct):
        matmul_nn.backward_launches += int(need_a) + int(need_b)
    return dA, dB


class _MatmulNT(torch.autograd.Function):
    @staticmethod
    def forward(A, B):
        C = nt(A, B)
        if _on_cuda(A):
            matmul_nt.launches += 1
        return C

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return matmul_nt_vjp(*ctx.saved_tensors, ct, *ctx.needs_input_grad)


class _MatmulNN(torch.autograd.Function):
    @staticmethod
    def forward(A, B):
        C = nn(A, B)
        if _on_cuda(A):
            matmul_nn.launches += 1
        return C

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return matmul_nn_vjp(*ctx.saved_tensors, ct, *ctx.needs_input_grad)


def matmul_nt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A Bᵀ`` for ``A (m, D)`` and ``B (n, D)``: ``(m, n)``."""
    _check_pair(A, B)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"contraction mismatch: {tuple(A.shape)} x {tuple(B.shape)}ᵀ")
    return _MatmulNT.apply(A, B)


def matmul_nn(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A B`` for ``A (m, z)`` and ``B (z, D)``: ``(m, D)``."""
    _check_pair(A, B)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(A.shape)} x {tuple(B.shape)}")
    return _MatmulNN.apply(A, B)


matmul_nt.launches = matmul_nt.backward_launches = 0
matmul_nn.launches = matmul_nn.backward_launches = 0
