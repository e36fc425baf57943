"""GGN probe sweep ``scale·(V Rᵀ) R`` at estimator precision: the hand-written
Hopper kernel, its plain version and its gradient.

Replaces ``ggn_sweep`` (``laplace_inducing_points_tpu/ops/pallas/matmul.py:213``):
``_matmul_nt_pallas`` then ``_matmul_nn_pallas`` at the estimator precision
DEFAULT, one reduced-precision pass with f32 accumulation. The kernel is
``csrc/ggn_sweep.cu``: TF32 tensor-core products (``mma.sync`` m16n8k8, inputs
rounded with ``cvt.rna.tf32.f32``) with FP32 accumulators, the first stage
``T = V Rᵀ`` split across blocks along D and summed in a second pass, the
second ``Y = scale·T R`` over (P, D) output tiles. Its source note says what
bounds it on an H100 and why TF32 is allowed here and nowhere else in the port.

``precision="highest"`` keeps the reference's argument: the sweep then runs
through the true-FP32 ``matmul_nt`` and ``matmul_nn`` kernels.

The wrapper is a ``torch.autograd.Function``. The GGN is symmetric, so
``dV = ggn_sweep(Ĉ, R, scale)``, the same TF32 kernel;
``dR = scale·(Tᵀ Ĉ + (Ĉ Rᵀ)ᵀ V)`` runs through the FP32 NT/NN kernels and only
when ``R`` needs a gradient. ``ggn_sweep.launches`` counts the forward's kernel
launches, ``ggn_sweep.backward_launches`` those of its backward.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from laplace_inducing_points_tpu_torch.ops.cuda._build import (check_matrix,
                                                               load_library,
                                                               raise_on_status,
                                                               stream_of)
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import (matmul_nn,
                                                               matmul_nn_plain,
                                                               matmul_nt,
                                                               matmul_nt_plain, nn, nt)

TILE = 64                 # output tile edge of both stages
MIN_SPLIT_DEPTH = 1024    # the least D a stage-1 block contracts


def ggn_sweep_plain(V: torch.Tensor, R: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``scale·(V Rᵀ) R`` through ``torch.matmul`` (f32; TF32 must be off on
    CUDA)."""
    return scale * torch.matmul(torch.matmul(V, R.T), R)


def sweep_splits(P: int, d: int, D: int, sms: int) -> int:
    """How many blocks share the D axis of ``T = V Rᵀ``: enough for about four
    blocks per SM over the ``ceil(P/64)·ceil(d/64)`` output tiles, and no
    block contracting fewer than ``MIN_SPLIT_DEPTH`` of D."""
    tiles = math.ceil(P / TILE) * math.ceil(d / TILE)
    return max(1, min(math.ceil(4 * sms / tiles), math.ceil(D / MIN_SPLIT_DEPTH)))


def _sweep(V: torch.Tensor, R: torch.Tensor, scale: float):
    """``(scale·T R, T)`` with ``T = V Rᵀ`` of checked operands: the plain
    version on the CPU, one launch of the TF32 kernel on CUDA. Counts
    nothing and records no gradient."""
    if V.device.type == "cpu":
        T = matmul_nt_plain(V, R)
        return scale * matmul_nn_plain(T, R), T
    (P, D), d = V.shape, R.shape[0]
    splits = sweep_splits(P, d, D, torch.cuda.get_device_properties(V.device)
                          .multi_processor_count)
    T = torch.empty((P, d), dtype=torch.float32, device=V.device)
    part = T if splits == 1 else torch.empty((splits, P, d), dtype=torch.float32,
                                             device=V.device)
    Y = torch.empty((P, D), dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        status = load_library().lip_ggn_sweep_tf32(
            V.data_ptr(), R.data_ptr(), part.data_ptr(), T.data_ptr(), Y.data_ptr(),
            P, d, D, splits, scale, stream_of(V))
    raise_on_status(status, "ggn_sweep")
    return Y, T


def ggn_sweep_vjp(V, R, T, scale: float, ct, need_v: bool = True, need_r: bool = True):
    """Cotangents of ``Y = scale·(V Rᵀ) R``: ``dV = scale·(Ĉ Rᵀ) R`` (the sweep
    itself) and ``dR = scale·(Tᵀ Ĉ + (Ĉ Rᵀ)ᵀ V)`` (one NT and two NN products
    over the long axis); a gradient not needed is not computed."""
    ct = ct.contiguous()
    dV = _sweep(ct, R, scale)[0] if need_v else None
    dR = None
    if need_r:
        U = nt(ct, R)                                           # Ĉ Rᵀ (P, d)
        dR = scale * (nn(T.T.contiguous(), ct) + nn(U.T.contiguous(), V))
    if ct.device.type == "cuda":
        ggn_sweep.backward_launches += int(need_v) + 3 * int(need_r)
    return dV, dR


class _GGNSweep(torch.autograd.Function):
    @staticmethod
    def forward(V, R, scale):
        Y, T = _sweep(V, R, scale)
        if V.device.type == "cuda":
            ggn_sweep.launches += 1
        return Y, T

    @staticmethod
    def setup_context(ctx, inputs, output):
        V, R, scale = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(V, R, output[1])
        ctx.scale = scale

    @staticmethod
    @once_differentiable
    def backward(ctx, ct, _ct_T):
        V, R, T = ctx.saved_tensors
        need_v, need_r, _ = ctx.needs_input_grad
        return (*ggn_sweep_vjp(V, R, T, ctx.scale, ct, need_v, need_r), None)


def ggn_sweep(V: torch.Tensor, R: torch.Tensor, scale: float = 1.0, *,
              precision: Optional[str] = None) -> torch.Tensor:
    """GGN probe sweep ``scale·(V Rᵀ) R`` for probes ``V (P, D)`` and rows
    ``R (d, D)``: ``(P, D)``.

    ``precision``: ``None`` or ``"default"``, the estimator precision (the
    TF32 kernel); ``"highest"``, true FP32 through ``matmul_nt`` then
    ``matmul_nn``.
    """
    check_matrix("V", V)
    check_matrix("R", R)
    if V.device != R.device:
        raise ValueError(f"V is on {V.device} but R is on {R.device}")
    if V.shape[1] != R.shape[1]:
        raise ValueError(f"contraction mismatch: {tuple(V.shape)} x {tuple(R.shape)}ᵀ")
    if precision in (None, "default"):
        return _GGNSweep.apply(V, R, float(scale))[0]
    if precision == "highest":
        return scale * matmul_nn(matmul_nt(V, R), R)
    raise ValueError(f"unknown precision {precision!r}: use 'default' or 'highest'")


ggn_sweep.launches = ggn_sweep.backward_launches = 0
