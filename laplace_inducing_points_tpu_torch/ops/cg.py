"""Batched conjugate gradients: many right-hand sides in one loop, with
implicit gradients.

Counterpart of ``laplace_inducing_points_tpu/ops/cg.py:39-110``. The matfree
paths need ``P`` independent solves against one PSD operator (Hutch++
probes, Matheron draws, healthcheck probes). The right-hand sides are stacked
into a ``(P, d)`` state and the operator is applied as a matmat; each row runs
the textbook Hestenes–Stiefel recurrence and is frozen (a zero step) once its
residual is below ``tol²·‖b‖²``, so every row stops at its own tolerance.

The reference differentiates the solve with ``lax.custom_linear_solve
(symmetric=True)``. Here a ``torch.autograd.Function`` does the same, as
GPyTorch's mBCG does: the backward solves ``A λ = x̄`` with the same operator
and preconditioner, returns ``λ`` for ``B`` and ``−λᵀ (∂A/∂θ) X`` for the
operator's tensors ``θ``, by ``torch.autograd.grad`` of ``matmat(X)``
recomputed with the graph on. The operator's differentiable tensors are
therefore passed in explicitly (``operator_inputs``): a closure alone would
drop their gradient without a word. The preconditioner only steers the
iteration and is never differentiated.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

MatMat = Callable[[torch.Tensor], torch.Tensor]


class CGInfo(NamedTuple):
    """What a solve did: iterations run, and the worst relative recursive
    residual ``max_p ‖r_p‖ / ‖b_p‖`` at exit."""
    iterations: int
    rel_residual: float


def _cg_core(matmat: MatMat, B: torch.Tensor, *, tol: float, maxiter: int,
             precond: Optional[MatMat] = None) -> tuple[torch.Tensor, CGInfo]:
    """The masked batched CG iteration on ``B (P, d)``; ``matmat`` and
    ``precond`` act on ``(P, d)`` row stacks. One host read per iteration
    decides whether any row is still active."""
    prec = precond if precond is not None else (lambda r: r)
    bb = torch.sum(B * B, dim=1)
    atol2 = (tol ** 2) * bb
    X = torch.zeros_like(B)
    R = B.clone()
    Zr = prec(R)
    Pd = Zr
    rz = torch.sum(R * Zr, dim=1)
    k = 0
    while k < maxiter:
        active = torch.sum(R * R, dim=1) > atol2
        if not bool(active.any()):
            break
        Q = matmat(Pd)
        pq = torch.sum(Pd * Q, dim=1)
        pos = pq > 0.0
        # frozen or degenerate rows step by 0: their X and R stay fixed
        a = torch.where(active & pos, rz / torch.where(pos, pq, torch.ones_like(pq)),
                        torch.zeros_like(pq))
        X = X + a[:, None] * Pd
        R = R - a[:, None] * Q
        Zr = prec(R)
        rz_n = torch.sum(R * Zr, dim=1)
        rpos = rz > 0.0
        b = torch.where(rpos, rz_n / torch.where(rpos, rz, torch.ones_like(rz)),
                        torch.zeros_like(rz))
        Pd = Zr + b[:, None] * Pd
        rz = rz_n
        k += 1
    rel = torch.sqrt(torch.sum(R * R, dim=1) / torch.clamp(bb, min=1e-60))
    return X, CGInfo(k, float(torch.max(rel)))


class _CGSolve(torch.autograd.Function):
    """``X = A⁻¹ B`` rowwise, differentiable in ``B`` and in the operator's
    tensors by implicit differentiation (``A`` symmetric)."""

    @staticmethod
    def forward(ctx, matmat, precond, tol, maxiter, info, B, *operator_inputs):
        X, stats = _cg_core(matmat, B, tol=tol, maxiter=maxiter, precond=precond)
        info.append(stats)
        ctx.matmat, ctx.precond, ctx.tol, ctx.maxiter = matmat, precond, tol, maxiter
        ctx.operator_inputs = operator_inputs
        ctx.save_for_backward(X)
        return X

    @staticmethod
    def backward(ctx, gX):
        (X,) = ctx.saved_tensors
        with torch.no_grad():
            lam, _ = _cg_core(ctx.matmat, gX.contiguous(), tol=ctx.tol,
                              maxiter=ctx.maxiter, precond=ctx.precond)
        grads = [None] * len(ctx.operator_inputs)
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[6:]) if need]
        if wanted:
            # retain_graph: the operator may hold tensors whose graph the
            # outer backward still has to run (the factor's f0 at Z)
            with torch.enable_grad():
                AX = ctx.matmat(X.detach())
                got = torch.autograd.grad(AX, [ctx.operator_inputs[i] for i in wanted],
                                          -lam, retain_graph=True, allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (None, None, None, None, None,
                lam if ctx.needs_input_grad[5] else None, *grads)


def cg_batched(matmat: MatMat, B: torch.Tensor, *, tol: float = 1e-5,
               maxiter: Optional[int] = None, precond: Optional[MatMat] = None,
               operator_inputs: Sequence[torch.Tensor] = ()
               ) -> tuple[torch.Tensor, CGInfo]:
    """Solve ``A x_i = b_i`` for every row of ``B (P, d)`` in one loop;
    returns ``(X, CGInfo)``.

    ``matmat`` must be linear in its ``(P, d)`` argument and act rowwise by
    one symmetric PSD ``A``. ``operator_inputs``: the tensors ``A`` depends on
    that need gradients (``Z``, a factor's leaves); ``matmat`` must read them.
    ``precond`` (a rowwise SPD approximate inverse) steers convergence only.
    ``maxiter=None`` is ``10·d``.
    """
    if maxiter is None:
        maxiter = 10 * B.shape[-1]
    info: list = []
    X = _CGSolve.apply(matmat, precond, tol, int(maxiter), info, B, *operator_inputs)
    return X, info[0]
