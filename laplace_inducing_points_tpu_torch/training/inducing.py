"""Inducing-point optimization on the exact Gram KL: learn ``Z`` by minimizing
``KL[q(θ|Z) ‖ q(θ|D)]``.

Counterpart of the gram path of
``laplace_inducing_points_tpu/training/inducing.py``: ``_grams`` (``:62``),
``_pivot_jitter`` (``:72``), ``_kl_core`` (``:87``), ``kl_objective_gram``
(``:124``), ``optimize_step`` (``:684``) for the ``gram`` objective,
``full_set_kl`` (``:724``) and ``train_inducing_points`` (``:795``) with its
divergence guard. The dense, stochastic and matfree objectives and the
restarts wait for later slices (ROADMAP, Queue A).

The Gram ``Gzz = Rz Rzᵀ`` goes through the ``syrk`` kernel and the cross-Gram
``Gxz = Rx Rzᵀ`` through ``matmul_nt``; their backward passes are kernels too
(``ops/cuda``). A step computes ``dL/dZ`` the way the reference's chunked
gradient does (``kl_grad_gram_chunked``, ``:627``), in eager form: the rows
without a tape, ``∂L/∂Rz`` by autograd through the small Gram algebra and the
kernels, then the row build's pullback one example block at a time
(``core.operators.dense_wt_pullback``). :func:`kl_objective_gram` stays
differentiable end to end, as the reference's is.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array

NOT_PORTED = ("the {!r} objective is not ported yet (ROADMAP, Queue A): "
              "only 'gram' is")


def grams_from_rows(Rz: torch.Tensor, Rx: torch.Tensor):
    """``(Gzz, Gxz, tr Gxx, D)`` from the unscaled rows."""
    return syrk(Rz), matmul_nt(Rx, Rz), torch.sum(Rx * Rx), Rz.shape[1]


def _grams(state, Z: torch.Tensor, X: torch.Tensor, example_block: Optional[int] = None):
    """Unscaled Gram blocks through materialized ``Lᵀ J`` rows."""
    Rz = ops.dense_wt(state, Z, example_block=example_block)     # (d_z, D)
    Rx = ops.dense_wt(state, X, example_block=example_block)     # (d_x, D)
    return grams_from_rows(Rz, Rx)


def _pivot_jitter(C: torch.Tensor) -> torch.Tensor:
    """Cholesky pivot-safety jitter for a theoretically-PD matrix: 2e-6 times
    the Gershgorin bound on λ_max (f32 round-off perturbs the spectrum by
    O(ε·λ_max); see the reference's note)."""
    return 2e-6 * torch.max(torch.sum(torch.abs(C), dim=1))


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all NaN where ``A`` is not positive definite.

    ``torch.linalg.cholesky`` raises there, while the reference's factor turns
    NaN and the NaN loss is what stops ``train_inducing_points``. The check
    stays on the device: no host sync per step.
    """
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, math.nan))


def _kl_core(Gzz, Gxz, tr_Gxx, D: int, alpha: float, beta: float, gamma: float,
             include_constants: bool = True) -> torch.Tensor:
    """KL value from the small Gram blocks.

    With β=N/M, γ=N/K, Mᵢ = β⁻¹I + α⁻¹Gzz:

      trace  = D + γα⁻¹tr(Gxx) − α⁻¹tr(Mᵢ⁻¹Gzz) − γα⁻²tr(Gxz Mᵢ⁻¹ Gxzᵀ)
      logdet = D·log α + logdet(I + (β/α)·Gzz)

    in the reference's C-form, ``C = Gzz + (α/β)I = αMᵢ``, which keeps every
    factored matrix at the Gram's own scale.
    """
    a_inv = 1.0 / alpha
    d_z = Gzz.shape[0]
    eye = torch.eye(d_z, dtype=Gzz.dtype, device=Gzz.device)
    C = Gzz + (alpha / beta) * eye
    L = _cholesky(ops.ensure_symmetry(C, jitter=0.0) + _pivot_jitter(C) * eye)
    C_inv_Gzz = torch.cholesky_solve(Gzz, L)
    C_inv_Gxz_t = torch.cholesky_solve(Gxz.T, L)

    trace_term = (-torch.trace(C_inv_Gzz)
                  - gamma * a_inv * torch.sum(Gxz.T * C_inv_Gxz_t))
    # logdet(I + (β/α)Gzz) = d_z·log(β/α) + logdet(C), via the Cholesky
    logdet_term = (d_z * math.log(beta * a_inv)
                   + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    if include_constants:
        trace_term = trace_term + D + gamma * a_inv * tr_Gxx
        logdet_term = logdet_term + D * math.log(alpha)
    return trace_term + logdet_term


def _calibration(M: int, n_x: int, full_set_size: Optional[int]) -> tuple[float, float]:
    """``(β, γ) = (N/M, N/|X|)``."""
    N = full_set_size or M
    return N / M, N / n_x


def kl_objective_gram(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                      full_set_size: Optional[int] = None,
                      include_constants: bool = True,
                      example_block: Optional[int] = None) -> torch.Tensor:
    """Exact KL through the small Grams, differentiable in ``Z``.

    Z-independent constants are kept by default, as in the reference, so the
    value matches the dense KL.
    """
    beta, gamma = _calibration(Z.shape[0], X.shape[0], full_set_size)
    return _kl_core(*_grams(state, Z, X, example_block), alpha, beta, gamma,
                    include_constants)


def kl_rows_value_and_grad(Rz: torch.Tensor, Rx: torch.Tensor, alpha: float,
                           beta: float, gamma: float,
                           include_constants: bool = True):
    """``(KL, ∂KL/∂Rz)`` for fixed rows: the Gram algebra forward and its
    backward, which runs the kernels' backward passes (``Rx`` needs none)."""
    Rz = Rz.detach().requires_grad_()
    with torch.enable_grad():
        loss = _kl_core(*grams_from_rows(Rz, Rx.detach()), alpha, beta, gamma,
                        include_constants)
        (ct,) = torch.autograd.grad(loss, Rz)
    return loss.detach(), ct


def kl_value_and_grad_gram(Z: torch.Tensor, X: torch.Tensor, state, alpha: float, *,
                           full_set_size: Optional[int] = None,
                           include_constants: bool = True,
                           example_block: Optional[int] = None):
    """``(KL, dKL/dZ)`` of :func:`kl_objective_gram`, staged: rows, Gram
    algebra and its backward, row pullback in blocks of ``example_block``."""
    beta, gamma = _calibration(Z.shape[0], X.shape[0], full_set_size)
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z, example_block=example_block)
        Rx = ops.dense_wt(state, X, example_block=example_block)
    loss, ct = kl_rows_value_and_grad(Rz, Rx, alpha, beta, gamma, include_constants)
    del Rz, Rx
    return loss, ops.dense_wt_pullback(state, Z, ct, example_block=example_block)


def make_optimizer(Z: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam on ``Z`` as ``optax.adam(lr)`` sets it up (ε = 1e-8 added to √v̂)."""
    return torch.optim.Adam([Z], lr=lr, eps=1e-8)


def optimize_step(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                  optimizer: torch.optim.Optimizer, *, objective: str = "gram",
                  full_set_size: Optional[int] = None,
                  example_block: Optional[int] = None) -> torch.Tensor:
    """One gradient step on ``Z``, in place; returns the loss at the ``Z``
    it started from. ``optimizer`` holds ``Z`` (:func:`make_optimizer`)."""
    if objective != "gram":
        raise NotImplementedError(NOT_PORTED.format(objective))
    loss, grad = kl_value_and_grad_gram(Z, X, state, alpha,
                                        full_set_size=full_set_size,
                                        example_block=example_block)
    Z.grad = grad
    optimizer.step()
    Z.grad = None
    return loss


@torch.no_grad()
def full_set_kl(Z: torch.Tensor, X_full: torch.Tensor, state, alpha: float,
                full_set_size: Optional[int] = None) -> float:
    """Exact gram KL of a candidate ``Z`` against the full training set (the
    restart-selection criterion; deterministic)."""
    return float(kl_objective_gram(Z, X_full, state, alpha,
                                   full_set_size=full_set_size))


def train_inducing_points(state, z_init: torch.Tensor, batches: Iterable, *,
                          alpha: float, num_steps: int, lr: float,
                          full_set_size: Optional[int] = None,
                          objective: str = "gram",
                          example_block: Optional[int] = None,
                          callback: Optional[Callable] = None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_name: str = "ind",
                          checkpoint_every: int = 100) -> torch.Tensor:
    """Optimize ``Z`` with Adam(``lr``) against minibatches ``(x, y)`` (numpy
    or tensors; moved to ``z_init``'s device).

    Divergence guard: the loss and ``Z`` are checked every 10 steps, at the
    last step, and at every step when there is a ``callback``
    (``callback(step, Z, loss)``); on a non-finite one the last ``Z`` that
    passed a check is returned, never a NaN ``Z``.
    """
    if objective != "gram":
        raise NotImplementedError(NOT_PORTED.format(objective))
    Z = z_init.detach().clone()
    optimizer = make_optimizer(Z, lr)
    it = iter(batches)
    last_finite_Z = Z.clone()
    for step in range(num_steps):
        x_batch, _ = next(it)
        x = torch.as_tensor(x_batch, dtype=torch.float32, device=Z.device)
        loss = optimize_step(Z, x, state, alpha, optimizer, objective=objective,
                             full_set_size=full_set_size,
                             example_block=example_block)
        check = step % 10 == 0 or step == num_steps - 1
        if check or callback is not None:
            loss_f = float(loss)
            if not (math.isfinite(loss_f) and bool(torch.isfinite(Z).all())):
                print(f"[inducing {step:4d}] DIVERGED (loss={loss_f}); "
                      "stopping and keeping the last finite Z — try a "
                      "smaller lr or alpha")
                return last_finite_Z
            last_finite_Z = Z.clone()
            if check:
                print(f"[inducing {step:4d}] loss={loss_f:.4f}")
            if callback is not None:
                callback(step, Z, loss_f)
        if checkpoint_dir and (step + 1) % checkpoint_every == 0 \
                and step + 1 < num_steps:
            save_array(Z, checkpoint_dir, checkpoint_name, step + 1)
    return Z
