"""Krylov decompositions and Lanczos matrix functions, differentiable end to end.

Counterpart of ``laplace_inducing_points_tpu/ops/lanczos.py:32-196``: symmetric
Lanczos and Golub–Kahan bidiagonalization with full reorthogonalization
(twice, against the stored basis), the small dense matrix functions, and the
eigenvalue clip the reference applied globally exposed as ``clip_min``.

The reference writes each Krylov vector into a preallocated ``(k, d)`` basis
inside ``lax.scan``. Here the basis is a Python list, and each step stacks the
prefix it reorthogonalizes against: an in-place write into a tensor autograd
has saved would raise, and a copy of the whole basis per step would keep k
copies of it. The stacked prefixes autograd keeps add up to ``k²/2`` vectors,
as many as the reference's scan saves. ``golub_kahan_bidiag(remat_body=True)``
(the matfree log-det) recomputes each step in the backward pass
(``torch.utils.checkpoint``) instead of keeping its operator's activations.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vjp
from torch.utils.checkpoint import checkpoint

MatVec = Callable[[torch.Tensor], torch.Tensor]

_EPS = 1e-30


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm with a finite gradient at 0: at Krylov breakdown ``z/‖z‖`` is 0/0
    and would poison the backward pass; the floor matters only there, where
    the direction's quadrature weight is zero anyway."""
    return torch.sqrt(torch.sum(x * x) + _EPS)


def _reorthogonalize(basis: list, w: torch.Tensor) -> torch.Tensor:
    """``w`` with the span of ``basis`` projected out, twice (Parlett)."""
    if not basis:
        return w
    V = torch.stack(basis)
    w = w - V.T @ (V @ w)
    return w - V.T @ (V @ w)


class Tridiag(NamedTuple):
    alphas: torch.Tensor   # (k,)  diagonal
    betas: torch.Tensor    # (k-1,) off-diagonal
    basis: torch.Tensor    # (k, d) Lanczos vectors (rows)


def lanczos_sym(matvec: MatVec, v0: torch.Tensor, num_matvecs: int,
                reorthogonalize: bool = True) -> Tridiag:
    """Symmetric Lanczos: ``T = tridiag(alphas, betas)`` and the orthonormal
    basis ``V`` with ``V A Vᵀ ≈ T`` on the Krylov space of ``(A, v0)``."""
    q = v0 / _safe_norm(v0)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), dtype=v0.dtype, device=v0.device)
    basis, alphas, betas = [], [], []
    for _ in range(num_matvecs):
        w = matvec(q)
        alpha = torch.dot(w, q)
        w = w - alpha * q - beta_prev * q_prev
        if reorthogonalize:
            w = _reorthogonalize(basis, w)
        beta = _safe_norm(w)
        basis.append(q)
        q, q_prev, beta_prev = w / (beta + _EPS), q, beta
        alphas.append(alpha)
        betas.append(beta)
    return Tridiag(alphas=torch.stack(alphas), betas=torch.stack(betas)[:-1],
                   basis=torch.stack(basis))


def tridiag_dense(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    T = torch.diag(alphas)
    if alphas.shape[0] > 1:
        T = T + torch.diag(betas, 1) + torch.diag(betas, -1)
    return T


def funm_sym_dense(matfun: Callable[[torch.Tensor], torch.Tensor], A: torch.Tensor,
                   clip_min: Optional[float] = None) -> torch.Tensor:
    """``f(A)`` for a small dense symmetric ``A`` by eigh; ``clip_min`` clips the
    eigenvalues first (``1.0`` is the reference's monkeypatched clip, so
    ``log -> 0`` and ``1/sqrt -> 1`` on the clipped subspace)."""
    evals, evecs = torch.linalg.eigh(A)
    if clip_min is not None:
        evals = torch.clamp(evals, min=clip_min)
    return (evecs * matfun(evals)) @ evecs.T


def funm_lanczos_sym(matfun: Callable[[torch.Tensor], torch.Tensor], matvec: MatVec,
                     v: torch.Tensor, num_matvecs: int,
                     clip_min: Optional[float] = None) -> torch.Tensor:
    """``f(A) v ≈ ‖v‖ · Vᵀ f(T) e₁`` by Lanczos."""
    tri = lanczos_sym(matvec, v, num_matvecs)
    fT = funm_sym_dense(matfun, tridiag_dense(tri.alphas, tri.betas), clip_min=clip_min)
    return tri.basis.T @ (fT[:, 0] * torch.linalg.norm(v))


class Bidiag(NamedTuple):
    alphas: torch.Tensor    # (k,)   B diagonal
    betas: torch.Tensor     # (k-1,) B super-diagonal
    right: torch.Tensor     # (k, D) right Golub-Kahan vectors


def _gk_step(matvec: MatVec, t_matvec: MatVec, reorthogonalize: bool,
             v: torch.Tensor, u_prev: Optional[torch.Tensor],
             beta_prev: Optional[torch.Tensor], *basis: torch.Tensor):
    """One Golub–Kahan step: ``(alpha_i, beta_i, u_i, v_{i+1})``."""
    # u_i alpha_i = G v_i - beta_{i-1} u_{i-1}
    w = matvec(v) if u_prev is None else matvec(v) - beta_prev * u_prev
    alpha = _safe_norm(w)
    u = w / (alpha + _EPS)
    # v_{i+1} beta_i = Gᵀ u_i - alpha_i v_i
    z = t_matvec(u) - alpha * v
    if reorthogonalize:
        z = _reorthogonalize([*basis, v], z)
    beta = _safe_norm(z)
    return alpha, beta, u, z / (beta + _EPS)


def golub_kahan_bidiag(matvec: MatVec, v0: torch.Tensor, num_matvecs: int,
                       t_matvec: Optional[MatVec] = None,
                       reorthogonalize: bool = True,
                       remat_body: bool = False) -> Bidiag:
    """Golub–Kahan bidiagonalization of a rectangular linear operator ``G``:
    upper-bidiagonal ``B`` with ``GᵀG ≈ V BᵀB Vᵀ`` on the Krylov space of
    ``(GᵀG, v0)``. Without ``t_matvec`` the adjoint is the vjp of ``matvec``
    at ``v0`` (``G`` must be linear).

    ``remat_body``: run each step under ``torch.utils.checkpoint``
    (non-reentrant), so the backward pass recomputes the step's operator
    applications instead of keeping their activations: for a matrix-free
    ``W`` at ``M`` points those are ``num_matvecs × M`` examples' activations.
    Values and gradients are the same; the backward runs one more matvec
    pair per step. The operator must then not use ``torch.func.vjp`` (it
    refuses checkpoint's saved-tensor hooks): the matrix-free factors'
    ``matvec`` is ``torch.autograd.grad``.
    """
    if t_matvec is None:
        _, pull = vjp(matvec, v0)
        t_matvec = lambda u: pull(u)[0]    # noqa: E731

    step = functools.partial(_gk_step, matvec, t_matvec, reorthogonalize)
    v = v0 / _safe_norm(v0)
    u_prev, beta_prev = None, None
    basis, alphas, betas = [], [], []
    for _ in range(num_matvecs):
        args = (v, u_prev, beta_prev, *(basis if reorthogonalize else ()))
        if remat_body:
            alpha, beta, u, v_next = checkpoint(step, *args, use_reentrant=False)
        else:
            alpha, beta, u, v_next = step(*args)
        basis.append(v)
        v, u_prev, beta_prev = v_next, u, beta
        alphas.append(alpha)
        betas.append(beta)
    return Bidiag(alphas=torch.stack(alphas), betas=torch.stack(betas)[:-1],
                  right=torch.stack(basis))


def bidiag_dense(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """The small ``k×k`` upper-bidiagonal ``B``."""
    B = torch.diag(alphas)
    if alphas.shape[0] > 1:
        B = B + torch.diag(betas, 1)
    return B
