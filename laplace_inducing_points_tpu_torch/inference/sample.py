"""Posterior weight sampling through the Gram's eigendecomposition.

Counterpart of ``laplace_inducing_points_tpu/inference/sample.py``:
``_g_weights`` (``:41``), ``inv_matsqrt_gram`` (``:64``),
``apply_inv_matsqrt_rows`` (``:73``), the materialized branch of
``make_inv_matsqrt`` (``:87-115``), ``make_inv_matsqrt_lanczos`` (``:314``),
``_batch_rel_residual`` (``:134``), ``make_matheron_sampler`` (``:155-311``)
both ways, ``inv_matsqrt_dense`` (``:357``) and ``sample`` (``:370``) for
``gram_eigh``, ``lanczos``, ``dense`` and ``matheron``. The matrix-free
branch of ``make_inv_matsqrt`` waits for a later slice (ROADMAP, Queue A).

Draws ``δθ ~ N(0, S⁻¹)`` with ``S = αI + β W Wᵀ`` by applying ``S^{-1/2}`` to
standard normal noise. With ``G = WᵀW = V Λ Vᵀ`` (``d×d``, d = M·K):

    S^{-1/2} ε = α^{-1/2} ε + W V diag(g(λ)) Vᵀ (Wᵀ ε),
    g(λ) = ((α + βλ)^{-1/2} − α^{-1/2}) / λ   for λ > tol,  else 0.

With the rows ``R = Wᵀ (d, D)`` materialized, the two long contractions are
``ε Rᵀ`` (the ``matmul_nt`` kernel) and ``(·) R`` (``matmul_nn``), and the
Gram is ``syrk(R)``. The Matheron sampler needs no square root: a Cholesky
of ``C = βG + αI`` with the rows, or CG against the matrix-free Gram
without them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.ops import lanczos as lz
from laplace_inducing_points_tpu_torch.ops.cg import cg_batched
from laplace_inducing_points_tpu_torch.ops.nystrom import precond_from_sketch, sketch_probe_block
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.training.inducing import (_cholesky, _pivot_jitter,
                                                                 matfree_sketch)


def _g_weights(lam: torch.Tensor, alpha: float, beta: float,
               rank_tol: float = 1e-7,
               range_clip_min: Optional[float] = None) -> torch.Tensor:
    """Spectral weights g(λ) with pseudo-inverse thresholding.

    Eigenvalues with ``λ ≤ rank_tol · max(λ_max, 1)`` — the f32 round-off
    level of softmax-CE null directions, since the Gram has rank ≤ M(K−1) —
    get weight 0. ``range_clip_min`` clips ``α + βλ`` from below (``1.0``
    reproduces the reference's monkeypatched sampler); ``None`` gives the
    exact inverse square root.
    """
    lam_max = torch.max(lam)
    mask = lam > rank_tol * torch.clamp(lam_max, min=1.0)
    lam_safe = torch.where(mask, lam, torch.ones_like(lam))
    inner = alpha + beta * lam_safe
    if range_clip_min is not None:
        inner = torch.clamp(inner, min=range_clip_min)
    g = (1.0 / torch.sqrt(inner) - 1.0 / math.sqrt(alpha)) / lam_safe
    return torch.where(mask, g, torch.zeros_like(g))


def inv_matsqrt_gram(gram: torch.Tensor, alpha: float, beta: float,
                     rank_tol: float = 1e-7,
                     range_clip_min: Optional[float] = None) -> torch.Tensor:
    """The spectral core ``V·diag(g)·Vᵀ`` (``d×d``)."""
    lam, V = torch.linalg.eigh(ops.ensure_symmetry(gram, jitter=0.0))
    g = _g_weights(lam, alpha, beta, rank_tol, range_clip_min)
    return (V * g) @ V.T


def apply_inv_matsqrt_rows(eps: torch.Tensor, R: torch.Tensor,
                           core: torch.Tensor, alpha: float) -> torch.Tensor:
    """``S^{-1/2} Eps`` through the rows and the spectral core.

    ``eps (P, D)``, ``R = Wᵀ (d, D)``, ``core = V diag(g) Vᵀ (d, d)``. All
    three contractions are true f32: the range-term correction cancels the
    prior draw along high-curvature directions.
    """
    U = matmul_nt(eps, R)                                      # (P, d)
    return eps / math.sqrt(alpha) + matmul_nn(ops.pdot(U, core.T), R)


def make_inv_matsqrt(state, Z: torch.Tensor, alpha: float,
                     full_set_size: Optional[int] = None,
                     rank_tol: float = 1e-7,
                     example_block: Optional[int] = None,
                     range_clip_min: Optional[float] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``Eps (P, D) ↦ S^{-1/2} Eps`` for ``S = αI + β W Wᵀ`` from the
    materialized rows (one vmapped jacrev, the SYRK Gram, one eigh)."""
    M = Z.shape[0]
    beta = (full_set_size or M) / M
    R = ops.dense_wt(state, Z, example_block=example_block)    # (d, D)
    core = inv_matsqrt_gram(syrk(R), alpha, beta, rank_tol, range_clip_min)
    return lambda eps: apply_inv_matsqrt_rows(eps, R, core, alpha)


def make_inv_matsqrt_lanczos(state, Z: torch.Tensor, alpha: float,
                             full_set_size: Optional[int] = None,
                             num_matvecs: Optional[int] = None,
                             eig_clip_min: Optional[float] = None
                             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Reference-parity sampler: ``S^{-1/2}ε`` as the null-space term
    ``α^{-1/2}(I − W G⁺ Wᵀ)ε`` plus the range term ``W G⁺ (αI + βG)^{-1/2} Wᵀε``,
    the inner inverse square root by ``funm_lanczos_sym`` over ``num_matvecs``
    (default ``2M``) Gram matvecs; ``G⁺`` is the pseudo-inverse of the (CE,
    generally singular) Gram. ``eig_clip_min=1.0`` is the reference's
    monkeypatched clip. The products with the rows ``R`` go through the NT/NN
    kernels; each probe runs its own Lanczos loop.
    """
    M = Z.shape[0]
    beta = (full_set_size or M) / M
    k = num_matvecs or 2 * M
    R = ops.dense_wt(state, Z)                                 # (d, D)
    gram = syrk(R)
    lam, V = torch.linalg.eigh(ops.ensure_symmetry(gram, jitter=0.0))
    mask = lam > 1e-7 * torch.clamp(torch.max(lam), min=1.0)
    inv_lam = torch.where(mask, 1.0 / torch.where(mask, lam, torch.ones_like(lam)),
                          torch.zeros_like(lam))
    gram_pinv = (V * inv_lam) @ V.T

    def inner_mv(u: torch.Tensor) -> torch.Tensor:
        return alpha * u + beta * (gram @ u)

    def apply(eps: torch.Tensor) -> torch.Tensor:
        U = matmul_nt(eps, R)                                  # rows Wᵀε (P, d)
        null_proj = (eps - matmul_nn(ops.pdot(U, gram_pinv.T), R)) / math.sqrt(alpha)
        Y = torch.stack([lz.funm_lanczos_sym(lambda t: 1.0 / torch.sqrt(t), inner_mv,
                                             u, k, clip_min=eig_clip_min) for u in U])
        return null_proj + matmul_nn(ops.pdot(Y, gram_pinv.T), R)

    return apply


def _batch_rel_residual(CX: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Worst relative solve residual over a batch: ``max_p ‖C x_p − u_p‖ / ‖u_p‖``."""
    num = torch.linalg.norm(CX - U, dim=-1)
    return torch.max(num / torch.clamp(torch.linalg.norm(U, dim=-1), min=1e-30))


def make_matheron_sampler(state, Z: torch.Tensor, alpha: float,
                          full_set_size: Optional[int] = None,
                          example_block: Optional[int] = None,
                          materialize_w: bool = True,
                          cg_tol: float = 1e-4, cg_maxiter: Optional[int] = None,
                          precond_rank: Optional[int] = 64, precond_power: int = 0,
                          precond_omega=None, precond_sketch=None,
                          cg_example_block: Optional[int] = None):
    """Exact posterior draws without a matrix square root (Matheron's rule).

    For ``S = αI + β W Wᵀ`` and ``C = βG + αI`` (``G = WᵀW``),

        θ = α^{-1/2} (ε − √β·W C⁻¹ (√β·Wᵀ ε + √α η)),  ε ~ N(0, I_D), η ~ N(0, I_d),

    has covariance exactly ``S⁻¹`` (Woodbury). ``C`` is positive definite for
    every α > 0, rank-deficient ``G`` included.

    ``materialize_w=True``: the rows ``R`` (``example_block`` chunks them),
    ``G = syrk(R)`` and a Cholesky of ``C`` (pivot-jittered); each draw batch
    is ``ε Rᵀ`` through ``matmul_nt``, a triangular solve pair and ``(·) R``
    through ``matmul_nn``, true FP32. ``materialize_w=False``: nothing of size
    ``d × D`` or ``d × d``; ``C⁻¹`` is a batched CG (``cg_tol``,
    ``cg_maxiter``, default ``10·d``) against the matrix-free Gram (over
    example blocks of ``cg_example_block``), preconditioned by
    ``precond_sketch`` (a :func:`matfree_sketch` of ``βG``, which depends on
    ``(state, Z)`` only) or else by a rank ``precond_rank`` sketch
    (``precond_power`` passes) built once here from ``precond_omega`` (a
    ``(d, k)`` start or a generator; default a generator seeded ``0x4E59``).

    Returns ``(apply, d)``: ``apply(eps (P, D), eta (P, d))`` gives the draws,
    ``apply(..., with_info=True)`` ``(draws, worst relative residual of the
    solve)``; a CG residual ≫ ``cg_tol`` means maxiter exits.
    """
    M = Z.shape[0]
    beta = (full_set_size or M) / M
    sqrt_alpha, sqrt_beta = math.sqrt(alpha), math.sqrt(beta)

    if materialize_w:
        R = ops.dense_wt(state, Z, example_block=example_block)   # (d, D)
        d = R.shape[0]
        eye = torch.eye(d, dtype=R.dtype, device=R.device)
        C = beta * syrk(R) + alpha * eye
        L = _cholesky(ops.ensure_symmetry(C, jitter=0.0) + _pivot_jitter(C) * eye)

        def apply(eps: torch.Tensor, eta: torch.Tensor, with_info: bool = False):
            U = sqrt_beta * matmul_nt(eps, R) + sqrt_alpha * eta           # (P, d)
            X = torch.cholesky_solve(U.T, L).T.contiguous()                # (P, d)
            draws = (eps - sqrt_beta * matmul_nn(X, R)) / sqrt_alpha
            if with_info:
                return draws, _batch_rel_residual(X @ (L @ L.T).T, U)
            return draws

        return apply, d

    w = ops.make_w_factor(state, Z, example_block=cg_example_block)
    M_, K_ = w.inner_shape
    d = M_ * K_
    sketch = precond_sketch
    if sketch is None and precond_rank:
        # depends only on (state, Z, beta): built once, not per draw batch
        omega = (precond_omega if precond_omega is not None else
                 torch.Generator(device=Z.device).manual_seed(0x4E59))
        sketch = matfree_sketch(state, Z, precond_rank, omega, precond_power,
                                cg_example_block, scale=beta)
    precond = None if sketch is None else precond_from_sketch(*sketch, alpha)

    def apply(eps: torch.Tensor, eta: torch.Tensor, with_info: bool = False):
        P = eps.shape[0]
        U = sqrt_beta * w.t_matmat(eps).reshape(P, d) + sqrt_alpha * eta
        cgblk = sketch_probe_block(M_, P)

        def c_matmat(Xm: torch.Tensor) -> torch.Tensor:
            return beta * w.gram_matmat(Xm, block=cgblk) + alpha * Xm

        X, _ = cg_batched(c_matmat, U, tol=cg_tol, maxiter=cg_maxiter or 10 * d,
                          precond=precond)
        draws = (eps - sqrt_beta * w.matmat(X.reshape(P, M_, K_))) / sqrt_alpha
        if with_info:
            return draws, _batch_rel_residual(c_matmat(X), U)
        return draws

    return apply, d


def inv_matsqrt_dense(state, Z: torch.Tensor, alpha: float,
                      full_set_size: Optional[int] = None) -> torch.Tensor:
    """Dense ``D×D`` twin for tests (small models only)."""
    M = Z.shape[0]
    beta = (full_set_size or M) / M
    R = ops.dense_wt(state, Z)                                 # (d, D)
    eye = torch.eye(R.shape[1], dtype=R.dtype, device=R.device)
    S = alpha * eye + beta * ops.pdot(R.T, R)
    evals, evecs = torch.linalg.eigh(S)
    return (evecs / torch.sqrt(torch.clamp(evals, min=1e-12))) @ evecs.T


def sample(state, Z: torch.Tensor, alpha: float, generator: torch.Generator, *,
           num_samples: int = 1, full_set_size: Optional[int] = None,
           method: str = "gram_eigh", **kwargs) -> torch.Tensor:
    """Draw ``(num_samples, D)`` zero-mean posterior weight perturbations;
    the noise comes from ``generator`` (on the state's device): ``ε`` and, for
    ``matheron``, then ``η (num_samples, d)``."""
    D = state.flat_params.shape[0]
    eps = torch.randn(num_samples, D, generator=generator,
                      device=state.device, dtype=torch.float32)
    if method == "matheron":
        apply2, d = make_matheron_sampler(state, Z, alpha, full_set_size, **kwargs)
        eta = torch.randn(num_samples, d, generator=generator, device=state.device,
                          dtype=torch.float32)
        return apply2(eps, eta)
    if method == "gram_eigh":
        apply = make_inv_matsqrt(state, Z, alpha, full_set_size, **kwargs)
    elif method == "lanczos":
        apply = make_inv_matsqrt_lanczos(state, Z, alpha, full_set_size, **kwargs)
    elif method == "dense":
        mat = inv_matsqrt_dense(state, Z, alpha, full_set_size)
        apply = lambda E: ops.pdot(E, mat.T)
    else:
        raise ValueError(f"unknown sampling method: {method}")
    return apply(eps)
