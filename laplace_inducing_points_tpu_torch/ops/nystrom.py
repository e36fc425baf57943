"""Randomized Nyström preconditioner for the matrix-free CG solves.

Counterpart of ``laplace_inducing_points_tpu/ops/nystrom.py:62-208``. The
matfree paths solve ``C x = b`` with ``C = G + ρI`` by CG against the
matrix-free Gram ``G = WᵀW``. GGN Gram spectra are front-loaded, so
``κ(C) ≈ λ_max/ρ`` and plain CG stalls. A rank-``k`` Nyström approximation
from ``k`` sketch matvecs deflates the top of the spectrum (Frangella, Tropp
& Udell, SIAM J. Matrix Anal. 2023):

    Y = G Ω,   Ω ∈ R^{d×k} orthonormal,
    G_nys = Y (ΩᵀY)⁻¹ Yᵀ = U diag(λ̂) Uᵀ,
    P⁻¹v = v + U ((λ̂_k + ρ)/(Λ̂ + ρ) − 1) Uᵀ v.

Everything is ``(d, k)`` and ``(k, k)`` algebra. The sketch is built without
a graph (``torch.no_grad``): ``P`` steers the CG trajectory, never its fixed
point, so gradients through the solution are exact without differentiating
the QR and eigh.

The random start ``Ω`` is a ``(d, k)`` tensor or drawn from a
``torch.Generator``: the reference's ``jax.random`` stream cannot be
reproduced, so the twin tests hand both packages the same ``Ω``.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

MatMat = Callable[[torch.Tensor], torch.Tensor]

# Peak live tangent activations of a Gram probe sweep scale with
# block·M (examples·probes); the reference's budget, kept: it sets the
# chunking, not the values.
_SWEEP_BUDGET_EXAMPLE_PROBES = 32768

_EPS32 = torch.finfo(torch.float32).eps


def sketch_probe_block(n_examples: int, n_probes: int,
                       budget: int = _SWEEP_BUDGET_EXAMPLE_PROBES):
    """Probe-chunk size for a Gram sweep (``None``: all probes at once), so
    that ``block·n_examples`` stays within ``budget``."""
    if n_probes * n_examples <= budget:
        return None
    return max(1, budget // n_examples)


@torch.no_grad()
def nystrom_sketch(gram_matmat: MatMat, d: int, rank: int,
                   omega: Union[torch.Tensor, torch.Generator], power: int = 0):
    """The ρ-independent part of the preconditioner: ``rank`` sketch matvecs
    → the Nyström eigenpairs ``(U (d, k), lam (k,), good (k,))``, sorted by
    decreasing ``λ̂``.

    ``gram_matmat``: the Gram's action on ``(k, d)`` probe rows. ``omega``:
    the ``(d, k)`` start (``k = min(rank, d)``) or a generator to draw it
    from. ``power`` adds that many subspace-iteration passes
    (``Ω ← orth(G Ω)``) before the final sketch, ``(1+power)·rank`` matvecs
    in all: at front-loaded spectra one pass aligns the sketch with the top
    eigenvectors.
    """
    k = min(rank, d)
    if isinstance(omega, torch.Generator):
        omega = torch.randn(d, k, generator=omega, device=omega.device)
    Om, _ = torch.linalg.qr(omega)                              # (d, k) orthonormal
    for _ in range(power):
        Om, _ = torch.linalg.qr(gram_matmat(Om.T.contiguous()).T)
    Y = gram_matmat(Om.T.contiguous()).T                        # (d, k) = G Ω

    # stability shift: ΩᵀY positive definite despite round-off and zero modes
    nu = (d ** 0.5) * _EPS32 * torch.linalg.norm(Y)
    Yv = Y + nu * Om
    B = Om.T @ Yv                                               # (k, k)
    # a failed factor makes the sketch NaN, as the reference's does, and the
    # NaN loss stops the trainer (torch.linalg.cholesky and eigh would raise)
    L, info = torch.linalg.cholesky_ex(0.5 * (B + B.T))
    if int(info) != 0 or not bool(torch.isfinite(Y).all()):
        nan = torch.full((k,), float("nan"), device=Y.device)
        return torch.full_like(Y, float("nan")), nan, torch.zeros_like(nan, dtype=torch.bool)
    F = torch.linalg.solve_triangular(L, Yv.T, upper=False).T  # (d, k)

    # eigenbasis of G_nys = F Fᵀ from the k×k eigh of FᵀF = V s² Vᵀ:
    # U = F V s⁻¹, columns with s ≈ 0 zeroed
    s2, V = torch.linalg.eigh(F.T @ F)
    s2 = torch.clamp(s2, min=0.0)
    s = torch.sqrt(s2)
    good = s > _EPS32 * torch.max(s) * d
    U = (F @ V) * torch.where(good, 1.0 / torch.clamp(s, min=1e-30),
                              torch.zeros_like(s))
    # descending before the re-orthonormalisation, so every good column
    # precedes the zeroed ones and keeps its place against lam
    order = torch.argsort(-s2, stable=True)
    U, s2, good = U[:, order], s2[order], good[order]
    # the eigh spans decades at GGN spectra and leaves UᵀU − I ≈ 1e-4, above
    # the deflation floor; QR of the near-orthonormal U rotates the good block
    # by ≈ I and makes P⁻¹ SPD for any orthonormal U
    U = torch.linalg.qr(U)[0]
    lam = torch.clamp(s2 - nu, min=0.0)
    return U, lam, good


def _coefficients(lam: torch.Tensor, good: torch.Tensor, rho: float,
                  deflation_floor: float) -> torch.Tensor:
    """``max((λ̂_min + ρ)/(λ̂ + ρ), floor)`` on the good columns."""
    lam_min = torch.min(torch.where(good, lam, torch.full_like(lam, float("inf"))))
    lam_min = torch.where(torch.isfinite(lam_min), lam_min, torch.zeros_like(lam_min))
    return torch.clamp((lam_min + rho) / (lam + rho), min=deflation_floor)


def _low_rank_update(U: torch.Tensor, coeff: torch.Tensor) -> MatMat:
    def apply(v: torch.Tensor) -> torch.Tensor:
        return v + ((v @ U) * coeff) @ U.T

    return apply


def precond_from_sketch(U: torch.Tensor, lam: torch.Tensor, good: torch.Tensor,
                        rho: float, deflation_floor: float = 1e-5) -> MatMat:
    """``apply(v) = P⁻¹ v`` (``(d,)`` or ``(..., d)``) from a stored sketch;
    the ρ-dependent part is O(k)."""
    mult = _coefficients(lam, good, rho, deflation_floor)
    coeff = torch.where(good, mult - 1.0, torch.zeros_like(mult))
    return _low_rank_update(U, coeff)


def precond_inv_sqrt_from_sketch(U: torch.Tensor, lam: torch.Tensor,
                                 good: torch.Tensor, rho: float,
                                 deflation_floor: float = 1e-5) -> MatMat:
    """``apply(v) = P^{-1/2} v`` for the same ``P``: ``P⁻¹ = I + U diag(mult−1)
    Uᵀ`` with ``mult ∈ [floor, 1]`` gives ``P^{-1/2} = I + U diag(√mult − 1)
    Uᵀ``. For measuring the spectrum CG sees after deflation (the healthcheck's
    power iteration on ``P^{-1/2} C P^{-1/2}``): the sketch's own ``λ̂_k``
    underestimates it when the spectrum decays slowly."""
    mult = _coefficients(lam, good, rho, deflation_floor)
    coeff = torch.where(good, torch.sqrt(mult) - 1.0, torch.zeros_like(mult))
    return _low_rank_update(U, coeff)


def nystrom_preconditioner(gram_matmat: MatMat, d: int, rank: int, rho: float,
                           generator: Union[torch.Tensor, torch.Generator],
                           deflation_floor: float = 1e-5, power: int = 0) -> MatMat:
    """``apply(v) = P⁻¹ v`` for ``C = G + ρI`` from ``rank`` sketch matvecs in
    one call: :func:`nystrom_sketch` then :func:`precond_from_sketch` (the
    reference's one-call constructor, ``:186``). ``generator`` draws the start ``Ω`` or is
    the ``(d, k)`` start itself. ``apply`` is symmetric positive definite, as
    ``ops.cg.cg_batched``'s preconditioner must be."""
    U, lam, good = nystrom_sketch(gram_matmat, d, rank, generator, power=power)
    return precond_from_sketch(U, lam, good, rho, deflation_floor)
