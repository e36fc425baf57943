"""Stochastic trace estimators, differentiable in the operator's parameters.

Counterpart of ``laplace_inducing_points_tpu/ops/stochtrace.py:29-142``:
Girard–Hutchinson, Hutch++ and NA-Hutch++ over a batched
``matmat: (P, D) -> (P, D)`` acting on row-stacked probes. The probes are drawn
once and passed in, so the trace and the log-det terms of the KL objective
share them (common random numbers).

Probes come from a ``torch.Generator``; they cannot reproduce ``jax.random``'s
bits, so the twin tests hand both packages the same probe array. The
reference's ``remat`` of each operator application has no counterpart: eager
autograd keeps only the operands each product saves, (P, D) tensors.
``trace_of_inverse`` composes an estimator with the batched CG of
``ops/cg.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from laplace_inducing_points_tpu_torch.core.operators import pdot
from laplace_inducing_points_tpu_torch.ops.cg import cg_batched

MatMat = Callable[[torch.Tensor], torch.Tensor]


def rademacher_probes(generator: torch.Generator, num: int, dim: int,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    """``(num, dim)`` iid ±1 probes on ``device`` (the generator's device)."""
    bits = torch.randint(0, 2, (num, dim), generator=generator,
                         device=device or generator.device)
    return (2 * bits - 1).to(dtype)


def normal_probes(generator: torch.Generator, num: int, dim: int,
                  device=None, dtype=torch.float32) -> torch.Tensor:
    """``(num, dim)`` iid standard normal probes."""
    return torch.randn(num, dim, generator=generator, device=device or generator.device,
                       dtype=dtype)


def hutchinson(matmat: MatMat, probes: torch.Tensor) -> torch.Tensor:
    """Girard–Hutchinson: ``mean_p  pᵀ A p``."""
    return torch.mean(torch.sum(probes * matmat(probes), dim=-1))


def hutchpp(matmat: MatMat, probes: torch.Tensor, *, s1: Optional[int] = None,
            s2: Optional[int] = None) -> torch.Tensor:
    """Hutch++ (Meyer et al., arXiv:2010.09649):
    ``tr(A) ≈ tr(Qᵀ A Q) + (1/s2) tr(G⊥ᵀ A G⊥)`` with ``Q`` an orthonormal basis
    of ``A S`` and ``G⊥`` the residual probes deflated against ``Q``.

    The first ``s1`` probes feed the range finder and the next ``s2`` the
    residual; ``s1`` is cut to ``D`` (QR needs a tall factor, and ``s1 ≥ D``
    already captures ``A``). The deflation is true f32.
    """
    total = probes.shape[0]
    s1 = total // 2 if s1 is None else s1
    s2 = total - s1 if s2 is None else s2
    s1 = min(s1, probes.shape[1])
    S, G = probes[:s1], probes[s1:s1 + s2]

    Y = matmat(S).T                                    # (D, s1)
    Q, _ = torch.linalg.qr(Y, mode="reduced")          # (D, s1)
    AQ = matmat(Q.T.contiguous())                      # (s1, D) rows = A q_i
    low_rank = torch.sum(AQ.T * Q)                     # tr(Qᵀ A Q)

    G_perp = G - pdot(pdot(G, Q), Q.T)
    resid = torch.sum(G_perp * matmat(G_perp)) / s2
    return low_rank + resid


def na_hutchpp(matmat: MatMat, probes: torch.Tensor) -> torch.Tensor:
    """Non-adaptive Hutch++ with the paper's (1/4, 1/2, 1/4) probe split."""
    total = probes.shape[0]
    n1, n2 = total // 4, total // 2
    S, R, G = probes[:n1], probes[n1:n1 + n2], probes[n1 + n2:]
    W = matmat(S).T                                    # (D, n1) = A Sᵀ
    Z = matmat(R).T                                    # (D, n2) = A Rᵀ
    pinv_SZ = torch.linalg.pinv(pdot(S, Z))            # (n2, n1)
    t1 = torch.trace(pdot(pinv_SZ, pdot(W.T, Z)))
    t2 = torch.trace(pdot(G, matmat(G).T))
    t3 = torch.trace(pdot(pdot(pdot(pdot(G, Z), pinv_SZ), W.T), G.T))
    return t1 + (t2 - t3) / G.shape[0]


def trace_of_inverse(matmat: MatMat, probes: torch.Tensor, *, cg_tol: float = 1e-6,
                     cg_maxiter: Optional[int] = None, estimator: str = "hutchpp",
                     operator_inputs=()) -> torch.Tensor:
    """``tr(A⁻¹)`` by an estimator over batched CG solves (``ops/cg.py``).

    ``matmat`` is the operator of the inner CG, so it must be true f32 (the
    f32 policy). ``operator_inputs``: the tensors ``A`` depends on that need
    gradients (``cg_batched``).
    """
    def inv_matmat(V: torch.Tensor) -> torch.Tensor:
        return cg_batched(matmat, V, tol=cg_tol, maxiter=cg_maxiter,
                          operator_inputs=operator_inputs)[0]

    if estimator == "hutchpp":
        return hutchpp(inv_matmat, probes)
    if estimator == "hutchinson":
        return hutchinson(inv_matmat, probes)
    if estimator == "na_hutchpp":
        return na_hutchpp(inv_matmat, probes)
    raise ValueError(f"unknown estimator: {estimator}")
