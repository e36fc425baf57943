"""Stochastic Lanczos quadrature log-determinants.

Counterpart of ``laplace_inducing_points_tpu/ops/slq.py:20-80``, the SLQ
log-det terms of the inducing-point KL objective on the Krylov layer of
``ops/lanczos.py``. The reference vmaps the probes; here they run one after
another, each a Krylov loop of ``num_matvecs`` operator applications and a
small dense factorization. The reference's per-probe ``remat`` has no
counterpart (eager autograd; see ``ops/stochtrace.py``); its ``remat_body``
passes through to ``golub_kahan_bidiag``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from laplace_inducing_points_tpu_torch.ops import lanczos as lz


def _graded_jitter(diag: torch.Tensor) -> torch.Tensor:
    """``1e-5·(1, 2, …, k)``: the graded diagonal jitter that breaks exact
    eigen/singular-value degeneracy at Krylov breakdown, where the eigh/SVD
    backward's ``1/(σᵢ²−σⱼ²)`` terms would give NaN gradients."""
    return 1e-5 * torch.arange(1, diag.shape[0] + 1, dtype=diag.dtype, device=diag.device)


def slq_logdet_sym(matvec: Callable[[torch.Tensor], torch.Tensor], probes: torch.Tensor,
                   num_matvecs: int, clip_min: Optional[float] = None) -> torch.Tensor:
    """``logdet(A)`` for PSD ``A`` by symmetric-Lanczos SLQ: per probe ``v``,
    ``vᵀ log(A) v ≈ ‖v‖² · e₁ᵀ log(T) e₁``, averaged over the probes."""
    def single(v):
        tri = lz.lanczos_sym(matvec, v, num_matvecs)
        T = lz.tridiag_dense(tri.alphas, tri.betas)
        d = torch.diagonal(T)
        T = T + torch.diag(_graded_jitter(d) * (torch.abs(d) + 1e-12))
        logT = lz.funm_sym_dense(torch.log, T, clip_min=clip_min)
        return torch.sum(v * v) * logT[0, 0]

    return torch.mean(torch.stack([single(v) for v in probes]))


def slq_logdet_product(matvec: Callable[[torch.Tensor], torch.Tensor],
                       probes: torch.Tensor, num_matvecs: int,
                       t_matvec: Optional[Callable] = None,
                       remat_body: bool = False) -> torch.Tensor:
    """``logdet(GᵀG)`` by Golub–Kahan SLQ: per probe,
    ``vᵀ log(GᵀG) v ≈ ‖v‖² · Σᵢ w₁ᵢ² · 2 log σᵢ`` with ``σ`` and the weights
    ``w₁ = Vᵀe₁`` from the SVD of the small bidiagonal ``B`` (sturdier than
    forming ``BᵀB``). ``remat_body``: recompute each Krylov step in the
    backward pass (``lanczos.golub_kahan_bidiag``)."""
    def single(v):
        bi = lz.golub_kahan_bidiag(matvec, v, num_matvecs, t_matvec=t_matvec,
                                   remat_body=remat_body)
        B = lz.bidiag_dense(bi.alphas, bi.betas)
        d = torch.diagonal(B)
        B = B + torch.diag(_graded_jitter(d) * (d + 1e-12))
        _, svals, vh = torch.linalg.svd(B, full_matrices=False)
        w1 = vh[:, 0]                  # e₁ᵀ V, V = vhᵀ
        quad = torch.sum(w1 * w1 * 2.0 * torch.log(svals + 1e-30))
        return torch.sum(v * v) * quad

    return torch.mean(torch.stack([single(v) for v in probes]))
