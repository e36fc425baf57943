"""Closed-form per-example loss Hessians and their (asymmetric) square roots.

Counterpart of ``laplace_inducing_points_tpu/core/loss_hessians.py:30-98``.
The GGN is ``Σ_i J_iᵀ H_i J_i`` with ``H_i`` the Hessian of the loss w.r.t.
the network output at example ``i``; for both likelihoods ``H`` and a factor
``L`` with ``L Lᵀ = H`` are closed form:

* softmax cross-entropy (``classifier``): ``H = diag(p) − p pᵀ``,
  ``L v = s⊙v − (sᵀv) p`` and ``Lᵀ v = s⊙v − (pᵀv) s`` with ``s = √p``;
* Gaussian NLL with learned variance (``regressor``): ``H = exp(−logvar)``,
  ``L = exp(−logvar/2)``.

Everything is batched over the leading axes; the class axis is the last.
"""

from __future__ import annotations

import torch

REGRESSOR = "regressor"
CLASSIFIER = "classifier"


def _exp(x):
    return torch.exp(torch.as_tensor(x))


def _ce_sqrt_h(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``L v`` for softmax-CE: rows ``s ⊙ v − (sᵀv) p``."""
    p = torch.softmax(f, dim=-1)
    s = torch.sqrt(p)
    coeff = torch.sum(s * v, dim=-1, keepdim=True)
    return s * v - coeff * p


def _ce_sqrt_h_t(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``Lᵀ v`` for softmax-CE: rows ``s ⊙ v − (pᵀv) s``."""
    p = torch.softmax(f, dim=-1)
    s = torch.sqrt(p)
    coeff = torch.sum(p * v, dim=-1, keepdim=True)
    return s * v - coeff * s


def _ce_h(f: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``H v`` for softmax-CE: rows ``p ⊙ v − (pᵀv) p``."""
    p = torch.softmax(f, dim=-1)
    coeff = torch.sum(p * v, dim=-1, keepdim=True)
    return p * v - coeff * p


def sqrt_h_apply(model_kind: str, f: torch.Tensor, v: torch.Tensor,
                 logvar: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Apply the Hessian square-root factor ``L`` rowwise (the ``W`` side)."""
    if model_kind == CLASSIFIER:
        return _ce_sqrt_h(f, v)
    if model_kind == REGRESSOR:
        return _exp(-0.5 * logvar) * v
    raise ValueError(f"unknown model_kind: {model_kind}")


def sqrt_h_t_apply(model_kind: str, f: torch.Tensor, v: torch.Tensor,
                   logvar: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Apply ``Lᵀ`` rowwise (the ``Wᵀ`` side, after ``J``)."""
    if model_kind == CLASSIFIER:
        return _ce_sqrt_h_t(f, v)
    if model_kind == REGRESSOR:
        return _exp(-0.5 * logvar) * v
    raise ValueError(f"unknown model_kind: {model_kind}")


def h_apply(model_kind: str, f: torch.Tensor, v: torch.Tensor,
            logvar: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Apply the full per-example loss Hessian ``H = L Lᵀ`` rowwise."""
    if model_kind == CLASSIFIER:
        return _ce_h(f, v)
    if model_kind == REGRESSOR:
        return _exp(-logvar) * v
    raise ValueError(f"unknown model_kind: {model_kind}")


def h_dense(model_kind: str, f: torch.Tensor,
            logvar: torch.Tensor | float = 0.0) -> torch.Tensor:
    """Materialize per-example loss Hessians, batched: ``(M,K) -> (M,K,K)``."""
    k = f.shape[-1]
    eye = torch.eye(k, dtype=f.dtype, device=f.device)
    if model_kind == CLASSIFIER:
        p = torch.softmax(f, dim=-1)
        return p[..., :, None] * eye - p[..., :, None] * p[..., None, :]
    if model_kind == REGRESSOR:
        return _exp(-logvar) * eye.expand(*f.shape, k)
    raise ValueError(f"unknown model_kind: {model_kind}")
