"""Devices and precision policy, configs, checkpoints; and ``is_pd``, the
reference's eigenvalue check (``laplace_inducing_points_tpu/utils/__init__.py:41``)."""

import torch


def is_pd(mat, tol: float = 1e-9) -> bool:
    """Every eigenvalue of the symmetric part of ``mat`` at least ``tol``."""
    mat = torch.as_tensor(mat)
    return bool(torch.all(torch.linalg.eigvalsh(0.5 * (mat + mat.T)) >= tol))
