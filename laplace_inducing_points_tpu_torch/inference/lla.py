"""Scalable linearized-Laplace (LLA) predictive: the serving path.

Counterpart of ``laplace_inducing_points_tpu/inference/lla.py``:
``predict_lla_scalable`` (``:107``), ``_amortized_logit_samples``
(``:133-174``) and ``ScalableLLAPredictor(method="weight")`` (``:348-488``).
The ``cov`` and ``matfree`` predictors, the dense predictive and the mesh
sharding wait for later slices (ROADMAP, Queue A).

``jax.random`` streams cannot be reproduced in PyTorch, so the per-batch
step is split in two: :func:`amortized_logit_samples_from_noise` takes the
noise ``ε`` as an argument (the twin tests feed both packages the same ε),
and :func:`amortized_logit_samples` draws it from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.func import vmap

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.inference.sample import _g_weights
from laplace_inducing_points_tpu_torch.inference.sample import sample as sample_weights
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk


def predict_lla_scalable(state, Xnew: torch.Tensor, Z: torch.Tensor, alpha: float,
                         generator: torch.Generator,
                         full_set_size: Optional[int] = None,
                         num_samples: int = 1,
                         sample_method: str = "gram_eigh",
                         **sample_kwargs) -> torch.Tensor:
    """Logit samples ``f(x*) + J* δθ_s``, ``(num_samples, N, K)``, with the
    posterior factor rebuilt for this call (use :class:`ScalableLLAPredictor`
    in loops)."""
    w_samples = sample_weights(state, Z, alpha, generator,
                               num_samples=num_samples,
                               full_set_size=full_set_size,
                               method=sample_method, **sample_kwargs)
    lin = ops.linearize_model(state, Xnew)
    return lin.f0[None] + vmap(lin.jvp)(w_samples)


def amortized_logit_samples_from_noise(state, R: torch.Tensor, lam: torch.Tensor,
                                       V: torch.Tensor, alpha: float, beta: float,
                                       x: torch.Tensor, eps: torch.Tensor,
                                       rank_tol: float = 1e-7,
                                       range_clip_min: Optional[float] = None,
                                       sample_block: Optional[int] = None
                                       ) -> torch.Tensor:
    """One evaluation step on given noise ``eps (S, D)``: posterior weight
    draws through the prebuilt spectral factor, pushed forward by the
    linearization at ``x``. Returns ``(S, B, K)`` logit samples.

    The contractions are true f32 (``matmul_nt``/``matmul_nn`` kernels and
    ``pdot``): the correction cancels the prior draw along high-curvature
    directions, and a relative error there re-enters the logits amplified by
    ~√λ_max. ``sample_block`` pushes the draws forward in chunks of that many
    samples, bounding the live (chunk, B, activation) tangents.
    """
    g = _g_weights(lam, alpha, beta, rank_tol, range_clip_min)
    lin = ops.linearize_model(state, x)
    push = vmap(lin.jvp)

    def draw(e: torch.Tensor) -> torch.Tensor:
        U = matmul_nt(e, R)                                    # (n, d)
        mixed = ops.pdot(U, V) * g                             # (n, d) · diag(g)
        w = e / math.sqrt(alpha) + matmul_nn(ops.pdot(mixed, V.T), R)
        return push(w)                                         # (n, B, K)

    S = eps.shape[0]
    if not sample_block or sample_block >= S:
        return lin.f0[None] + draw(eps)
    return lin.f0[None] + torch.cat([draw(eps[i:i + sample_block])
                                     for i in range(0, S, sample_block)])


def amortized_logit_samples(state, R: torch.Tensor, lam: torch.Tensor,
                            V: torch.Tensor, alpha: float, beta: float,
                            x: torch.Tensor, generator: torch.Generator,
                            num_samples: int, rank_tol: float = 1e-7,
                            range_clip_min: Optional[float] = None,
                            sample_block: Optional[int] = None) -> torch.Tensor:
    """:func:`amortized_logit_samples_from_noise` with ``ε ~ N(0, I)`` drawn
    from ``generator`` (on ``R``'s device)."""
    eps = torch.randn(num_samples, R.shape[1], generator=generator,
                      device=R.device, dtype=R.dtype)
    return amortized_logit_samples_from_noise(state, R, lam, V, alpha, beta, x,
                                              eps, rank_tol, range_clip_min,
                                              sample_block)


class ScalableLLAPredictor:
    """Amortized IP-LLA predictive for a fixed ``(state, Z)``.

    The ``(d×D)`` row factor, its SYRK Gram and the ``d×d`` eigendecomposition
    are built once here; each batch then costs two long contractions (the
    ``matmul_nt``/``matmul_nn`` kernels), two small ``d×d`` products and one
    batched jvp. ``alpha`` is a per-call argument, so an alpha grid search
    shares the factor.
    """

    def __init__(self, state, Z: torch.Tensor, *,
                 full_set_size: Optional[int] = None,
                 example_block: Optional[int] = None,
                 rank_tol: float = 1e-7,
                 range_clip_min: Optional[float] = None,
                 sample_block: Optional[int] = None,
                 method: str = "weight"):
        if method in ("cov", "matfree"):
            raise NotImplementedError(f"predictive method {method!r} is not "
                                      "ported yet (ROADMAP, Queue A)")
        if method != "weight":
            raise ValueError(f"unknown predictive method {method!r}")
        M = Z.shape[0]
        self.state = state
        self.beta = float(full_set_size or M) / M
        self.rank_tol = rank_tol
        self.range_clip_min = range_clip_min
        self.sample_block = sample_block
        self.R = ops.dense_wt(state, Z, example_block=example_block)
        self.gram = syrk(self.R)
        self.lam, self.V = torch.linalg.eigh(ops.ensure_symmetry(self.gram, jitter=0.0))

    def logit_samples(self, x: torch.Tensor, alpha: float,
                      generator: torch.Generator, num_samples: int) -> torch.Tensor:
        """``(num_samples, B, K)`` predictive logit samples for one batch."""
        return amortized_logit_samples(
            self.state, self.R, self.lam, self.V, alpha, self.beta,
            x.to(device=self.R.device, dtype=torch.float32), generator,
            num_samples, self.rank_tol, self.range_clip_min, self.sample_block)
