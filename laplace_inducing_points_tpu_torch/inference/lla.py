"""Scalable linearized-Laplace (LLA) predictive: the serving path.

Counterpart of ``laplace_inducing_points_tpu/inference/lla.py``:
``predict_lla_scalable`` (``:107``), ``_amortized_logit_samples``
(``:133-174``), the matfree predictive's ``_matfree_logit_samples``
(``:183-296``; its ``_jitted_nystrom_sketch`` is ``matfree_sketch`` of
``training/inducing.py`` with scale β) and ``ScalableLLAPredictor`` with
``method="weight"`` or ``"matfree"`` (``:348-488``). The ``cov`` predictor,
the dense predictive and the mesh sharding wait for later slices (ROADMAP,
Queue A).

``jax.random`` streams cannot be reproduced in PyTorch, so each per-batch
step is split in two: :func:`amortized_logit_samples_from_noise` and
:func:`matfree_logit_samples_from_noise` take the noise as arguments (the
twin tests feed both packages the same arrays), and
:func:`amortized_logit_samples` and :meth:`ScalableLLAPredictor.logit_samples`
draw it from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
from torch.func import vmap

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.inference.sample import _g_weights, make_matheron_sampler
from laplace_inducing_points_tpu_torch.inference.sample import sample as sample_weights
from laplace_inducing_points_tpu_torch.ops.nystrom import sketch_probe_block
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.training.inducing import matfree_sketch


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


def matfree_logit_samples_from_noise(state, Z: torch.Tensor, sketch, alpha: float,
                                     full_set_size: Optional[int], x: torch.Tensor,
                                     eps: torch.Tensor, eta: torch.Tensor, cg_tol: float,
                                     cg_maxiter: Optional[int] = None,
                                     sample_block: Optional[int] = None,
                                     example_block: Optional[int] = None):
    """One evaluation step of the ``d_z``-unbounded predictive on given noise
    ``eps (S, D)`` and ``eta (S, d)``: the matfree Matheron sampler
    (``make_matheron_sampler(materialize_w=False)``, preconditioned by
    ``sketch``, a :func:`matfree_sketch` of ``βGzz``, or ``None``), pushed
    forward by the linearization at ``x``. Nothing of size ``d_z × D`` or
    ``d_z × d_z`` is formed.

    Returns ``((S, B, K) logit samples, the worst CG relative residual)``; a
    residual ≫ ``cg_tol`` means maxiter exits. ``sample_block`` solves and
    pushes forward that many draws at a time; ``example_block`` runs the
    factor over example blocks.
    """
    apply, _ = make_matheron_sampler(state, Z, alpha, full_set_size, materialize_w=False,
                                     cg_tol=cg_tol, cg_maxiter=cg_maxiter,
                                     precond_rank=None, precond_sketch=sketch,
                                     cg_example_block=example_block)
    lin = ops.linearize_model(state, x)
    push = vmap(lin.jvp)
    S = eps.shape[0]
    block = S if not sample_block else sample_block
    outs, worst = [], None
    for i in range(0, S, block):
        draws, res = apply(eps[i:i + block], eta[i:i + block], with_info=True)
        outs.append(push(draws))
        worst = res if worst is None else torch.maximum(worst, res)
    return lin.f0[None] + torch.cat(outs), worst


class ScalableLLAPredictor:
    """Amortized IP-LLA predictive for a fixed ``(state, Z)``.

    ``method="weight"``: the ``(d×D)`` row factor, its SYRK Gram and the
    ``d×d`` eigendecomposition are built once here; each batch then costs two
    long contractions (the ``matmul_nt``/``matmul_nn`` kernels), two small
    ``d×d`` products and one batched jvp.

    ``method="matfree"``: the ``d_z``-unbounded path. Only a
    ``(d_z, precond_rank)`` Nyström sketch of ``β·Gzz`` is built here (from
    ``precond_omega``: a ``(d_z, k)`` start or a generator, default one
    seeded ``0x4E59``); each batch draws Matheron samples by CG against the
    matrix-free Gram (``cg_tol``, ``cg_maxiter``, over example blocks of
    ``cg_example_block``) and pushes them forward. ``range_clip_min`` does not
    apply (the sampler is exact). ``sample_block`` defaults to
    ``sketch_probe_block(M, ·)``: each CG iteration of a chunk keeps
    ``chunk·M`` examples' tangents live. It warns once when a batch's CG
    residual exceeds ``max(5·cg_tol, 1e-5)`` (maxiter exits); the last
    batch's residual is ``last_cg_residual``.

    ``alpha`` is a per-call argument, so an alpha grid search shares the
    factor (or the sketch).
    """

    def __init__(self, state, Z: torch.Tensor, *,
                 full_set_size: Optional[int] = None,
                 example_block: Optional[int] = None,
                 rank_tol: float = 1e-7,
                 range_clip_min: Optional[float] = None,
                 sample_block: Optional[int] = None,
                 method: str = "weight",
                 cg_tol: float = 1e-4, cg_maxiter: Optional[int] = None,
                 precond_rank: Optional[int] = 64, precond_power: int = 0,
                 precond_omega=None, cg_example_block: Optional[int] = None):
        if method == "cov":
            raise NotImplementedError(f"predictive method {method!r} is not "
                                      "ported yet (ROADMAP, Queue A)")
        if method not in ("weight", "matfree"):
            raise ValueError(f"unknown predictive method {method!r}")
        M = Z.shape[0]
        self.state = state
        self.method = method
        self.full_set_size = full_set_size
        self.beta = float(full_set_size or M) / M
        self.rank_tol = rank_tol
        self.range_clip_min = range_clip_min
        self.sample_block = sample_block
        if method == "matfree":
            self.Z = Z
            self.cg_tol, self.cg_maxiter = cg_tol, cg_maxiter
            self.cg_example_block = cg_example_block
            self.last_cg_residual = None
            self._cg_warned = False
            if sample_block is None:
                self.sample_block = sketch_probe_block(M, 1 << 30)
            with torch.no_grad():
                K = ops.model_outputs(state, state.flat_params, Z[:1]).shape[-1]
            self.d = M * K
            self.nys = None
            if precond_rank:
                omega = (precond_omega if precond_omega is not None else
                         torch.Generator(device=Z.device).manual_seed(0x4E59))
                self.nys = matfree_sketch(state, Z, min(precond_rank, self.d), omega,
                                          precond_power, cg_example_block, scale=self.beta)
            return
        self.R = ops.dense_wt(state, Z, example_block=example_block)
        self.d = self.R.shape[0]
        self.gram = syrk(self.R)
        self.lam, self.V = torch.linalg.eigh(ops.ensure_symmetry(self.gram, jitter=0.0))

    def logit_samples(self, x: torch.Tensor, alpha: float,
                      generator: torch.Generator, num_samples: int) -> torch.Tensor:
        """``(num_samples, B, K)`` predictive logit samples for one batch; the
        noise (``ε``, then the matfree path's ``η``) from ``generator``."""
        device = self.state.device
        x = x.to(device=device, dtype=torch.float32)
        if self.method == "weight":
            return amortized_logit_samples(
                self.state, self.R, self.lam, self.V, alpha, self.beta, x, generator,
                num_samples, self.rank_tol, self.range_clip_min, self.sample_block)
        eps = torch.randn(num_samples, self.state.spec.num_params, generator=generator,
                          device=device)
        eta = torch.randn(num_samples, self.d, generator=generator, device=device)
        out, res = matfree_logit_samples_from_noise(
            self.state, self.Z, self.nys, alpha, self.full_set_size, x, eps, eta, self.cg_tol,
            self.cg_maxiter, self.sample_block, self.cg_example_block)
        self.last_cg_residual = float(res)
        # floored at the f32-attainable residual: a tolerance below round-off
        # that bottoms out near 1e-6 is a converged solve, not a stall
        if not self._cg_warned and self.last_cg_residual > max(5 * self.cg_tol, 1e-5):
            self._cg_warned = True
            warnings.warn(
                f"ScalableLLAPredictor(method='matfree'): worst CG relative residual "
                f"{self.last_cg_residual:.2e} exceeds 5x cg_tol={self.cg_tol:g}: CG is "
                f"exiting on maxiter, not tolerance. The draw error is bounded by the "
                f"residual; raise precond_rank and/or cg_maxiter.", stacklevel=2)
        return out
