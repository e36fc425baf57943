"""Linearized-Laplace (LLA) predictive distributions.

Counterpart of ``laplace_inducing_points_tpu/inference/lla.py``: the dense
path for small models, ``Gaussian`` (``:29-45``), ``posterior_lla_dense``
(``:48``), ``_per_datum_jacobians`` (``:60``), ``predict_lla_dense``
(``:70``), ``predict_la_samples_dense`` (``:84``) and
``materialize_covariance`` (``:599``); the scalable serving path,
``predict_lla_scalable`` (``:107``), ``_amortized_logit_samples``
(``:133-174``), the matfree predictive's ``_matfree_logit_samples``
(``:183-296``; its ``_jitted_nystrom_sketch`` is ``matfree_sketch`` of
``training/inducing.py`` with scale β), the ``cov`` predictive's
``_joint_logit_samples`` (``:298-346``) and ``ScalableLLAPredictor`` with
``method="weight"``, ``"cov"`` or ``"matfree"`` (``:348-596``), with its
``mesh``: the sample axis split over a ``parallel.mesh.Mesh``.
:class:`DenseLLAPredictor`
hoists the dense path's α-independent GGN out of the per-batch loop, as the
scalable predictor hoists its factor.

``jax.random`` streams cannot be reproduced in PyTorch, so each sampling step
is split in two: a ``*_from_noise`` function takes the noise as an argument
(the twin tests feed both packages the same arrays), and its caller draws it
from an explicit ``torch.Generator``. Where the sampler's factor is unique
only up to column signs (the SVD of ``predict_la_samples_dense``, the
per-image ``eigh`` of the ``cov`` path), the twins compare the factor's
product, not the draws.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.func import vmap

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.inference.sample import _g_weights, make_matheron_sampler
from laplace_inducing_points_tpu_torch.inference.sample import sample as sample_weights
from laplace_inducing_points_tpu_torch.ops.nystrom import sketch_probe_block
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.training.inducing import matfree_sketch
from laplace_inducing_points_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class Gaussian:
    """Mean and full covariance, with the few operations the pipeline needs."""
    mean: torch.Tensor           # (..., K)
    cov: torch.Tensor            # (..., K, K)

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(torch.diagonal(self.cov, dim1=-2, dim2=-1), min=0.0))

    def sample_from_noise(self, eps: torch.Tensor) -> torch.Tensor:
        """``mean + chol(cov + 1e-8 I) ε`` for ``eps (S, ..., K)``; a factor
        that fails is NaN, as the reference's is."""
        k = self.cov.shape[-1]
        jitter = 1e-8 * torch.eye(k, dtype=self.cov.dtype, device=self.cov.device)
        chol, info = torch.linalg.cholesky_ex(self.cov + jitter)
        chol = torch.where((info == 0)[..., None, None], chol, torch.full_like(chol, math.nan))
        return self.mean + torch.einsum("...ij,s...j->s...i", chol, eps)

    def sample(self, generator: torch.Generator, num_samples: int) -> torch.Tensor:
        """``(num_samples, ..., K)`` draws, ``ε`` from ``generator``."""
        eps = torch.randn((num_samples, *self.mean.shape), generator=generator,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.sample_from_noise(eps)


def _inverse(S_prec: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(S_prec.shape[0], dtype=S_prec.dtype, device=S_prec.device)
    return torch.linalg.solve(S_prec, eye)


def posterior_lla_dense(state, X: torch.Tensor, alpha: float,
                        full_set_size: Optional[int] = None) -> Gaussian:
    """Dense weight posterior ``N(θ_MAP, (GGN + αI)⁻¹)``."""
    cov = _inverse(ops.curvature_dense(state, X, alpha, full_set_size))
    return Gaussian(mean=state.flat_params, cov=cov)


def _per_datum_jacobians(state, Xnew: torch.Tensor):
    """``(J (N, K, D), f0 (N, K))`` at the state's weights."""
    return ops.jacobian_fn(state)(Xnew)


def predictive_from_cov(state, Xnew: torch.Tensor, cov: torch.Tensor) -> Gaussian:
    """``N(f(x*), J* cov J*ᵀ)`` per datum for a weight covariance ``cov``."""
    J, f_mean = _per_datum_jacobians(state, Xnew)                 # (N, K, D)
    f_cov = ops.pdot(ops.pdot(J, cov), J.transpose(1, 2))
    return Gaussian(mean=f_mean, cov=f_cov)


def predict_lla_dense(state, Xnew: torch.Tensor, Z: torch.Tensor, alpha: float,
                      full_set_size: Optional[int] = None) -> Gaussian:
    """Dense LLA predictive ``N(f(x*), J* S⁻¹ J*ᵀ)`` per datum, ``S`` the dense
    curvature at ``Z`` (true f32: TF32 is off)."""
    cov = _inverse(ops.curvature_dense(state, Z, alpha, full_set_size))
    return predictive_from_cov(state, Xnew, cov)


def la_covariance_factor(state, Z: torch.Tensor, alpha: float,
                         full_set_size: Optional[int] = None) -> torch.Tensor:
    """``F = U·√s`` from the SVD of the dense posterior covariance ``S⁻¹``
    (``F Fᵀ = S⁻¹``), the factor ``jax.random.multivariate_normal(method=
    "svd")`` draws through."""
    cov = _inverse(ops.curvature_dense(state, Z, alpha, full_set_size))
    U, s, _ = torch.linalg.svd(cov)
    return U * torch.sqrt(s)[None, :]


def predict_la_samples_dense_from_noise(state, Xnew: torch.Tensor, factor: torch.Tensor,
                                        eps: torch.Tensor) -> torch.Tensor:
    """The non-linearized Laplace predictive on given noise ``eps (S, D)``:
    weights ``θ_MAP + F ε`` pushed through the full network, ``(S, N, K)``."""
    flat_samples = state.flat_params[None] + ops.pdot(eps, factor.T)
    return torch.stack([ops.model_outputs(state, w, Xnew) for w in flat_samples])


def predict_la_samples_dense(state, Xnew: torch.Tensor, Z: torch.Tensor, alpha: float,
                             generator: torch.Generator,
                             full_set_size: Optional[int] = None,
                             num_mc_samples: int = 100) -> torch.Tensor:
    """Non-linearized Laplace MC baseline: weights from the dense posterior,
    each pushed through the full nonlinear network; ``ε`` from ``generator``."""
    factor = la_covariance_factor(state, Z, alpha, full_set_size)
    eps = torch.randn(num_mc_samples, factor.shape[0], generator=generator,
                      device=factor.device, dtype=factor.dtype)
    return predict_la_samples_dense_from_noise(state, Xnew, factor, eps)


class DenseLLAPredictor:
    """The dense LLA predictive for a fixed ``(state, Z)``: the ``D × D`` GGN
    at ``Z`` is built once (it is α-independent); each batch then inverts
    ``GGN + αI`` and samples :func:`predictive_from_cov`'s Gaussian, as
    :func:`predict_lla_dense` does. Small models only."""

    def __init__(self, state, Z: torch.Tensor, *, full_set_size: Optional[int] = None):
        self.state = state
        self.ggn = ops.make_ggn_operator(state, Z, full_set_size).dense()

    def predictive(self, x: torch.Tensor, alpha: float) -> Gaussian:
        eye = torch.eye(self.ggn.shape[0], dtype=self.ggn.dtype, device=self.ggn.device)
        return predictive_from_cov(self.state, x, _inverse(self.ggn + alpha * eye))

    def logit_samples(self, x: torch.Tensor, alpha: float, generator: torch.Generator,
                      num_samples: int, cache_key=None) -> torch.Tensor:
        """``(num_samples, B, K)`` draws of the dense predictive at ``x``."""
        x = x.to(device=self.state.device, dtype=torch.float32)
        return self.predictive(x, alpha).sample(generator, num_samples)


def materialize_covariance(f_cov_vp: Callable[[torch.Tensor], torch.Tensor], n: int,
                           out_dim: int, mode: str = "diag") -> torch.Tensor:
    """Probe a covariance operator into its diagonal (``(n, out_dim)``) or its
    full matrix, one basis vector a probe (vmapped)."""
    k = n * out_dim
    eye = torch.eye(k)
    cols = vmap(lambda e: f_cov_vp(e).reshape(k))(eye)           # (k, k)
    if mode == "diag":
        return torch.diagonal(cols).reshape(n, out_dim)
    if mode == "full":
        return cols.T
    raise ValueError("mode must be 'diag' or 'full'")


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
    lin = None

    def draw(e: torch.Tensor) -> torch.Tensor:
        nonlocal lin
        with span("contract"):
            U = matmul_nt(e, R)                                # (n, d)
            mixed = ops.pdot(U, V) * g                         # (n, d) · diag(g)
            w = e / math.sqrt(alpha) + matmul_nn(ops.pdot(mixed, V.T), R)
        with span("pushforward"):
            if lin is None:         # the primal outputs f0, once, with the first block
                lin = ops.linearize_model(state, x)
            return vmap(lin.jvp)(w)                            # (n, B, K)

    S = eps.shape[0]
    if not sample_block or sample_block >= S:
        pushed = draw(eps)
    else:
        pushed = torch.cat([draw(eps[i:i + sample_block]) for i in range(0, S, sample_block)])
    return lin.f0[None] + pushed


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


def cov_predictive_sigma(JJt: torch.Tensor, A: torch.Tensor, gram: torch.Tensor,
                         lam: torch.Tensor, V: torch.Tensor, alpha: float, beta: float,
                         rank_tol: float = 1e-7,
                         range_clip_min: Optional[float] = None) -> torch.Tensor:
    """The per-image predictive covariance ``Σ = J S⁻¹ Jᵀ`` (symmetrised),
    ``(B, K, K)``, from the statistics ``JJᵀ`` and ``A = J Rᵀ``.

    With the g-form factor ``S^{-1/2} = I/√α + Rᵀ H R``, ``H = V diag(g) Vᵀ``:
    ``Σ = JJᵀ/α + A·[(2/√α)·H + H·Gzz·H]·Aᵀ``, every operator bounded (the
    clip included) and the quadratic on the true Gram, not its eigh
    reconstruction (the reference's notes give the assemblies that fail).
    """
    g = _g_weights(lam, alpha, beta, rank_tol, range_clip_min)
    H = ops.pdot(V * g, V.T)                                      # (d_z, d_z)
    Hp = (2.0 / math.sqrt(alpha)) * H + ops.pdot(ops.pdot(H, gram), H)
    Sigma = JJt / alpha + ops.pdot(ops.pdot(A, Hp), A.transpose(1, 2))
    return 0.5 * (Sigma + Sigma.transpose(1, 2))


def joint_logit_samples_from_noise(f0: torch.Tensor, JJt: torch.Tensor, A: torch.Tensor,
                                   gram: torch.Tensor, lam: torch.Tensor, V: torch.Tensor,
                                   alpha: float, beta: float, eta: torch.Tensor,
                                   rank_tol: float = 1e-7,
                                   range_clip_min: Optional[float] = None) -> torch.Tensor:
    """Logit samples ``(S, B, K)`` of the ``cov`` predictive on given noise
    ``eta (S, B, K)``: each image's ``N(f0, Σ)`` through a per-image K×K eigh
    with eigenvalues clipped at 0. Images draw independently, so every
    per-image marginal is the weight path's."""
    Sigma = cov_predictive_sigma(JJt, A, gram, lam, V, alpha, beta, rank_tol, range_clip_min)
    ev, Q = torch.linalg.eigh(Sigma)
    L = Q * torch.sqrt(torch.clamp(ev, min=0.0))[..., None, :]   # (B, K, K)
    return f0[None] + torch.einsum("bkj,sbj->sbk", L, eta)


# the cov self-check: draws per path, the band of a variance ratio, and the
# share of entries outside it that counts as a failure
COV_CHECK_SAMPLES = 64
COV_CHECK_BAND = 3.0
COV_CHECK_TAIL = 0.02


class ScalableLLAPredictor:
    """Amortized IP-LLA predictive for a fixed ``(state, Z)``.

    ``method="weight"``: the ``(d×D)`` row factor, its SYRK Gram and the
    ``d×d`` eigendecomposition are built once here; each batch then costs two
    long contractions (the ``matmul_nt``/``matmul_nn`` kernels), two small
    ``d×d`` products and one batched jvp.

    ``method="cov"``: the same factor; each batch's per-image statistics
    ``(f0, JJᵀ, J Rᵀ)`` (:func:`core.operators.predictive_jac_stats`, K
    backward passes an image, ``jac_block`` images at a time) replace the
    per-sample push-forward, and the samples come from each image's K-dim
    Gaussian (:func:`joint_logit_samples_from_noise`). The statistics are
    α-independent: :meth:`batch_stats` caches them under the caller's
    ``cache_key`` (``cache_hits`` counts the reuses). On the first batch a
    self-check compares its variances with a weight-path draw and warns when
    the f32 covariance assembly has left its range.

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

    ``mesh`` (a ``parallel.mesh.Mesh``) spreads evaluation over its devices
    along ``mesh_axis``: the state and the factor (or the sketch) are
    replicated on each, and each batch's draws, made from the caller's
    generator as without a mesh, are split along the sample axis, pushed
    forward on their devices and gathered on the first. The numbers are the
    single-device ones. ``method="cov"`` runs unsharded: its per-sample cost
    is a K-dim Gaussian draw, nothing worth splitting.
    """

    def __init__(self, state, Z: torch.Tensor, *,
                 full_set_size: Optional[int] = None,
                 example_block: Optional[int] = None,
                 rank_tol: float = 1e-7,
                 range_clip_min: Optional[float] = None,
                 sample_block: Optional[int] = None,
                 method: str = "weight", jac_block: Optional[int] = None,
                 cg_tol: float = 1e-4, cg_maxiter: Optional[int] = None,
                 precond_rank: Optional[int] = 64, precond_power: int = 0,
                 precond_omega=None, cg_example_block: Optional[int] = None,
                 mesh=None, mesh_axis: str = "data"):
        if method not in ("weight", "cov", "matfree"):
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
            self._replicate(mesh, mesh_axis, (Z, self.nys))
            return
        self.R = ops.dense_wt(state, Z, example_block=example_block)
        self.d = self.R.shape[0]
        self.gram = syrk(self.R)
        self.lam, self.V = torch.linalg.eigh(ops.ensure_symmetry(self.gram, jitter=0.0))
        self.jac_block = jac_block
        self._stats_cache: dict = {}
        self.cache_hits = 0
        self.cov_check_frac = None           # the self-check's share outside the band
        self._replicate(None if method == "cov" else mesh, mesh_axis,
                        (self.R, self.lam, self.V))

    def _replicate(self, mesh, axis: str, factor: tuple) -> None:
        """``self.shards``: ``(device, state, factor)`` on each device along
        ``axis`` of ``mesh`` (``factor``'s tensors, or tuples of them, copied
        there); without a mesh, the one shard this predictor holds."""
        if mesh is None:
            self.shards = [(self.state.device, self.state, factor)]
            return

        def to(t, d):
            if isinstance(t, tuple):
                return tuple(to(u, d) for u in t)
            return None if t is None else t.to(d)

        self.shards = [(rep.device, rep, to(factor, rep.device))
                       for rep in mesh.replicate(self.state, axis)]

    def _split(self, draw, *noise) -> list:
        """``draw(state, factor, *noise shard)`` on each shard's device with
        its share of the sample axis of every ``noise`` tensor."""
        chunks = [t.tensor_split(len(self.shards)) for t in noise]
        outs = []
        for k, (device, rep, factor) in enumerate(self.shards):
            parts = [c[k].to(device) for c in chunks]
            if len(parts[0]):
                outs.append(draw(rep, factor, *parts))
        return outs

    def batch_stats(self, x: torch.Tensor, cache_key=None):
        """The α-independent per-image statistics ``(f0, JJᵀ, J Rᵀ)`` of
        ``method="cov"``, cached under ``cache_key``. The key must name the
        batch's content among all callers of this predictor; a batch of
        another shape under a used key is computed anew (the shape guard)."""
        if cache_key is not None and cache_key in self._stats_cache:
            shape, stats = self._stats_cache[cache_key]
            if shape == tuple(x.shape):
                self.cache_hits += 1
                return stats
        x = x.to(device=self.state.device, dtype=torch.float32)
        stats = ops.predictive_jac_stats(self.state, x, self.R, jac_block=self.jac_block)
        if cache_key is not None:
            self._stats_cache[cache_key] = (tuple(x.shape), stats)
        return stats

    def _cov_self_check(self, x: torch.Tensor, alpha: float) -> None:
        """Once, on the first ``cov`` batch: the per-image logit variances of
        64 ``cov`` draws against 64 weight-path draws. Where more than 2% of
        them differ by more than 3× (the f32 covariance assembly cancels terms
        ~JJᵀ/α by the posterior's contraction ratio, where the weight path
        pays its square root), it warns to use ``method="weight"``. The share
        is kept in ``cov_check_frac``."""
        if self.cov_check_frac is not None:
            return
        device = self.state.device
        n = COV_CHECK_SAMPLES
        w_draws = amortized_logit_samples(
            self.state, self.R, self.lam, self.V, alpha, self.beta, x,
            torch.Generator(device=device).manual_seed(0), n, self.rank_tol,
            self.range_clip_min, self.sample_block)
        f0, JJt, A = self.batch_stats(x)
        eta = torch.randn((n, *f0.shape), generator=torch.Generator(device=device).manual_seed(1),
                          device=device, dtype=f0.dtype)
        c_draws = joint_logit_samples_from_noise(f0, JJt, A, self.gram, self.lam, self.V,
                                                 alpha, self.beta, eta, self.rank_tol,
                                                 self.range_clip_min)
        self.cov_check_frac = cov_check_fraction(w_draws, c_draws)
        if self.cov_check_frac > COV_CHECK_TAIL:
            warnings.warn(
                f"ScalableLLAPredictor(method='cov'): {100 * self.cov_check_frac:.0f}% of "
                f"per-image logit variances disagree with a weight-path draw by "
                f">{COV_CHECK_BAND:g}x: the posterior's contraction ratio at this operating "
                f"point likely exceeds the f32 covariance-assembly range. Use "
                f"method='weight' (--predictive weight) here.", stacklevel=3)

    def logit_samples(self, x: torch.Tensor, alpha: float,
                      generator: torch.Generator, num_samples: int,
                      cache_key=None) -> torch.Tensor:
        """``(num_samples, B, K)`` predictive logit samples for one batch; the
        noise (``ε``; the cov path's ``η (S, B, K)``; the matfree path's ``ε``
        then ``η``) from ``generator``. ``cache_key`` names the batch for the
        cov path's statistics cache."""
        with span("predict"):
            device = self.state.device
            x = x.to(device=device, dtype=torch.float32)
            if self.method == "weight":
                eps = torch.randn(num_samples, self.R.shape[1], generator=generator,
                                  device=device, dtype=self.R.dtype)
                outs = self._split(
                    lambda rep, f, e: amortized_logit_samples_from_noise(
                        rep, *f, alpha, self.beta, x.to(rep.device), e, self.rank_tol,
                        self.range_clip_min, self.sample_block), eps)
                return torch.cat([o.to(device) for o in outs])
            if self.method == "cov":
                f0, JJt, A = self.batch_stats(x, cache_key)
                eta = torch.randn((num_samples, *f0.shape), generator=generator, device=device,
                                  dtype=f0.dtype)
                out = joint_logit_samples_from_noise(f0, JJt, A, self.gram, self.lam, self.V,
                                                     alpha, self.beta, eta, self.rank_tol,
                                                     self.range_clip_min)
                self._cov_self_check(x, alpha)
                return out
            eps = torch.randn(num_samples, self.state.spec.num_params, generator=generator,
                              device=device)
            eta = torch.randn(num_samples, self.d, generator=generator, device=device)
            outs = self._split(
                lambda rep, f, e, t: matfree_logit_samples_from_noise(
                    rep, *f, alpha, self.full_set_size, x.to(rep.device), e, t, self.cg_tol,
                    self.cg_maxiter, self.sample_block, self.cg_example_block), eps, eta)
            out = torch.cat([o.to(device) for o, _ in outs])
            res = max(float(r) for _, r in outs)
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


def cov_check_fraction(w_draws: torch.Tensor, c_draws: torch.Tensor) -> float:
    """The share of (image, class) logit variances whose weight-path to
    cov-path ratio lies outside ``[1/3, 3]``."""
    v_w = torch.var(w_draws, dim=0, unbiased=False)
    v_c = torch.var(c_draws, dim=0, unbiased=False)
    ratio = v_w / torch.clamp(v_c, min=1e-12)
    bad = (ratio < 1.0 / COV_CHECK_BAND) | (ratio > COV_CHECK_BAND)
    return float(torch.mean(bad.float()))
