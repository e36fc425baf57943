"""Inducing-point optimization: learn ``Z`` by minimizing
``KL[q(θ|Z) ‖ q(θ|D)]``, on the exact Gram KL, its stochastic estimate or
the dense D × D oracle.

Counterpart of ``laplace_inducing_points_tpu/training/inducing.py``:
``kl_objective_dense`` (``:51``), ``_grams`` (``:62``), ``_pivot_jitter``
(``:72``), ``_kl_core`` (``:87``), ``kl_objective_gram`` (``:124``),
``kl_objective_stochastic`` (``:142``) both ways, ``OBJECTIVES`` (``:340``),
``matfree_cg_healthcheck`` (``:472``, one function: the reference's staged
probes are compile workarounds), ``kl_grad_gram_chunked`` (``:627``),
``optimize_step`` (``:684``; ``gram_chunked`` takes the chunk of
``optimize_step_chunked``, ``:653``) for the ``dense``, ``gram``,
``gram_chunked``, ``stochastic`` and ``stochastic_matfree`` objectives, ``full_set_kl`` (``:724``),
``train_inducing_points_restarts`` (``:733``) and ``train_inducing_points``
(``:795``) with its divergence guard.

The Gram ``Gzz = Rz Rzᵀ`` goes through the ``syrk`` kernel, the long
products with the rows through ``matmul_nt``/``matmul_nn`` and the stochastic
objective's GGN probe sweeps through ``ggn_sweep``; their backward passes are
kernels too (``ops/cuda``). A step computes ``dL/dZ`` the way the reference's
chunked gradient does (``kl_grad_gram_chunked``, ``:627``), in eager form: the
rows without a tape, ``∂L/∂Rz`` by autograd through the algebra on the rows
and the kernels, then the row build's pullback one example block at a time
(``core.operators.dense_wt_pullback``); ``gram_chunked`` is that step with
the rows built and pulled back in chunks of ``example_block or 4`` examples,
as the reference's is. The stochastic objective is computed
from the materialized rows in the same way: the same function as the
reference's jvp/vjp operators, with ``S_X = γ·RxᵀRx + αI`` applied by the
sweep kernel. :func:`kl_objective_gram` and :func:`kl_objective_stochastic`
stay differentiable end to end, as the reference's are.

The matfree objective (``materialize_w=False``) never forms ``Rz`` or the
``d_z × d_z`` Gram: the Woodbury solve is a batched CG (``ops/cg.py``, its
gradient implicit) on ``X ↦ Wzᵀ(Wz X) + (α/β)X`` through the matrix-free
factor (example-blocked with ``cg_example_block``), preconditioned by a
Nyström sketch built without a graph, and the SLQ log-det runs the stacked
operator ``[√α v; √β Wzᵀv]`` matrix-free with each Krylov step recomputed in
the backward pass. ``S_X`` keeps the materialized design: the data batch's
rows ``Rx`` (``d_x × D``, independent of M) through the ``ggn_sweep``
kernel. Its ``dL/dZ`` is plain autograd through it all.

On a CUDA device ``optimize_step`` replays the gram objectives'
value-and-grad (rows, Gram algebra, its backward, pullback) from one CUDA
graph per ``Z``: the step is a fixed sequence of launches on fixed shapes,
with no host read, so the host's cost per launch leaves the step's pace.
The first call with a new :func:`graph_key` runs eager (the warm-up of every
handle, plan and lazy state the capture needs), the second captures and
replays, every later one copies its batch into the graph's own and replays.
A capture that fails leaves that key eager, with one warning. The CPU, the
other objectives and the direct calls of :func:`kl_value_and_grad_gram` run
eager as ever.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Iterable, Optional, Union

import torch
from torch.utils.weak import WeakIdKeyDictionary

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.ops import cg as cg_mod
from laplace_inducing_points_tpu_torch.ops import slq as slq_mod
from laplace_inducing_points_tpu_torch.ops import stochtrace as st
from laplace_inducing_points_tpu_torch.ops.nystrom import (nystrom_sketch,
                                                           precond_from_sketch,
                                                           precond_inv_sqrt_from_sketch,
                                                           sketch_probe_block)
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array
from laplace_inducing_points_tpu_torch.utils.profiling import span


def kl_objective_dense(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                       probes=None, full_set_size: Optional[int] = None) -> torch.Tensor:
    """``tr(S S_z⁻¹) + logdet(S_z)`` through the dense ``D × D`` curvatures
    (the Z-independent ``logdet S`` dropped); the test oracle of the Gram
    KL, differentiable in ``Z``. ``probes`` is unused (the objectives share a
    signature)."""
    S = ops.curvature_dense(state, X, alpha, full_set_size)
    S_z = ops.curvature_dense(state, Z, alpha, full_set_size)
    S_z_inv = torch.linalg.inv(S_z)
    trace_term = torch.trace(ops.pdot(S, S_z_inv))
    logdet_term = -torch.linalg.slogdet(S_z_inv)[1]
    return trace_term + logdet_term


def grams_from_rows(Rz: torch.Tensor, Rx: torch.Tensor):
    """``(Gzz, Gxz, tr Gxx, D)`` from the unscaled rows."""
    return syrk(Rz), matmul_nt(Rx, Rz), torch.sum(Rx * Rx), Rz.shape[1]


def _grams(state, Z: torch.Tensor, X: torch.Tensor, example_block: Optional[int] = None):
    """Unscaled Gram blocks through materialized ``Lᵀ J`` rows."""
    Rz = ops.dense_wt(state, Z, example_block=example_block)     # (d_z, D)
    Rx = ops.dense_wt(state, X, example_block=example_block)     # (d_x, D)
    return grams_from_rows(Rz, Rx)


def _pivot_jitter(C: torch.Tensor) -> torch.Tensor:
    """Cholesky pivot-safety jitter for a theoretically-PD matrix: 2e-6 times
    the Gershgorin bound on λ_max (f32 round-off perturbs the spectrum by
    O(ε·λ_max); see the reference's note)."""
    return 2e-6 * torch.max(torch.sum(torch.abs(C), dim=1))


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all NaN where ``A`` is not positive definite.

    ``torch.linalg.cholesky`` raises there, while the reference's factor turns
    NaN and the NaN loss is what stops ``train_inducing_points``. The check
    stays on the device: no host sync per step.
    """
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, math.nan))


def _c_cholesky(Gzz: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """Lower Cholesky factor of the C-form ``C = Gzz + (α/β)I`` (with
    ``Mᵢ = β⁻¹I + α⁻¹Gzz = α⁻¹C``), symmetrized and pivot-jittered: every
    factored matrix stays at the Gram's own scale."""
    eye = torch.eye(Gzz.shape[0], dtype=Gzz.dtype, device=Gzz.device)
    C = Gzz + (alpha / beta) * eye
    return _cholesky(ops.ensure_symmetry(C, jitter=0.0) + _pivot_jitter(C) * eye)


class _Trace(torch.autograd.Function):
    """``torch.trace`` of a matrix, its cotangent put on the diagonal of
    zeros on the device: PyTorch's own backward fills the diagonal through
    ``index_fill_`` with a tensor value, which reads it on the host, and a
    host read stops the capture of the Z step's CUDA graph. The same values
    both ways."""

    @staticmethod
    def forward(A):
        return torch.trace(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape = inputs[0].shape

    @staticmethod
    def backward(ctx, ct):
        grad = ct.new_zeros(ctx.shape)
        grad.diagonal().copy_(ct.expand(min(ctx.shape)))
        return grad


def _kl_core(Gzz, Gxz, tr_Gxx, D: int, alpha: float, beta: float, gamma: float,
             include_constants: bool = True) -> torch.Tensor:
    """KL value from the small Gram blocks.

    With β=N/M, γ=N/K, Mᵢ = β⁻¹I + α⁻¹Gzz:

      trace  = D + γα⁻¹tr(Gxx) − α⁻¹tr(Mᵢ⁻¹Gzz) − γα⁻²tr(Gxz Mᵢ⁻¹ Gxzᵀ)
      logdet = D·log α + logdet(I + (β/α)·Gzz)

    in the reference's C-form, ``C = Gzz + (α/β)I = αMᵢ``, which keeps every
    factored matrix at the Gram's own scale.
    """
    a_inv = 1.0 / alpha
    d_z = Gzz.shape[0]
    L = _c_cholesky(Gzz, alpha, beta)
    C_inv_Gzz = torch.cholesky_solve(Gzz, L)
    C_inv_Gxz_t = torch.cholesky_solve(Gxz.T, L)

    trace_term = (-_Trace.apply(C_inv_Gzz)
                  - gamma * a_inv * torch.sum(Gxz.T * C_inv_Gxz_t))
    # logdet(I + (β/α)Gzz) = d_z·log(β/α) + logdet(C), via the Cholesky
    logdet_term = (d_z * math.log(beta * a_inv)
                   + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    if include_constants:
        trace_term = trace_term + D + gamma * a_inv * tr_Gxx
        logdet_term = logdet_term + D * math.log(alpha)
    return trace_term + logdet_term


def _calibration(M: int, n_x: int, full_set_size: Optional[int]) -> tuple[float, float]:
    """``(β, γ) = (N/M, N/|X|)``."""
    N = full_set_size or M
    return N / M, N / n_x


def kl_objective_gram(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                      full_set_size: Optional[int] = None,
                      include_constants: bool = True,
                      example_block: Optional[int] = None) -> torch.Tensor:
    """Exact KL through the small Grams, differentiable in ``Z``.

    Z-independent constants are kept by default, as in the reference, so the
    value matches the dense KL.
    """
    beta, gamma = _calibration(Z.shape[0], X.shape[0], full_set_size)
    return _kl_core(*_grams(state, Z, X, example_block), alpha, beta, gamma,
                    include_constants)


def _rows_value_and_grad(loss_of_rows: Callable, Rz: torch.Tensor, Rx: torch.Tensor):
    """``(loss, ∂loss/∂Rz)`` of ``loss_of_rows(Rz, Rx)`` for fixed rows; the
    backward runs the kernels' backward passes (``Rx`` needs none)."""
    Rz = Rz.detach().requires_grad_()
    with torch.enable_grad():
        with span("objective.forward"):
            loss = loss_of_rows(Rz, Rx.detach())
        with span("objective.backward"):
            (ct,) = torch.autograd.grad(loss, Rz)
    return loss.detach(), ct


def kl_rows_value_and_grad(Rz: torch.Tensor, Rx: torch.Tensor, alpha: float,
                           beta: float, gamma: float,
                           include_constants: bool = True):
    """``(KL, ∂KL/∂Rz)`` for fixed rows through the Gram algebra."""
    return _rows_value_and_grad(
        lambda rz, rx: _kl_core(*grams_from_rows(rz, rx), alpha, beta, gamma,
                                include_constants), Rz, Rx)


def kl_value_and_grad_gram(Z: torch.Tensor, X: torch.Tensor, state, alpha: float, *,
                           full_set_size: Optional[int] = None,
                           include_constants: bool = True,
                           example_block: Optional[int] = None):
    """``(KL, dKL/dZ)`` of :func:`kl_objective_gram`, staged: rows, Gram
    algebra and its backward, row pullback in blocks of ``example_block``."""
    beta, gamma = _calibration(Z.shape[0], X.shape[0], full_set_size)
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z, example_block=example_block)
        Rx = ops.dense_wt(state, X, example_block=example_block)
    loss, ct = kl_rows_value_and_grad(Rz, Rx, alpha, beta, gamma, include_constants)
    del Rz, Rx
    return loss, ops.dense_wt_pullback(state, Z, ct, example_block=example_block)


def kl_grad_gram_chunked(Z: torch.Tensor, X: torch.Tensor, state, alpha: float, *,
                         full_set_size: Optional[int] = None, chunk: int = 4,
                         include_constants: bool = True):
    """``(KL, dKL/dZ)`` of the gram KL with the rows of ``Z`` and ``X`` built,
    and the row cotangent pulled back, ``chunk`` examples at a time: only one
    chunk's activations and second-order tape are alive at once. The same
    function as :func:`kl_value_and_grad_gram`."""
    return kl_value_and_grad_gram(Z, X, state, alpha, full_set_size=full_set_size,
                                  include_constants=include_constants,
                                  example_block=chunk)


@dataclass(frozen=True)
class Products:
    """The long products of the stochastic objective: ``syrk(A) = A Aᵀ``,
    ``nt(A, B) = A Bᵀ``, ``nn(A, B) = A B`` and ``sweep(V, R, s) = s·(V Rᵀ) R``.
    The objective runs on :data:`KERNEL_PRODUCTS`; another set (the plain
    versions, the FP32 sweep) evaluates the same algebra for comparison."""
    syrk: Callable
    nt: Callable
    nn: Callable
    sweep: Callable


KERNEL_PRODUCTS = Products(syrk, matmul_nt, matmul_nn, ggn_sweep)


def probe_split(st_samples: int) -> tuple[int, int]:
    """Hutch++'s ``(s1, s2)``: ``s2 = min(16, max(st_samples // 4, 1))``
    residual probes, the rest for the range finder."""
    s2 = min(16, max(st_samples // 4, 1))
    return st_samples - s2, s2


def stochastic_composite(Rz: torch.Tensor, Rx: torch.Tensor, L: torch.Tensor,
                         alpha: float, gamma: float,
                         products: Products = KERNEL_PRODUCTS) -> Callable:
    """``V (P, D) ↦ S_X S_z⁻¹ V``, the operator whose trace Hutch++ estimates.

    ``S_z⁻¹V = α⁻¹V − α⁻¹·Rzᵀ C⁻¹ Rz V`` (Woodbury in the C-form, ``L`` the
    factor of ``C``; the reference's ``sz_inv_vp``, ``:279-282``) runs in the
    true-FP32 kernels, because its correction cancels ``V`` along the stiff
    directions. ``S_X W = γ·(W Rxᵀ) Rx + αW`` is
    ``ops.ggn_matmat_materialized(state, X, W, full_set_size=N, R=Rx) + αW``:
    the probe sweep, at estimator precision.
    """
    a_inv = 1.0 / alpha

    def composite(V: torch.Tensor) -> torch.Tensor:
        V = V.contiguous()
        X = torch.cholesky_solve(products.nt(V, Rz).T, L).T.contiguous()   # C⁻¹ Rz V
        W = a_inv * V - a_inv * products.nn(X, Rz)
        return products.sweep(W, Rx, gamma) + alpha * W

    return composite


def stacked_operator(Rz: torch.Tensor, alpha: float, beta: float,
                     products: Products = KERNEL_PRODUCTS) -> tuple[Callable, Callable]:
    """``G v = [√α v; √β Rz v]`` and its adjoint ``Gᵀ[a; b] = √α a + √β Rzᵀ b``,
    so that ``GᵀG = αI + β RzᵀRz = S_z`` (``:322-328``)."""
    D = Rz.shape[1]
    sqrt_alpha, sqrt_beta = math.sqrt(alpha), math.sqrt(beta)

    def stacked(v: torch.Tensor) -> torch.Tensor:
        return torch.cat([sqrt_alpha * v, sqrt_beta * products.nt(v[None], Rz)[0]])

    def stacked_t(w: torch.Tensor) -> torch.Tensor:
        return sqrt_alpha * w[:D] + sqrt_beta * products.nn(w[None, D:], Rz)[0]

    return stacked, stacked_t


def kl_stochastic_from_rows(Rz: torch.Tensor, Rx: torch.Tensor, alpha: float,
                            beta: float, gamma: float, probes: torch.Tensor,
                            slq_samples: int, slq_num_matvecs: int,
                            products: Products = KERNEL_PRODUCTS) -> torch.Tensor:
    """Hutch++ ``tr(S_X S_z⁻¹)`` plus SLQ ``logdet(S_z)`` from the unscaled rows,
    the probes shared: ``probes[:slq_samples]`` also feed the log-det."""
    L = _c_cholesky(products.syrk(Rz), alpha, beta)
    s1, s2 = probe_split(probes.shape[0])
    trace_term = st.hutchpp(stochastic_composite(Rz, Rx, L, alpha, gamma, products),
                            probes, s1=s1, s2=s2)
    stacked, stacked_t = stacked_operator(Rz, alpha, beta, products)
    logdet_term = slq_mod.slq_logdet_product(stacked, probes[:slq_samples],
                                             num_matvecs=slq_num_matvecs,
                                             t_matvec=stacked_t)
    return trace_term + logdet_term


def _stochastic_setup(Z: torch.Tensor, X: torch.Tensor, state,
                      probes: Union[torch.Tensor, torch.Generator],
                      full_set_size: Optional[int], st_samples: int,
                      slq_num_matvecs: Optional[int]):
    """``(β, γ, probes, slq_num_matvecs)`` of a stochastic objective call:
    probes drawn from a generator (Rademacher, ``(st_samples, D)``) or checked."""
    M = Z.shape[0]
    beta, gamma = _calibration(M, X.shape[0], full_set_size)
    D = state.spec.num_params
    if isinstance(probes, torch.Generator):
        probes = st.rademacher_probes(probes, st_samples, D, device=state.device)
    elif tuple(probes.shape) != (st_samples, D):
        raise ValueError(f"probes have shape {tuple(probes.shape)}; expected "
                         f"(st_samples, D) = ({st_samples}, {D})")
    return beta, gamma, probes, slq_num_matvecs or max(int(0.8 * M), 4)


def matfree_sketch(state, Z: torch.Tensor, rank: int,
                   omega: Union[torch.Tensor, torch.Generator], power: int = 0,
                   cg_example_block: Optional[int] = None, scale: float = 1.0):
    """The Nyström sketch ``(U, lam, good)`` of ``scale·WzᵀWz`` at ``Z``, built
    without a graph through the factor over example blocks of
    ``cg_example_block``, its probes in chunks of ``sketch_probe_block``: the
    preconditioner of one matfree step (``scale`` 1), or of the Matheron
    solves against ``βG + αI`` (``scale`` β)."""
    with torch.no_grad():
        wz = ops.make_w_factor(state, Z.detach(), example_block=cg_example_block)
        blk = sketch_probe_block(wz.inner_shape[0], rank)
        return nystrom_sketch(lambda V: scale * wz.gram_matmat(V, block=blk), wz.d, rank,
                              omega, power=power)


def matfree_trace_term(Z: torch.Tensor, X: torch.Tensor, state, alpha: float, beta: float,
                       gamma: float, probes: torch.Tensor, *, cg_tol: float = 1e-3,
                       cg_maxiter: Optional[int] = None, sketch=None,
                       cg_example_block: Optional[int] = None,
                       sweep: Callable = ggn_sweep) -> torch.Tensor:
    """Hutch++ ``tr(S_X S_z⁻¹)`` with nothing of size ``d_z × D`` or
    ``d_z × d_z``, differentiable in ``Z``.

    ``S_z⁻¹V = α⁻¹V − α⁻¹·Wz C⁻¹ WzᵀV`` with ``C⁻¹`` a batched CG solve of
    ``C = WzᵀWz + (α/β)I`` (``ops/cg.py``: every probe of a sweep in one loop,
    its gradient in ``Z`` implicit) on the factor over example blocks of
    ``cg_example_block``, preconditioned by ``sketch`` (``None``: plain CG).
    ``S_X W = γ·(W Rxᵀ) Rx + αW`` through ``sweep`` on the data batch's rows.
    ``cg_maxiter=None`` is ``10·d_z``.
    """
    a_inv = 1.0 / alpha
    rho = alpha / beta
    with torch.no_grad():
        Rx = ops.dense_wt(state, X)                                  # (d_x, D)
    wz = ops.make_w_factor(state, Z)
    wz_cg = ops.make_w_factor(state, Z, example_block=cg_example_block)
    Mk, Kk = wz.inner_shape
    d_z = Mk * Kk
    maxiter = 10 * d_z if cg_maxiter is None else cg_maxiter
    precond = None if sketch is None else precond_from_sketch(*sketch, rho)

    def composite(V: torch.Tensor) -> torch.Tensor:
        P = V.shape[0]
        cgblk = sketch_probe_block(Mk, P)

        def c_matmat(Xm: torch.Tensor) -> torch.Tensor:
            return wz_cg.gram_matmat(Xm, block=cgblk) + rho * Xm

        U = wz.t_matmat(V).reshape(P, d_z)
        Xs, _ = cg_mod.cg_batched(c_matmat, U, tol=cg_tol, maxiter=maxiter,
                                  precond=precond, operator_inputs=(Z,))
        W = a_inv * V - a_inv * wz.matmat(Xs.reshape(P, Mk, Kk))
        return sweep(W.contiguous(), Rx, gamma) + alpha * W

    s1, s2 = probe_split(probes.shape[0])
    return st.hutchpp(composite, probes, s1=s1, s2=s2)


def matfree_logdet_term(Z: torch.Tensor, state, alpha: float, beta: float,
                        probes: torch.Tensor, slq_num_matvecs: int) -> torch.Tensor:
    """SLQ ``logdet(αI + β WzWzᵀ)`` on the matrix-free stacked operator
    ``G v = [√α v; √β Wzᵀv]`` (``GᵀG = S_z``), each Golub–Kahan step
    recomputed in the backward pass instead of keeping the factor's
    activations; ``probes`` are the SLQ probes."""
    wz = ops.make_w_factor(state, Z)
    Mk, Kk = wz.inner_shape
    D = wz.num_params
    sqrt_alpha, sqrt_beta = math.sqrt(alpha), math.sqrt(beta)

    def stacked(v: torch.Tensor) -> torch.Tensor:
        return torch.cat([sqrt_alpha * v, sqrt_beta * wz.t_matvec(v).reshape(-1)])

    def stacked_t(w: torch.Tensor) -> torch.Tensor:
        return sqrt_alpha * w[:D] + sqrt_beta * wz.matvec(w[D:].reshape(Mk, Kk))

    return slq_mod.slq_logdet_product(stacked, probes, num_matvecs=slq_num_matvecs,
                                      t_matvec=stacked_t, remat_body=True)


def kl_stochastic_matfree(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                          beta: float, gamma: float, probes: torch.Tensor,
                          slq_samples: int, slq_num_matvecs: int, **trace_knobs
                          ) -> torch.Tensor:
    """The matfree stochastic KL: :func:`matfree_trace_term` on all the probes
    plus :func:`matfree_logdet_term` on the first ``slq_samples``
    (``trace_knobs``: the trace term's CG knobs)."""
    return (matfree_trace_term(Z, X, state, alpha, beta, gamma, probes, **trace_knobs)
            + matfree_logdet_term(Z, state, alpha, beta, probes[:slq_samples],
                                  slq_num_matvecs))


def kl_objective_stochastic(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                            probes: Union[torch.Tensor, torch.Generator],
                            full_set_size: Optional[int] = None,
                            st_samples: int = 256, slq_samples: int = 2,
                            slq_num_matvecs: Optional[int] = None,
                            materialize_w: bool = True,
                            example_block: Optional[int] = None,
                            cg_tol: float = 1e-3, cg_maxiter: Optional[int] = None,
                            precond_rank: Optional[int] = 64, precond_power: int = 0,
                            precond_sketch=None,
                            cg_example_block: Optional[int] = None) -> torch.Tensor:
    """Hutch++ trace + SLQ log-det with shared Rademacher probes,
    differentiable in ``Z``.

    ``probes``: the ``(st_samples, D)`` probe array, or a ``torch.Generator``
    to draw it from. The Hutch++ split is :func:`probe_split`; the SLQ depth
    defaults to ``max(int(0.8·M), 4)``.

    ``materialize_w=False`` is the matfree objective
    (:func:`kl_stochastic_matfree`; ``stochastic_matfree`` in
    :data:`OBJECTIVES`) with the knobs ``cg_tol``, ``cg_maxiter``,
    ``precond_rank`` (0 or ``None``: no preconditioner), ``precond_power``
    and ``cg_example_block``. ``precond_sketch``: a prebuilt
    :func:`matfree_sketch`; without one it is built here, its start drawn
    after the probes from the generator (or from a generator seeded
    ``0x4E59`` when the probes are given).
    """
    beta, gamma, probes_t, num_matvecs = _stochastic_setup(
        Z, X, state, probes, full_set_size, st_samples, slq_num_matvecs)
    if not materialize_w:
        sketch = None
        if precond_rank:
            sketch = precond_sketch
            if sketch is None:
                omega = (probes if isinstance(probes, torch.Generator) else
                         torch.Generator(device=state.device).manual_seed(0x4E59))
                sketch = matfree_sketch(state, Z, precond_rank, omega, precond_power,
                                        cg_example_block)
        return kl_stochastic_matfree(Z, X, state, alpha, beta, gamma, probes_t,
                                     slq_samples, num_matvecs, cg_tol=cg_tol,
                                     cg_maxiter=cg_maxiter, sketch=sketch,
                                     cg_example_block=cg_example_block)
    Rz = ops.dense_wt(state, Z, example_block=example_block)
    Rx = ops.dense_wt(state, X, example_block=example_block)
    return kl_stochastic_from_rows(Rz, Rx, alpha, beta, gamma, probes_t, slq_samples,
                                   num_matvecs)


def kl_stochastic_rows_value_and_grad(Rz: torch.Tensor, Rx: torch.Tensor, alpha: float,
                                      beta: float, gamma: float, probes: torch.Tensor,
                                      slq_samples: int, slq_num_matvecs: int,
                                      products: Products = KERNEL_PRODUCTS):
    """``(KL, ∂KL/∂Rz)`` of the stochastic objective for fixed rows and probes."""
    return _rows_value_and_grad(
        lambda rz, rx: kl_stochastic_from_rows(rz, rx, alpha, beta, gamma, probes,
                                               slq_samples, slq_num_matvecs, products),
        Rz, Rx)


def kl_value_and_grad_stochastic(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                                 probes: Union[torch.Tensor, torch.Generator], *,
                                 full_set_size: Optional[int] = None,
                                 st_samples: int = 256, slq_samples: int = 2,
                                 slq_num_matvecs: Optional[int] = None,
                                 example_block: Optional[int] = None):
    """``(KL, dKL/dZ)`` of :func:`kl_objective_stochastic`, staged as
    :func:`kl_value_and_grad_gram` is."""
    beta, gamma, probes, num_matvecs = _stochastic_setup(
        Z, X, state, probes, full_set_size, st_samples, slq_num_matvecs)
    with torch.no_grad():
        Rz = ops.dense_wt(state, Z, example_block=example_block)
        Rx = ops.dense_wt(state, X, example_block=example_block)
    loss, ct = kl_stochastic_rows_value_and_grad(Rz, Rx, alpha, beta, gamma, probes,
                                                 slq_samples, num_matvecs)
    del Rz, Rx
    return loss, ops.dense_wt_pullback(state, Z, ct, example_block=example_block)


def kl_value_and_grad_matfree(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                              probes: Union[torch.Tensor, torch.Generator], **kwargs):
    """``(KL, dKL/dZ)`` of the matfree objective by autograd through it
    (``kwargs``: :func:`kl_objective_stochastic`'s)."""
    z = Z.detach().requires_grad_()
    with torch.enable_grad():
        loss = kl_objective_stochastic(z, X, state, alpha, probes, materialize_w=False,
                                       **kwargs)
        (grad,) = torch.autograd.grad(loss, z)
    return loss.detach(), grad


OBJECTIVES = {
    "dense": kl_objective_dense,
    "gram": kl_objective_gram,
    # the same function; its step builds and pulls back the rows in chunks
    "gram_chunked": kl_objective_gram,
    "stochastic": kl_objective_stochastic,
    "stochastic_matfree": partial(kl_objective_stochastic, materialize_w=False),
}


# ---------------------------------------------------------------------------
# matfree CG convergence visibility
# ---------------------------------------------------------------------------

def _power_top(matvec: Callable[[torch.Tensor], torch.Tensor], v0: torch.Tensor,
               steps: int = 30) -> float:
    """Rayleigh quotient after ``steps`` power iterations from ``v0``."""
    v = v0 / torch.linalg.norm(v0)
    for _ in range(steps):
        w = matvec(v)
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    return float(torch.dot(v, matvec(v)) / torch.dot(v, v))


@torch.no_grad()
def matfree_cg_healthcheck(state, Z: torch.Tensor, alpha: float, *,
                           full_set_size: Optional[int] = None, cg_tol: float = 1e-3,
                           cg_maxiter: Optional[int] = None,
                           precond_rank: Optional[int] = 64, precond_power: int = 0,
                           generator: Optional[torch.Generator] = None,
                           n_probes: int = 4, cg_example_block: Optional[int] = None,
                           warn: bool = True) -> dict:
    """CG convergence visibility for the matfree paths: the objective's inner
    solve (same operator, preconditioner construction and budget) on
    ``n_probes`` random right-hand sides.

    Returns the worst true relative residual ``‖C x − b‖ / ‖b‖``
    (``cg_rel_residual``; ≫ tol means the solves exit on ``maxiter``), the
    iterations the solve ran, and the conditioning that explains them:
    ``lam_max`` (30 power iterations on the Gram), ``kappa = (λ_max+ρ)/ρ``
    with ``ρ = α/β``, the deflated ``kappa_deflated = (λ_seen+ρ)/ρ`` with
    ``λ_seen`` measured by power iteration on ``P^{-1/2} C P^{-1/2}`` (the
    spectrum CG sees), the sketch's own claim ``kappa_deflated_sketch`` and
    the CG bound ``predicted_iters ≈ ½·√κ_defl·ln(2/tol)``. Warns when the
    residual is above ``max(5·tol, 1e-5)``.
    """
    M = Z.shape[0]
    rho = float(alpha) / ((full_set_size or M) / M)
    gen = generator or torch.Generator(device=Z.device).manual_seed(0)
    wz = ops.make_w_factor(state, Z.detach(), example_block=cg_example_block)
    d_z = wz.d

    def c_matmat(Xm: torch.Tensor) -> torch.Tensor:
        return wz.gram_matmat(Xm, block=sketch_probe_block(M, Xm.shape[0])) + rho * Xm

    def c_matvec(u: torch.Tensor) -> torch.Tensor:
        return c_matmat(u[None])[0]

    lam_max = max(_power_top(c_matvec, torch.randn(d_z, generator=gen, device=Z.device))
                  - rho, 0.0)
    precond = None
    lam_defl = lam_seen = lam_max
    if precond_rank:
        U, lam, good = matfree_sketch(state, Z, precond_rank, gen, precond_power,
                                      cg_example_block)
        kept = lam[good]
        if kept.numel():
            lam_defl = float(torch.min(kept))
        pis = precond_inv_sqrt_from_sketch(U, lam, good, rho)
        lam_seen = max(_power_top(lambda u: pis(c_matvec(pis(u))),
                                  torch.randn(d_z, generator=gen, device=Z.device))
                       - rho, 0.0)
        precond = precond_from_sketch(U, lam, good, rho)
    b = torch.randn(n_probes, d_z, generator=gen, device=Z.device)
    Xs, info = cg_mod.cg_batched(c_matmat, b, tol=cg_tol, maxiter=cg_maxiter,
                                 precond=precond)
    res = float(torch.max(torch.linalg.norm(c_matmat(Xs) - b, dim=-1)
                          / torch.clamp(torch.linalg.norm(b, dim=-1), min=1e-30)))
    kappa = (lam_max + rho) / rho
    lam_eff = max(lam_defl, 1e-5 * lam_max) if precond_rank else lam_max
    kappa_defl_sketch = (lam_eff + rho) / rho
    kappa_defl = (lam_seen + rho) / rho
    predicted_iters = 0.5 * math.sqrt(kappa_defl) * math.log(2.0 / cg_tol)
    # floored at the f32-attainable residual: a tolerance below round-off
    # still counts as converged when the solve bottoms out near 1e-6
    converged = res <= max(5 * cg_tol, 1e-5)
    if warn and not converged:
        warnings.warn(
            f"stochastic_matfree inner CG: relative residual {res:.2e} after "
            f"{info.iterations} iterations (cg_tol={cg_tol:g}): CG is exiting on "
            f"maxiter, not tolerance. Conditioning: lam_max={lam_max:.3g}, "
            f"kappa={kappa:.3g}, measured kappa_deflated={kappa_defl:.3g} (rank "
            f"{precond_rank}; the sketch claims {kappa_defl_sketch:.3g}); the CG bound "
            f"needs ~{predicted_iters:.0f} iterations vs the "
            f"{cg_maxiter or 'default'} budgeted. The KL trace term is biased by "
            f"O(residual): raise precond_rank or cg_maxiter, or alpha_ip (kappa "
            f"scales as 1/alpha).", stacklevel=2)
    return {"cg_rel_residual": res, "converged": converged, "cg_iterations": info.iterations,
            "cg_tol": cg_tol, "precond_rank": precond_rank, "precond_power": precond_power,
            "lam_max": lam_max, "kappa": kappa, "lam_seen": lam_seen,
            "kappa_deflated": kappa_defl, "kappa_deflated_sketch": kappa_defl_sketch,
            "predicted_iters": predicted_iters}


def healthcheck_line(hc: dict) -> str:
    """One line summarizing a :func:`matfree_cg_healthcheck`."""
    return (f"rel residual {hc['cg_rel_residual']:.2e} after {hc['cg_iterations']} "
            f"iterations ({'converged' if hc['converged'] else 'MAXITER STALL'}, "
            f"tol={hc['cg_tol']:g}, precond_rank={hc['precond_rank']}, "
            f"lam_max={hc['lam_max']:.4g}, kappa={hc['kappa']:.4g}, "
            f"kappa_deflated={hc['kappa_deflated']:.4g} (sketch "
            f"{hc['kappa_deflated_sketch']:.4g}), ~{hc['predicted_iters']:.0f} iters needed)")


def make_optimizer(Z: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam on ``Z`` as ``optax.adam(lr)`` sets it up (ε = 1e-8 added to √v̂)."""
    return torch.optim.Adam([Z], lr=lr, eps=1e-8)


# ---------------------------------------------------------------------------
# the gram step's value-and-grad as one CUDA graph
# ---------------------------------------------------------------------------

# the kernels whose launch counters a replay advances by what its capture counted
_COUNTED_KERNELS = (syrk, matmul_nt, matmul_nn, ggn_sweep)


def graph_key(Z: torch.Tensor, X: torch.Tensor, state, alpha: float, *, objective: str,
              full_set_size: Optional[int], example_block: Optional[int]) -> tuple:
    """What a captured gram value-and-grad at ``Z`` was recorded for, beyond
    the values in the memory it reads: the shapes, dtypes and scalars of its
    launches, and the addresses of the tensors it reads in place (``Z``, the
    weights, the BatchNorm statistics; the batch is copied into a buffer of
    the graph's own, so a new batch of the same shape keeps the key). Equal
    keys replay one graph; a changed key captures anew."""
    return (Z.data_ptr(), tuple(Z.shape), Z.dtype, tuple(X.shape), X.dtype, float(alpha),
            full_set_size, objective, example_block, id(state.model), state.model_kind,
            state.flat_params.data_ptr(),
            tuple((name, t.data_ptr()) for name, t in state.batch_stats.items()))


@dataclass(eq=False)
class _StepGraph:
    """One ``Z``'s graph: its key and the objects the key names (held, so
    that no other tensor or module takes their addresses while it lives);
    the graph, ``None`` until the key's second call and for good once its
    capture failed; its static batch and outputs; the kernel launches its
    capture counted, by counter."""
    key: tuple
    refs: tuple
    graph: Optional[torch.cuda.CUDAGraph] = None
    failed: bool = False
    X: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None
    grad: Optional[torch.Tensor] = None
    launches: dict = field(default_factory=dict)


# one graph per Z, its memory pool freed with Z; keyed by identity, since a
# WeakKeyDictionary would compare tensors with ``==``
_GRAPHS: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _kernel_counts() -> dict:
    """Every launch counter of the kernels: ``(wrapper, attribute, path)`` →
    count (``path`` ``None`` for ``launches`` and ``backward_launches``)."""
    counts = {}
    for fn in _COUNTED_KERNELS:
        counts[fn, "launches", None] = fn.launches
        counts[fn, "backward_launches", None] = fn.backward_launches
        for path, n in getattr(fn, "path_launches", {}).items():
            counts[fn, "path_launches", path] = n
    return counts


def _counts_since(before: dict) -> dict:
    """The counters that moved since :func:`_kernel_counts` read ``before``,
    by how much."""
    after = _kernel_counts()
    return {k: after[k] - n for k, n in before.items() if after[k] != n}


def _add_counts(counts: dict, sign: int = 1) -> None:
    for (fn, attr, path), n in counts.items():
        if path is None:
            setattr(fn, attr, getattr(fn, attr) + sign * n)
        else:
            fn.path_launches[path] += sign * n


def _void_capture(graph: torch.cuda.CUDAGraph, pool: tuple, device: torch.device) -> None:
    """End a capture that an operation refused (an error where it ran, or
    at ``capture_end``). PyTorch's ``capture_end`` then raises before it
    stops routing the device's allocations to the memory ``pool`` and before
    the graph holds the pool, so both are undone here, as
    ``torch.cuda.memory`` undoes its own pool contexts; the pool's blocks go
    back with the next ``empty_cache``."""
    with contextlib.suppress(RuntimeError):     # void, or ended already
        graph.capture_end()
    with contextlib.suppress(RuntimeError):     # where capture_end got that far
        torch._C._cuda_endAllocateToPool(device.index, pool)
    torch._C._cuda_releasePool(device.index, pool)


def _capture(entry: _StepGraph, Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
             kwargs: dict) -> None:
    """Record ``kl_value_and_grad_gram`` at ``Z`` on a static copy of ``X``
    into ``entry``, on a side stream, into the graph's own memory pool.
    Raises (``RuntimeError``) where an operation refuses capture; the
    counters are then as they were."""
    entry.X = X.detach().clone()
    torch.cuda.synchronize(Z.device)
    torch.cuda.empty_cache()        # the eager step's cached blocks, for the pool
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(Z.device)
    pool = torch.cuda.graph_pool_handle()
    before = _kernel_counts()
    with torch.cuda.device(Z.device), torch.cuda.stream(stream):
        graph.capture_begin(pool, capture_error_mode="thread_local")
        try:
            loss, grad = kl_value_and_grad_gram(Z, entry.X, state, alpha, **kwargs)
            graph.capture_end()
        except RuntimeError:
            _add_counts(_counts_since(before), -1)
            _void_capture(graph, pool, Z.device)
            raise
    entry.graph, entry.loss, entry.grad = graph, loss, grad
    entry.launches = _counts_since(before)


def _gram_value_and_grad(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                         objective: str, *, full_set_size: Optional[int],
                         example_block: Optional[int]):
    """``(loss, dL/dZ)`` of :func:`kl_value_and_grad_gram` for
    :func:`optimize_step`: on a CUDA ``Z`` from ``Z``'s graph (eager at a new
    key, captured at its second call, replayed after), elsewhere eager. The
    loss is a fresh tensor; the gradient may be the graph's own buffer, good
    until the next replay."""
    kwargs = {"full_set_size": full_set_size, "example_block": example_block}
    if Z.device.type != "cuda":
        return kl_value_and_grad_gram(Z, X, state, alpha, **kwargs)
    key = graph_key(Z, X, state, alpha, objective=objective, **kwargs)
    entry = _GRAPHS.get(Z)
    if entry is None or entry.key != key:
        _GRAPHS[Z] = _StepGraph(key, (state.model, state.flat_params,
                                      *state.batch_stats.values()))
        return kl_value_and_grad_gram(Z, X, state, alpha, **kwargs)
    if entry.failed:
        return kl_value_and_grad_gram(Z, X, state, alpha, **kwargs)
    if entry.graph is None:
        try:
            _capture(entry, Z, X, state, alpha, kwargs)
        except RuntimeError as exc:
            entry.X = None
            entry.failed = True
            _STEP_COUNTERS.graph_fallbacks += 1
            warnings.warn(f"the gram Z step could not be captured as a CUDA graph and runs "
                          f"eager for this Z, batch shape and settings: {exc}",
                          RuntimeWarning, stacklevel=3)
            return kl_value_and_grad_gram(Z, X, state, alpha, **kwargs)
        _STEP_COUNTERS.graph_captures += 1
    else:
        _add_counts(entry.launches)
    with span("z_step.graph"):
        entry.X.copy_(X)
        entry.graph.replay()
        loss = entry.loss.clone()
    _STEP_COUNTERS.graph_replays += 1
    return loss, entry.grad


def optimize_step(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                  optimizer: torch.optim.Optimizer, *, objective: str = "gram",
                  full_set_size: Optional[int] = None,
                  example_block: Optional[int] = None,
                  probes: Union[torch.Tensor, torch.Generator, None] = None,
                  st_samples: int = 256, slq_samples: int = 2,
                  slq_num_matvecs: Optional[int] = None, **matfree) -> torch.Tensor:
    """One gradient step on ``Z``, in place; returns the loss at the ``Z``
    it started from. ``optimizer`` holds ``Z`` (:func:`make_optimizer`).
    ``probes``: the stochastic objectives' probes, or a generator to draw
    fresh ones from. ``matfree``: the matfree objective's knobs
    (``cg_tol``, ``cg_maxiter``, ``precond_rank``, ``precond_power``,
    ``precond_sketch``, ``cg_example_block``).

    The gram objectives on a CUDA ``Z`` replay a CUDA graph of the
    value-and-grad (module docstring); Adam's step stays eager. Counters:
    ``optimize_step.calls``, ``.graph_captures``, ``.graph_replays`` (the
    capturing call's replay included) and ``.graph_fallbacks`` (keys whose
    capture failed)."""
    _STEP_COUNTERS.calls += 1
    with span("z_step"):
        if objective in ("gram", "gram_chunked"):
            if objective == "gram_chunked":
                example_block = example_block or 4
            loss, grad = _gram_value_and_grad(Z, X, state, alpha, objective,
                                              full_set_size=full_set_size,
                                              example_block=example_block)
        elif objective == "dense":
            z = Z.detach().requires_grad_()
            with torch.enable_grad():
                value = kl_objective_dense(z, X, state, alpha, full_set_size=full_set_size)
                (grad,) = torch.autograd.grad(value, z)
            loss = value.detach()
        elif objective in ("stochastic", "stochastic_matfree"):
            if probes is None:
                raise ValueError("the stochastic objectives need probes or a generator")
            knobs = dict(full_set_size=full_set_size, st_samples=st_samples,
                         slq_samples=slq_samples, slq_num_matvecs=slq_num_matvecs)
            if objective == "stochastic":
                loss, grad = kl_value_and_grad_stochastic(
                    Z, X, state, alpha, probes, example_block=example_block, **knobs)
            else:
                loss, grad = kl_value_and_grad_matfree(Z, X, state, alpha, probes, **knobs,
                                                       **matfree)
        else:
            raise ValueError(f"unknown objective {objective!r}: one of {sorted(OBJECTIVES)}")
        Z.grad = grad
        optimizer.step()
        Z.grad = None
        return loss


optimize_step.calls = optimize_step.graph_captures = 0
optimize_step.graph_replays = optimize_step.graph_fallbacks = 0
# where the step counts, whatever a caller rebinds the module's name
# ``optimize_step`` to (a wrapper that calls it, say)
_STEP_COUNTERS = optimize_step


@torch.no_grad()
def full_set_kl(Z: torch.Tensor, X_full: torch.Tensor, state, alpha: float,
                full_set_size: Optional[int] = None) -> float:
    """Exact gram KL of a candidate ``Z`` against the full training set (the
    restart-selection criterion; deterministic)."""
    return float(kl_objective_gram(Z, X_full, state, alpha,
                                   full_set_size=full_set_size))


def train_inducing_points_restarts(state, z_init: torch.Tensor, batches: Iterable, *,
                                   alpha: float, num_steps: int, lr: float,
                                   selection_X: torch.Tensor,
                                   candidate_pool: Optional[torch.Tensor] = None,
                                   n_restarts: int = 4,
                                   full_set_size: Optional[int] = None, seed: int = 0,
                                   **train_kwargs):
    """k-restart Z training selected by the exact full-set KL.

    Restart 0 starts from ``z_init``; restart r ≥ 1 from M points drawn from
    ``candidate_pool`` (default ``selection_X``) by a generator seeded from
    ``seed`` and r (with replacement only when the pool has fewer than M
    points). Each restart's stochastic probes come from its own generator of
    the same seed. The candidate with the lowest :func:`full_set_kl` on
    ``selection_X`` wins. Returns ``(Z_best, kl_best, kls)``, ``kls`` in
    restart order.
    """
    pool = candidate_pool if candidate_pool is not None else selection_X
    m = z_init.shape[0]
    best_Z, best_kl, kls = None, None, []
    for r in range(n_restarts):
        gen = torch.Generator(device=z_init.device).manual_seed(
            (seed * 1000003 + r) % 2**63)
        if r == 0:
            z0 = z_init
        elif pool.shape[0] < m:
            z0 = pool[torch.randint(pool.shape[0], (m,), generator=gen, device=z_init.device)]
        else:
            z0 = pool[torch.randperm(pool.shape[0], generator=gen, device=z_init.device)[:m]]
        Z = train_inducing_points(state, z0, batches, alpha=alpha, num_steps=num_steps,
                                  lr=lr, full_set_size=full_set_size, generator=gen,
                                  **train_kwargs)
        kl = full_set_kl(Z, selection_X, state, alpha, full_set_size)
        kls.append(kl)
        print(f"[inducing restart {r}/{n_restarts}] full-set KL = {kl:.4f}")
        if best_kl is None or kl < best_kl:
            best_Z, best_kl = Z, kl
    print(f"[inducing restarts] selected KL {best_kl:.4f} "
          f"(spread {min(kls):.4f}..{max(kls):.4f})")
    return best_Z, best_kl, kls


def train_inducing_points(state, z_init: torch.Tensor, batches: Iterable, *,
                          alpha: float, num_steps: int, lr: float,
                          full_set_size: Optional[int] = None,
                          objective: str = "gram",
                          example_block: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          st_samples: int = 256, slq_samples: int = 2,
                          slq_num_matvecs: Optional[int] = None,
                          cg_tol: float = 1e-3, cg_maxiter: Optional[int] = None,
                          precond_rank: Optional[int] = 64, precond_power: int = 0,
                          cg_example_block: Optional[int] = None,
                          callback: Optional[Callable] = None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_name: str = "ind",
                          checkpoint_every: int = 100) -> torch.Tensor:
    """Optimize ``Z`` with Adam(``lr``) against minibatches ``(x, y)`` (numpy
    or tensors; moved to ``z_init``'s device).

    The stochastic objectives draw fresh probes every step from
    ``generator`` (default: seed 0 on ``z_init``'s device). The matfree one
    first runs :func:`matfree_cg_healthcheck` (printed; it warns on maxiter
    exits), then builds a fresh Nyström sketch at each step's ``Z`` outside
    the autograd graph, its start drawn from ``generator`` before the
    step's probes.

    Divergence guard: the loss and ``Z`` are checked every 10 steps, at the
    last step, and at every step when there is a ``callback``
    (``callback(step, Z, loss)``); on a non-finite one the last ``Z`` that
    passed a check is returned, never a NaN ``Z``.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}: one of {sorted(OBJECTIVES)}")
    if objective.startswith("stochastic") and generator is None:
        generator = torch.Generator(device=z_init.device).manual_seed(0)
    matfree = {}
    if objective == "stochastic_matfree":
        matfree = dict(cg_tol=cg_tol, cg_maxiter=cg_maxiter, precond_rank=precond_rank,
                       precond_power=precond_power, cg_example_block=cg_example_block)
        # CG convergence visibility before any step: a silent maxiter stall
        # biases every trace term
        hc = matfree_cg_healthcheck(state, z_init, alpha, full_set_size=full_set_size,
                                    generator=generator, **matfree)
        print(f"[inducing] matfree CG healthcheck: {healthcheck_line(hc)}")
    Z = z_init.detach().clone()
    optimizer = make_optimizer(Z, lr)
    it = iter(batches)
    last_finite_Z = Z.clone()
    for step in range(num_steps):
        x_batch, _ = next(it)
        x = torch.as_tensor(x_batch, dtype=torch.float32, device=Z.device)
        if matfree and precond_rank:
            matfree["precond_sketch"] = matfree_sketch(state, Z, precond_rank, generator,
                                                       precond_power, cg_example_block)
        loss = optimize_step(Z, x, state, alpha, optimizer, objective=objective,
                             full_set_size=full_set_size,
                             example_block=example_block, probes=generator,
                             st_samples=st_samples, slq_samples=slq_samples,
                             slq_num_matvecs=slq_num_matvecs, **matfree)
        check = step % 10 == 0 or step == num_steps - 1
        if check or callback is not None:
            loss_f = float(loss)
            if not (math.isfinite(loss_f) and bool(torch.isfinite(Z).all())):
                print(f"[inducing {step:4d}] DIVERGED (loss={loss_f}); "
                      "stopping and keeping the last finite Z — try a "
                      "smaller lr or alpha")
                return last_finite_Z
            last_finite_Z = Z.clone()
            if check:
                print(f"[inducing {step:4d}] loss={loss_f:.4f}")
            if callback is not None:
                callback(step, Z, loss_f)
        if checkpoint_dir and (step + 1) % checkpoint_every == 0 \
                and step + 1 < num_steps:
            save_array(Z, checkpoint_dir, checkpoint_name, step + 1)
    _GRAPHS.pop(Z, None)     # Z's graph and its memory pool now, not when the caller drops Z
    return Z
