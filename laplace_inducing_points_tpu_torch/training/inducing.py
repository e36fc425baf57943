"""Inducing-point optimization: learn ``Z`` by minimizing
``KL[q(θ|Z) ‖ q(θ|D)]``, on the exact Gram KL or its stochastic estimate.

Counterpart of ``laplace_inducing_points_tpu/training/inducing.py``: ``_grams``
(``:62``), ``_pivot_jitter`` (``:72``), ``_kl_core`` (``:87``),
``kl_objective_gram`` (``:124``), ``kl_objective_stochastic`` (``:142``) with
``materialize_w=True``, ``OBJECTIVES`` (``:340``), ``optimize_step`` (``:684``)
for the ``gram`` and ``stochastic`` objectives, ``full_set_kl`` (``:724``) and
``train_inducing_points`` (``:795``) with its divergence guard. The dense and
matfree objectives and the restarts wait for later slices (ROADMAP, Queue A).

The Gram ``Gzz = Rz Rzᵀ`` goes through the ``syrk`` kernel, the long
products with the rows through ``matmul_nt``/``matmul_nn`` and the stochastic
objective's GGN probe sweeps through ``ggn_sweep``; their backward passes are
kernels too (``ops/cuda``). A step computes ``dL/dZ`` the way the reference's
chunked gradient does (``kl_grad_gram_chunked``, ``:627``), in eager form: the
rows without a tape, ``∂L/∂Rz`` by autograd through the algebra on the rows
and the kernels, then the row build's pullback one example block at a time
(``core.operators.dense_wt_pullback``). The stochastic objective is computed
from the materialized rows in the same way: the same function as the
reference's jvp/vjp operators, with ``S_X = γ·RxᵀRx + αI`` applied by the
sweep kernel. :func:`kl_objective_gram` and :func:`kl_objective_stochastic`
stay differentiable end to end, as the reference's are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Union

import torch

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.ops import slq as slq_mod
from laplace_inducing_points_tpu_torch.ops import stochtrace as st
from laplace_inducing_points_tpu_torch.ops.cuda.matmul import matmul_nn, matmul_nt
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.utils.checkpoint import save_array

NOT_PORTED = ("the {!r} objective is not ported yet (ROADMAP, Queue A): "
              "'gram' and 'stochastic' are")


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

    trace_term = (-torch.trace(C_inv_Gzz)
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
        loss = loss_of_rows(Rz, Rx.detach())
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


def kl_objective_stochastic(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                            probes: Union[torch.Tensor, torch.Generator],
                            full_set_size: Optional[int] = None,
                            st_samples: int = 256, slq_samples: int = 2,
                            slq_num_matvecs: Optional[int] = None,
                            materialize_w: bool = True,
                            example_block: Optional[int] = None) -> torch.Tensor:
    """Hutch++ trace + SLQ log-det with shared Rademacher probes,
    differentiable in ``Z``.

    ``probes``: the ``(st_samples, D)`` probe array, or a ``torch.Generator``
    to draw it from. The Hutch++ split is :func:`probe_split`; the SLQ depth
    defaults to ``max(int(0.8·M), 4)``. ``materialize_w=False`` (the matfree
    objective) is not ported yet and raises.
    """
    if not materialize_w:
        raise NotImplementedError(NOT_PORTED.format("stochastic_matfree"))
    beta, gamma, probes, num_matvecs = _stochastic_setup(
        Z, X, state, probes, full_set_size, st_samples, slq_num_matvecs)
    Rz = ops.dense_wt(state, Z, example_block=example_block)
    Rx = ops.dense_wt(state, X, example_block=example_block)
    return kl_stochastic_from_rows(Rz, Rx, alpha, beta, gamma, probes, slq_samples,
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


OBJECTIVES = {
    "gram": kl_objective_gram,
    "stochastic": kl_objective_stochastic,
}


def make_optimizer(Z: torch.Tensor, lr: float) -> torch.optim.Adam:
    """Adam on ``Z`` as ``optax.adam(lr)`` sets it up (ε = 1e-8 added to √v̂)."""
    return torch.optim.Adam([Z], lr=lr, eps=1e-8)


def optimize_step(Z: torch.Tensor, X: torch.Tensor, state, alpha: float,
                  optimizer: torch.optim.Optimizer, *, objective: str = "gram",
                  full_set_size: Optional[int] = None,
                  example_block: Optional[int] = None,
                  probes: Union[torch.Tensor, torch.Generator, None] = None,
                  st_samples: int = 256, slq_samples: int = 2,
                  slq_num_matvecs: Optional[int] = None) -> torch.Tensor:
    """One gradient step on ``Z``, in place; returns the loss at the ``Z``
    it started from. ``optimizer`` holds ``Z`` (:func:`make_optimizer`).
    ``probes``: the stochastic objective's probes, or a generator to draw
    fresh ones from."""
    if objective == "gram":
        loss, grad = kl_value_and_grad_gram(Z, X, state, alpha,
                                            full_set_size=full_set_size,
                                            example_block=example_block)
    elif objective == "stochastic":
        if probes is None:
            raise ValueError("the stochastic objective needs probes or a generator")
        loss, grad = kl_value_and_grad_stochastic(
            Z, X, state, alpha, probes, full_set_size=full_set_size,
            st_samples=st_samples, slq_samples=slq_samples,
            slq_num_matvecs=slq_num_matvecs, example_block=example_block)
    else:
        raise NotImplementedError(NOT_PORTED.format(objective))
    Z.grad = grad
    optimizer.step()
    Z.grad = None
    return loss


@torch.no_grad()
def full_set_kl(Z: torch.Tensor, X_full: torch.Tensor, state, alpha: float,
                full_set_size: Optional[int] = None) -> float:
    """Exact gram KL of a candidate ``Z`` against the full training set (the
    restart-selection criterion; deterministic)."""
    return float(kl_objective_gram(Z, X_full, state, alpha,
                                   full_set_size=full_set_size))


def train_inducing_points(state, z_init: torch.Tensor, batches: Iterable, *,
                          alpha: float, num_steps: int, lr: float,
                          full_set_size: Optional[int] = None,
                          objective: str = "gram",
                          example_block: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          st_samples: int = 256, slq_samples: int = 2,
                          slq_num_matvecs: Optional[int] = None,
                          callback: Optional[Callable] = None,
                          checkpoint_dir: Optional[str] = None,
                          checkpoint_name: str = "ind",
                          checkpoint_every: int = 100) -> torch.Tensor:
    """Optimize ``Z`` with Adam(``lr``) against minibatches ``(x, y)`` (numpy
    or tensors; moved to ``z_init``'s device).

    The stochastic objective draws fresh probes every step from
    ``generator`` (default: seed 0 on ``z_init``'s device).

    Divergence guard: the loss and ``Z`` are checked every 10 steps, at the
    last step, and at every step when there is a ``callback``
    (``callback(step, Z, loss)``); on a non-finite one the last ``Z`` that
    passed a check is returned, never a NaN ``Z``.
    """
    if objective not in OBJECTIVES:
        raise NotImplementedError(NOT_PORTED.format(objective))
    if objective == "stochastic" and generator is None:
        generator = torch.Generator(device=z_init.device).manual_seed(0)
    Z = z_init.detach().clone()
    optimizer = make_optimizer(Z, lr)
    it = iter(batches)
    last_finite_Z = Z.clone()
    for step in range(num_steps):
        x_batch, _ = next(it)
        x = torch.as_tensor(x_batch, dtype=torch.float32, device=Z.device)
        loss = optimize_step(Z, x, state, alpha, optimizer, objective=objective,
                             full_set_size=full_set_size,
                             example_block=example_block, probes=generator,
                             st_samples=st_samples, slq_samples=slq_samples,
                             slq_num_matvecs=slq_num_matvecs)
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
    return Z
