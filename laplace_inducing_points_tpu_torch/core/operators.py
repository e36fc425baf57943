"""Linearization and the materialized GGN row factor (serving-path part).

Counterpart of ``laplace_inducing_points_tpu/core/operators.py``: ``pdot``
(``:44``), ``model_outputs`` (``:61``), ``Linearization``/``linearize_model``
(``:80-164``), ``dense_wt`` (``:496-532``) with its pullback in ``Z`` (the
reference's ``_rows_chunk_vjp``, ``training/inducing.py:591``),
``ggn_matmat_materialized`` (``:625``) on the ``ggn_sweep`` kernel and
``ensure_symmetry`` (``:702``). The matrix-free ``WFactor``/``GGNOperator``
family waits for the matfree slice (ROADMAP, Queue A).

Operator glossary (D = #params, M = #points, K = #outputs, d = M·K):
``Wᵀ : R^D -> R^{M×K}``, ``(Wᵀ v)_i = c · L_iᵀ J_i v``, so the rows
``R = Wᵀ`` are ``(d, D)`` and the GGN is ``Rᵀ R``.

PyTorch has no stored linearization like ``jax.linearize``: each jvp here
re-runs the primal forward pass alongside the tangent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.func import functional_call, jacrev, jvp, vjp, vmap

from laplace_inducing_points_tpu_torch.core import loss_hessians as lh
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul for Gram/posterior algebra and every
    posterior-sample contraction.

    A contraction error re-enters the pushed-forward samples amplified by
    ~√λ_max, because the range-space correction cancels the prior draw along
    high-curvature directions. On CUDA this is true f32 only with TF32 off,
    which ``utils.device.set_f32_policy`` (called by every entry point)
    ensures.
    """
    return torch.matmul(a, b)


def model_outputs(state, flat_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched network outputs ``(M, K)`` at the flat weights ``flat_params``,
    in eval mode: BatchNorm normalises with the state's frozen
    ``batch_stats``, so every jvp, vjp and row build sees the same fixed
    function of the weights. The regressor's ``(mu, logvar)`` is reduced to
    ``mu``."""
    out = functional_call(state.model,
                          {**state.spec.unflatten(flat_params), **state.batch_stats}, (x,))
    if isinstance(out, tuple):
        out = out[0]
    return out


@dataclass(frozen=True)
class Linearization:
    """First-order expansion of the batched apply at the state's weights."""
    model_kind: str
    flat_params: torch.Tensor         # (D,)
    f0: torch.Tensor                  # (M, K) primal outputs
    jvp: Callable[[torch.Tensor], torch.Tensor]      # (D,) -> (M, K)
    vjp: Callable[[torch.Tensor], torch.Tensor]      # (M, K) -> (D,)
    logvar: torch.Tensor | float      # scalar for regressors, 0 otherwise


def linearize_model(state, Z: torch.Tensor) -> Linearization:
    """Linearize the batched network apply at ``state.flat_params``.

    The reference's ``matmul_precision`` knob has no counterpart: the f32
    policy (TF32 off for matmuls and cuDNN) already makes every jvp/vjp here
    true f32.
    """
    flat = state.flat_params

    def f(flat_p: torch.Tensor) -> torch.Tensor:
        return model_outputs(state, flat_p, Z)

    def jvp_fn(v: torch.Tensor) -> torch.Tensor:
        return jvp(f, (flat,), (v,))[1]

    def vjp_fn(ct: torch.Tensor) -> torch.Tensor:
        return vjp(f, flat)[1](ct)[0]

    return Linearization(model_kind=state.model_kind, flat_params=flat, f0=f(flat),
                         jvp=jvp_fn, vjp=vjp_fn, logvar=state.logvar)


def row_fn(state) -> Callable[[torch.Tensor], torch.Tensor]:
    """``rows(z) -> (b·K, D)``: the unscaled rows ``Lᵀ J`` of a block of
    points, differentiable in ``z``.

    A vmapped per-example ``jacrev`` (K backward passes per example) that also
    returns the primal outputs ``f0``, then the loss factor ``Lᵀ`` at ``f0``
    along the class axis. ``f0`` stays on the tape: ``√H(f0(z))`` is part of
    ``dR/dz`` (the reference's ``f0`` comes from ``jax.linearize`` and is
    differentiated too).
    """
    flat = state.flat_params

    def f_single(flat_p: torch.Tensor, zi: torch.Tensor):
        out = model_outputs(state, flat_p, zi[None])[0]
        return out, out

    jac = vmap(jacrev(f_single, has_aux=True), in_dims=(None, 0))

    def rows(z: torch.Tensor) -> torch.Tensor:
        J, f0 = jac(flat, z)                                      # (b, K, D), (b, K)
        LtJ = lh.sqrt_h_t_apply(state.model_kind, f0[:, None, :],
                                J.transpose(1, 2), state.logvar)  # (b, D, K)
        return LtJ.transpose(1, 2).reshape(-1, flat.shape[0])     # (b·K, D)

    return rows


def _blocks(M: int, example_block: Optional[int]) -> list[slice]:
    block = M if example_block is None else min(example_block, M)
    return [slice(i, i + block) for i in range(0, M, block)]


def dense_wt(state, Z: torch.Tensor, *, scale: float = 1.0,
             example_block: Optional[int] = None) -> torch.Tensor:
    """Materialize ``Wᵀ ∈ R^{(M·K) × D}`` for a point set ``Z``
    (differentiable in ``Z``).

    ``example_block`` processes the examples in chunks of that size, bounding
    the extra memory to ``block·K·D`` plus one chunk's activations.
    """
    rows = row_fn(state)
    parts = [rows(Z[s]) for s in _blocks(Z.shape[0], example_block)]
    R = parts[0] if len(parts) == 1 else torch.cat(parts)
    return R if scale == 1.0 else scale * R


def dense_wt_pullback(state, Z: torch.Tensor, ct: torch.Tensor, *,
                      example_block: Optional[int] = None) -> torch.Tensor:
    """``(∂R/∂Z)ᵀ ct``: the vjp of the unscaled row build at ``Z`` applied to a
    row cotangent ``ct (M·K, D)``, one example block at a time.

    Eager counterpart of the reference's chunked pullback
    (``training/inducing.py:591-594``): each block re-runs its row build under
    ``torch.func.vjp`` and pulls its slice of ``ct`` back, so only one block's
    second-order tape is alive at a time. ``None`` is one block.
    """
    rows = row_fn(state)
    K = ct.shape[0] // Z.shape[0]
    grads = []
    for s in _blocks(Z.shape[0], example_block):
        _, pull = vjp(rows, Z[s])
        grads.append(pull(ct[s.start * K:s.stop * K])[0])
    return grads[0] if len(grads) == 1 else torch.cat(grads)


def ggn_matmat_materialized(state, Z: torch.Tensor, V: torch.Tensor,
                            full_set_size: Optional[int] = None,
                            R: Optional[torch.Tensor] = None,
                            example_block: Optional[int] = None) -> torch.Tensor:
    """GGN probe sweep through the materialized rows: ``c²·(V Rᵀ) R`` with
    ``c² = N/M`` and ``R = LᵀJ``, two long products in the ``ggn_sweep``
    kernel at estimator precision.

    Building ``R`` costs ``M·K`` single-example backward passes once; each
    probe after that is matrix-product work, so for hundreds of probes
    (Hutch++) this beats a per-probe jvp/vjp sweep. Pass a prebuilt ``R`` to
    amortize it across sweeps.
    """
    M = Z.shape[0]
    N = full_set_size or M
    if R is None:
        R = dense_wt(state, Z, example_block=example_block)    # (M·K, D)
    return ggn_sweep(V, R, N / M)


def ensure_symmetry(A: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    """Symmetrize + jitter a theoretically-symmetric matrix."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return 0.5 * (A + A.T) + jitter * eye
