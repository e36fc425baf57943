"""Linearization and the materialized GGN row factor (serving-path part).

Counterpart of ``laplace_inducing_points_tpu/core/operators.py``: ``pdot``
(``:44``), ``model_outputs`` (``:61``), ``Linearization``/``linearize_model``
(``:80-164``), ``dense_wt`` (``:496-532``) and ``ensure_symmetry``
(``:702``). The matrix-free ``WFactor``/``GGNOperator`` family waits for the
stochastic and matfree slices (ROADMAP, Queue A).

Operator glossary (D = #params, M = #points, K = #outputs, d = M·K):
``Wᵀ : R^D -> R^{M×K}``, ``(Wᵀ v)_i = c · L_iᵀ J_i v``, so the rows
``R = Wᵀ`` are ``(d, D)`` and the GGN is ``Rᵀ R``.

PyTorch has no stored linearization like ``jax.linearize``: each jvp here
re-runs the primal forward pass alongside the tangent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.func import functional_call, jacrev, jvp, vjp, vmap

from laplace_inducing_points_tpu_torch.core import loss_hessians as lh


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
    """Batched network outputs ``(M, K)`` at the flat weights ``flat_params``;
    the regressor's ``(mu, logvar)`` is reduced to ``mu``."""
    out = functional_call(state.model, state.spec.unflatten(flat_params), (x,))
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
    f_single: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = field(repr=False)


def linearize_model(state, Z: torch.Tensor) -> Linearization:
    """Linearize the batched network apply at ``state.flat_params``.

    The reference's ``matmul_precision`` knob has no counterpart: the f32
    policy (TF32 off for matmuls and cuDNN) already makes every jvp/vjp here
    true f32.
    """
    flat = state.flat_params

    def f(flat_p: torch.Tensor) -> torch.Tensor:
        return model_outputs(state, flat_p, Z)

    def f_single(flat_p: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
        return model_outputs(state, flat_p, zi[None])[0]

    def jvp_fn(v: torch.Tensor) -> torch.Tensor:
        return jvp(f, (flat,), (v,))[1]

    def vjp_fn(ct: torch.Tensor) -> torch.Tensor:
        return vjp(f, flat)[1](ct)[0]

    with torch.no_grad():
        f0 = f(flat)
    return Linearization(model_kind=state.model_kind, flat_params=flat, f0=f0,
                         jvp=jvp_fn, vjp=vjp_fn, logvar=state.logvar,
                         f_single=f_single)


def dense_wt(state, Z: torch.Tensor, *, scale: float = 1.0,
             example_block: Optional[int] = None) -> torch.Tensor:
    """Materialize ``Wᵀ ∈ R^{(M·K) × D}`` for a point set ``Z``.

    A vmapped per-example ``jacrev`` (K backward passes per example), then the
    loss factor ``Lᵀ`` along the class axis. ``example_block`` processes the
    examples in chunks of that size, bounding the extra memory to
    ``block·K·D`` plus one chunk's activations.
    """
    lin = linearize_model(state, Z)
    flat = lin.flat_params
    M, D = Z.shape[0], flat.shape[0]
    jac = vmap(jacrev(lin.f_single), in_dims=(None, 0))

    def rows(z_blk: torch.Tensor, f0_blk: torch.Tensor) -> torch.Tensor:
        J = jac(flat, z_blk)                                      # (b, K, D)
        LtJ = lh.sqrt_h_t_apply(lin.model_kind, f0_blk[:, None, :],
                                J.transpose(1, 2), lin.logvar)    # (b, D, K)
        return LtJ.transpose(1, 2)                                # (b, K, D)

    block = M if example_block is None else min(example_block, M)
    R = torch.cat([rows(Z[i:i + block], lin.f0[i:i + block])
                   for i in range(0, M, block)]).reshape(-1, D)
    if scale != 1.0:
        R = R.mul_(scale)      # R is a fresh tensor: scale it in place
    return R


def ensure_symmetry(A: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    """Symmetrize + jitter a theoretically-symmetric matrix."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return 0.5 * (A + A.T) + jitter * eye
