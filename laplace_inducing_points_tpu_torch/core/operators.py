"""Linearization, the materialized GGN row factor and the matrix-free W
factor.

Counterpart of ``laplace_inducing_points_tpu/core/operators.py``: ``pdot``
(``:44``), ``model_outputs`` (``:61``), ``Linearization``/``linearize_model``
(``:80-164``), ``_probe_blocked`` (``:171``), ``WFactor`` and
``BlockedWFactor`` as one class built by ``make_w_factor`` (``:186-493``,
``:647``), ``dense_wt`` (``:496-532``) with its pullback in ``Z`` (the
reference's ``_rows_chunk_vjp``, ``training/inducing.py:591``),
``ggn_matmat_materialized`` (``:625``) on the ``ggn_sweep`` kernel,
``predictive_jac_stats`` (``:535-570``, the ``cov`` predictive's per-image
statistics), the dense paths' ``GGNOperator``, ``dense_wt_from_lin``,
``make_ggn_operator``, ``make_curvature_operator`` and ``curvature_dense``
(``:577-700``) and ``ensure_symmetry`` (``:702``).

Operator glossary (D = #params, M = #points, K = #outputs, d = M·K):
``W : R^{M×K} -> R^D``, ``W U = c · Σ_i J_iᵀ L_i U_i``; ``Wᵀ : R^D -> R^{M×K}``,
``(Wᵀ v)_i = c · L_iᵀ J_i v``, so the rows ``R = Wᵀ`` are ``(d, D)`` and the
GGN is ``Rᵀ R = W Wᵀ``.

PyTorch has no stored linearization like ``jax.linearize``: each jvp here
re-runs the primal forward pass alongside the tangent. The factor's single
jvp is ``torch.func.jvp`` and its single vjp ``torch.autograd.grad`` of the
forward (with ``create_graph`` when grad mode is on, so it stays
differentiable in ``Z``), which, unlike ``torch.func.vjp``, also runs inside
``torch.utils.checkpoint`` (the Golub–Kahan steps of the matfree log-det);
probe batches are ``torch.func.vmap`` of ``jvp`` and of ``vjp``'s pullback.
The factor is differentiable in the point set ``Z``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.func import functional_call, jacrev, jvp, vjp, vmap

from laplace_inducing_points_tpu_torch.core import loss_hessians as lh
from laplace_inducing_points_tpu_torch.ops.cuda.sweep import ggn_sweep
from laplace_inducing_points_tpu_torch.utils.profiling import span


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
    state: object = field(repr=False, default=None)
    inputs: Optional[torch.Tensor] = field(repr=False, default=None)   # (M, ...) points

    @property
    def num_points(self) -> int:
        return self.f0.shape[0]


def _vjp_of_outputs(f: Callable, flat: torch.Tensor,
                    ct_of: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``(∂f/∂θ)ᵀ ct_of(f(θ))`` at ``flat`` by ``torch.autograd.grad``, from one
    forward: the cotangent may depend on the primal outputs (``L`` at
    ``f0``). Differentiable (in the points ``f`` closes over, and in the
    cotangent) when grad mode is on; runs inside ``torch.utils.checkpoint``."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        p = flat.detach().requires_grad_()
        out = f(p)
        ct = ct_of(out if create else out.detach())
        return torch.autograd.grad(out, p, ct, create_graph=create)[0]


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
                         jvp=jvp_fn, vjp=vjp_fn, logvar=state.logvar, state=state, inputs=Z)


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
    jac = jacobian_fn(state)

    def rows(z: torch.Tensor) -> torch.Tensor:
        J, f0 = jac(z)                                            # (b, K, D), (b, K)
        LtJ = lh.sqrt_h_t_apply(state.model_kind, f0[:, None, :],
                                J.transpose(1, 2), state.logvar)  # (b, D, K)
        return LtJ.transpose(1, 2).reshape(-1, flat.shape[0])     # (b·K, D)

    return rows


def jacobian_fn(state) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """``jac(x) -> (J (b, K, D), f0 (b, K))``: per-example Jacobians of the
    outputs at ``state.flat_params`` (a vmapped ``jacrev``, K backward passes
    an example) and the primal outputs."""
    def f_single(flat_p: torch.Tensor, xi: torch.Tensor):
        out = model_outputs(state, flat_p, xi[None])[0]
        return out, out

    jac = vmap(jacrev(f_single, has_aux=True), in_dims=(None, 0))
    return lambda x: jac(state.flat_params, x)


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
    with span("rows"):
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
    with span("pullback"):
        for s in _blocks(Z.shape[0], example_block):
            _, pull = vjp(rows, Z[s])
            grads.append(pull(ct[s.start * K:s.stop * K])[0])
        return grads[0] if len(grads) == 1 else torch.cat(grads)


# ---------------------------------------------------------------------------
# the matrix-free W factor
# ---------------------------------------------------------------------------

def _probe_blocked(batched_fn: Callable[[torch.Tensor], torch.Tensor], V: torch.Tensor,
                   block: Optional[int]) -> torch.Tensor:
    """``batched_fn`` over ``V``'s leading (probe) axis in chunks of ``block``
    rows, one after another; ``None`` (or ≥ P) is one call. The reference pads
    the last chunk to keep one compiled shape; an eager chunk needs no pad."""
    P = V.shape[0]
    if block is None or block >= P:
        return batched_fn(V)
    return torch.cat([batched_fn(V[i:i + block]) for i in range(0, P, block)])


@dataclass(frozen=True)
class WFactor:
    """The GGN square-root factor ``W`` as a matrix-free operator at ``Z``:
    ``t_matvec`` is one jvp and ``matvec`` one vjp of the network, and the
    probe-batched actions vmap them. The model runs over example blocks
    ``Z[s:s+b]`` one after another (one block of all ``M`` examples when no
    block is set), so the live activations are one block's; the primal
    forward is recomputed per block in every action.

    Padding contract (the reference's ``BlockedWFactor``): when ``b ∤ M`` the
    example axis is padded with ``Z[:pad]``; ``t_matvec`` trims their rows
    (zero cotangent, no phantom dZ) and ``matvec`` gives them zero
    coefficients (the vjp is linear in them, so they add nothing to the
    value or to dZ).
    """
    inner_shape: tuple[int, int]          # (M, K)
    num_params: int                       # D
    scale: float                          # sqrt(N/M) recalibration
    state: object = field(repr=False)
    blocks: tuple = field(repr=False)     # the padded Z in blocks of b
    pad: int = 0

    @property
    def d(self) -> int:
        """Columns of W (= M·K)."""
        M, K = self.inner_shape
        return M * K

    def _f(self, z: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
        return lambda p: model_outputs(self.state, p, z)

    def _padded(self, U: torch.Tensor) -> tuple:
        """``U (..., M, K)`` with ``pad`` zero rows, split into the blocks."""
        if self.pad:
            U = torch.cat([U, U.new_zeros(*U.shape[:-2], self.pad, U.shape[-1])], dim=-2)
        return U.split(self.blocks[0].shape[0], dim=-2)

    def t_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``Wᵀ v``: ``(D,) -> (M, K)``."""
        st = self.state
        outs = [lh.sqrt_h_t_apply(st.model_kind, *jvp(self._f(z), (st.flat_params,), (v,)),
                                  st.logvar) for z in self.blocks]
        return self.scale * torch.cat(outs)[:self.inner_shape[0]]

    def matvec(self, U: torch.Tensor) -> torch.Tensor:
        """``W U``: ``(M, K) -> (D,)``, accumulated over the blocks."""
        st = self.state
        out = 0.0
        for z, u in zip(self.blocks, self._padded(U)):
            out = out + _vjp_of_outputs(
                self._f(z), st.flat_params,
                lambda f0, u=u: lh.sqrt_h_apply(st.model_kind, f0, u, st.logvar))
        return self.scale * out

    def _t_mm(self, V: torch.Tensor) -> torch.Tensor:
        st = self.state
        outs = []
        for z in self.blocks:
            f = self._f(z)
            f0, JV = vmap(lambda v, f=f: jvp(f, (st.flat_params,), (v,)))(V)
            outs.append(lh.sqrt_h_t_apply(st.model_kind, f0, JV, st.logvar))
        return self.scale * torch.cat(outs, dim=1)[:, :self.inner_shape[0]]

    def _mm(self, U: torch.Tensor) -> torch.Tensor:
        st = self.state
        out = 0.0
        for z, u in zip(self.blocks, self._padded(U)):
            f0, pull = vjp(self._f(z), st.flat_params)
            out = out + vmap(pull)(lh.sqrt_h_apply(st.model_kind, f0, u, st.logvar))[0]
        return self.scale * out

    def t_matmat(self, V: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
        """Batched ``Wᵀ`` over probes: ``(P, D) -> (P, M, K)``, in chunks of
        ``block`` probes (bounding the live tangent activations to
        ``block·b`` examples)."""
        return _probe_blocked(self._t_mm, V, block)

    def matmat(self, U: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
        """Batched ``W`` over probes: ``(P, M, K) -> (P, D)``."""
        return _probe_blocked(self._mm, U, block)

    def gram_matmat(self, V: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
        """The Gram action ``Wᵀ(W ·)`` on flat probe rows ``(P, d) -> (P, d)``,
        unscaled by β; ``block`` bounds the live tangents of both legs (the
        inner operation of every Nyström sketch and CG solve)."""
        M, K = self.inner_shape

        def one(Vc: torch.Tensor) -> torch.Tensor:
            return self._t_mm(self._mm(Vc.reshape(-1, M, K))).reshape(Vc.shape[0], M * K)

        return _probe_blocked(one, V, block)


def make_w_factor(state, Z: torch.Tensor, full_set_size: Optional[int] = None,
                  example_block: Optional[int] = None) -> WFactor:
    """The :class:`WFactor` at ``Z`` with ``sqrt(N/M)`` recalibration
    (``N = full_set_size or M``), its model run over example blocks of
    ``example_block`` (``None`` or 0: one block; the reference's
    ``make_w_factor_blocked`` when set)."""
    M = Z.shape[0]
    b = int(min(example_block or M, M))
    pad = (-M) % b
    Zp = torch.cat([Z, Z[:pad]]) if pad else Z
    with torch.no_grad():
        K = model_outputs(state, state.flat_params, Z[:1]).shape[-1]
    return WFactor(inner_shape=(M, K), num_params=state.spec.num_params,
                   scale=math.sqrt((full_set_size or M) / M), state=state,
                   blocks=tuple(Zp.split(b)), pad=pad)


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


def predictive_jac_stats(state, x: torch.Tensor, R: torch.Tensor, *,
                         jac_block: Optional[int] = None):
    """Per-image predictive statistics ``(f0 (B, K), JJᵀ (B, K, K), A = J Rᵀ
    (B, K, d_z))``.

    The IP-LLA predictive at one input depends on its Jacobian ``J (K, D)``
    only through ``J Jᵀ`` and ``J Rᵀ``; both are α-independent. ``jac_block``
    builds the Jacobians that many images at a time, so only
    ``(block, K, D)`` of them are alive at once.
    """
    jac = jacobian_fn(state)
    f0s, JJts, As = [], [], []
    for s in _blocks(x.shape[0], jac_block):
        J, f0 = jac(x[s])                                         # (b, K, D)
        b, K, D = J.shape
        f0s.append(f0)
        JJts.append(pdot(J, J.transpose(1, 2)))
        As.append(pdot(J.reshape(b * K, D), R.T).reshape(b, K, -1))
        del J
    return torch.cat(f0s), torch.cat(JJts), torch.cat(As)


# ---------------------------------------------------------------------------
# the dense GGN and curvature (small models: D × D)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GGNOperator:
    """``v ↦ c² Σ_i J_iᵀ H_i J_i v``: one jvp, the loss Hessian and one vjp
    of the batched network."""
    lin: Linearization
    scale: float                      # N/M recalibration (c²)

    @property
    def num_params(self) -> int:
        return self.lin.flat_params.shape[0]

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        lin = self.lin
        hv = lh.h_apply(lin.model_kind, lin.f0, lin.jvp(v), lin.logvar)
        return self.scale * lin.vjp(hv)

    def matmat(self, V: torch.Tensor) -> torch.Tensor:
        """Batched probes: ``(P, D) -> (P, D)``."""
        return vmap(self.matvec)(V)

    def dense(self) -> torch.Tensor:
        """The ``D × D`` GGN ``c²·RᵀR`` (small models only; true f32)."""
        R = dense_wt_from_lin(self.lin)                           # (M·K, D)
        return self.scale * pdot(R.T, R)


def dense_wt_from_lin(lin: Linearization) -> torch.Tensor:
    """Unscaled ``Lᵀ J`` rows ``(M·K, D)`` of a linearization's points
    (differentiable in them)."""
    return dense_wt(lin.state, lin.inputs)


def make_ggn_operator(state, Z: torch.Tensor, full_set_size: Optional[int] = None,
                      lin: Optional[Linearization] = None) -> GGNOperator:
    """The GGN operator with ``N/M`` recalibration."""
    lin = lin or linearize_model(state, Z)
    M = lin.num_points
    return GGNOperator(lin=lin, scale=(full_set_size or M) / M)


def make_curvature_operator(state, Z: torch.Tensor, alpha: float,
                            full_set_size: Optional[int] = None,
                            lin: Optional[Linearization] = None
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``v ↦ (GGN + αI) v``, the PSD curvature ``S``."""
    ggn = make_ggn_operator(state, Z, full_set_size, lin=lin)
    return lambda v: ggn.matvec(v) + alpha * v


def curvature_dense(state, Z: torch.Tensor, alpha: float,
                    full_set_size: Optional[int] = None) -> torch.Tensor:
    """Dense ``S = GGN + αI``, differentiable in ``Z``."""
    G = make_ggn_operator(state, Z, full_set_size).dense()
    return G + alpha * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)


def ensure_symmetry(A: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    """Symmetrize + jitter a theoretically-symmetric matrix."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return 0.5 * (A + A.T) + jitter * eye
