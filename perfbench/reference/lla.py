"""Plain reference of what the timed paths compute: the GGN rows of a
softmax classifier, the Gram KL between the inducing-point and the data
posteriors, its gradient in the points Z, Adam, and the linearized-Laplace
weight-space predictive.

It is written from the definitions, in plain PyTorch, for any dtype, and
imports nothing of the program: a network is a module of this folder
(``lenet5``, ``resnet1m``) with ``LEAVES``, ``STATS`` and ``forward``.

Definitions (D weights, K classes, prior precision alpha, beta = N/M,
gamma = N/n for a data batch of n):

- rows of a point x: ``R(x) = L(f(x))^T J(x)`` (K, D), with ``J`` the
  Jacobian of the logits in the weights and ``L L^T = diag(p) - p p^T`` the
  softmax cross-entropy Hessian, ``L^T v = s*v - (p.v) s``, ``s = sqrt(p)``;
- posteriors ``S = alpha I + gamma Rx^T Rx`` and ``S_z = alpha I + beta Rz^T Rz``;
- the objective ``tr(S S_z^-1) + logdet S_z``, by Woodbury with
  ``C = Rz Rz^T + (alpha/beta) I``:
  ``D - tr(C^-1 Gzz) + gamma/alpha (tr Gxx - tr(Gxz C^-1 Gxz^T))
  + D log alpha + d log(beta/alpha) + logdet C``. ``C`` is symmetrized and
  given the JAX package's pivot jitter, 2e-6 times its largest absolute row
  sum, before it is factored;
- a posterior weight draw ``w = (alpha I + beta R^T R)^-1/2 eps``
  ``= eps / sqrt(alpha) + R^T V g(lam) V^T R eps`` with ``R R^T = V lam V^T``
  and ``g = ((alpha + beta lam)^-1/2 - alpha^-1/2) / lam`` on the
  eigenvalues above ``rank_tol * max(lam_max, 1)`` (0 on the others), pushed
  forward as ``f(x) + J(x) w``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.func import jacrev, vjp, vmap

PIVOT_JITTER = 2e-6


@contextlib.contextmanager
def precision(mode: str):
    """The dtype to compute in, and inside the block the matching settings,
    the previous ones restored after it. ``"float64"``: nothing changes (the
    caller casts to float64). ``"float32"``: matmuls and cuDNN convolutions in
    true float32 (TF32 off). ``"tf32"``: float32 matmuls and cuDNN
    convolutions on the tensor cores in TF32."""
    if mode == "float64":
        yield torch.float64
        return
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def unflatten(net, flat: torch.Tensor) -> dict:
    out, offset = {}, 0
    for path, shape in net.LEAVES:
        size = math.prod(shape)
        out[".".join(path)] = flat[offset:offset + size].view(shape)
        offset += size
    if offset != flat.shape[0]:
        raise ValueError(f"the flat vector has {flat.shape[0]} weights, the net {offset}")
    return out


def num_params(net) -> int:
    return sum(math.prod(shape) for _, shape in net.LEAVES)


def logits(net, flat: torch.Tensor, stats: dict, x: torch.Tensor) -> torch.Tensor:
    return net.forward(unflatten(net, flat), stats, x)


def _blocks(n: int, block: Optional[int]) -> list[slice]:
    block = n if not block else min(block, n)
    return [slice(i, i + block) for i in range(0, n, block)]


def jacobians(net, flat: torch.Tensor, stats: dict, x: torch.Tensor):
    """``(J (b, K, D), f (b, K))``: each point's Jacobian of its logits in the
    weights, and its logits."""
    def one(w, xi):
        out = logits(net, w, stats, xi[None])[0]
        return out, out
    return vmap(jacrev(one, has_aux=True), in_dims=(None, 0))(flat, x)


def rows_of(net, flat: torch.Tensor, stats: dict, x: torch.Tensor) -> torch.Tensor:
    """``(b*K, D)``: the rows ``L(f)^T J`` of the points ``x``, differentiable
    in ``x``."""
    J, f = jacobians(net, flat, stats, x)
    p = torch.softmax(f, dim=-1)
    s = torch.sqrt(p)
    mixed = torch.einsum("bc,bcd->bd", p, J)
    R = s[:, :, None] * (J - mixed[:, None, :])
    return R.reshape(-1, J.shape[-1])


def rows(net, flat, stats, x, block: Optional[int] = None) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([rows_of(net, flat, stats, x[s]) for s in _blocks(x.shape[0], block)])


def gram_kl(Rz: torch.Tensor, Rx: torch.Tensor, alpha: float, beta: float,
            gamma: float) -> torch.Tensor:
    d, D = Rz.shape
    Gzz, Gxz = Rz @ Rz.T, Rx @ Rz.T
    eye = torch.eye(d, dtype=Rz.dtype, device=Rz.device)
    C = Gzz + (alpha / beta) * eye
    jitter = PIVOT_JITTER * torch.max(torch.sum(torch.abs(C), dim=1))
    L = torch.linalg.cholesky(0.5 * (C + C.T) + jitter * eye)
    Cinv_Gzz = torch.cholesky_solve(Gzz, L)
    Cinv_Gzx = torch.cholesky_solve(Gxz.T, L)
    trace = (D - torch.trace(Cinv_Gzz)
             + gamma / alpha * (torch.sum(Rx * Rx) - torch.sum(Gxz.T * Cinv_Gzx)))
    logdet = (D * math.log(alpha) + d * math.log(beta / alpha)
              + 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return trace + logdet


def kl_value_and_grad(net, flat, stats, Z: torch.Tensor, X: torch.Tensor, alpha: float,
                      full_set_size: int, block: Optional[int] = None):
    """``(KL, dKL/dZ)`` at the points ``Z`` against the batch ``X``: the
    rows, the KL's gradient in the rows of Z, pulled back through the rows'
    dependence on Z one block of points at a time."""
    M, n = Z.shape[0], X.shape[0]
    beta, gamma = full_set_size / M, full_set_size / n
    Rz = rows(net, flat, stats, Z, block).requires_grad_()
    Rx = rows(net, flat, stats, X, block)
    with torch.enable_grad():
        loss = gram_kl(Rz, Rx, alpha, beta, gamma)
        (ct,) = torch.autograd.grad(loss, Rz)
    del Rz, Rx
    K = ct.shape[0] // M
    grads = []
    for s in _blocks(M, block):
        _, pull = vjp(lambda z: rows_of(net, flat, stats, z), Z[s])
        grads.append(pull(ct[s.start * K:s.stop * K])[0])
    return loss.detach(), torch.cat(grads)


class Adam:
    """Adam as ``torch.optim.Adam`` and optax define it: bias-corrected
    moments, ``eps`` added to the corrected root."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t, self.m, self.v = 0, None, None

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        if self.m is None:
            self.m, self.v = torch.zeros_like(param), torch.zeros_like(param)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * grad
        self.v = self.b2 * self.v + (1 - self.b2) * grad * grad
        m_hat = self.m / (1 - self.b1 ** self.t)
        v_hat = self.v / (1 - self.b2 ** self.t)
        return param - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def weight_factor(R: torch.Tensor):
    """``(lam, V)``: the eigendecomposition of the Gram ``R R^T``."""
    G = R @ R.T
    return torch.linalg.eigh(0.5 * (G + G.T))


def g_weights(lam: torch.Tensor, alpha: float, beta: float, rank_tol: float) -> torch.Tensor:
    keep = lam > rank_tol * torch.clamp(torch.max(lam), min=1.0)
    safe = torch.where(keep, lam, torch.ones_like(lam))
    g = (1.0 / torch.sqrt(alpha + beta * safe) - 1.0 / math.sqrt(alpha)) / safe
    return torch.where(keep, g, torch.zeros_like(g))


def logit_samples(net, flat, stats, x: torch.Tensor, R: torch.Tensor, lam: torch.Tensor,
                  V: torch.Tensor, eps: torch.Tensor, alpha: float, beta: float,
                  rank_tol: float, block: Optional[int] = None) -> torch.Tensor:
    """``(S, B, K)``: the draws ``eps (S, D)`` of the posterior over the
    weights, pushed forward through the linearization at the images ``x``."""
    g = g_weights(lam, alpha, beta, rank_tol)
    w = eps / math.sqrt(alpha) + (((eps @ R.T) @ V) * g) @ V.T @ R          # (S, D)
    outs = []
    with torch.no_grad():
        for s in _blocks(x.shape[0], block):
            J, f = jacobians(net, flat, stats, x[s])                            # (b, K, D)
            outs.append(f[None] + torch.einsum("bkd,sd->sbk", J, w))
    return torch.cat(outs, dim=1)
