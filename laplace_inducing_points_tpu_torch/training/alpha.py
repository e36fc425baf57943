"""Prior-precision (α) optimization by evidence maximization.

Counterpart of ``laplace_inducing_points_tpu/training/alpha.py:26-104``: the
log marginal likelihood through the low-rank log-det identity on the small
Gram (the rows ``dense_wt``, then the ``syrk`` kernel, then ``slogdet``),
Adam ascent on log α (``torch.optim.Adam`` set up as ``optax.adam``), and
the MAP loop that takes an α step every few epochs after a burn-in. The rows
and their Gram do not depend on α: they are built without a tape, so only
the scalar path in α is differentiated.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.ops.cuda.syrk import syrk
from laplace_inducing_points_tpu_torch.training.map import (adam_state, evaluate_loader,
                                                            map_optimizer, map_step, set_lr,
                                                            trained_state, working_state)


def log_marginal_likelihood(alpha, X: torch.Tensor, state,
                            full_set_size: Optional[int] = None,
                            example_block: Optional[int] = None) -> torch.Tensor:
    """log p(D|α) up to α-independent constants:
    ``log N(θ_MAP | 0, α⁻¹I) − ½·[logdet(I + (N/b)/α·G) + D·log α]`` with
    ``G = R Rᵀ`` the Gram of the rows of the batch ``X`` (``b`` examples).

    ``alpha`` may be a tensor that requires grad; ``example_block`` chunks the
    row build.
    """
    N = full_set_size or X.shape[0]
    rescale = N / X.shape[0]
    with torch.no_grad():
        R = ops.dense_wt(state, X, example_block=example_block)     # (d, D), unscaled
        G = syrk(R)
    D = R.shape[1]
    del R
    alpha = torch.as_tensor(alpha, dtype=G.dtype, device=G.device)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    logdet_lowrank = torch.linalg.slogdet(eye + (rescale / alpha) * G)[1]
    logdet_term = logdet_lowrank + D * torch.log(alpha)
    flat = state.flat_params.detach()
    log_prior = -0.5 * alpha * torch.dot(flat, flat) + 0.5 * D * torch.log(alpha)
    return log_prior - 0.5 * logdet_term


def make_alpha_optimizer(log_alpha: torch.Tensor, lr: float = 5e-2) -> torch.optim.Adam:
    """Adam on the leaf ``log_alpha`` as ``optax.adam(lr)`` sets it up."""
    return torch.optim.Adam([log_alpha], lr=lr, eps=1e-8)


def update_alpha(log_alpha: torch.Tensor, optimizer: torch.optim.Optimizer,
                 X: torch.Tensor, state, full_set_size: Optional[int] = None,
                 example_block: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One ascent step on ``log_alpha`` (a leaf that ``optimizer`` holds), in
    place; returns the log evidence at the old α and its derivative in log α."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        lml = log_marginal_likelihood(torch.exp(log_alpha), X, state, full_set_size,
                                      example_block)
        (-lml).backward()
    slope = -log_alpha.grad.detach().clone()
    optimizer.step()
    return lml.detach(), slope


def train_map_then_alpha(state, train_loader: Iterable, test_loader: Iterable, *,
                         num_epochs: int = 500, alpha0: float = 1.0,
                         lr: float | Callable[[int], float] = 1e-3,
                         alpha_lr: float = 5e-2, alpha_every: int = 5,
                         burnin: int = 100, full_set_size: Optional[int] = None,
                         example_block: Optional[int] = None, verbose: bool = True,
                         callback: Optional[Callable] = None):
    """MAP epochs at prior precision α, with an α step on the epoch's last
    batch every ``alpha_every`` epochs after ``burnin``; returns ``(trained
    state, α)``. ``lr`` and ``callback(step, loss)`` are :func:`train_map`'s;
    as there, Adam and the schedule continue from ``state.opt_state``.
    """
    flat = state.flat_params.detach().clone().requires_grad_(True)
    work = working_state(state, flat)
    optimizer, schedule = map_optimizer(flat, lr, opt_state=state.opt_state)
    log_alpha = torch.tensor(math.log(alpha0), dtype=torch.float32,
                             device=state.device).requires_grad_(True)
    alpha_opt = make_alpha_optimizer(log_alpha, alpha_lr)
    step, last_batch = state.step, None
    for epoch in range(num_epochs):
        alpha = math.exp(log_alpha.item())
        for batch in train_loader:
            set_lr(optimizer, schedule(step))
            loss = map_step(work, flat, optimizer, batch, alpha)
            if callback is not None:
                callback(step, loss)
            step += 1
            last_batch = batch
        if epoch >= burnin and (epoch + 1) % alpha_every == 0:
            x = torch.as_tensor(last_batch[0], dtype=torch.float32, device=state.device)
            update_alpha(log_alpha, alpha_opt, x, trained_state(work), full_set_size,
                         example_block)
        if verbose and epoch % 4 == 0:
            nll, acc = evaluate_loader(trained_state(work), test_loader)
            print(f"[MAP+α e{epoch:4d}] NLL={nll:.4f} α={math.exp(log_alpha.item()):.4f} "
                  f"ACC={acc:.4f}")
    return trained_state(work, opt_state=adam_state(optimizer)), math.exp(log_alpha.item())
