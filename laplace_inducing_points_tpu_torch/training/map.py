"""MAP training.

Counterpart of ``laplace_inducing_points_tpu/training/map.py``: ``l2_prior``
(``:23``), ``_loss`` with its BatchNorm branch (``:37-63``), ``map_step``
(``:66``), ``eval_classification`` (``:81``), ``eval_regression`` (``:95``),
``train_map`` (``:104``) and ``cosine_lr`` (``:145``). The weights are the flat
vector of the port's ``ModelState``, applied through
``torch.func.functional_call``; Adam is ``torch.optim.Adam`` set up as
``optax.adam`` (ε = 1e-8 added to √v̂). A model with BatchNorm runs its MAP
forward in train mode (batch statistics) and the step writes the updated
statistics into the state; evaluation uses the stored ones.

The regressor's Gaussian NLL has a learned observation ``logvar``: a leaf of
its own beside the flat vector (it stays out of the curvature), trained by
the same Adam and under the weights' prior precision, as in the reference's
parameter tree (biases carry no prior there). The trained value is written
into the returned state's model, which ``ModelState.logvar`` and so the rows'
scale ``exp(-logvar/2)`` read.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from laplace_inducing_points_tpu_torch.core.operators import model_outputs
from laplace_inducing_points_tpu_torch.models.state import ModelState


def l2_prior(state, flat: torch.Tensor, weight_precision: float,
             bias_precision: float = 0.0) -> torch.Tensor:
    """0.5·Σ prec·‖θ‖² with biases under their own precision."""
    total = flat.new_zeros(())
    for path, leaf in zip(state.spec.paths, state.spec.unflatten(flat).values()):
        prec = bias_precision if path[-1] == "bias" else weight_precision
        total = total + 0.5 * prec * torch.sum(leaf ** 2)
    return total


def train_outputs(state, flat: torch.Tensor, x: torch.Tensor):
    """``(outputs, new batch_stats)`` of the MAP forward: BatchNorm in train
    mode, its statistics updated on copies of ``state.batch_stats`` (the
    reference's ``apply_fn(..., train=True, mutable=["batch_stats"])``); a
    model without BatchNorm runs as it always does."""
    if not state.batch_stats:
        return model_outputs(state, flat, x), state.batch_stats
    stats = {name: t.clone() for name, t in state.batch_stats.items()}
    out = functional_call(state.model, {**state.spec.unflatten(flat), **stats}, (x,),
                          {"train": True})
    return out, stats


def classifier_loss(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    prior_precision: float):
    """``(loss, new batch_stats)`` of one batch: mean softmax cross-entropy
    plus the L2 prior on every leaf (weights and biases at
    ``prior_precision``; BatchNorm's ``bias`` counts as a bias, its ``scale``
    as a weight)."""
    logits, stats = train_outputs(state, flat, x)
    nll = F.cross_entropy(logits, y.reshape(-1).long())
    return nll + l2_prior(state, flat, prior_precision, prior_precision), stats


def gaussian_nll(mu: torch.Tensor, logvar: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean Gaussian NLL of ``y`` under ``N(mu, exp(logvar))``."""
    var = torch.exp(logvar)
    se = torch.square(mu - y.reshape(mu.shape).to(mu.dtype))
    return 0.5 * torch.mean(torch.log(2 * math.pi * var) + se / var)


def regressor_loss(state, flat: torch.Tensor, logvar: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, prior_precision: float) -> torch.Tensor:
    """Mean Gaussian NLL with the learned ``logvar`` plus the L2 prior at
    ``prior_precision`` on the kernels and on ``logvar`` (biases: none)."""
    mu, lv = functional_call(state.model, {**state.spec.unflatten(flat), "logvar": logvar},
                             (x,))
    prior = l2_prior(state, flat, prior_precision) + 0.5 * prior_precision * logvar ** 2
    return gaussian_nll(mu, lv, y) + prior


def map_loss(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             prior_precision: float, logvar: Optional[torch.Tensor] = None):
    """``(loss, new batch_stats)`` of one batch for either model kind; a
    regressor needs its ``logvar`` leaf."""
    if state.model_kind == "regressor":
        if logvar is None:
            raise ValueError("a regressor's MAP loss needs its logvar leaf")
        return regressor_loss(state, flat, logvar, x, y, prior_precision), state.batch_stats
    return classifier_loss(state, flat, x, y, prior_precision)


def _to_device(batch, device):
    x, y = batch
    return (torch.as_tensor(x, dtype=torch.float32, device=device),
            torch.as_tensor(y, device=device))


def map_step(state, flat: torch.Tensor, optimizer: torch.optim.Optimizer, batch,
             prior_precision: float, logvar: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MAP step on ``flat`` (a leaf that ``optimizer`` holds; a
    regressor's ``logvar`` leaf too), in place, and the batch's updated
    statistics into ``state.batch_stats``; returns the batch loss before the
    step."""
    x, y = _to_device(batch, flat.device)
    optimizer.zero_grad(set_to_none=True)
    loss, stats = map_loss(state, flat, x, y, prior_precision, logvar)
    loss.backward()
    optimizer.step()
    state.batch_stats = stats
    return loss.detach()


@torch.no_grad()
def eval_classification(state, batch) -> tuple[float, float]:
    """``(mean NLL, accuracy)`` of one batch at ``state.flat_params`` and the
    stored statistics."""
    x, y = _to_device(batch, state.device)
    logits = model_outputs(state, state.flat_params, x)
    labels = y.reshape(-1).long()
    nll = F.cross_entropy(logits, labels)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return float(nll), float(acc)


@torch.no_grad()
def eval_regression(state, batch) -> tuple[float, float]:
    """``(mean Gaussian NLL, 0)`` of one batch at ``state.flat_params`` and its
    ``logvar``."""
    x, y = _to_device(batch, state.device)
    mu = model_outputs(state, state.flat_params, x)
    return float(gaussian_nll(mu, torch.as_tensor(state.logvar, device=mu.device), y)), 0.0


def evaluate_loader(state, loader: Iterable) -> tuple[float, float]:
    """Batch means of :func:`eval_classification` (or :func:`eval_regression`)
    over ``loader``."""
    step = eval_regression if state.model_kind == "regressor" else eval_classification
    tot_nll, tot_acc, nb = 0.0, 0.0, 0
    for batch in loader:
        nll, acc = step(state, batch)
        tot_nll += nll
        tot_acc += acc
        nb += 1
    nb = max(nb, 1)
    return tot_nll / nb, tot_acc / nb


def map_optimizer(flat: torch.Tensor, lr: float | Callable[[int], float],
                  logvar: Optional[torch.Tensor] = None):
    """``(Adam on flat, and logvar if given, as optax.adam sets it up, the lr
    schedule)``."""
    schedule = lr if callable(lr) else (lambda _: lr)
    leaves = [flat] if logvar is None else [flat, logvar]
    return torch.optim.Adam(leaves, lr=schedule(0), eps=1e-8), schedule


def set_lr(optimizer: torch.optim.Optimizer, value: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = value


def cosine_lr(init_value: float, num_epochs: int, steps_per_epoch: int,
              final_fraction: float = 0.08) -> Callable[[int], float]:
    """Cosine decay from ``init_value`` to ``final_fraction·init_value`` over
    ``num_epochs·steps_per_epoch`` steps, then flat; the values of
    ``optax.cosine_decay_schedule(init_value, decay_steps, alpha=final_fraction)``."""
    decay_steps = num_epochs * steps_per_epoch
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1.0 - final_fraction) * cosine + final_fraction)

    return schedule


def train_map(state, train_loader: Iterable, test_loader: Iterable, *,
              num_epochs: int, alpha: float, lr: float | Callable[[int], float],
              callback: Optional[Callable] = None) -> ModelState:
    """Epoch loop with Adam at ``lr`` (a number or a schedule of the step
    count), printing the test NLL (and a classifier's accuracy) after each
    epoch; returns a new state holding the trained weights (a regressor's
    with its trained ``logvar``).

    ``callback(step, loss)`` sees every step's loss, a device scalar, so the
    loop does not wait for the device unless the callback does.
    """
    flat = state.flat_params.detach().clone().requires_grad_(True)
    logvar = None
    if state.model_kind == "regressor":
        logvar = torch.as_tensor(state.logvar, dtype=flat.dtype,
                                 device=flat.device).clone().requires_grad_(True)
    work = working_state(state, flat)
    optimizer, schedule = map_optimizer(flat, lr, logvar)
    step = 0
    for epoch in range(num_epochs):
        for batch in train_loader:
            set_lr(optimizer, schedule(step))
            loss = map_step(work, flat, optimizer, batch, alpha, logvar)
            if callback is not None:
                callback(step, loss)
            step += 1
        nll, acc = evaluate_loader(trained_state(work, logvar), test_loader)
        print(f"[MAP e{epoch:4d}] NLL={nll:.4f}"
              + (f" ACC={acc:.4f}" if logvar is None else f" logvar={float(logvar):.4f}"))
    return trained_state(work, logvar)


def working_state(state, flat: torch.Tensor) -> ModelState:
    """A state around the trained leaf ``flat`` with its own copy of the
    statistics, so the caller's state is left as it was."""
    return ModelState(state.model, flat, state.model_kind,
                      {name: t.clone() for name, t in state.batch_stats.items()})


def trained_state(work: ModelState, logvar: Optional[torch.Tensor] = None) -> ModelState:
    """The weights and statistics of a working state, detached; with a
    regressor's ``logvar`` leaf, on a copy of the model that holds it."""
    model = work.model
    if logvar is not None:
        model = copy.deepcopy(model)
        with torch.no_grad():
            model.logvar.copy_(logvar.detach())
    return ModelState(model, work.flat_params.detach().clone(), work.model_kind,
                      {name: t.clone() for name, t in work.batch_stats.items()})
