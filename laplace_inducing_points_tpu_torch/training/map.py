"""MAP training of the classifier weights.

Counterpart of ``laplace_inducing_points_tpu/training/map.py``: ``l2_prior``
(``:23``), the classifier branch of ``_loss`` (``:37``), ``map_step``
(``:66``), ``eval_classification`` (``:81``), ``train_map`` (``:104``) and
``cosine_lr`` (``:145``). The weights are the flat vector of the port's
``ModelState``, applied through ``torch.func.functional_call``; Adam is
``torch.optim.Adam`` set up as ``optax.adam`` (ε = 1e-8 added to √v̂). The
regressor's Gaussian NLL and the BatchNorm statistics wait for the toy and
ResNet slices (ROADMAP, Queue A).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F

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


def _require_classifier(state) -> None:
    if state.model_kind != "classifier":
        raise NotImplementedError("MAP training of a regressor is not ported yet "
                                  "(ROADMAP, Queue A)")


def classifier_loss(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    prior_precision: float) -> torch.Tensor:
    """Negative log joint of one batch: mean softmax cross-entropy plus the L2
    prior on every leaf (weights and biases at ``prior_precision``)."""
    logits = model_outputs(state, flat, x)
    nll = F.cross_entropy(logits, y.reshape(-1).long())
    return nll + l2_prior(state, flat, prior_precision, prior_precision)


def _to_device(batch, device):
    x, y = batch
    return (torch.as_tensor(x, dtype=torch.float32, device=device),
            torch.as_tensor(y, device=device))


def map_step(state, flat: torch.Tensor, optimizer: torch.optim.Optimizer, batch,
             prior_precision: float) -> torch.Tensor:
    """One MAP step on ``flat`` (a leaf that ``optimizer`` holds), in place;
    returns the batch loss before the step."""
    _require_classifier(state)
    x, y = _to_device(batch, flat.device)
    optimizer.zero_grad(set_to_none=True)
    loss = classifier_loss(state, flat, x, y, prior_precision)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_classification(state, batch) -> tuple[float, float]:
    """``(mean NLL, accuracy)`` of one batch at ``state.flat_params``."""
    x, y = _to_device(batch, state.device)
    logits = model_outputs(state, state.flat_params, x)
    labels = y.reshape(-1).long()
    nll = F.cross_entropy(logits, labels)
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return float(nll), float(acc)


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
    count), printing the test NLL and accuracy after each epoch; returns a new
    state holding the trained weights.

    ``callback(step, loss)`` sees every step's loss, a device scalar, so the
    loop does not wait for the device unless the callback does.
    """
    _require_classifier(state)
    flat = state.flat_params.detach().clone().requires_grad_(True)
    schedule = lr if callable(lr) else (lambda _: lr)
    optimizer = torch.optim.Adam([flat], lr=schedule(0), eps=1e-8)
    step = 0
    for epoch in range(num_epochs):
        for batch in train_loader:
            for group in optimizer.param_groups:
                group["lr"] = schedule(step)
            loss = map_step(state, flat, optimizer, batch, alpha)
            if callback is not None:
                callback(step, loss)
            step += 1
        trained = ModelState(state.model, flat.detach(), state.model_kind)
        tot_nll, tot_acc, nb = 0.0, 0.0, 0
        for batch in test_loader:
            nll, acc = eval_classification(trained, batch)
            tot_nll += nll
            tot_acc += acc
            nb += 1
        nb = max(nb, 1)
        print(f"[MAP e{epoch:4d}] NLL={tot_nll / nb:.4f} ACC={tot_acc / nb:.4f}")
    return ModelState(state.model, flat.detach().clone(), state.model_kind)
