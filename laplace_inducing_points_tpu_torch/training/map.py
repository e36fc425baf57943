"""MAP training: resumable, BatchNorm-aware, data-parallel over a mesh.

Counterpart of ``laplace_inducing_points_tpu/training/map.py``: ``l2_prior``
(``:23``), ``_loss`` with its BatchNorm branch (``:37-63``), ``map_step``
(``:66``), ``eval_classification`` (``:81``), ``eval_regression`` (``:95``),
``train_map`` (``:104``) and ``cosine_lr`` (``:145``). The weights are the flat
vector of the port's ``ModelState``, applied through
``torch.func.functional_call``; Adam is ``torch.optim.Adam`` set up as
``optax.adam`` (ε = 1e-8 added to √v̂). A model with BatchNorm runs its MAP
forward in train mode (batch statistics) and the step writes the updated
statistics into the state; evaluation uses the stored ones.

``train_map`` continues from the state's ``opt_state`` (an ``AdamState``: the
moments and the step count, restored by ``utils.checkpoint.load_train_state``)
as the reference's continues from its ``TrainState``: Adam's bias correction
and the learning-rate schedule both resume at the restored count (a cosine
schedule past its decay steps stays at its floor), and ``num_epochs`` more
epochs are trained. It returns the state with the optimizer state after its
last step, and saves it every ``checkpoint_every`` epochs into
``checkpoint_dir``.

On a ``parallel.mesh.Mesh`` the step splits the batch over the devices of the
data axis: each shard's forward runs in a thread of its own on a copy of the
module, with a copy of ``flat`` made by ``.to(device)`` (differentiable, so
every gradient lands on the leaf), the loss is the whole batch's mean NLL
plus the prior, and a train-mode BatchNorm normalises with the whole batch's
moments (``models.layers.batch_moments``), as the reference's SPMD step does.

The regressor's Gaussian NLL has a learned observation ``logvar``: a leaf of
its own beside the flat vector (it stays out of the curvature), trained by
the same Adam and under the weights' prior precision, as in the reference's
parameter tree (biases carry no prior there). The trained value is written
into the returned state's model, which ``ModelState.logvar`` and so the rows'
scale ``exp(-logvar/2)`` read.
"""

from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from laplace_inducing_points_tpu_torch.core.operators import model_outputs
from laplace_inducing_points_tpu_torch.models.layers import batch_moments
from laplace_inducing_points_tpu_torch.models.state import AdamState, ModelState


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


def classifier_nll(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``(mean softmax cross-entropy, new batch_stats)`` of one batch."""
    logits, stats = train_outputs(state, flat, x)
    return F.cross_entropy(logits, y.reshape(-1).long()), stats


def classifier_loss(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    prior_precision: float):
    """``(loss, new batch_stats)`` of one batch: mean softmax cross-entropy
    plus the L2 prior on every leaf (weights and biases at
    ``prior_precision``; BatchNorm's ``bias`` counts as a bias, its ``scale``
    as a weight)."""
    nll, stats = classifier_nll(state, flat, x, y)
    return nll + l2_prior(state, flat, prior_precision, prior_precision), stats


def gaussian_nll(mu: torch.Tensor, logvar: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean Gaussian NLL of ``y`` under ``N(mu, exp(logvar))``."""
    var = torch.exp(logvar)
    se = torch.square(mu - y.reshape(mu.shape).to(mu.dtype))
    return 0.5 * torch.mean(torch.log(2 * math.pi * var) + se / var)


def regressor_nll(state, flat: torch.Tensor, logvar: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """Mean Gaussian NLL of one batch with the learned ``logvar``."""
    mu, lv = functional_call(state.model, {**state.spec.unflatten(flat), "logvar": logvar},
                             (x,))
    return gaussian_nll(mu, lv, y)


def regressor_prior(state, flat: torch.Tensor, logvar: torch.Tensor,
                    prior_precision: float) -> torch.Tensor:
    """The L2 prior at ``prior_precision`` on the kernels and on ``logvar``
    (biases: none)."""
    return l2_prior(state, flat, prior_precision) + 0.5 * prior_precision * logvar ** 2


def regressor_loss(state, flat: torch.Tensor, logvar: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, prior_precision: float) -> torch.Tensor:
    """Mean Gaussian NLL with the learned ``logvar`` plus the L2 prior at
    ``prior_precision`` on the kernels and on ``logvar`` (biases: none)."""
    return (regressor_nll(state, flat, logvar, x, y)
            + regressor_prior(state, flat, logvar, prior_precision))


def map_loss(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             prior_precision: float, logvar: Optional[torch.Tensor] = None):
    """``(loss, new batch_stats)`` of one batch for either model kind; a
    regressor needs its ``logvar`` leaf."""
    if state.model_kind == "regressor":
        if logvar is None:
            raise ValueError("a regressor's MAP loss needs its logvar leaf")
        return regressor_loss(state, flat, logvar, x, y, prior_precision), state.batch_stats
    return classifier_loss(state, flat, x, y, prior_precision)


class _MomentSum:
    """The BatchNorm moments of the whole batch from its shards' threads:
    each shard hands in ``(E[x], E[x²], count)`` and waits at a barrier; one
    thread adds them on the first device, weighted by the shards' counts, and
    each shard takes the sums back onto its own device. Differentiable, so
    the gradient of every shard's loss reaches every shard's activations."""

    def __init__(self, devices):
        self.devices = devices
        self.barrier = threading.Barrier(len(devices))
        self.parts = [None] * len(devices)
        self.total = None

    def reducer(self, rank: int) -> Callable:
        def reduce(mean, mean2, count):
            self.parts[rank] = (mean, mean2, count)
            if self.barrier.wait() == 0:
                n = sum(c for _, _, c in self.parts)
                root = self.devices[0]
                self.total = (sum(m.to(root) * (c / n) for m, _, c in self.parts),
                              sum(m2.to(root) * (c / n) for _, m2, c in self.parts))
            self.barrier.wait()
            return tuple(t.to(self.devices[rank]) for t in self.total)

        return reduce


def _parallel_nll(state, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mesh,
                  logvar: Optional[torch.Tensor]):
    """``(the whole batch's mean NLL on flat's device, the first shard's new
    batch_stats)`` with the batch split over ``mesh``'s data axis, each shard
    in a thread of its own (empty shards left out)."""
    from laplace_inducing_points_tpu_torch.parallel.mesh import shard_batch
    xs, ys = shard_batch((x, y), mesh)
    shards = [(d, m, xi, yi) for d, m, xi, yi in
              zip(mesh.axis_devices(), mesh.module_copies(state.model), xs, ys) if len(xi)]
    exchange = _MomentSum([d for d, *_ in shards]) if state.batch_stats else None
    grad_mode = torch.is_grad_enabled()
    results, errors = [None] * len(shards), []

    def run(rank: int) -> None:
        device, model, xi, yi = shards[rank]
        try:
            with contextlib.ExitStack() as scope:
                scope.enter_context(torch.set_grad_enabled(grad_mode))
                if device.type == "cuda":
                    scope.enter_context(torch.cuda.device(device))
                if exchange is not None:
                    scope.enter_context(batch_moments(exchange.reducer(rank)))
                replica = ModelState(model, flat.to(device), state.model_kind,
                                     {k: t.to(device) for k, t in state.batch_stats.items()})
                if state.model_kind == "regressor":
                    nll = regressor_nll(replica, replica.flat_params, logvar.to(device), xi, yi)
                    results[rank] = nll, replica.batch_stats
                else:
                    results[rank] = classifier_nll(replica, replica.flat_params, xi, yi)
        except BaseException as err:          # handed to the caller below
            errors.append(err)
            if exchange is not None:
                exchange.barrier.abort()

    threads = [threading.Thread(target=run, args=(rank,), name=f"shard {rank}")
               for rank in range(len(shards))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    n = len(x)
    nll = sum(r[0].to(flat.device) * (len(s[2]) / n) for r, s in zip(results, shards))
    return nll, {k: t.to(flat.device) for k, t in results[0][1].items()}


def _to_device(batch, device):
    x, y = batch
    return (torch.as_tensor(x, dtype=torch.float32, device=device),
            torch.as_tensor(y, device=device))


def map_step(state, flat: torch.Tensor, optimizer: torch.optim.Optimizer, batch,
             prior_precision: float, logvar: Optional[torch.Tensor] = None, *,
             mesh=None) -> torch.Tensor:
    """One MAP step on ``flat`` (a leaf that ``optimizer`` holds; a
    regressor's ``logvar`` leaf too), in place, and the batch's updated
    statistics into ``state.batch_stats``; returns the batch loss before the
    step. With a ``mesh`` the batch is split over its data axis (module
    note)."""
    x, y = _to_device(batch, flat.device)
    optimizer.zero_grad(set_to_none=True)
    if mesh is None:
        loss, stats = map_loss(state, flat, x, y, prior_precision, logvar)
    else:
        if state.model_kind == "regressor" and logvar is None:
            raise ValueError("a regressor's MAP loss needs its logvar leaf")
        nll, stats = _parallel_nll(state, flat, x, y, mesh, logvar)
        prior = (regressor_prior(state, flat, logvar, prior_precision)
                 if state.model_kind == "regressor"
                 else l2_prior(state, flat, prior_precision, prior_precision))
        loss = nll + prior
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
                  logvar: Optional[torch.Tensor] = None,
                  opt_state: Optional[AdamState] = None):
    """``(Adam on flat, and logvar if given, as optax.adam sets it up, the lr
    schedule)``; with ``opt_state``, Adam continues from its moments and step
    count (:func:`adam_state` reads them back)."""
    schedule = lr if callable(lr) else (lambda _: lr)
    leaves = [flat] if logvar is None else [flat, logvar]
    optimizer = torch.optim.Adam(leaves, lr=schedule(0), eps=1e-8)
    if opt_state is not None and opt_state.count > 0:
        if len(opt_state.mu) != len(leaves):
            raise ValueError(f"the Adam state holds {len(opt_state.mu)} leaves; the "
                             f"optimizer {len(leaves)}")
        # torch keeps the count per leaf, as a tensor on the host: the bias
        # correction reads it
        optimizer.load_state_dict({
            "state": {i: {"step": torch.tensor(float(opt_state.count)),
                          "exp_avg": mu.to(leaf.device).clone(),
                          "exp_avg_sq": nu.to(leaf.device).clone()}
                      for i, (leaf, mu, nu) in enumerate(zip(leaves, opt_state.mu,
                                                             opt_state.nu))},
            "param_groups": optimizer.state_dict()["param_groups"]})
    return optimizer, schedule


def adam_state(optimizer: torch.optim.Adam) -> AdamState:
    """The moments and step count of ``optimizer``'s leaves, detached copies
    (zeros and count 0 before its first step)."""
    leaves = [p for group in optimizer.param_groups for p in group["params"]]
    states = [optimizer.state.get(p, {}) for p in leaves]
    count = int(states[0]["step"]) if states[0] else 0
    return AdamState(count,
                     tuple(st["exp_avg"].detach().clone() if st else torch.zeros_like(p)
                           for p, st in zip(leaves, states)),
                     tuple(st["exp_avg_sq"].detach().clone() if st else torch.zeros_like(p)
                           for p, st in zip(leaves, states)))


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
              callback: Optional[Callable] = None, mesh=None,
              checkpoint_dir: Optional[str] = None, checkpoint_name: str = "map",
              checkpoint_every: int = 50) -> ModelState:
    """Epoch loop with Adam at ``lr`` (a number or a schedule of the step
    count), printing the test NLL (and a classifier's accuracy) after each
    epoch; returns a new state holding the trained weights (a regressor's
    with its trained ``logvar``) and the optimizer state.

    It continues from ``state.opt_state`` where there is one: Adam's moments
    and its count, at which the schedule resumes too; ``num_epochs`` more
    epochs are trained. ``mesh`` splits each batch over its data axis.
    ``checkpoint_dir``: the train state is saved as ``{checkpoint_name}.pt``
    there after epoch ``e + 1`` where ``(e + 1) % checkpoint_every == 0`` and
    ``e + 1 < num_epochs`` (the caller saves the last).

    ``callback(step, loss)`` sees every step's loss, a device scalar, so the
    loop does not wait for the device unless the callback does.
    """
    flat = state.flat_params.detach().clone().requires_grad_(True)
    logvar = None
    if state.model_kind == "regressor":
        logvar = torch.as_tensor(state.logvar, dtype=flat.dtype,
                                 device=flat.device).clone().requires_grad_(True)
    work = working_state(state, flat)
    optimizer, schedule = map_optimizer(flat, lr, logvar, state.opt_state)
    step = state.step
    for epoch in range(num_epochs):
        for batch in train_loader:
            set_lr(optimizer, schedule(step))
            loss = map_step(work, flat, optimizer, batch, alpha, logvar, mesh=mesh)
            if callback is not None:
                callback(step, loss)
            step += 1
        nll, acc = evaluate_loader(trained_state(work, logvar), test_loader)
        print(f"[MAP e{epoch:4d}] NLL={nll:.4f}"
              + (f" ACC={acc:.4f}" if logvar is None else f" logvar={logvar.item():.4f}"))
        # periodic crash-resume checkpoints
        if checkpoint_dir and (epoch + 1) % checkpoint_every == 0 and epoch + 1 < num_epochs:
            from laplace_inducing_points_tpu_torch.utils.checkpoint import save_train_state
            save_train_state(trained_state(work, logvar, adam_state(optimizer)),
                             checkpoint_dir, checkpoint_name)
    return trained_state(work, logvar, adam_state(optimizer))


def working_state(state, flat: torch.Tensor) -> ModelState:
    """A state around the trained leaf ``flat`` with its own copy of the
    statistics, so the caller's state is left as it was."""
    return ModelState(state.model, flat, state.model_kind,
                      {name: t.clone() for name, t in state.batch_stats.items()})


def trained_state(work: ModelState, logvar: Optional[torch.Tensor] = None,
                  opt_state: Optional[AdamState] = None) -> ModelState:
    """The weights and statistics of a working state, detached, with
    ``opt_state``; with a regressor's ``logvar`` leaf, on a copy of the model
    that holds it."""
    model = work.model
    if logvar is not None:
        model = copy.deepcopy(model)
        with torch.no_grad():
            model.logvar.copy_(logvar.detach())
    return ModelState(model, work.flat_params.detach().clone(), work.model_kind,
                      {name: t.clone() for name, t in work.batch_stats.items()}, opt_state)
