"""Dataset-level evaluation harness.

Counterpart of ``laplace_inducing_points_tpu/evaluation/harness.py:27-197``:
``batch_logit_samples`` (one batch, the factor rebuilt) and
``make_batch_sampler``, whose scalable predictor (:class:`ScalableLLAPredictor`)
or dense one (:class:`DenseLLAPredictor`) is built once per ``(state, Z)`` and
reused across every batch, repetition and alpha value. The loops name each
batch with a cache key (the loader's identity and the batch index), under
which the ``cov`` predictor keeps its α-independent statistics. The noise
comes from one ``torch.Generator`` that advances batch by batch.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.evaluation import metrics
from laplace_inducing_points_tpu_torch.inference.lla import (DenseLLAPredictor,
                                                             ScalableLLAPredictor,
                                                             predict_lla_dense,
                                                             predict_lla_scalable)


def batch_logit_samples(state, x, Z, *, alpha, full_set_size, num_mc_samples,
                        generator: torch.Generator, scalable: bool = True) -> torch.Tensor:
    """``(S, B, C)`` predictive logit samples for one batch, the posterior
    rebuilt for it (use :func:`make_batch_sampler` in loops)."""
    if scalable:
        return predict_lla_scalable(state, x, Z, alpha, generator,
                                    full_set_size=full_set_size, num_samples=num_mc_samples)
    dist = predict_lla_dense(state, x, Z, alpha, full_set_size=full_set_size)
    return dist.sample(generator, num_mc_samples)


def make_batch_sampler(state, Z, *, alpha, full_set_size, num_mc_samples,
                       scalable: bool = True, predictor=None,
                       example_block: Optional[int] = None,
                       range_clip_min: Optional[float] = None,
                       sample_block: Optional[int] = None):
    """Return ``fn(x, generator, cache_key=None) -> (S, B, C)`` with the
    posterior factor (the dense GGN without ``scalable``) hoisted out of the
    per-batch loop; ``predictor`` is a prebuilt one (a
    :class:`ScalableLLAPredictor` or a :class:`DenseLLAPredictor`)."""
    if predictor is not None:
        pred = predictor
    elif scalable:
        pred = ScalableLLAPredictor(state, Z, full_set_size=full_set_size,
                                    example_block=example_block,
                                    range_clip_min=range_clip_min, sample_block=sample_block)
    else:
        pred = DenseLLAPredictor(state, Z, full_set_size=full_set_size)
    return lambda x, generator, cache_key=None: pred.logit_samples(
        x, alpha, generator, num_mc_samples, cache_key=cache_key)


def _to_device(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)


def _batch_metrics(state, out_samples: torch.Tensor, y):
    """Softmax-CE MC-NLL for classifiers, Gaussian MC-NLL (+rmse in the
    'acc' slot) for regressors."""
    y = torch.as_tensor(np.asarray(y)).to(out_samples.device)
    if state.model_kind == "regressor":
        nll, rmse = metrics.mc_gaussian_nll(out_samples, y, state.logvar)
        return nll, rmse, None
    return metrics.mc_predictive_nll_acc(out_samples, y)


def eval_dataset(state, loader: Iterable, Z, *, alpha, full_set_size,
                 num_mc_samples, generator: torch.Generator,
                 verbose: bool = False, predictor=None,
                 example_block: Optional[int] = None,
                 range_clip_min: Optional[float] = None,
                 sample_block: Optional[int] = None) -> tuple[float, float]:
    """Weighted-mean NLL and accuracy (rmse for regressors) over a loader."""
    sampler = make_batch_sampler(
        state, Z, alpha=alpha, full_set_size=full_set_size,
        num_mc_samples=num_mc_samples, predictor=predictor,
        example_block=example_block, range_clip_min=range_clip_min,
        sample_block=sample_block)
    tot_nll = tot_acc = tot_n = 0.0
    is_regressor = state.model_kind == "regressor"
    for i, (x, y) in enumerate(loader):
        logits = sampler(_to_device(x, state.device), generator, ("eval", id(loader), i))
        nll, acc, _ = _batch_metrics(state, logits, y)
        bs = x.shape[0]
        tot_nll += float(nll) * bs
        # a regressor's 'acc' slot is a per-batch RMSE: aggregate the MSE
        tot_acc += (float(acc) ** 2 if is_regressor else float(acc)) * bs
        tot_n += bs
        if verbose:
            print(f"  [eval] NLL={float(nll):.3f} ACC={float(acc):.3f}")
    if tot_n == 0:
        raise ValueError("eval_dataset: loader yielded no batches")
    score = tot_acc / tot_n
    return tot_nll / tot_n, (score ** 0.5 if is_regressor else score)


def eval_dataset_extended(state, loader: Iterable, Z, *, alpha, full_set_size,
                          num_mc_samples, generator: torch.Generator,
                          predictor=None,
                          example_block: Optional[int] = None,
                          range_clip_min: Optional[float] = None,
                          sample_block: Optional[int] = None) -> dict:
    """Extended metrics record, dispatched on the model kind.

    Classifier: ``{"nll", "acc", "brier", "ece", "probs", "labels"}``.
    Regressor:  ``{"nll", "rmse", "picp90", "picp_err", "means", "targets"}``
    (PICP90: coverage of the moment-matched 90% credible interval).
    """
    sampler = make_batch_sampler(
        state, Z, alpha=alpha, full_set_size=full_set_size,
        num_mc_samples=num_mc_samples, predictor=predictor,
        example_block=example_block, range_clip_min=range_clip_min,
        sample_block=sample_block)
    tot_nll = tot_acc = tot_n = 0.0
    collected, all_labels = [], []
    covered = 0.0
    is_regressor = state.model_kind == "regressor"
    for i, (x, y) in enumerate(loader):
        out = sampler(_to_device(x, state.device), generator, ("eval", id(loader), i))
        nll, acc, mean_probs = _batch_metrics(state, out, y)
        bs = x.shape[0]
        tot_nll += float(nll) * bs
        tot_acc += (float(acc) ** 2 if is_regressor else float(acc)) * bs
        tot_n += bs
        if is_regressor:
            mu = out.mean(dim=0).reshape(bs)
            var = out.var(dim=0, unbiased=False).reshape(bs) + torch.exp(
                torch.as_tensor(state.logvar, device=out.device))
            half = 1.6449 * torch.sqrt(var)                   # 90% two-sided
            yb = torch.as_tensor(np.asarray(y)).to(out).reshape(bs)
            covered += float(torch.sum(torch.abs(yb - mu) <= half))
            collected.append(mu.cpu().numpy())
            all_labels.append(yb.cpu().numpy())
        else:
            collected.append(mean_probs.cpu().numpy())
            all_labels.append(np.asarray(y).reshape(-1))
    if tot_n == 0:
        raise ValueError("eval_dataset_extended: loader yielded no batches")
    flat = np.concatenate(collected)
    labels = np.concatenate(all_labels)
    if is_regressor:
        picp = covered / tot_n
        return {"nll": tot_nll / tot_n, "rmse": (tot_acc / tot_n) ** 0.5,
                "picp90": picp, "picp_err": abs(picp - 0.9),
                "means": flat, "targets": labels}
    return {"nll": tot_nll / tot_n, "acc": tot_acc / tot_n,
            "brier": metrics.brier_score(flat, labels),
            "ece": metrics.ece(flat, labels),
            "probs": flat, "labels": labels}


def auroc_ood(state, id_probs: np.ndarray, ood_loader: Iterable, Z, *,
              alpha, full_set_size, num_mc_samples, generator: torch.Generator,
              predictor=None,
              example_block: Optional[int] = None,
              range_clip_min: Optional[float] = None,
              sample_block: Optional[int] = None) -> float:
    """OOD AUROC against an out-of-distribution loader."""
    sampler = make_batch_sampler(
        state, Z, alpha=alpha, full_set_size=full_set_size,
        num_mc_samples=num_mc_samples, predictor=predictor,
        example_block=example_block, range_clip_min=range_clip_min,
        sample_block=sample_block)
    ood_probs = []
    for i, (x, _) in enumerate(ood_loader):
        logits = sampler(_to_device(x, state.device), generator, ("ood", id(ood_loader), i))
        _, _, mean_probs = metrics.mc_predictive_nll_acc(
            logits, torch.zeros(x.shape[0], dtype=torch.int64))
        ood_probs.append(mean_probs.cpu().numpy())
    return metrics.auroc_ood(id_probs, np.concatenate(ood_probs))
