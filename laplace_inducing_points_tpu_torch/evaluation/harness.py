"""Dataset-level evaluation harness.

Counterpart of ``laplace_inducing_points_tpu/evaluation/harness.py:27-197``
for the scalable predictive: the posterior factor is built once per
``(state, Z)`` by :class:`ScalableLLAPredictor` and reused across every
batch, repetition and alpha value. The noise comes from one
``torch.Generator`` that advances batch by batch. The dense predictive is not
ported yet (ROADMAP, Queue A).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from laplace_inducing_points_tpu_torch.evaluation import metrics
from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor


def make_batch_sampler(state, Z, *, alpha, full_set_size, num_mc_samples,
                       predictor: Optional[ScalableLLAPredictor] = None,
                       example_block: Optional[int] = None,
                       range_clip_min: Optional[float] = None,
                       sample_block: Optional[int] = None):
    """Return ``fn(x, generator) -> (S, B, C)`` with the posterior factor
    hoisted out of the per-batch loop."""
    pred = predictor if predictor is not None else ScalableLLAPredictor(
        state, Z, full_set_size=full_set_size, example_block=example_block,
        range_clip_min=range_clip_min, sample_block=sample_block)
    return lambda x, generator: pred.logit_samples(x, alpha, generator,
                                                   num_mc_samples)


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
                 verbose: bool = False,
                 predictor: Optional[ScalableLLAPredictor] = None,
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
    for x, y in loader:
        logits = sampler(_to_device(x, state.device), generator)
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
                          predictor: Optional[ScalableLLAPredictor] = None,
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
    for x, y in loader:
        out = sampler(_to_device(x, state.device), generator)
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
              predictor: Optional[ScalableLLAPredictor] = None,
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
    for x, _ in ood_loader:
        logits = sampler(_to_device(x, state.device), generator)
        _, _, mean_probs = metrics.mc_predictive_nll_acc(
            logits, torch.zeros(x.shape[0], dtype=torch.int64))
        ood_probs.append(mean_probs.cpu().numpy())
    return metrics.auroc_ood(id_probs, np.concatenate(ood_probs))
