"""Calibration / uncertainty metrics.

Counterpart of ``laplace_inducing_points_tpu/evaluation/metrics.py:19-133``:
MC predictive NLL and accuracy (torch, on the samples' device), Brier,
15-bin ECE and the rank-statistic OOD AUROC (numpy, on the host).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def mc_predictive_nll_acc(logit_samples: torch.Tensor, labels: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MC-averaged predictive NLL ``−log(1/S Σ_s p_s(y))``, accuracy, mean
    probabilities. ``logit_samples``: (S, B, C); ``labels``: (B,)."""
    S = logit_samples.shape[0]
    log_probs = torch.log_softmax(logit_samples, dim=-1)         # (S, B, C)
    y = labels.reshape(-1).to(device=logit_samples.device, dtype=torch.int64)
    log_p_true = torch.take_along_dim(
        log_probs, y[None, :, None], dim=-1).squeeze(-1)        # (S, B)
    log_avg = torch.logsumexp(log_p_true, dim=0) - math.log(S)
    nll = -torch.mean(log_avg)

    mean_probs = torch.exp(log_probs).mean(dim=0)               # (B, C)
    acc = torch.mean((mean_probs.argmax(-1) == y).to(torch.float32))
    return nll, acc, mean_probs


def brier_score(probs: np.ndarray, labels: np.ndarray) -> float:
    """Multi-class Brier score."""
    probs = np.asarray(probs)
    one_hot = np.eye(probs.shape[-1])[np.asarray(labels, dtype=int)]
    return float(np.mean(np.sum((probs - one_hot) ** 2, axis=1)))


def ece(probs: np.ndarray, labels: np.ndarray, n_bins: int = 15) -> float:
    """Expected calibration error, naive histogram binning; the top bin
    includes confidence 1.0 (as the JAX package does)."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    conf = probs.max(1)
    correct = probs.argmax(1) == labels
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    total = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (conf >= lo) & (conf < hi)
        if hi >= 1.0:
            mask = (conf >= lo) & (conf <= hi)
        if not mask.any():
            continue
        total += abs(conf[mask].mean() - correct[mask].mean()) * mask.mean()
    return float(total)


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Binary AUROC by the rank-statistic (Mann–Whitney) formula, ties by
    midranks."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * ((i + 1) + (j + 1))
        i = j + 1
    rank_sum_pos = ranks[labels].sum()
    return float((rank_sum_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def ood_scores(probs: np.ndarray) -> np.ndarray:
    """Higher ⇒ more OOD-like (negative max-probability)."""
    return -np.asarray(probs).max(1)


def auroc_ood(id_probs: np.ndarray, ood_probs: np.ndarray) -> float:
    """AUROC of separating OOD (positive) from in-distribution samples."""
    scores = np.concatenate([ood_scores(id_probs), ood_scores(ood_probs)])
    labels = np.concatenate([np.zeros(len(id_probs)), np.ones(len(ood_probs))])
    return roc_auc(scores, labels)


def mc_gaussian_nll(mu_samples: torch.Tensor, targets: torch.Tensor,
                    logvar: torch.Tensor | float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """MC predictive NLL ``−log(1/S Σ_s N(y | μ_s, σ²))`` with σ² =
    exp(logvar), and the RMSE of the posterior-mean predictor."""
    S = mu_samples.shape[0]
    y = targets.reshape(1, *mu_samples.shape[1:]).to(mu_samples)
    var = torch.exp(torch.as_tensor(logvar, dtype=mu_samples.dtype,
                                    device=mu_samples.device))
    log_comp = -0.5 * (torch.log(2 * math.pi * var) + (mu_samples - y) ** 2 / var)
    log_comp = log_comp.reshape(S, -1)                          # (S, B·K)
    log_avg = torch.logsumexp(log_comp, dim=0) - math.log(S)
    nll = -torch.mean(log_avg)
    rmse = torch.sqrt(torch.mean((mu_samples.mean(0) - y[0]) ** 2))
    return nll, rmse
