"""Calibration metrics and the dataset-level evaluation harness.

Exports the counterparts of
``laplace_inducing_points_tpu/evaluation/__init__.py``'s names (read lazily:
``_exports.py``)."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("auroc_ood", "eval_dataset", "eval_dataset_extended",
                     "make_batch_sampler"), "harness"),
    **dict.fromkeys(("brier_score", "ece", "mc_gaussian_nll", "mc_predictive_nll_acc",
                     "roc_auc"), "metrics"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
