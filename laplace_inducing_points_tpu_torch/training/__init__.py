"""Training: MAP weights, the inducing points Z and the prior precision α.

Exports the counterparts of
``laplace_inducing_points_tpu/training/__init__.py``'s names (read lazily:
``_exports.py``)."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("log_marginal_likelihood", "train_map_then_alpha", "update_alpha"),
                    "alpha"),
    "grid_search_alpha": "grid_search",
    **dict.fromkeys(("kl_objective_dense", "kl_objective_gram", "kl_objective_stochastic",
                     "optimize_step", "train_inducing_points"), "inducing"),
    **dict.fromkeys(("cosine_lr", "map_step", "train_map"), "map"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
