"""Core algebra: flat parameters, loss Hessians, linearization, row factors.

Exports the counterparts of ``laplace_inducing_points_tpu/core/__init__.py``'s
names (read lazily: ``_exports.py``)."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("h_apply", "h_dense", "sqrt_h_apply", "sqrt_h_t_apply"), "loss_hessians"),
    **dict.fromkeys(("GGNOperator", "WFactor", "curvature_dense", "dense_wt",
                     "ensure_symmetry", "linearize_model", "make_curvature_operator",
                     "make_ggn_operator", "make_w_factor", "model_outputs", "pdot"),
                    "operators"),
    # FlatSpec replaces the reference's flatten_nn_params: the flat vector is a
    # tensor, and FlatSpec.unflatten is its unravel
    **dict.fromkeys(("FlatSpec", "count_params", "num_curvature_params", "params_from_jax",
                     "print_summary", "split_nn_params"), "params"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
