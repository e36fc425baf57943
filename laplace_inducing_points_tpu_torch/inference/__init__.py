"""Posterior sampling and the scalable LLA predictive (serving path).

Exports the counterparts of
``laplace_inducing_points_tpu/inference/__init__.py``'s names (read lazily:
``_exports.py``); the sampler ``sample.sample`` as ``sample_weights``, so that
``inference.sample`` stays the submodule."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("Gaussian", "ScalableLLAPredictor", "materialize_covariance",
                     "posterior_lla_dense", "predict_la_samples_dense", "predict_lla_dense",
                     "predict_lla_scalable"), "lla"),
    **dict.fromkeys(("inv_matsqrt_dense", "make_inv_matsqrt", "make_inv_matsqrt_lanczos"),
                    "sample"),
    "sample_weights": "sample:sample",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
