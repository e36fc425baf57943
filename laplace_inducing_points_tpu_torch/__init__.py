"""PyTorch/CUDA port of ``laplace_inducing_points_tpu`` for an NVIDIA H100.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``. Its subpackages carry the same names as the reference's,
so each module's counterpart is easy to find. The serving path of the
linearized-Laplace predictive runs through hand-written CUDA kernels
(``ops/cuda``, sources in ``csrc``).
"""
