"""Ops: randomized estimators, Krylov decompositions, CG, the Nyström
preconditioner and the hand-written CUDA kernels for Hopper (``ops/cuda``).

Exports the counterparts of ``laplace_inducing_points_tpu/ops/__init__.py``'s
names (read lazily: ``_exports.py``). ``syrk`` is the B1 kernel's wrapper
(``ops/cuda/syrk.py``): on a CUDA tensor it launches the kernel, on a CPU
tensor it runs the plain version. Neither importing this package nor reading
a name builds or loads the kernels' library; the first launch does."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("funm_lanczos_sym", "funm_sym_dense", "golub_kahan_bidiag",
                     "lanczos_sym"), "lanczos"),
    **dict.fromkeys(("nystrom_preconditioner", "nystrom_sketch", "precond_from_sketch"),
                    "nystrom"),
    "syrk": "cuda.syrk",
    **dict.fromkeys(("slq_logdet_product", "slq_logdet_sym"), "slq"),
    **dict.fromkeys(("hutchinson", "hutchpp", "na_hutchpp", "normal_probes",
                     "rademacher_probes", "trace_of_inverse"), "stochtrace"),
    "cg_batched": "cg",
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
