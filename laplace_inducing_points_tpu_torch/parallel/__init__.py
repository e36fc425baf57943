"""Parallel: device meshes and example-sharded operator variants.

Exports the counterparts of
``laplace_inducing_points_tpu/parallel/__init__.py``'s names (read lazily:
``_exports.py``)."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    **dict.fromkeys(("DATA_AXIS", "MODEL_AXIS", "batch_sharding", "make_mesh",
                     "pad_to_multiple", "replicated", "shard_batch"), "mesh"),
    **dict.fromkeys(("shard_probes", "sharded_curvature_matmat", "sharded_dense_wt",
                     "sharded_ggn_matmat", "sharded_gram"), "sharded_ops"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
