"""Data: numpy datasets and loaders (image sets and their offline surrogate).

Exports the counterparts of ``laplace_inducing_points_tpu/data/__init__.py``'s
names (read lazily: ``_exports.py``)."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = dict.fromkeys(("ArrayDataset", "DataLoader", "cycling_batches", "device_iter",
                          "make_dataloaders"), "loader")
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
