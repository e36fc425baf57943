"""Models of the port: LeNet5, the wide MLP, ResNet1M and the toy MLPs, in
Flax's parameter layouts.

Exports the counterparts of ``laplace_inducing_points_tpu/models/__init__.py``'s
names (read lazily: ``_exports.py``)."""

from laplace_inducing_points_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "get_model": "registry",
    **dict.fromkeys(("BasicBlock", "LargeClassifier", "LeNet5", "ResNet1M"), "scale"),
    # ModelState replaces the reference's TrainState and create_train_state:
    # the module, its flat weights and statistics, and the trainer's Adam state
    **dict.fromkeys(("AdamState", "ModelState"), "state"),
    **dict.fromkeys(("SimpleClassifier", "SimpleRegressor"), "toy"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
