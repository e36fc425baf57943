"""Model factory keyed by config name.

Counterpart of ``laplace_inducing_points_tpu/models/registry.py``. Flax
infers input widths from a dummy batch; the MLPs here take them from
``input_shape`` (one example's shape).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

from torch import nn

from laplace_inducing_points_tpu_torch.models.scale import LargeClassifier, LeNet5, ResNet1M
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier, SimpleRegressor


def get_model(model_cfg: Mapping[str, Any], input_shape: tuple[int, ...]) -> nn.Module:
    name = model_cfg["name"]
    if name == "LeNet5":
        if tuple(input_shape) != (28, 28, 1):
            raise ValueError(f"LeNet5 takes 28x28x1 inputs, got {tuple(input_shape)}")
        return LeNet5()
    if name == "large_classifier":
        return LargeClassifier(input_shape=input_shape,
                               num_hidden=model_cfg["num_h"],
                               num_layers=model_cfg["num_l"],
                               num_classes=model_cfg.get("num_c"))
    if name == "ResNet1":
        return ResNet1M(num_classes=model_cfg.get("num_c"))
    in_features = math.prod(input_shape)
    if name == "classifier":
        return SimpleClassifier(num_hidden=model_cfg["num_h"],
                                num_layers=model_cfg["num_l"],
                                num_classes=model_cfg.get("num_c"),
                                in_features=in_features)
    if name == "regressor":
        return SimpleRegressor(num_hidden=model_cfg["num_h"],
                               num_layers=model_cfg["num_l"],
                               in_features=in_features)
    raise ValueError(f"Unknown model name: {name}")
