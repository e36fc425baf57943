"""Model factory keyed by config name.

Counterpart of ``laplace_inducing_points_tpu/models/registry.py``. Flax
infers input widths from a dummy batch; the toy MLPs here take them from
``input_shape`` (one example's shape).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

from torch import nn

from laplace_inducing_points_tpu_torch.models.scale import LeNet5
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier, SimpleRegressor

NOT_PORTED = ("large_classifier", "ResNet1")


def get_model(model_cfg: Mapping[str, Any], input_shape: tuple[int, ...]) -> nn.Module:
    name = model_cfg["name"]
    if name == "LeNet5":
        if tuple(input_shape) != (28, 28, 1):
            raise ValueError(f"LeNet5 takes 28x28x1 inputs, got {tuple(input_shape)}")
        return LeNet5()
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
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  "(ROADMAP, Queue A)")
    raise ValueError(f"Unknown model name: {name}")
