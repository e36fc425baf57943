"""The plain reference against the program at a tiny size on the CPU: the rows,
the Gram KL and its gradient in Z in float64 (the program's operators run on
a float64 copy of its state), and the logit samples of the weight predictive
(the program's kernels take float32 only)."""

from __future__ import annotations

import copy
import math
from types import SimpleNamespace

import pytest
import torch

from perfbench import inputs
from perfbench.reference import lenet5, lla, resnet1m

CPU = torch.device("cpu")
NETS = {"lenet5": (lenet5, {"name": "LeNet5", "type": "classifier"}),
        "resnet1m": (resnet1m, {"name": "ResNet1", "type": "classifier", "num_c": 10})}


def _program(name: str, seed: int):
    from laplace_inducing_points_tpu_torch.models.registry import get_model
    from laplace_inducing_points_tpu_torch.models.state import ModelState
    net, model_cfg = NETS[name]
    flat, stats = inputs.weights(net, seed, CPU), inputs.batch_stats(net, CPU)
    state = ModelState(get_model(model_cfg, net.INPUT_SHAPE), flat.clone(), "classifier",
                       {k: v.clone() for k, v in stats.items()})
    return net, flat, stats, state


def _float64(state):
    return SimpleNamespace(model=copy.deepcopy(state.model).double(),
                           flat_params=state.flat_params.double(), spec=state.spec,
                           batch_stats={k: v.double() for k, v in state.batch_stats.items()},
                           model_kind=state.model_kind, logvar=state.logvar,
                           device=state.device)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("name,m,n", [("lenet5", 3, 4), ("resnet1m", 1, 1)])
def test_rows_kl_and_gradient_agree_in_float64(name, m, n):
    from laplace_inducing_points_tpu_torch.core import operators as ops
    from laplace_inducing_points_tpu_torch.training.inducing import _kl_core
    net, flat, stats, state = _program(name, 7)
    s64 = _float64(state)
    Z = inputs.images(m, net.INPUT_SHAPE, 10, 7, inputs.IMAGES, CPU).double()
    X = inputs.images(n, net.INPUT_SHAPE, 10, 7, inputs.TEST_IMAGES, CPU).double()
    flat64, stats64 = flat.double(), {k: v.double() for k, v in stats.items()}
    alpha, N = 0.005, 1000
    beta, gamma = N / m, N / n

    Rz, Rx = ops.dense_wt(s64, Z), ops.dense_wt(s64, X)
    assert _rel(lla.rows(net, flat64, stats64, Z), Rz) < 1e-12
    assert _rel(lla.rows(net, flat64, stats64, X), Rx) < 1e-12

    rz = Rz.detach().requires_grad_()
    kl = _kl_core(rz @ rz.T, Rx @ rz.T, torch.sum(Rx * Rx), rz.shape[1], alpha, beta, gamma)
    (ct,) = torch.autograd.grad(kl, rz)
    dZ = ops.dense_wt_pullback(s64, Z, ct)
    ref_kl, ref_dZ = lla.kl_value_and_grad(net, flat64, stats64, Z, X, alpha, N)
    assert math.isclose(float(ref_kl), float(kl.detach()), rel_tol=1e-12)
    assert _rel(ref_dZ, dZ) < 1e-10


def test_logit_samples_agree_with_the_float32_predictor():
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    net, flat, stats, state = _program("lenet5", 3)
    Z = inputs.images(4, net.INPUT_SHAPE, 10, 3, inputs.IMAGES, CPU)
    x = inputs.images(5, net.INPUT_SHAPE, 10, 3, inputs.TEST_IMAGES, CPU)
    alpha, N, S = 0.005, 1000, 6
    pred = ScalableLLAPredictor(state, Z, full_set_size=N)
    got = pred.logit_samples(x, alpha, inputs.generator(CPU, 3, inputs.DRAWS), S)
    eps = torch.randn(S, flat.shape[0], generator=inputs.generator(CPU, 3, inputs.DRAWS))
    flat64 = flat.double()
    R = lla.rows(net, flat64, {}, Z.double())
    lam, V = lla.weight_factor(R)
    ref = lla.logit_samples(net, flat64, {}, x.double(), R, lam, V, eps.double(), alpha,
                            N / 4, 1e-7)
    f = lla.logits(net, flat64, {}, x.double())
    assert got.shape == ref.shape == (S, 5, 10)
    assert float(torch.linalg.norm(got.double() - ref) / torch.linalg.norm(ref - f)) < 1e-4
