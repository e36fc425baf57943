"""Shared builders for the twin tests of the PyTorch port.

A twin test gives the JAX package and the port the same inputs, made once in
numpy from a seed: a Flax parameter tree converted with
``params_from_jax``, the same points, the same noise. JAX stays on the CPU.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from laplace_inducing_points_tpu.models import scale as jmodels
from laplace_inducing_points_tpu.models.scale import LeNet5 as JaxLeNet5
from laplace_inducing_points_tpu.models.state import create_train_state
from laplace_inducing_points_tpu.models.toy import (SimpleClassifier as JaxClassifier,
                                                    SimpleRegressor as JaxRegressor)
from laplace_inducing_points_tpu_torch.core.params import batch_stats_from_jax, params_from_jax
from laplace_inducing_points_tpu_torch.models import scale as tmodels
from laplace_inducing_points_tpu_torch.models.layers import BatchNorm, Conv, Dense
from laplace_inducing_points_tpu_torch.models.scale import LeNet5
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier, SimpleRegressor

TOY_IN = 2          # toy inputs are 2-D points
LOGVAR = -0.7       # the regressor's observation log-variance in the twins


def _numpy_tree(tree, rng: np.random.Generator):
    """Seeded leaves in the tree's shapes: kernels ~ N(0, 1/fan_in), BatchNorm
    scales ~ 1 + 0.1·N(0, 1), other leaves (biases, logvar) ~ 0.1·N(0, 1), so
    every layout is exercised."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = _numpy_tree(dict(value), rng)
        elif key == "kernel":
            fan_in = int(np.prod(value.shape[:-1]))
            out[key] = (rng.standard_normal(value.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif key == "scale":
            out[key] = (1.0 + 0.1 * rng.standard_normal(value.shape)).astype(np.float32)
        else:
            out[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
    return out


def numpy_batch_stats(tree, rng: np.random.Generator):
    """Seeded BatchNorm statistics in a ``batch_stats`` tree's shapes: means
    ~ 0.1·N(0, 1), variances ~ U(0.5, 1.5)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = numpy_batch_stats(dict(value), rng)
        elif key == "mean":
            out[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
        else:
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
    return out


def convert_twins(jmodel, tmodel, dummy, model_kind: str = "classifier", seed: int = 0):
    """``(jax_state, port_state, numpy_tree, numpy_batch_stats)``: one Flax
    model and its port counterpart holding the same seeded weights and
    BatchNorm statistics (``{}`` without BatchNorm), converted with
    ``params_from_jax`` and ``batch_stats_from_jax``."""
    jstate = create_train_state(jmodel, jax.random.PRNGKey(0), dummy,
                                optax.adam(1e-3), model_kind=model_kind)
    rng = np.random.default_rng(seed)
    tree = _numpy_tree(dict(jstate.params), rng)
    stats = numpy_batch_stats(dict(jstate.batch_stats), rng) if jstate.batch_stats else {}
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree))
    if stats:
        jstate = jstate.replace(batch_stats=jax.tree.map(jnp.asarray, stats))
    flat, _ = params_from_jax(tree)
    return (jstate, ModelState(tmodel, flat, model_kind, batch_stats_from_jax(stats)),
            tree, stats)


def make_twins(kind: str, seed: int = 0):
    """``(jax_state, port_state, numpy_tree)`` holding the same weights.

    ``kind``: ``"classifier"`` (tanh MLP 3×32, 3 classes), ``"regressor"``
    (GELU MLP 2×16), ``"lenet5"`` (full width, D = 61,706), or the toy
    configs' own models: ``"banana"`` (tanh MLP 3×16, 2 classes, D = 626) and
    ``"sine"`` (GELU MLP 2×16 on 1-D inputs, D = 321).
    """
    if kind == "classifier":
        jmodel, tmodel = JaxClassifier(32, 3, 3), SimpleClassifier(32, 3, 3, TOY_IN)
        dummy, model_kind = jnp.zeros((1, TOY_IN)), "classifier"
    elif kind == "banana":
        jmodel, tmodel = JaxClassifier(16, 3, 2), SimpleClassifier(16, 3, 2, TOY_IN)
        dummy, model_kind = jnp.zeros((1, TOY_IN)), "classifier"
    elif kind == "regressor":
        jmodel, tmodel = JaxRegressor(16, 2), SimpleRegressor(16, 2, TOY_IN)
        dummy, model_kind = jnp.zeros((1, TOY_IN)), "regressor"
    elif kind == "sine":
        jmodel, tmodel = JaxRegressor(16, 2), SimpleRegressor(16, 2, 1)
        dummy, model_kind = jnp.zeros((1, 1)), "regressor"
    elif kind == "lenet5":
        jmodel, tmodel = JaxLeNet5(), LeNet5()
        dummy, model_kind = jnp.zeros((1, 28, 28, 1)), "classifier"
    else:
        raise ValueError(kind)
    jstate = create_train_state(jmodel, jax.random.PRNGKey(0), dummy,
                                optax.adam(1e-3), model_kind=model_kind)
    tree = _numpy_tree(dict(jstate.params), np.random.default_rng(seed))
    if model_kind == "regressor":
        tree["logvar"] = np.float32(LOGVAR)
        with torch.no_grad():
            tmodel.logvar.fill_(LOGVAR)
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, tree))
    flat, _ = params_from_jax(tree)
    return jstate, ModelState(tmodel, flat, model_kind), tree


def inputs(kind: str, n: int, seed: int = 1) -> np.ndarray:
    """``n`` seeded inputs for the twin of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "lenet5":
        return rng.uniform(0.0, 1.0, (n, 28, 28, 1)).astype(np.float32)
    return rng.standard_normal((n, 1 if kind == "sine" else TOY_IN)).astype(np.float32)


def state64(pstate):
    """The port state in float64, as the namespace of attributes the operators
    and the predictives read, for twins held in float64 (``ModelState`` is
    float32)."""
    from types import SimpleNamespace

    import copy

    model = copy.deepcopy(pstate.model).double()
    logvar = model.logvar.detach() if pstate.model_kind == "regressor" else 0.0
    return SimpleNamespace(model=model, flat_params=pstate.flat_params.double(),
                           spec=pstate.spec, batch_stats={}, model_kind=pstate.model_kind,
                           logvar=logvar, device=pstate.device)


def jax_state64(jstate):
    """``jstate`` with float64 parameters; use under ``jax.enable_x64(True)``."""
    return jstate.replace(params=jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), jstate.params))


# --- a small BatchNorm net ---------------------------------------------------

class JaxTinyBNNet(fnn.Module):
    """Conv + BN + residual block + head (``tests/test_bn_models.py``)."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(4, (3, 3), padding="SAME", use_bias=False)(x)
        x = fnn.BatchNorm(use_running_average=not train)(x)
        x = fnn.relu(x)
        x = jmodels.BasicBlock(4)(x, train=train)
        x = jmodels.BasicBlock(6, stride=2)(x, train=train)
        x = jnp.mean(x, axis=(1, 2))
        return fnn.Dense(3)(x)


class TinyBNNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(2, 4, (3, 3), padding="SAME", use_bias=False)
        self.BatchNorm_0 = BatchNorm(4)
        self.BasicBlock_0 = tmodels.BasicBlock(4, 4)
        self.BasicBlock_1 = tmodels.BasicBlock(4, 6, stride=2)
        self.Dense_0 = Dense(6, 3)

    def forward(self, x, train: bool = False):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2)), train))
        x = self.BasicBlock_1(self.BasicBlock_0(x, train), train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def bn_twins():
    """:func:`convert_twins` of the tiny BatchNorm net (5×5×2 inputs)."""
    return convert_twins(JaxTinyBNNet(), TinyBNNet(), jnp.zeros((1, 5, 5, 2)), seed=3)


def bn_data(n: int, seed: int):
    """``n`` seeded 5×5×2 images and 3-class labels."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 5, 5, 2)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))
