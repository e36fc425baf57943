"""Twin tests of the port's flat parameters, models, configs and checkpoints.

Catches the layout traps: ``ravel_pytree`` order over string-sorted keys
with ``logvar`` left out, HWIO conv kernels, ``(in, out)`` dense kernels and
LeNet5's NHWC flatten.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu.core import operators as jops
from laplace_inducing_points_tpu.core.params import flatten_nn_params
from laplace_inducing_points_tpu.utils import checkpoint as jckpt
from laplace_inducing_points_tpu.utils.config import (
    load_experiment_config as jax_load_config)
from laplace_inducing_points_tpu_torch.core import operators as tops
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec,
                                                           lecun_normal_params,
                                                           params_from_jax,
                                                           params_to_jax)
from laplace_inducing_points_tpu_torch.models.registry import get_model
from laplace_inducing_points_tpu_torch.models.scale import LeNet5
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.utils import checkpoint as tckpt
from laplace_inducing_points_tpu_torch.utils.config import load_experiment_config
from laplace_inducing_points_tpu_torch.utils.device import resolve_device

from torch_twins import inputs, make_twins

KINDS = ["classifier", "regressor", "lenet5"]
CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "**", "*.yml"), recursive=True))


@pytest.mark.parametrize("kind", KINDS)
def test_flat_vector_matches_jax_bitwise(kind):
    jstate, pstate, tree = make_twins(kind)
    jflat, _ = flatten_nn_params(jstate.params)
    flat, spec = params_from_jax(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert spec == pstate.spec          # the module's own order is ravel_pytree's
    assert "logvar" not in spec.names


@pytest.mark.parametrize("kind", KINDS)
def test_converter_round_trip_bitwise(kind):
    _, _, tree = make_twins(kind, seed=3)
    tree.pop("logvar", None)
    back = params_to_jax(*params_from_jax(tree))
    assert back.keys() == tree.keys()
    for layer in tree:
        assert back[layer].keys() == tree[layer].keys()
        for leaf in tree[layer]:
            assert back[layer][leaf].dtype == tree[layer][leaf].dtype
            np.testing.assert_array_equal(back[layer][leaf], tree[layer][leaf])


@pytest.mark.parametrize("kind,batch", [("classifier", 5), ("regressor", 5), ("lenet5", 3)])
def test_model_outputs_match_jax(kind, batch):
    jstate, pstate, _ = make_twins(kind)
    x = inputs(kind, batch)
    ref = jops.model_outputs(jstate, jstate.params, jnp.asarray(x))
    got = tops.model_outputs(pstate, pstate.flat_params, torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_lenet5_has_the_reference_width():
    assert FlatSpec.from_module(LeNet5()).num_params == 61706


def test_params_checkpoint_round_trip(tmp_path):
    spec = FlatSpec.from_module(LeNet5())
    flat, spec2 = params_from_jax(lecun_normal_params(spec, 7))
    assert spec2 == spec
    tckpt.save_params(flat, spec, str(tmp_path), "map_mnist")
    flat_back, spec_back, logvar = tckpt.load_params(str(tmp_path), "map_mnist")
    assert spec_back == spec and logvar is None
    assert torch.equal(flat_back, flat)
    ModelState(LeNet5(), flat_back, "classifier")


def test_inducing_points_written_by_jax_load(tmp_path):
    Z = np.random.default_rng(0).standard_normal((6, 28, 28, 1)).astype(np.float32)
    jckpt.save_array(jnp.asarray(Z), str(tmp_path), "ind_mnist", 250)
    jckpt.save_run_meta(str(tmp_path), "ind_mnist", {"alpha_ip": 2.5})
    np.testing.assert_array_equal(tckpt.load_array(str(tmp_path), "ind_mnist", 250), Z)
    assert tckpt.load_run_meta(str(tmp_path), "ind_mnist") == {"alpha_ip": 2.5}


def test_model_state_rejects_wrong_width():
    with pytest.raises(ValueError, match="flat_params"):
        ModelState(LeNet5(), torch.zeros(10), "classifier")


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_matches_jax(path):
    assert load_experiment_config(path) == jax_load_config(path)


def test_registry_builds_ported_models_and_refuses_the_rest():
    """Every model of the JAX registry is ported; an unknown name raises."""
    assert isinstance(get_model({"name": "LeNet5"}, (28, 28, 1)), LeNet5)
    clf = get_model({"name": "classifier", "num_h": 8, "num_l": 2, "num_c": 3}, (2,))
    assert FlatSpec.from_module(clf).num_params == (2 * 8 + 8) + (8 * 8 + 8) + (8 * 3 + 3)
    mlp = get_model({"name": "large_classifier", "num_h": [16, 8], "num_l": 2, "num_c": 3},
                    (4, 4, 1))
    assert FlatSpec.from_module(mlp).num_params == (16 * 16 + 16) + (16 * 8 + 8) + (8 * 3 + 3)
    assert FlatSpec.from_module(get_model({"name": "ResNet1", "num_c": 10},
                                          (28, 28, 1))).num_params == 1084586
    with pytest.raises(ValueError, match="Unknown model"):
        get_model({"name": "ResNet50"}, (28, 28, 1))


def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
