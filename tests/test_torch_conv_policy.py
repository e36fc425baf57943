"""The port's convolution policy (``utils.device.set_conv_policy``): cuDNN
deterministic, no autotuning, TF32 off, and its Winograd and FFT engines
blocked through ``utils/cudnn_errata.json``; applied by every convolution of
the port's models and by every entry point.

These run on the CPU, where cuDNN is not used: they check that the policy is
in force wherever a convolution runs. Its effect on the card (each route's
float32 error against float64 within 2x the cuDNN-off path's, rows and MAP
gradients bitwise reproducible, no Winograd or FFT kernel) is
``chip_smoke.py``'s phase 32 and the ``cuda``-marked tests below."""

import json
import os

import numpy as np
import pytest
import torch

from laplace_inducing_points_tpu_torch.cli import evaluate, main_toy, train_scale
from laplace_inducing_points_tpu_torch.core import operators as ops
from laplace_inducing_points_tpu_torch.core.params import (FlatSpec, lecun_normal_params,
                                                           params_from_jax)
from laplace_inducing_points_tpu_torch.models import layers
from laplace_inducing_points_tpu_torch.models.scale import LeNet5, ResNet1M
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("allow_tf32", "deterministic", "benchmark")


@pytest.fixture
def no_policy(monkeypatch):
    """No errata file named and cuDNN's flags at PyTorch's defaults; both
    restored afterwards."""
    monkeypatch.delenv("CUDNN_ERRATA_JSON_FILE", raising=False)
    saved = {f: getattr(torch.backends.cudnn, f) for f in FLAGS}
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    torch.backends.cudnn.benchmark = True
    yield
    for f, v in saved.items():
        setattr(torch.backends.cudnn, f, v)


def _in_force() -> bool:
    return (os.environ.get("CUDNN_ERRATA_JSON_FILE") == str(device.CUDNN_ERRATA)
            and torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
            and not torch.backends.cudnn.allow_tf32)


def test_set_conv_policy_names_the_errata_file_and_sets_cudnn(no_policy):
    assert not _in_force()
    device.set_conv_policy()
    assert _in_force()
    device.set_conv_policy()            # idempotent
    assert _in_force()
    line = device.set_f32_policy()
    assert "deterministic=True" in line and "cudnn_errata.json" in line and _in_force()


def test_another_errata_file_refuses(no_policy, monkeypatch, tmp_path):
    """cuDNN reads one errata file a process: a variable naming another is an
    error, not a policy quietly left out."""
    monkeypatch.setenv("CUDNN_ERRATA_JSON_FILE", str(tmp_path / "other.json"))
    with pytest.raises(RuntimeError, match="CUDNN_ERRATA_JSON_FILE"):
        device.set_conv_policy()


def test_errata_file_blocks_the_winograd_and_fft_engines():
    """The file parses as cuDNN's frontend reads it (``rules`` of
    ``operation`` and ``engine``), ships with the package, and blocks each
    convolution direction's engines that the card's profile showed running
    Winograd or FFT kernels, and the weight-gradient engine whose float32
    error at LeNet5's MAP batches was 5x the cuDNN-off path's."""
    rules = json.loads(device.CUDNN_ERRATA.read_text())["rules"]
    blocked = {(r["operation"], r["engine"]) for r in rules}
    assert blocked == {("ConvFwd", 3), ("ConvBwdData", 50), ("ConvBwdFilter", 17),
                       ("ConvBwdFilter", 18), ("ConvBwdFilter", 67)}
    assert all(isinstance(r["rule_id"], str) and "knob" not in r for r in rules)
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    assert "utils/cudnn_errata.json" in text


def _seeded(model):
    flat, _ = params_from_jax(lecun_normal_params(FlatSpec.from_module(model), 3))
    return ModelState(model, flat, "classifier")


@pytest.mark.parametrize("name", ["LeNet5", "ResNet1M"])
def test_every_convolution_applies_the_policy(name, no_policy, monkeypatch):
    """Each ``Conv`` call applies the policy, in a forward, a vmapped jacrev
    (the rows) and a vmapped jvp (the push-forward) alike: the library needs
    no entry point to have run first."""
    model = LeNet5() if name == "LeNet5" else ResNet1M(10)
    shape = (2, 28, 28, 1) if name == "LeNet5" else (2, 32, 32, 3)
    state = _seeded(model)
    x = torch.as_tensor(np.random.default_rng(0).random(shape, dtype=np.float32))
    convs = sum(isinstance(m, layers.Conv) for m in model.modules())
    calls = []
    monkeypatch.setattr(layers, "set_conv_policy",
                        lambda: (calls.append(1), device.set_conv_policy()))
    with torch.no_grad():
        ops.model_outputs(state, state.flat_params, x)
    assert len(calls) == convs and _in_force()
    torch.backends.cudnn.deterministic = False
    with torch.no_grad():
        ops.dense_wt(state, x[:1])
    assert _in_force()
    torch.backends.cudnn.benchmark = True
    lin = ops.linearize_model(state, x)
    with torch.no_grad():
        torch.func.vmap(lin.jvp)(torch.zeros(2, state.spec.num_params))
    assert _in_force()


@pytest.mark.parametrize("cli, argv", [
    (train_scale, ["train_map", "--dataset", "mnist", "--config",
                   "configs/scale/lenet5_mnist.yml"]),
    (evaluate, ["--dataset", "mnist", "--config", "configs/scale/lenet5_mnist.yml"]),
    (main_toy, ["train_map", "--dataset", "banana", "--config",
                "configs/toy/classifier_banana.yml"]),
])
def test_every_entry_point_applies_the_policy_first(cli, argv, monkeypatch):
    """Each CLI applies the f32 policy, and with it the convolution policy,
    before it builds or runs a model."""
    class Applied(Exception):
        pass

    def policy():
        raise Applied

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(cli, "set_f32_policy", policy)
    with pytest.raises(Applied):
        cli.main([*argv, "--device", "cpu"])


def _cuda_state(name):
    model = LeNet5() if name == "LeNet5" else ResNet1M(10)
    state = _seeded(model)
    return ModelState(model.cuda(), state.flat_params.cuda(), "classifier")


def _state64(state):
    import copy
    from types import SimpleNamespace
    return SimpleNamespace(model=copy.deepcopy(state.model).double(),
                           flat_params=state.flat_params.double(), spec=state.spec,
                           batch_stats={k: v.double() for k, v in state.batch_stats.items()},
                           model_kind=state.model_kind, logvar=state.logvar,
                           device=state.device)


def _rel(a, b):
    return float(torch.linalg.norm((a.double() - b).ravel()) / torch.linalg.norm(b.ravel()))


@pytest.mark.cuda
@pytest.mark.parametrize("name, block", [("LeNet5", 8), ("LeNet5", 4), ("LeNet5", 1),
                                         ("ResNet1M", 2), ("ResNet1M", 1)])
def test_rows_within_twice_the_cudnn_off_error_on_cuda(name, block):
    """The rows of a block under the policy: no further from float64 than 2x
    PyTorch's own convolutions (cuDNN off) on the same inputs, and bitwise
    equal in two builds (unrestricted, cuDNN's Winograd engines put LeNet5's
    rows in blocks of 4 at 4.2e-5 from float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device.set_f32_policy()
    state = _cuda_state(name)
    shape = (block, 28, 28, 1) if name == "LeNet5" else (block, 32, 32, 3)
    gen = torch.Generator(device="cuda").manual_seed(block)
    x = torch.rand(*shape, device="cuda", generator=gen)
    with torch.no_grad():
        ref = ops.dense_wt(_state64(state), x.double())
        rows, again = ops.dense_wt(state, x), ops.dense_wt(state, x)
        with torch.backends.cudnn.flags(enabled=False):
            off = ops.dense_wt(state, x)
    assert torch.equal(rows, again)
    assert _rel(rows, ref) <= 2.0 * _rel(off, ref), (_rel(rows, ref), _rel(off, ref))


@pytest.mark.cuda
def test_two_factor_builds_are_bitwise_equal_on_cuda():
    """Two builds of the weight predictor's factor on one MAP and one Z give
    the same rows, Gram, eigenpairs and logits on the same noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
    device.set_f32_policy()
    state = _cuda_state("LeNet5")
    gen = torch.Generator(device="cuda").manual_seed(0)
    Z, x = (torch.rand(n, 28, 28, 1, device="cuda", generator=gen) for n in (100, 64))
    with torch.no_grad():
        preds = [ScalableLLAPredictor(state, Z, full_set_size=60000, range_clip_min=1.0)
                 for _ in range(2)]
        logits = [p.logit_samples(x, 0.005, torch.Generator(device="cuda").manual_seed(1), 50)
                  for p in preds]
    assert torch.equal(preds[0].R, preds[1].R)
    assert torch.equal(logits[0], logits[1])
