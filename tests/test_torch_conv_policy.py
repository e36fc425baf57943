"""The port's convolution policy (``utils.device.set_conv_policy``): cuDNN
deterministic, no autotuning, TF32 off, and its Winograd and FFT engines
blocked through ``utils/cudnn_errata.json``; applied by every convolution of
the port's models and by every entry point.

These run on the CPU, where cuDNN is not used: they check that the policy is
in force wherever a convolution runs. Its effect on the card (each route's
float32 error against float64 within 2x the cuDNN-off path's, rows and MAP
gradients bitwise reproducible, no Winograd or FFT kernel) is
``chip_smoke.py``'s phase 32 and the ``cuda``-marked tests below. So is the
policy's probe (``utils.device.check_conv_policy``), which raises where the
policy is out of force; here its logic runs on the CPU with a perturbed
convolution standing in for a Winograd engine."""

import json
import os
import subprocess
import sys

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
from laplace_inducing_points_tpu_torch.utils.relu_masks import replay_relu_masks

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
    Winograd or FFT kernels, the weight-gradient engine whose float32 error
    at LeNet5's MAP batches was 5x the cuDNN-off path's, and the
    data-gradient engine that put ResNet1M's row pullback 2.2x from it."""
    rules = json.loads(device.CUDNN_ERRATA.read_text())["rules"]
    blocked = {(r["operation"], r["engine"]) for r in rules}
    assert blocked == {("ConvFwd", 3), ("ConvBwdData", 50), ("ConvBwdFilter", 17),
                       ("ConvBwdFilter", 18), ("ConvBwdFilter", 67), ("ConvBwdData", 74)}
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
                        lambda *args: (calls.append(1), device.set_conv_policy(*args)))
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

    def policy(*args):
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
    PyTorch's own convolutions (cuDNN off) on the same inputs, each against
    float64 on its own ReLU masks, and bitwise equal in two builds
    (unrestricted, cuDNN's Winograd engines put LeNet5's rows in blocks of 4
    at 4.2e-5 from float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device.set_f32_policy()
    state = _cuda_state(name)
    s64 = _state64(state)
    shape = (block, 28, 28, 1) if name == "LeNet5" else (block, 32, 32, 3)
    gen = torch.Generator(device="cuda").manual_seed(block)
    x = torch.rand(*shape, device="cuda", generator=gen)
    with torch.no_grad():
        with replay_relu_masks(state, s64):
            ref = ops.dense_wt(s64, x.double())
        rows, again = ops.dense_wt(state, x), ops.dense_wt(state, x)
        with torch.backends.cudnn.flags(enabled=False):
            off = ops.dense_wt(state, x)
            with replay_relu_masks(state, s64):
                ref_off = ops.dense_wt(s64, x.double())
    assert torch.equal(rows, again)
    assert _rel(rows, ref) <= 2.0 * _rel(off, ref_off), (_rel(rows, ref), _rel(off, ref_off))


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


# --- the policy's probe (utils.device.check_conv_policy) ----------------------

def test_the_probe_does_not_run_on_the_cpu(monkeypatch):
    """cuDNN does not run on the CPU: neither the policy's setters nor a CPU
    model's convolutions probe anything."""
    def probed(dev):
        raise AssertionError(f"probed {dev}")

    monkeypatch.setattr(device, "check_conv_policy", probed)
    cpu = torch.device("cpu")
    device.set_conv_policy(cpu)
    device.set_conv_policy()
    device.set_f32_policy(cpu)
    state = _seeded(LeNet5())
    x = torch.as_tensor(np.random.default_rng(0).random((2, 28, 28, 1), dtype=np.float32))
    with torch.no_grad():
        ops.dense_wt(state, x)


def test_the_probe_is_at_round_off_inside_transforms_and_grad_modes(monkeypatch):
    """The probe's own computation (a vmap of jacrev) runs, and reads float32
    round-off, wherever a convolution may first call it: inside the rows'
    vmap of jacrev, under no_grad and under inference_mode (on the CPU, where
    the convolutions are PyTorch's own)."""
    cpu, errors = torch.device("cpu"), []
    monkeypatch.setattr(layers, "set_conv_policy",
                        lambda *args: errors.append(device.probe_error(cpu)))
    state = _seeded(LeNet5())
    x = torch.as_tensor(np.random.default_rng(1).random((2, 28, 28, 1), dtype=np.float32))
    with torch.no_grad():
        ops.dense_wt(state, x)
    with torch.inference_mode():
        errors.append(device.probe_error(cpu))
    assert len(errors) == 3 and max(errors) <= device.PROBE_LIMIT / 10, errors


def test_a_probe_above_its_limit_raises_and_nothing_falls_back(no_policy, monkeypatch):
    """A convolution whose float32 result is off by 1e-3 (as a Winograd
    engine's would be): the check raises, names the likely causes, leaves the
    policy in force and records nothing, so the next call raises again; on a
    simulated CUDA device ``set_conv_policy`` runs it and raises too."""
    conv2d = torch.nn.functional.conv2d

    def perturbed(x, w, *args, **kwargs):
        out = conv2d(x, w, *args, **kwargs)
        return out * (1 + 1e-3) if out.dtype == torch.float32 else out

    monkeypatch.setattr(torch.nn.functional, "conv2d", perturbed)
    monkeypatch.setattr(device, "PROBED", {})
    device.set_conv_policy()
    cpu = torch.device("cpu")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="not in force on cpu.*CUDNN_ERRATA_JSON_FILE"):
            device.check_conv_policy(cpu)
        assert _in_force() and device.PROBED == {}
    probe_error = device.probe_error
    monkeypatch.setattr(device, "probe_error", lambda dev: probe_error(cpu))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    cuda = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="not in force on cuda:0"):
        device.set_conv_policy(cuda)
    assert device.PROBED == {}
    monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d)
    device.set_conv_policy(cuda)                    # a probe at round-off passes, once
    assert set(device.PROBED) == {"cuda:0"} and device.PROBED["cuda:0"][0] <= device.PROBE_LIMIT
    monkeypatch.setattr(device, "probe_error", lambda dev: 1.0)
    device.set_conv_policy(cuda)                    # checked once a process and device


@pytest.mark.cuda
def test_the_probe_passes_under_the_policy_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device.set_f32_policy(torch.device("cuda"))
    err, seconds = device.PROBED[f"cuda:{torch.cuda.current_device()}"]
    assert err <= device.PROBE_LIMIT and seconds > 0


_CONV_FIRST = """
import torch
import torch.nn.functional as F
F.conv2d(torch.rand(2, 3, 8, 8, device="cuda"), torch.rand(4, 3, 3, 3, device="cuda"))
from laplace_inducing_points_tpu_torch.utils.device import set_f32_policy
set_f32_policy(torch.device("cuda"))
"""


@pytest.mark.cuda
def test_a_convolution_before_the_policy_makes_the_probe_raise_on_cuda():
    """A process that built a cuDNN convolution plan before the port named
    the errata file runs Winograd at the probe's shape: the entry point's
    policy raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    env = {k: v for k, v in os.environ.items() if k != "CUDNN_ERRATA_JSON_FILE"}
    proc = subprocess.run([sys.executable, "-c", _CONV_FIRST], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "convolution policy is not in force" in proc.stderr, \
        proc.stderr[-2000:]


# --- float64 on the float32 forward's ReLU masks (utils.relu_masks) ----------

def test_replayed_masks_make_float64_the_float32_function():
    """Where the float32 forward's ReLU masks differ from float64's, the
    replayed float64 forward follows the float32 masks, inside the rows'
    vmap of jacrev and the push-forward's vmap of jvp: with every one of
    Dense_1's inputs negative in the float32 model (its bias shifted by -1e3)
    the float64 model at the unshifted weights outputs Dense_2's bias, and its
    rows and push-forward reach no weight but that bias. Without the masks
    nothing of that holds."""
    state = _seeded(LeNet5())
    s64 = _state64(state)
    spec = state.spec
    leaves = spec.unflatten(state.flat_params)
    leaves["Dense_1.bias"] = leaves["Dense_1.bias"] - 1e3
    off = ModelState(LeNet5(), torch.cat([leaves[k].reshape(-1) for k in leaves]), "classifier")
    assert torch.equal(off.spec.unflatten(off.flat_params)["Dense_1.bias"], leaves["Dense_1.bias"])
    x = torch.as_tensor(np.random.default_rng(2).random((3, 28, 28, 1), dtype=np.float32))
    bias = torch.zeros(spec.num_params, dtype=torch.bool)
    start = 0
    for name, t in spec.unflatten(state.flat_params).items():
        bias[start:start + t.numel()] = name == "Dense_2.bias"
        start += t.numel()
    v = torch.as_tensor(np.random.default_rng(3).standard_normal((2, spec.num_params)))
    with torch.no_grad():
        with replay_relu_masks(off, s64):
            out = ops.model_outputs(s64, s64.flat_params, x.double())
            rows = ops.dense_wt(s64, x.double())
            push = torch.func.vmap(ops.linearize_model(s64, x.double()).jvp)(v)
        plain = ops.dense_wt(s64, x.double())
    dense_2_bias = s64.spec.unflatten(s64.flat_params)["Dense_2.bias"]
    assert torch.equal(out, dense_2_bias.expand_as(out))
    assert torch.all(rows[:, ~bias] == 0) and torch.all(rows[:, bias].abs().sum(1) > 0)
    assert torch.allclose(push, v[:, None, bias].expand_as(push), rtol=0, atol=1e-12)
    assert torch.any(plain[:, ~bias] != 0)


def test_replayed_masks_leave_the_float32_statistics_and_match_float64():
    """In train mode (the MAP gradient, BatchNorm on the batch's moments) the
    replay's float32 forward updates copies, not the float32 state's
    statistics; where no mask differs (ResNet1M on the CPU at these inputs)
    the replayed gradient equals plain float64's to round-off, and float32's
    is at float32 round-off from it."""
    from laplace_inducing_points_tpu_torch.training.map import map_loss
    state = _seeded(ResNet1M(10))
    s64 = _state64(state)
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.random((2, 32, 32, 3), dtype=np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 2))

    def grad(st, cast):
        flat = st.flat_params.clone().requires_grad_()
        return torch.autograd.grad(map_loss(st, flat, cast(x), y, 0.005)[0], flat)[0]

    with replay_relu_masks(state, s64):
        replayed = grad(s64, lambda t: t.double())
    assert all(torch.equal(stats[k], state.batch_stats[k]) for k in stats)
    assert _rel(replayed, grad(s64, lambda t: t.double())) <= 1e-12
    assert _rel(grad(state, lambda t: t), replayed) <= 1e-5


def test_a_data_parallel_steps_masks_are_recorded_by_shard_and_replayed():
    """The shards of a data-parallel MAP step record their ReLU masks under
    ``shard <rank>``; in rank order they are the whole batch's, as one
    device's forward records them, and float64 on them gives the float32
    gradient's function (ResNet1M, train mode, a mesh of the CPU twice)."""
    from laplace_inducing_points_tpu_torch.parallel.mesh import make_mesh
    from laplace_inducing_points_tpu_torch.training.map import map_loss, map_step
    from laplace_inducing_points_tpu_torch.utils.relu_masks import (recorded_relu_masks,
                                                                      replayed_relu_masks)
    state = _seeded(ResNet1M(10))
    rng = np.random.default_rng(7)
    batch = (torch.as_tensor(rng.random((4, 32, 32, 3), dtype=np.float32)),
             torch.as_tensor(rng.integers(0, 10, 4)))
    records, grads = [], []
    for mesh in (None, make_mesh([torch.device("cpu")] * 2)):
        flat = state.flat_params.clone().requires_grad_()
        work = ModelState(state.model, flat, "classifier",
                          {k: v.clone() for k, v in state.batch_stats.items()})
        record = {}
        with recorded_relu_masks(record):
            map_step(work, flat, torch.optim.SGD([flat], lr=0.0), batch, 0.005, mesh=mesh)
        records.append(record)
        grads.append(flat.grad)
    one, shards = records[0]["MainThread"], [records[1]["shard 0"], records[1]["shard 1"]]
    assert len(one) == len(shards[0]) == len(shards[1]) == 19
    assert all(torch.equal(a, torch.cat([b, c])) for a, b, c in zip(one, *shards))
    s64 = _state64(state)
    flat = s64.flat_params.clone().requires_grad_()
    with replayed_relu_masks(one):
        loss, _ = map_loss(s64, flat, batch[0].double(), batch[1], 0.005)
    g64 = torch.autograd.grad(loss, flat)[0]
    assert _rel(grads[0], g64) <= 1e-5 and _rel(grads[1], g64) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 2])
def test_resnet1m_rows_at_the_cpu_float32_level_on_cuda(block):
    """ResNet1M's rows on the first images, on the card with cuDNN off and
    under the policy, each from float64 on its own ReLU masks, no further than
    F64_RATIO = 2 times the CPU float32 port's error from the CPU's float64 on
    its masks (against plain ReLUs the card read 5.9e-4 on image 0, cuDNN on
    and off alike, where one of 3 x 10^5 pre-activations flipped: a kink, not
    an op)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    device.set_f32_policy(torch.device("cuda"))
    cpu32 = _seeded(ResNet1M(10))
    card = ModelState(ResNet1M(10).cuda(), cpu32.flat_params.cuda(), "classifier")
    cpu64, card64 = _state64(cpu32), _state64(card)
    x = torch.as_tensor(load_arrays("cifar10", True, root=os.path.join(
        REPO, "data", "no_such_dir"))[0][:block])
    with torch.no_grad():
        with replay_relu_masks(cpu32, cpu64):
            cpu_err = _rel(ops.dense_wt(cpu32, x), ops.dense_wt(cpu64, x.double()))
        errors = []
        for enabled in (False, True):       # cuDNN off, then the policy's settings
            with torch.backends.cudnn.flags(enabled=enabled, benchmark=False,
                                            deterministic=True, allow_tf32=False):
                rows = ops.dense_wt(card, x.cuda())
                with replay_relu_masks(card, card64):
                    errors.append(_rel(rows, ops.dense_wt(card64, x.cuda().double())))
    off, policy = errors
    assert off <= 2.0 * cpu_err and policy <= 2.0 * off, (off, policy, cpu_err)


# --- BatchNorm's normaliser (models.layers.inv_std) ---------------------------

@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_normalises_without_rsqrt(train, monkeypatch):
    """BatchNorm divides by a correctly rounded square root, in eval and in
    train mode: on CUDA ``torch.rsqrt`` is approximate (up to 2 ulp), which
    put seeded ResNet1M's push-forward 2x the CPU's distance from float64.
    With ``torch.rsqrt`` unavailable the layer runs and agrees with float64's
    ``(x - mean) / sqrt(var + eps) * scale + bias`` to float32 round-off."""
    def no_rsqrt(*args, **kwargs):
        raise AssertionError("BatchNorm called torch.rsqrt")

    monkeypatch.setattr(torch, "rsqrt", no_rsqrt)
    rng = np.random.default_rng(5)
    bn = layers.BatchNorm(8)
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, 8)))
        bn.bias.copy_(torch.as_tensor(rng.standard_normal(8)))
        bn.mean.copy_(torch.as_tensor(rng.standard_normal(8)))
        bn.var.copy_(torch.as_tensor(rng.uniform(0.1, 3.0, 8)))
    x = torch.as_tensor(rng.standard_normal((4, 8, 5, 5)), dtype=torch.float32)
    x64 = x.double()
    if train:
        mean = x64.mean(dim=(0, 2, 3))
        var = torch.clamp((x64 * x64).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = bn.mean.double(), bn.var.double()
    ref = ((x64 - mean[:, None, None]) / torch.sqrt(var + bn.epsilon)[:, None, None]
           * bn.scale.double()[:, None, None] + bn.bias.double()[:, None, None])
    with torch.no_grad():
        out = bn(x, train)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.cuda
def test_resnet1m_push_forward_at_the_cpu_float32_level_on_cuda():
    """Seeded ResNet1M's push-forward of 25 draws on the first 10 images, on
    the card with cuDNN off and under the policy, each from float64 on its
    own ReLU masks, no further than the CPU float32 port is from the CPU's
    float64 on its masks. On ``chip_smoke.py``'s phase-32 draws, with
    ``torch.rsqrt`` in BatchNorm the card read 5.2e-7 (cuDNN off) against the
    CPU's 2.7e-7; with 1 / sqrt 1.7e-7 (cuDNN off) and 2.2e-7 (the policy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from laplace_inducing_points_tpu_torch.data.scale import load_arrays
    device.set_f32_policy(torch.device("cuda"))
    cpu32 = _seeded(ResNet1M(10))
    card = ModelState(ResNet1M(10).cuda(), cpu32.flat_params.cuda(), "classifier")
    cpu64, card64 = _state64(cpu32), _state64(card)
    x = torch.as_tensor(load_arrays("cifar10", True, root=os.path.join(
        REPO, "data", "no_such_dir"))[0][:10])
    v = 0.05 * torch.as_tensor(np.random.default_rng(6).standard_normal(
        (25, cpu32.spec.num_params)), dtype=torch.float32)

    def push(state, xs, vs):
        return torch.func.vmap(ops.linearize_model(state, xs).jvp)(vs)

    with torch.no_grad():
        with replay_relu_masks(cpu32, cpu64):
            cpu_err = _rel(push(cpu32, x, v), push(cpu64, x.double(), v.double()))
        errors = []
        for enabled in (False, True):       # cuDNN off, then the policy's settings
            with torch.backends.cudnn.flags(enabled=enabled, benchmark=False,
                                            deterministic=True, allow_tf32=False):
                out = push(card, x.cuda(), v.cuda())
                with replay_relu_masks(card, card64):
                    errors.append(_rel(out, push(card64, x.cuda().double(),
                                                 v.cuda().double())))
    assert max(errors) <= cpu_err, (errors, cpu_err)
